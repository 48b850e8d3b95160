"""The one generator of every traffic mix: scenes and requests from the seed.

A mix (``traffic/<name>.json``) gives the scene geometry, how many distinct
areas (DEMs) and flood scenarios the seed draws, whether each job
names its DEM through a new hard link (so the program's path-keyed DEM cache
never finds it), how many jobs go into one call, and how many requests are
judged. Every seed draws the same sizes and the same spread of flood levels,
in another order over other terrain. A scenario's LR raster (a depth, or a
water surface) is the model family's (``families/<name>.py::lr_raster``).

Keys: ``lr_shape``, ``lr_res_m``, ``hr_shape``, ``epsg``, ``west``, ``south``,
``nodata``, ``relief_m``, ``areas``, ``scenarios``, ``offset_m`` and
``tilt_m`` (ranges, stratified over the scenarios), ``fresh_dem_path``,
``jobs_per_call``, ``warmup_calls``, ``judged`` and ``judged_among`` (the
judged jobs are drawn from the first ``judged_among``), ``rotate_outputs``;
and, read by the harness, ``loop`` and ``front`` (``loops/``, ``fronts/``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np

from perfbench.harness.synth import make_terrain
from perfbench.reference.tiff import write_geotiff


def sub_seed(seed: int, *tags: int) -> int:
    """A seed for one part of the run, from the run's seed and the part's tags."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *tags]).generate_state(2, np.uint64)[0])


@dataclass
class Area:
    dem: np.ndarray
    dem_path: Path
    base_m: float


@dataclass
class Scenario:
    area: int
    lr: np.ndarray
    lr_path: Path
    offset_m: float
    tilt_m: float


@dataclass
class Job:
    index: int
    scenario: int
    dem_path: Path
    out_path: Path
    judged: bool
    hr_mp: float


@dataclass
class Plan:
    mix: dict
    geometry: dict
    areas: list[Area] = field(default_factory=list)
    scenarios: list[Scenario] = field(default_factory=list)
    order: np.ndarray | None = None
    judged: set[int] = field(default_factory=set)
    workdir: Path | None = None
    bytes_written: int = 0

    @property
    def jobs_per_call(self) -> int:
        return int(self.mix.get("jobs_per_call", 1))

    def job(self, index: int, warmup: bool = False) -> Job:
        """The ``index``-th job of the window (or of the warm-up)."""
        k = int(self.order[index % len(self.order)])
        sc = self.scenarios[k]
        area = self.areas[sc.area]
        tag = "w" if warmup else "j"
        dem_path = area.dem_path
        if self.mix.get("fresh_dem_path"):
            dem_path = self.workdir / "links" / f"dem_{sc.area}_{tag}{index}.tif"
            os.link(area.dem_path, dem_path)
        judged = (not warmup) and index in self.judged
        if judged:
            out = self.workdir / "judged" / f"out_{index}.tif"
        else:
            out = self.workdir / "out" / f"{tag}{index % int(self.mix.get('rotate_outputs', 4))}.tif"
        h, w = self.geometry["hr_shape"]
        return Job(index, k, dem_path, out, judged, h * w / 1e6)

    def body(self, job: Job) -> dict:
        """The machine-interface body of one job: the program's defaults
        (feathered windows, LZW output) for everything it does not name."""
        return {"in": str(self.scenarios[job.scenario].lr_path), "dem": str(job.dem_path),
                "out": str(job.out_path)}

    def release(self, jobs: list[Job]) -> None:
        """Drop the hard links the jobs named (the DEM file stays)."""
        for j in jobs:
            if self.mix.get("fresh_dem_path"):
                j.dem_path.unlink(missing_ok=True)


def build(mix: dict, seed: int, workdir: Path,
          lr_raster: Callable[[np.ndarray, float, float, float, tuple], np.ndarray]) -> Plan:
    """Draw the areas and scenarios of ``mix`` from ``seed`` and write them
    as GeoTIFFs under ``workdir``; ``lr_raster(dem, base_m, offset_m, tilt_m,
    lr_shape)`` makes a scenario's LR input."""
    lr_shape = tuple(mix["lr_shape"])
    hr_shape = tuple(mix["hr_shape"])
    lr_res = float(mix["lr_res_m"])
    extent = lr_shape[0] * lr_res, lr_shape[1] * lr_res
    hr_res = extent[0] / hr_shape[0]
    geometry = {
        "lr_shape": lr_shape, "hr_shape": hr_shape, "lr_res": lr_res, "hr_res": hr_res,
        "west": float(mix["west"]), "north": float(mix["south"]) + extent[0],
        "epsg": int(mix["epsg"]), "nodata": float(mix["nodata"]),
    }
    for sub in ("links", "judged", "out"):
        (workdir / sub).mkdir(parents=True, exist_ok=True)
    plan = Plan(mix=mix, geometry=geometry, workdir=workdir)
    g = geometry
    for a in range(int(mix["areas"])):
        dem = make_terrain(hr_shape, sub_seed(seed, 1, a), float(mix.get("relief_m", 40.0)))
        fp = workdir / f"dem_{a}.tif"
        plan.bytes_written += write_geotiff(
            fp, dem, west=g["west"], north=g["north"], res=hr_res, epsg=g["epsg"],
            nodata=g["nodata"],
        )
        plan.areas.append(Area(dem, fp, float(np.quantile(dem, 0.25))))

    n = int(mix["scenarios"])
    rng = np.random.default_rng(sub_seed(seed, 2))
    strata = (np.arange(n) + 0.5) / n
    lo, hi = mix["offset_m"]
    offsets = lo + (hi - lo) * rng.permutation(strata)
    tlo, thi = mix["tilt_m"]
    tilts = (tlo + (thi - tlo) * rng.permutation(strata)) * np.where(np.arange(n) % 2, -1.0, 1.0)
    for k in range(n):
        area = k % len(plan.areas)
        lr = lr_raster(
            plan.areas[area].dem, plan.areas[area].base_m, float(offsets[k]), float(tilts[k]),
            lr_shape,
        )
        fp = workdir / f"depth_{k}.tif"
        plan.bytes_written += write_geotiff(
            fp, lr, west=g["west"], north=g["north"], res=lr_res, epsg=g["epsg"],
            nodata=g["nodata"],
        )
        plan.scenarios.append(Scenario(area, lr, fp, float(offsets[k]), float(tilts[k])))
    plan.order = rng.permutation(n)
    among = int(mix.get("judged_among", n))
    plan.judged = {int(i) for i in rng.choice(among, size=min(int(mix["judged"]), among), replace=False)}
    return plan
