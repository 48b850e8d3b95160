"""A second model family through the same run: a fixture family, defined here,
serves the program's ``CostGrow`` (WSE downscaling by least-cost growth, no
weights) through ``run.run_cell``, on the CPU at a 16x16 WSE over a 240x240
DEM. Nothing of the ResUNet is consulted or loaded: none of its metric
readers, its reference network, its weights or its work counts.

``FAMILY`` and ``CONFIG`` are importable, so that the same run can be made on
the card at a mix's own geometry:

    run.run_cell(entry, CONFIG, mix, {}, seed=..., seconds=30, trace=True, device="cuda")
    (with ``spec.family`` answering ``FAMILY``)
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from perfbench import run
from perfbench.harness import spec
from perfbench.harness.synth import depth_lr
from perfbench.reference.tiff import read_geotiff

SEED = 2**35 + 19
NODATA = -9999.0  # the mixes' nodata
CELL = "costgrow-fixture"

#: What a CostGrow configuration would state: the model, its parameter file's
#: keys (``floodsr_tpu_torch/models/CostGrow.py``), the depth range of the draw.
CONFIG = {
    "name": "costgrow_fixture",
    "family": "costgrow_fixture",
    "model_version": "CostGrow",
    "parameters": {"max_grow_coarse_pixels": 4, "terrain_penalty_scale": 1.0,
                   "decay_per_meter": 0.0, "output_kind": "wse"},
    "max_depth": 5.0,
}

#: The ResUNet's modules, which a run of this family must not load.
RESUNET_MODULES = ("perfbench.reference.model", "perfbench.reference.pipeline",
                   "perfbench.reference.artifact", "perfbench.harness.weights",
                   "perfbench.harness.work")


def _artifact(cfg: dict, workdir: Path, device) -> Path:
    """The parameter JSON the worker reads as its model file."""
    fp = workdir / "costgrow.json"
    fp.write_text(json.dumps({"model_version": cfg["model_version"], **cfg["parameters"]}))
    return fp


def _lr_raster(cfg: dict, dem: np.ndarray, base_m: float, offset_m: float, tilt_m: float,
               lr_shape) -> np.ndarray:
    """The LR water surface: the terrain's LR mean plus the drawn depth where
    wet, nodata where dry."""
    depth = depth_lr(dem, base_m, offset_m, tilt_m, lr_shape, float(cfg["max_depth"]))
    kh, kw = dem.shape[0] // lr_shape[0], dem.shape[1] // lr_shape[1]
    ground = dem.reshape(lr_shape[0], kh, lr_shape[1], kw).mean(axis=(1, 3))
    return np.where(depth > 0, ground + depth, NODATA).astype(np.float32)


def _judge(cfg: dict, plan, done: list, limits: dict, device: str, control: bool) -> dict:
    """Every output present; the judged ones on the mix's grid, finite, some wet."""
    # Else the last job completed: no later job has written over its output.
    judged = [(j, r) for j, r in done if j.judged] or done[-1:]
    g = plan.geometry
    bad = {"missing": sum(not j.out_path.is_file() for j, _ in done), "georef": 0,
           "not_finite": 0}
    for job, _ in judged:
        out, prof = read_geotiff(job.out_path)
        if (prof["height"], prof["width"]) != tuple(g["hr_shape"]) or any(
            abs(prof[k] - g[v]) > 1e-6
            for k, v in (("west", "west"), ("north", "north"), ("res_x", "hr_res"), ("res_y", "hr_res"))
        ):
            bad["georef"] += 1
        bad["not_finite"] += int(not np.isfinite(out).all() or not (out != NODATA).any())
    return {"judged": {"value": len(judged), "limit": 1},
            **{k: {"value": v, "limit": 0} for k, v in bad.items()}}


FAMILY = SimpleNamespace(
    artifact=_artifact,
    service_options=lambda cfg: {},
    warmup_shapes=lambda cfg, plan: [],
    lr_raster=_lr_raster,
    per_job=lambda cfg, plan: {"arch": None, "windows_per_job": None},
    judge=_judge,
)


class _Refuse:
    """An import finder that refuses the ResUNet's modules."""

    def find_spec(self, name, path=None, target=None):
        if name in RESUNET_MODULES:
            raise ImportError(f"{name} loaded by a run of another family")
        return None


def _forget_resunet_modules(monkeypatch) -> None:
    """Unload the ResUNet's modules for the test and refuse them again."""
    for name in RESUNET_MODULES:
        parent, _, leaf = name.rpartition(".")
        monkeypatch.delitem(sys.modules, name, raising=False)
        monkeypatch.delattr(sys.modules[parent], leaf, raising=False)
    monkeypatch.setattr(sys, "meta_path", [_Refuse(), *sys.meta_path])


def test_a_second_family_runs_through_the_same_cell(monkeypatch):
    bench = copy.deepcopy(spec.benchmark())
    for m in bench["end_to_end"]:
        if m["name"] == "hr_mps":
            m["workloads"].append(CELL)
    monkeypatch.setattr(spec, "benchmark", lambda: bench)
    monkeypatch.setattr(spec, "family", lambda cfg: FAMILY)
    consulted = []
    reader = spec.metric_reader
    monkeypatch.setattr(spec, "metric_reader", lambda name: consulted.append(name) or reader(name))
    _forget_resunet_modules(monkeypatch)

    mix = dict(spec.traffic("resident"), lr_shape=[16, 16], hr_shape=[240, 240],
               judged_among=4, warmup_calls=1)
    entry = {"name": CELL, "config": CONFIG["name"], "traffic": "resident", "chips": 1}
    result = run.run_cell(entry, CONFIG, mix, {}, seed=SEED, seconds=1.0, trace=False,
                          device="cpu")

    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["metrics"]["hr_mps"]["value"] > 0
    assert sorted(consulted) == ["hr_mps", "setup_s"]
    assert not set(RESUNET_MODULES) & set(sys.modules)
