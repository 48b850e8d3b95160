"""The CostGrow workers' spans and counters (``floodsr_tpu_torch/tracing.py``).

A CostGrow job through ``TohrService.handle_tohr`` on the CPU: its answer
carries the request's record as ``scene_timings["trace"]``, with the read, the
resample, each solve and the write as spans under ``worker.run``, covering
it; each least-cost solve's span carries its relaxations, host checks and K3
launches. The CPU launches no kernel, so the tests count a launch per call of
the wrapper, as the card's does for up to 8 relaxations: one a check block.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import floodsr_tpu_torch.ops.costgrow as cg
from floodsr_tpu_torch import tracing
from floodsr_tpu_torch.io import from_origin, write_raster
from floodsr_tpu_torch.models.CostGrow import _costgrow_phases
from floodsr_tpu_torch.ops.kernels import relax_step as k3
from floodsr_tpu_torch.serve import TohrService
from floodsr_tpu_torch.tohr import tohr

pytestmark = pytest.mark.unit

NODATA = -9999.0
LEAST_COST = ("solve.neutral_fill", "solve.anchor_distance", "solve.penalized_fill")
SPANS = ("worker.run", "read", "read.wse", "read.dem", "costgrow.resample",
         "costgrow.phases", *LEAST_COST, "solve.components", "worker.write")
PARENTS = {"read": "worker.run", "read.wse": "read", "read.dem": "read",
           "costgrow.resample": "worker.run", "costgrow.phases": "worker.run",
           "solve.components": "costgrow.phases", "worker.write": "worker.run",
           **{name: "costgrow.phases" for name in LEAST_COST}}


def _scene(root, seed):
    """A 16x16 WSE at 30 m over a 240x240 DEM at 2 m (downscale 15): a tilted
    valley, the WSE its LR mean plus a depth where wet, nodata where dry."""
    rng = np.random.default_rng(seed)
    hr, lr = 240, 16
    yy, xx = np.mgrid[0:hr, 0:hr].astype(np.float32)
    dem = (250.0 + 0.05 * yy + 4.0 * np.abs(xx - hr / 2) / hr * 8
           + np.cumsum(rng.normal(0, 0.1, (hr, hr)), axis=1)).astype(np.float32)
    ground = dem.reshape(lr, 15, lr, 15).mean(axis=(1, 3))
    depth = rng.uniform(-1.0, 2.5, (lr, lr)).astype(np.float32)
    wse = np.where(depth > 0, ground + depth, NODATA).astype(np.float32)

    def profile(shape, res):
        return {"height": shape[0], "width": shape[1], "count": 1, "dtype": "float32",
                "crs": "EPSG:32633", "nodata": NODATA, "compress": "LZW",
                "transform": from_origin(500000.0, 4000480.0, res, res)}

    write_raster(root / "dem.tif", dem, profile((hr, hr), 2.0))
    write_raster(root / "wse.tif", wse, profile((lr, lr), 30.0))
    return root / "dem.tif", root / "wse.tif"


#: relaxations between two checks: the workers' default, one launch on the card
BLOCK = 8


@pytest.fixture(scope="module")
def counted_launches():
    """Count one K3 launch per call of the wrapper on the CPU."""
    real = cg.relax_step

    def step(*args):
        k3.launches += 1
        return real(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cg, "relax_step", step)
        yield


@pytest.fixture(scope="module")
def served(tmp_path_factory, counted_launches):
    """One job of each CostGrow worker through the service, and one outside it."""
    tmp = tmp_path_factory.mktemp("costgrow_tracing")
    dem, wse = _scene(tmp, 11)
    out = {}
    for version in ("CostGrow", "CostGrow_pcraster"):
        params = tmp / f"{version}.json"
        params.write_text(json.dumps({"model_version": version}))
        service = TohrService(model_version=version, model_fp=params, device="cpu")
        service.start()
        try:
            out[version] = service.handle_tohr(
                {"in": str(wse), "dem": str(dem), "out": str(tmp / f"{version}.tif")})
        finally:
            service.close()
    out["bare"] = tohr(model_version="CostGrow", model_fp=tmp / "CostGrow.json",
                       depth_lr_fp=wse, dem_hr_fp=dem, output_fp=tmp / "bare.tif",
                       device="cpu")
    out["files"] = {k: (tmp / f"{k}.tif").read_bytes() for k in ("CostGrow", "bare")}
    return out


def _spans(result):
    return result["scene_timings"]["trace"]["spans"]


def _seconds(span):
    return (span[3] - span[2]) * 1e-9


def test_a_costgrow_job_carries_every_span_under_its_parent(served):
    spans = _spans(served["CostGrow"])
    names = [s[0] for s in spans]
    for name in SPANS:
        assert names.count(name) == 1, name
    for name, parent in PARENTS.items():
        s = spans[names.index(name)]
        assert spans[s[1]][0] == parent, name
    assert spans[names.index("worker.run")][1] == names.index("service.job")


@pytest.mark.parametrize("version", ["CostGrow", "CostGrow_pcraster", "bare"])
def test_children_of_worker_run_cover_it(served, version):
    result = served[version]
    spans = _spans(result)
    root = next(i for i, s in enumerate(spans) if s[0] == "worker.run")
    children = sum(_seconds(s) for s in spans if s[1] == root)
    assert children >= 0.95 * _seconds(spans[root])
    assert result["runtime_s"] == pytest.approx(_seconds(spans[root]), abs=1e-9)
    assert result["scene_timings"]["runtime_s"] == result["runtime_s"]


def test_scene_timings_are_the_spans(served):
    timings = served["CostGrow"]["scene_timings"]
    spans = _spans(served["CostGrow"])
    for key, name in (("read_s", "read"), ("resample_s", "costgrow.resample"),
                      ("phases_s", "costgrow.phases"), ("write_s", "worker.write")):
        (s,) = [s for s in spans if s[0] == name]
        assert timings[key] == pytest.approx(_seconds(s), abs=1e-9), key


@pytest.mark.parametrize("version", ["CostGrow", "CostGrow_pcraster"])
def test_the_counters_are_the_solves_counts(served, version):
    result = served[version]
    counters = result["scene_timings"]["trace"]["counters"]
    solves = result["solves"]
    relaxations = sum(s["relaxations"] for s in solves.values())
    assert relaxations > 0
    assert counters["relaxations"] == relaxations
    assert counters["checks"] == sum(s["checks"] for s in solves.values())
    # a launch per check block: the counter is the launches made inside the solves
    assert counters["k3_launches"] == relaxations // BLOCK
    assert relaxations % BLOCK == 0


def test_each_least_cost_solve_span_carries_its_own_counts(served, counted_launches):
    """``_costgrow_phases`` in a request of the test's own: per span, the
    relaxations, checks and launches of that solve alone."""
    import torch

    rng = np.random.default_rng(5)
    dem = torch.from_numpy(np.cumsum(rng.normal(0, 0.2, (48, 48)), axis=1).astype(np.float32))
    wse = torch.where(torch.rand(48, 48, generator=torch.Generator().manual_seed(5)) < 0.3,
                      dem + 0.5, torch.nan)
    solves = {}
    with tracing.request() as trace, tracing.span("root"):
        _costgrow_phases(wse, dem, torch.ones_like(dem, dtype=torch.bool),
                         max_grow_fine_pixels=6.0, terrain_penalty_scale=1.0,
                         decay_per_pixel=0.0, solves=solves)
    by_name = {s.name: s for s in trace.spans}
    for name in LEAST_COST:
        stats, span = solves[name.split(".", 1)[1]], by_name[name]
        assert span.counters == {"relaxations": stats["relaxations"], "checks": stats["checks"],
                                 "k3_launches": stats["relaxations"] // BLOCK}, name
        assert stats["k3_launches"] == stats["checks"] - 1 > 0, name
    assert by_name["solve.components"].counters is None


def test_no_span_is_opened_per_relaxation(served):
    spans = _spans(served["CostGrow"])
    assert served["CostGrow"]["scene_timings"]["trace"]["counters"]["relaxations"] > len(spans)
    assert len(spans) < 20


def test_the_served_raster_is_the_libraries(served):
    """The spans change nothing the worker writes: the service's file and a
    bare ``tohr``'s are the same bytes."""
    assert served["files"]["CostGrow"] == served["files"]["bare"]
    for name, stats in served["CostGrow"]["solves"].items():
        bare = served["bare"]["solves"][name]
        assert (stats["relaxations"], stats["checks"]) == (bare["relaxations"], bare["checks"])


def test_the_resample_span_counts_two_separable_warps(tmp_path):
    """Phase 01 between the scene's axis-aligned grids: the WSE warp and the
    validity mask each from the 1-D sample plan, none from full grids."""
    dem, wse = _scene(tmp_path, 11)
    params = tmp_path / "CostGrow.json"
    params.write_text(json.dumps({"model_version": "CostGrow"}))
    with tracing.request() as trace, tracing.span("root"):
        tohr(model_version="CostGrow", model_fp=params, depth_lr_fp=wse, dem_hr_fp=dem,
             output_fp=tmp_path / "out.tif", device="cpu")
    (resample,) = [s for s in trace.spans if s.name == "costgrow.resample"]
    assert resample.counters == {"resample.separable": 2.0}
