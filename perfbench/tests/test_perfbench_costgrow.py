"""The ``costgrow`` configuration on the CPU at a small size (a 16x16 WSE over
a 240x240 DEM, downscale 15): the program's CostGrow against the plain
reference (``reference/costgrow.py``), the reference's solves against the
program's sequential-Dijkstra twin, the cell ``costgrow-cycles`` through
``run.run_cell``, and its per-layer readers on records made here."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.harness import spec, traffic
from perfbench.reference import costgrow as ref

CELL = "costgrow-cycles"
SEEDS = (2**33 + 5, 3 * 10**9 + 17, 2**31 + 77)
READERS = ("read_ms.costgrow", "resample_ms.costgrow", "solve_ms.costgrow",
           "write_ms.costgrow", "device_idle_pct.costgrow", "relax_roofline.costgrow")


def _small(mix: dict) -> dict:
    return dict(mix, lr_shape=[16, 16], hr_shape=[240, 240], judged_among=4, warmup_calls=1)


def _plan(seed: int, tmp_path: Path):
    entry, cfg, mix = spec.cell(CELL)
    family = spec.family(cfg)
    plan = traffic.build(_small(mix), seed, tmp_path, lambda *a: family.lr_raster(cfg, *a))
    return cfg, family, plan


def _reference_kw(cfg, plan):
    g = plan.geometry
    return dict(lr_res=g["lr_res"], hr_res=g["hr_res"], west=g["west"], north=g["north"],
                nodata=g["nodata"], params=cfg["parameters"], device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_the_program_agrees_with_the_reference(seed, tmp_path):
    """The worker on ``device="cpu"``, on every fourth scenario of the seed:
    the same wet cells, the same WSE within 1e-5 m."""
    from floodsr_tpu_torch.tohr import tohr
    from perfbench.reference.tiff import read_geotiff

    cfg, family, plan = _plan(seed, tmp_path)
    params = family.artifact(cfg, tmp_path, "cpu")
    for k in range(0, len(plan.scenarios), 4):
        sc = plan.scenarios[k]
        out_fp = tmp_path / f"out{k}.tif"
        tohr(model_version=cfg["model_version"], model_fp=params, depth_lr_fp=sc.lr_path,
             dem_hr_fp=plan.areas[sc.area].dem_path, output_fp=out_fp, device="cpu")
        out, _ = read_geotiff(out_fp)
        out = np.where(out == np.float32(plan.geometry["nodata"]), np.nan, out)
        expected = family.reference(cfg, plan, k, "cpu")
        gaps = family.compare(out, expected)
        assert gaps["wet_mismatch"] == 0.0 and gaps["max_abs_m"] <= 1e-5, (k, gaps)
        assert np.isfinite(expected).sum() > 1000


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_the_reference_solves_equal_dijkstra(seed, tmp_path):
    """The reference's three solves on a scenario's own inputs against the
    program's sequential Dijkstra (``mcp_fill_numpy``, float64 sums): the
    same reachable cells, distances within rtol 1e-4."""
    from floodsr_tpu_torch.ops.costgrow import mcp_fill_numpy

    cfg, family, plan = _plan(seed, tmp_path)
    g, sc = plan.geometry, plan.scenarios[3]
    dem = torch.from_numpy(plan.areas[sc.area].dem)
    domain = torch.isfinite(dem)
    wse, nearest = ref.resample(sc.lr, g["nodata"], dem.shape, g["lr_res"], g["hr_res"],
                                g["west"], g["north"], "cpu")
    wse = torch.where(nearest & domain, wse, torch.nan)
    anchors = wse > dem
    ones = torch.ones_like(dem)
    neutral, _, _ = ref.fill(wse, torch.isfinite(wse), ones, domain)
    delta = neutral - dem
    cost = torch.where(delta > 0, 1.0, 1.0 + delta.abs())
    solves = {
        "neutral_fill": (wse, torch.isfinite(wse), ones),
        "anchor_distance": (torch.zeros_like(dem), anchors, ones),
        "penalized_fill": (torch.where(anchors, wse, torch.nan), anchors, cost),
    }
    for name, (values, seeds, c) in solves.items():
        _, dist, sweeps = ref.least_cost(values, seeds, c, domain)
        _, expected = mcp_fill_numpy(values.numpy(), seeds.numpy(), c.numpy(), domain.numpy())
        dist = dist.numpy()
        assert sweeps > 10, name
        assert (np.isfinite(dist) == np.isfinite(expected)).all(), name
        finite = np.isfinite(dist)
        np.testing.assert_allclose(dist[finite], expected[finite], rtol=1e-4, err_msg=name)


def test_the_cell_runs_through_run_cell(monkeypatch):
    """The real cell, family and judge on the CPU at the small size: correct,
    with ``hr_mps`` and ``setup_s``; no reader of the ResUNet consulted."""
    entry, cfg, mix = spec.cell(CELL)
    consulted = []
    reader = spec.metric_reader
    monkeypatch.setattr(spec, "metric_reader", lambda name: consulted.append(name) or reader(name))
    result = run.run_cell(entry, cfg, _small(mix), run.limits_of(CELL), seed=SEEDS[1],
                          seconds=1.0, trace=False, device="cpu")
    assert result["correct"], json.dumps(result["checks"])
    assert result["failed"] == 0 and result["checks"]["judged"]["value"] >= 1
    assert {k: v["value"] for k, v in result["checks"].items()
            if k not in ("judged", "failed")} == {
        "wet_mismatch": 0.0, "moved_share": 0.0, "rmse_m": 0.0, "georef": 0}
    assert result["metrics"]["hr_mps"]["value"] > 0 and result["metrics"]["setup_s"]["value"] > 0
    assert sorted(consulted) == ["hr_mps", "setup_s"]


def _result(spans=None, counters=None):
    """A job's answer: with a record of ``spans`` (name, parent, ms from, ms
    to), or the parent commit's (no ``scene_timings``)."""
    if spans is None:
        return {"ok": True, "solves": {}}
    ns = [[n, p, int(a * 1e6), int(b * 1e6)] for n, p, a, b in spans]
    return {"ok": True, "scene_timings": {"runtime_s": 1.0, "trace": {
        "request": 1, "spans": ns, "counters": counters or {}}}}


RECORD = [("service.job", -1, 0, 100), ("worker.run", 0, 1, 99), ("read", 1, 1, 5),
          ("read.wse", 2, 1, 2), ("read.dem", 2, 2, 5), ("costgrow.resample", 1, 5, 45),
          ("costgrow.phases", 1, 45, 80), ("solve.neutral_fill", 6, 46, 56),
          ("solve.anchor_distance", 6, 56, 62), ("solve.penalized_fill", 6, 62, 74),
          ("solve.components", 6, 74, 77), ("worker.write", 1, 80, 99)]


def _run(*results, trace=None, hr_shape=(240, 240)):
    return SimpleNamespace(jobs=[(None, r) for r in results], trace=trace,
                           cfg=spec.config("costgrow"), geometry={"hr_shape": hr_shape})


def _read(name, run_):
    return spec.metric_reader(name).read(run_)


def test_the_span_readers_read_their_spans():
    other = [list(s) for s in RECORD]
    other[5] = ("costgrow.resample", 1, 5, 25)
    r = _run(_result(RECORD), _result(other))
    assert _read("read_ms.costgrow", r) == pytest.approx(4.0)
    assert _read("resample_ms.costgrow", r) == pytest.approx((40.0 + 20.0) / 2)
    assert _read("solve_ms.costgrow", r) == pytest.approx(10 + 6 + 12 + 3)
    assert _read("write_ms.costgrow", r) == pytest.approx(19.0)


def test_no_record_reads_nothing():
    """The parent commit's CostGrow answers carry no record: every new reader
    gives None and raises nothing (the idle share reads the trace alone)."""
    idle_trace = {"busy_s": 1.0, "window_us": 4e6, "device_s_by_name": {"gemm": 1.0}}
    for name in READERS:
        for r in (_run(_result()), _run(), _run(_result(), trace=idle_trace)):
            if name == "device_idle_pct.costgrow" and r.trace:
                continue
            assert _read(name, r) is None, name
    assert _read("device_idle_pct.costgrow", _run(_result(), trace=idle_trace)) == pytest.approx(75.0)


def test_the_relax_roofline_counts_twenty_bytes_a_cell_a_launch():
    """Synthetic trace: 3,000 launches over 3840x3840 against 0.5 s of
    ``relax_step_kernel``; other kernels do not count."""
    trace = {"busy_s": 2.0, "window_us": 10e6, "device_s_by_name": {
        "(anonymous namespace)::relax_step_kernel(float const*, float const*, float const*, "
        "float*, float*, int, int, float, float)": 0.5, "void at::native::gemm": 1.0}}
    jobs = [_result(RECORD, {"k3_launches": 1000.0}), _result(RECORD, {"k3_launches": 2000.0})]
    got = _read("relax_roofline.costgrow", _run(*jobs, trace=trace, hr_shape=(3840, 3840)))
    assert got == pytest.approx(100.0 * 3000 * 3840 * 3840 * 20 / 3.35e12 / 0.5)
    family = spec.family(spec.config("costgrow"))
    assert family.relax_bytes_per_launch((3840, 3840)) == 3840 * 3840 * 20
    # a job without the counter (the parent's), or no K3 in the trace: nothing
    assert _read("relax_roofline.costgrow", _run(jobs[0], _result(), trace=trace)) is None
    bare = dict(trace, device_s_by_name={"void at::native::gemm": 1.0})
    assert _read("relax_roofline.costgrow", _run(*jobs, trace=bare)) is None


def test_the_cell_and_its_metrics_are_in_the_benchmark():
    bench = spec.benchmark()
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("costgrow", "wse_cycles", 1)
    (cfg,) = [c for c in bench["configs"] if c["name"] == "costgrow"]
    assert cfg["reduced"] == [] and spec.config("costgrow")["family"] == "costgrow"
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["workloads"] == [CELL] and m["moves"] == "hr_mps", name
    assert per_layer["relax_roofline.costgrow"]["source"] == "device_trace"
    assert {m["name"] for m in spec.metrics_of(CELL, "per_layer")} == set(READERS)
    assert {m["name"] for m in spec.metrics_of(CELL, "end_to_end")} == {"hr_mps", "setup_s"}


def test_the_controls_at_the_small_size(tmp_path):
    """At 240x240 the growth radius (60 px) is a quarter of the grid and every
    distance stays under 256: the bfloat16 control fails the cell's limits on
    2 of the seed's 16 scenarios. The output reads only distances within the
    growth radius, which settle early: stopped at half or a quarter of its
    sweeps each solve gives the converged output, at a tenth it does not."""
    cfg, family, plan = _plan(SEEDS[0], tmp_path)
    limits = run.limits_of(CELL)

    def fails(gaps):
        return any(gaps[k] > limits[k] for k in family.CHECKED)

    full = [family.reference(cfg, plan, k, "cpu") for k in range(len(plan.scenarios))]
    bf16 = [fails(family.compare(family.reference(cfg, plan, k, "cpu", "bf16_distances"), f))
            for k, f in enumerate(full)]
    assert sum(bf16) == 2
    kw = _reference_kw(cfg, plan)
    sc = plan.scenarios[0]
    for share, differs in ((0.5, False), (0.25, False), (0.1, True)):
        out = ref.costgrow(sc.lr, plan.areas[sc.area].dem, sweep_share=share, **kw)
        assert fails(family.compare(out, full[0])) is differs, share
        assert (np.isfinite(out) == np.isfinite(full[0])).all() is not differs, share


@pytest.mark.cuda
def test_the_bf16_control_fails_at_the_cells_size():
    """The reference with its distances accumulated in bfloat16 in the
    program's place, at the cell's own size, on three seeds: not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    entry, cfg, mix = spec.cell(CELL)
    for seed in (2**31 + 404, 2**31 + 505, 2**31 + 606):
        result = run.run_cell(entry, cfg, mix, run.limits_of(CELL), seed=seed, seconds=2.0,
                              trace=False, device="cuda", control="bf16_distances")
        assert not result["correct"], json.dumps(result["checks"])
