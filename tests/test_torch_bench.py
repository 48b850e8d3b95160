"""``bench_torch.py`` against ``bench.py`` and the port's ``run_scene``, on the CPU.

The scene ``bench_torch`` writes is ``bench.py``'s bit for bit; the device
pipeline it times is the executor ``EngineTorch.run_scene`` runs, on the same
inputs the same bits, over the window count of the JAX package's grid; a
whole ``run`` at a small shape (the test artifact, ``device="cpu"``) returns
every key of the line; without CUDA ``main`` runs nothing.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import bench_torch as bt
from floodsr_tpu.io import from_origin as from_origin_jax
from floodsr_tpu.io import write_raster as write_raster_jax
from floodsr_tpu.tiling import build_window_grid as build_window_grid_jax
from floodsr_tpu.train.synth import box_mean, make_terrain, make_truth
from floodsr_tpu_torch.io import read_raster
from floodsr_tpu_torch.models.ResUNet_16x_DEM import ModelWorker

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
TEST_ARTIFACT = ROOT / "tests" / "data" / "_artifacts" / "model_infer_test.fsrz"
# 15 HR pixels an LR pixel, as the bench's 3840 / 256: the HR pixel is
# bench.py's HR_RES of 2 m.
SMALL_HR, SMALL_LR = (240, 240), (16, 16)
# The test artifact (scale 4, 32² HR tiles) sees a 64² crop here: 9 windows.
RUN_HR, RUN_LR = (256, 256), (16, 16)


def _bench_py_stream_scene(root: Path, k: int) -> dict:
    """``bench.py``'s stream scene ``k`` (its ``main``, :284-304), at its shapes."""
    seed = 30260816 + k
    dem_k = make_terrain(bench.HR_SHAPE, seed=seed).astype(np.float32)
    lr_k = box_mean(make_truth(dem_k, seed=seed), bench.HR_SHAPE[0] // bench.LR_SHAPE[0])
    x0, y0 = 500000.0, 4000000.0

    def prof(arr, res, top):
        return {
            "height": arr.shape[0], "width": arr.shape[1], "count": 1, "dtype": "float32",
            "crs": bench.CRS, "transform": from_origin_jax(x0, top, res, res),
            "nodata": -9999.0, "compress": "LZW",
        }

    lr_fp, dem_fp = root / f"stream_lr_{k}.tif", root / f"stream_dem_{k}.tif"
    write_raster_jax(lr_fp, lr_k, prof(lr_k, bench.LR_RES, y0 + bench.LR_SHAPE[0] * bench.LR_RES))
    write_raster_jax(dem_fp, dem_k, prof(dem_k, bench.HR_RES, y0 + bench.HR_SHAPE[0] * bench.HR_RES))
    return {"lr": lr_fp, "dem": dem_fp}


@pytest.mark.parametrize("which", ["scene", "stream_1"])
def test_scene_is_bench_py_scene_bit_for_bit(which, tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "HR_SHAPE", SMALL_HR)
    monkeypatch.setattr(bench, "LR_SHAPE", SMALL_LR)
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    if which == "scene":
        want = bench._make_scene(tmp_path / "jax")
        got = bt.write_scene(
            tmp_path / "torch", bt.SCENE_SEED, SMALL_HR, SMALL_LR,
            "lowres030.tif", "hires002_dem.tif",
        )
    else:
        want = _bench_py_stream_scene(tmp_path / "jax", 1)
        got = bt.write_scene(
            tmp_path / "torch", bt.STREAM_SEED + 1, SMALL_HR, SMALL_LR,
            "stream_lr_1.tif", "stream_dem_1.tif",
        )
    for key in ("lr", "dem"):
        a, prof_a, _ = read_raster(got[key])
        b, prof_b, _ = read_raster(want[key])
        assert a.dtype == b.dtype and np.array_equal(a, b), key
        assert prof_a == prof_b, key
        assert got[key].read_bytes() == want[key].read_bytes(), key


@pytest.mark.parametrize("window_method", ["feather", "hard"])
def test_pipeline_executor_is_run_scenes_executor(window_method, tmp_path, monkeypatch):
    scene = bt.write_scene(tmp_path, bt.SCENE_SEED, RUN_HR, RUN_LR, "lr.tif", "dem.tif")
    with ModelWorker(model_fp=TEST_ARTIFACT, device="cpu") as worker:
        worker.run(depth_lr_fp=scene["lr"], dem_hr_fp=scene["dem"],
                   output_fp=tmp_path / "pred.tif", window_method=window_method)
        engine = worker.engine
        args = dict(engine.last_scene_args)
        cfg = engine.scene_config(args["tile_lr"])
        executor, idx, depth_dev, dem_dev, n_windows = bt.pipeline_inputs(engine, scene["lr"])
        out_bench, stats_bench = executor(depth_dev, dem_dev, idx)

        # run_scene on the same inputs, its executor's output caught.
        caught = {}
        build = engine.scene_executor

        def spy(*a, **kw):
            ex, idx_, content, n = build(*a, **kw)

            def call(d, m, i):
                caught["out"], caught["stats"] = ex(d, m, i)
                return caught["out"], caught["stats"]

            return call, idx_, content, n

        monkeypatch.setattr(engine, "scene_executor", spy)
        crop = args["crop_shape"]
        depth = read_raster(scene["lr"])[0]
        dem = np.random.default_rng(0).normal(300, 20, crop).astype(np.float32)
        engine.run_scene(depth, dem, **args)

    assert torch.equal(caught["out"], out_bench)
    assert torch.equal(caught["stats"], stats_bench)
    # The JAX package's window grid over the tile-padded crop.
    content = [-(-c // cfg.hr_tile) * cfg.hr_tile for c in crop]
    assert n_windows == len(build_window_grid_jax(*content, cfg.hr_tile, args["stride_hr"])["y0"])
    assert (args["overlap_hr"] == 0) == (window_method == "hard")


# The keys the bench's line carries (bench.py:393-475, less the requalify
# probe and the TPU's bf16 note; plus the card and bf16's measured RMSE).
TENTPOLE_KEYS = {
    "bench_schema", "metric", "value", "unit", "vs_baseline", "windows_per_s",
    "vs_baseline_output_rate", "e2e_mps", "e2e_vs_baseline", "e2e_mps_zstd",
    "e2e_mps_none", "e2e_mps_pack12_zstd", "e2e_mps_pack12_lzw",
    "pack12_rmse_vs_uint16_m", "stream_mps", "stream_scenes", "e2e_scene_timings",
    "parity_gate", "hard_window_mps", "hard_windows_per_s", "hard_window_vs_baseline",
    "hard_window_vs_baseline_output_rate", "bf16_mps", "bf16_windows_per_s",
    "bf16_vs_baseline", "bf16_parity_gate", "bf16_rmse_vs_f32_m", "device",
}


def test_run_at_a_small_shape_returns_every_key(tmp_path, monkeypatch):
    monkeypatch.setenv("FLOODSR_BENCH_REPEATS", "2")
    monkeypatch.setenv("FLOODSR_BENCH_STREAM_SCENES", "2")
    monkeypatch.setenv("FLOODSR_BENCH_PARITY", "0")
    committed = {fp: fp.read_bytes() for fp in ROOT.glob("PARITY_r*.json")}
    payload = bt.run("cpu", RUN_HR, RUN_LR, TEST_ARTIFACT, tmp_path)
    assert TENTPOLE_KEYS <= set(bt.PAYLOAD_KEYS)
    assert set(payload) == set(bt.PAYLOAD_KEYS)
    json.dumps(payload)
    assert payload["device"] == {"name": "cpu", "power_limit": None}
    assert payload["parity_gate"] == {"pass": None, "skipped": "disabled via FLOODSR_BENCH_PARITY=0"}
    assert payload["stream_scenes"] == 2
    for key in ("value", "e2e_mps", "stream_mps", "hard_window_mps", "bf16_mps", "windows_per_s"):
        assert payload[key] > 0, key
    # uint12 quantization (max_depth / 4095 / sqrt(12) ≈ 3.5e-4 m at most)
    assert 0 <= payload["pack12_rmse_vs_uint16_m"] <= 1e-3
    assert isinstance(payload["bf16_parity_gate"], bool)
    # The bench writes no parity record into the repository.
    assert {fp: fp.read_bytes() for fp in ROOT.glob("PARITY_r*.json")} == committed


@pytest.mark.parametrize("argv", [[], ["--device", "cpu"]], ids=["default", "cpu"])
def test_main_runs_nothing_without_cuda(argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bt, "run", lambda *a, **kw: pytest.fail("the bench ran"))
    assert bt.main(argv) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "nothing was run" in captured.err
