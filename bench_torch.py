#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: SR megapixels per second per GPU on
the rss_mersch_A-shaped 16× tohr.

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 bench_torch.py [--device cuda]

Prints ONE JSON line on stdout (progress and every repeat on stderr), with
the keys of ``bench.py``'s line, so the two read side by side:
``{"metric": ..., "value": N, "unit": "MP/s", "vs_baseline": N, ...}`` plus
``"device": {"name", "power_limit"}`` as ``nvidia-smi`` prints them. Exits
non-zero, running nothing, without CUDA; it never measures the CPU.

Workload, as ``bench.py``'s: a synthetic 256² LR @30 m → 3840² HR @2 m
scene (the flagship's training family, seed 20260816) through
``floodsr_tpu_torch``'s ``ResUNet_16x_DEM`` worker with the committed
flagship artifact (a seeded random init if the file is absent): GeoTIFF read
→ align → the scene on the device → feather mosaic → post-resample →
GeoTIFF write.

- ``value``: device-pipeline MP/s — the scene executor ``run_scene`` runs
  between its two synchronizes (normalize with K2, trunk, tail with K1,
  inverse, feathered mosaic, quantize), on inputs already on the device:
  one warm-up call, then the best of 5 groups of 16 queued calls, each group
  closed by one synchronize. MP/s = 14.7456 output MP / the per-call time.
- ``e2e_mps``: best of ``FLOODSR_BENCH_REPEATS`` (6) ``worker.run`` calls
  (read to written file); then the ``zstd``/``none`` output-compression
  sweep, the ``uint12`` download with ``zstd``/``lzw`` and its RMSE against
  the uint16 output, and a stream of ``FLOODSR_BENCH_STREAM_SCENES`` (5)
  scenes through ``worker.run_many`` (generation excluded).
- Secondaries: the hard-window scene's device pipeline and a ``bfloat16``
  worker's, with bf16's RMSE against the f32 output measured here; then the
  f32 output once more, which must equal the first bit for bit.
- ``parity_gate``: ``bin/parity_gate_torch.py`` as a child process, its
  result written to the bench's temporary directory.

Baseline: the original floodsr publishes ~24 windows/s of 512² windows on
CPU ONNX Runtime (its ``examples.ipynb`` cell 10; SURVEY.md §6), a CPU
figure. ``vs_baseline`` is windows/s over it on the same 121-window job;
``vs_baseline_output_rate`` the output MP/s over its 6.3 MP/s window-pixel
rate.

Switches (``bench.py``'s): ``FLOODSR_BENCH_REPEATS``, ``_MAX_BATCH``,
``_DTYPE``, ``_E2E_BUDGET_S``, ``_COMPRESS_SWEEP``, ``_PACK12``, ``_STREAM``,
``_STREAM_SCENES``, ``_HARD``, ``_HARD_BUDGET_S``, ``_BF16``,
``_BF16_BUDGET_S``, ``_PARITY``, ``_PARITY_BUDGET_S``, ``_DEBUG``. A
secondary they skip is printed on stderr; any failure fails the run.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

BASELINE_WINDOWS_PER_S = 24.0  # original floodsr, CPU ONNX Runtime, examples.ipynb cell 10
BASELINE_COMPUTE_MPS = 6.3  # = 24 win/s x 512^2 px (computed-window pixel rate)
BASELINE_E2E_MPS = 2.5      # original floodsr, CPU ONNX Runtime end-to-end estimate
LR_SHAPE = (256, 256)
LR_RES = 30.0
HR_SHAPE = (3840, 3840)
CRS = "EPSG:32633"
SCENE_SEED = 20260816   # held out of bin/train_flagship.py's training seeds
STREAM_SEED = 30260816  # stream scene k draws seed STREAM_SEED + k
GATE_RMSE_M = 1e-3
PIPELINE_GROUPS = 5
PIPELINE_CALLS = 16
FLAGSHIP = REPO / "tests" / "data" / "_artifacts" / "model_infer_flagship.fsrz"
#: Every key of the line when no switch skips a secondary: bench.py's, with
#: bf16's measured RMSE in place of its note, and the card.
PAYLOAD_KEYS = (
    "bench_schema", "metric", "value", "unit", "vs_baseline", "windows_per_s",
    "vs_baseline_output_rate", "e2e_mps", "e2e_vs_baseline", "device",
    "e2e_mps_zstd", "e2e_mps_none", "e2e_mps_pack12_zstd", "e2e_mps_pack12_lzw",
    "pack12_rmse_vs_uint16_m", "stream_mps", "stream_scenes", "e2e_scene_timings",
    "e2e_mps_excl_d2h_wait", "parity_gate", "hard_window_mps", "hard_windows_per_s",
    "hard_window_vs_baseline", "hard_window_vs_baseline_output_rate", "bf16_mps",
    "bf16_windows_per_s", "bf16_vs_baseline", "bf16_rmse_vs_f32_m", "bf16_parity_gate",
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def write_scene(
    root: Path, seed: int, hr_shape, lr_shape, lr_name: str, dem_name: str
) -> dict[str, Path]:
    """Write one scene's LR depth and HR DEM GeoTIFFs, as ``bench.py`` does.

    The HR pixel size gives both rasters one extent: 2 m at the bench's
    shapes, ``bench.py``'s ``HR_RES``.
    """
    from floodsr_tpu_torch.io import from_origin, write_raster
    from floodsr_tpu_torch.train.synth import box_mean, make_terrain, make_truth

    x0, y0 = 500000.0, 4000000.0
    hr_res = LR_RES * lr_shape[0] / hr_shape[0]
    dem = make_terrain(tuple(hr_shape), seed=seed).astype(np.float32)
    truth = make_truth(dem, seed=seed)
    depth_lr = box_mean(truth, hr_shape[0] // lr_shape[0])

    def profile(arr, res, top):
        return {
            "height": arr.shape[0],
            "width": arr.shape[1],
            "count": 1,
            "dtype": "float32",
            "crs": CRS,
            "transform": from_origin(x0, top, res, res),
            "nodata": -9999.0,
            "compress": "LZW",
        }

    lr_fp, dem_fp = root / lr_name, root / dem_name
    write_raster(lr_fp, depth_lr, profile(depth_lr, LR_RES, y0 + lr_shape[0] * LR_RES))
    write_raster(dem_fp, dem, profile(dem, hr_res, y0 + hr_shape[0] * hr_res))
    return {"lr": lr_fp, "dem": dem_fp}


def make_model(root: Path) -> Path:
    """The committed flagship artifact; a seeded random init of the flagship
    configuration when the file is absent."""
    if FLAGSHIP.exists():
        return FLAGSHIP
    from floodsr_tpu_torch.nn.checkpoint import save_artifact
    from floodsr_tpu_torch.nn.resunet import ResUNetConfig, init_resunet

    cfg = ResUNetConfig()
    params, state = init_resunet(SCENE_SEED, cfg)
    fp = root / "model_infer.fsrz"
    save_artifact(fp, cfg, params, state, {"seed": SCENE_SEED, "purpose": "bench"})
    return fp


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rmse_m(a_fp: Path, b_fp: Path) -> float:
    from floodsr_tpu_torch.io import read_raster

    a, b = read_raster(a_fp)[0], read_raster(b_fp)[0]
    return float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2)))


def pipeline_inputs(engine, lr_fp: Path):
    """The executor of the engine's last scene and its inputs on the device:
    ``(executor, idx, depth, dem, n_windows)``.

    The geometry is the one the worker gave ``run_scene`` last
    (``engine.last_scene_args``); the depth is the scene's LR raster, the
    DEM ``default_rng(0).normal(300, 20, crop)``, as ``bench.py`` measures.
    """
    from floodsr_tpu_torch.io import read_raster

    args = engine.last_scene_args
    if not args:
        raise RuntimeError("the engine has run no scene yet")
    executor, idx, content, n_windows = engine.scene_executor(**args)
    scale = engine.scene_config(args["tile_lr"]).scale
    crop = args["crop_shape"]
    depth = read_raster(lr_fp)[0]
    if depth.shape != (crop[0] // scale, crop[1] // scale):
        raise RuntimeError(f"LR depth {depth.shape} is not the crop {crop} / {scale}")
    dem = np.random.default_rng(0).normal(300, 20, crop).astype(np.float32)
    depth_dev = engine._put_padded(depth, (content[0] // scale, content[1] // scale))
    dem_dev = engine._put_padded(dem, content)
    return executor, idx, depth_dev, dem_dev, n_windows


def measure_pipeline(engine, lr_fp: Path, out_mp: float, label: str) -> tuple[float, float]:
    """Best-of-5 per-call time of the scene executor (16 queued calls a
    group, one synchronize a group): ``(MP/s, windows/s)``."""
    executor, idx, depth_dev, dem_dev, n_windows = pipeline_inputs(engine, lr_fp)
    executor(depth_dev, dem_dev, idx)
    _sync(engine.device)
    best = float("inf")
    for g in range(PIPELINE_GROUPS):
        t0 = time.perf_counter()
        for _ in range(PIPELINE_CALLS):
            executor(depth_dev, dem_dev, idx)
        _sync(engine.device)
        per_call = (time.perf_counter() - t0) / PIPELINE_CALLS
        best = min(best, per_call)
        log(f"# device pipeline {label} group {g}: {per_call * 1000:.2f} ms a call")
    mps, win_ps = out_mp / best, n_windows / best
    log(
        f"# device pipeline {label}: {mps:.1f} MP/s, {win_ps:.0f} windows/s "
        f"({best * 1000:.2f} ms/scene, {n_windows} windows, best of "
        f"{PIPELINE_GROUPS}x{PIPELINE_CALLS} queued)"
    )
    return mps, win_ps


def run_parity_gate(t_start: float, root: Path, device: str) -> dict:
    """``bin/parity_gate_torch.py`` as a child process; its result, or the
    reason a switch skipped it. A gate that writes no result fails the run."""
    budget_s = float(os.environ.get("FLOODSR_BENCH_PARITY_BUDGET_S", "2700"))
    if os.environ.get("FLOODSR_BENCH_PARITY", "1") != "1":
        reason = "disabled via FLOODSR_BENCH_PARITY=0"
    elif time.perf_counter() - t_start > budget_s:
        reason = f"bench wall already past {budget_s:.0f}s budget"
    else:
        out = root / "parity_gate_torch.json"
        proc = subprocess.run(
            [sys.executable, str(REPO / "bin" / "parity_gate_torch.py"),
             "--out", str(out), "--device", device],
            timeout=budget_s, capture_output=True, text=True,
        )
        log(proc.stderr[-2000:])
        if not out.exists():
            raise RuntimeError(
                f"parity gate wrote no result (exit code {proc.returncode}):\n"
                f"{proc.stderr[-3000:]}"
            )
        parity = json.loads(out.read_text())
        return {
            "pass": parity["pass"],
            "worst_rmse_m": max(
                (c["rmse_m"] for c in parity["cases"].values()), default=None
            ),
            "artifact": out.name,
        }
    log(f"# parity gate skipped: {reason}")
    return {"pass": None, "skipped": reason}


def run(device: str, hr_shape, lr_shape, model_fp: Path, root: Path) -> dict:
    """Every measurement of the bench on ``device``; returns the payload.

    ``main`` passes the bench's shapes and model; the CPU tests call this at
    a small shape with the test artifact and ``device="cpu"``.
    """
    from floodsr_tpu_torch.device import card_info
    from floodsr_tpu_torch.io import read_raster
    from floodsr_tpu_torch.model_registry import resolve_model_worker_class
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, route_counts

    max_batch = int(os.environ.get("FLOODSR_BENCH_MAX_BATCH", "8"))
    compute_dtype = os.environ.get("FLOODSR_BENCH_DTYPE", "float32")
    repeats = int(os.environ.get("FLOODSR_BENCH_REPEATS", "6"))
    e2e_budget_s = float(os.environ.get("FLOODSR_BENCH_E2E_BUDGET_S", "1500"))
    sweep_n = max(2, min(3, repeats - 1))
    card = card_info(device)
    log(f"# device {card['name']}, {card['power_limit']}")

    t_start = time.perf_counter()
    scene = write_scene(
        root, SCENE_SEED, hr_shape, lr_shape, "lowres030.tif", "hires002_dem.tif"
    )
    out_mp = hr_shape[0] * hr_shape[1] / 1e6
    worker_cls = resolve_model_worker_class("ResUNet_16x_DEM")

    def make_worker(**kw):
        kw = {"compute_dtype": compute_dtype, **kw}
        return worker_cls(model_fp=model_fp, max_batch=max_batch, device=device, **kw)

    def timed_runs(worker, n: int, prefix: str, **kw) -> float:
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            worker.run(
                depth_lr_fp=scene["lr"], dem_hr_fp=scene["dem"],
                output_fp=root / f"{prefix}_{i}.tif", window_method="feather", **kw,
            )
            times.append(time.perf_counter() - t0)
        return out_mp / min(times)

    # Workers are built and run on this thread, one at a time (cuDNN's plans
    # are per thread; each worker's device memory goes with it).
    with make_worker() as worker:
        times, best_scene_timings = [], None
        for i in range(repeats):
            reset_launch_counts()
            t0 = time.perf_counter()
            result = worker.run(
                depth_lr_fp=scene["lr"], dem_hr_fp=scene["dem"],
                output_fp=root / f"pred_{i}.tif", window_method="feather",
            )
            times.append(time.perf_counter() - t0)
            if times[-1] == min(times):
                best_scene_timings = result["scene_timings"]
            st = result["scene_timings"]
            log(
                f"# run {i}: {times[-1]:.3f}s ({out_mp / times[-1]:.2f} MP/s, "
                f"{result['preprocess']['tile_cache_size']} tiles, read {st['read_s']:.3f}s "
                f"exec {st['exec_s']:.3f}s finish {st['finish_s']:.3f}s, "
                f"launches {json.dumps(launch_counts())} routes {json.dumps(route_counts())})"
            )
            if i >= 1 and time.perf_counter() - t_start > e2e_budget_s:
                log(f"# stopping e2e repeats at {i + 1}/{repeats} (wall past {e2e_budget_s:.0f}s budget)")
                break
        best = min(times)
        e2e_mps = out_mp / best
        log(f"# e2e: {e2e_mps:.2f} MP/s (best of {len(times)})")

        # Output-compression sweep: only the host encode differs.
        e2e_by_compress: dict[str, float] = {}
        if os.environ.get("FLOODSR_BENCH_COMPRESS_SWEEP", "1") == "1":
            for codec in ("zstd", "none"):
                e2e_by_compress[codec] = timed_runs(
                    worker, sweep_n, f"pred_{codec}", output_compress=codec
                )
                log(f"# e2e --output-compress {codec}: {e2e_by_compress[codec]:.2f} MP/s (best of {sweep_n})")
        else:
            log("# skipping the output-compression sweep (env)")

        # A stream of scenes, each with its own DEM: the next DEM decodes and
        # uploads while the current scene computes (run_many's prefetch).
        stream_mps = None
        stream_n = int(os.environ.get("FLOODSR_BENCH_STREAM_SCENES", "5"))
        if stream_n > 1 and os.environ.get("FLOODSR_BENCH_STREAM", "1") == "1":
            jobs = []
            for k in range(stream_n):
                s = write_scene(
                    root, STREAM_SEED + k, hr_shape, lr_shape,
                    f"stream_lr_{k}.tif", f"stream_dem_{k}.tif",
                )
                jobs.append({
                    "depth_lr_fp": s["lr"], "dem_hr_fp": s["dem"],
                    "output_fp": root / f"stream_pred_{k}.tif",
                })
            t0 = time.perf_counter()
            worker.run_many(jobs, window_method="feather")
            stream_wall = time.perf_counter() - t0
            stream_mps = stream_n * out_mp / stream_wall
            log(f"# stream: {stream_mps:.2f} MP/s over {stream_n} scenes ({stream_wall:.2f}s wall)")
        else:
            log("# skipping the stream (env)")

        # The headline, read before any other worker exists: the f32 scene
        # executor of the feathered scene.
        pipe_f32, win_f32 = measure_pipeline(worker.engine, scene["lr"], out_mp, compute_dtype)

        pipe_hard = None
        hard_budget = float(os.environ.get("FLOODSR_BENCH_HARD_BUDGET_S", "1500"))
        if (
            os.environ.get("FLOODSR_BENCH_HARD", "1") == "1"
            and time.perf_counter() - t_start < hard_budget
        ):
            worker.run(
                depth_lr_fp=scene["lr"], dem_hr_fp=scene["dem"],
                output_fp=root / "pred_hard.tif", window_method="hard",
            )
            pipe_hard, win_hard = measure_pipeline(
                worker.engine, scene["lr"], out_mp, f"{compute_dtype}-hard"
            )
        else:
            log("# skipping hard-window secondary (budget/env)")

    # The uint12 download: the uint16 codes packed 2 pixels into 3 bytes on
    # the device; its quantization against the uint16 output of the scene.
    pack12_results: dict[str, float] = {}
    pack12_rmse = None
    if os.environ.get("FLOODSR_BENCH_PACK12", "1") == "1":
        with make_worker(output_transfer="uint12") as worker12:
            for codec in ("zstd", "lzw"):
                pack12_results[codec] = timed_runs(
                    worker12, sweep_n, f"pred12_{codec}", output_compress=codec
                )
                log(f"# e2e uint12 transfer + {codec}: {pack12_results[codec]:.2f} MP/s (best of {sweep_n})")
        pack12_rmse = rmse_m(root / "pred_0.tif", root / "pred12_lzw_0.tif")
        log(f"# uint12 vs uint16 output rmse: {pack12_rmse:.2e} m")
    else:
        log("# skipping the uint12 secondary (env)")

    # The bfloat16 policy on the same scene; then the f32 output once more,
    # which must not have moved (the bf16 stages restore the TF32 switches).
    pipe_bf16 = None
    bf16_budget = float(os.environ.get("FLOODSR_BENCH_BF16_BUDGET_S", "900"))
    if time.perf_counter() - t_start > bf16_budget:
        log("# skipping bf16 secondary (wall budget)")
    elif os.environ.get("FLOODSR_BENCH_BF16", "1") != "1" or compute_dtype != "float32":
        log("# skipping bf16 secondary (env)")
    else:
        with make_worker(compute_dtype="bfloat16") as bf16_worker:
            reset_launch_counts()
            t0 = time.perf_counter()
            bf16_worker.run(
                depth_lr_fp=scene["lr"], dem_hr_fp=scene["dem"],
                output_fp=root / "pred_bf16.tif", window_method="feather",
            )
            log(
                f"# run bfloat16: {time.perf_counter() - t0:.3f}s, launches "
                f"{json.dumps(launch_counts())} routes {json.dumps(route_counts())}"
            )
            pipe_bf16, win_bf16 = measure_pipeline(
                bf16_worker.engine, scene["lr"], out_mp, "bfloat16"
            )
        bf16_rmse = rmse_m(root / "pred_0.tif", root / "pred_bf16.tif")
        log(f"# bfloat16 vs float32 output rmse: {bf16_rmse:.2e} m")
        with make_worker() as worker:
            worker.run(
                depth_lr_fp=scene["lr"], dem_hr_fp=scene["dem"],
                output_fp=root / "pred_after_bf16.tif", window_method="feather",
            )
        if not np.array_equal(
            read_raster(root / "pred_0.tif")[0], read_raster(root / "pred_after_bf16.tif")[0]
        ):
            raise AssertionError("the float32 output moved after the bfloat16 worker ran")

    parity = run_parity_gate(t_start, root, device)

    payload = {
        # bench.py's schema 2: vs_baseline is the job-level windows/s ratio.
        "bench_schema": 2,
        "metric": (
            "SR megapixels/sec per GPU on 16x tohr (rss_mersch_A-shaped scene): "
            "device pipeline (normalize+forward+invert+feather mosaic), "
            f"{compute_dtype}; vs_baseline = job-level speedup (measured 512^2 "
            "windows/s over the original floodsr CPU ORT's 24 windows/s on the "
            "identical tiled job); vs_baseline_output_rate = unique-output MP/s "
            "over that baseline's computed-window pixel rate 6.3 MP/s"
        ),
        "value": round(pipe_f32, 2),
        "unit": "MP/s",
        "vs_baseline": round(win_f32 / BASELINE_WINDOWS_PER_S, 2),
        "windows_per_s": round(win_f32, 1),
        "vs_baseline_output_rate": round(pipe_f32 / BASELINE_COMPUTE_MPS, 2),
        "e2e_mps": round(e2e_mps, 3),
        "e2e_vs_baseline": round(e2e_mps / BASELINE_E2E_MPS, 2),
        "device": card,
    }
    for codec, mps in e2e_by_compress.items():
        payload[f"e2e_mps_{codec}"] = round(mps, 3)
    for codec, mps in pack12_results.items():
        payload[f"e2e_mps_pack12_{codec}"] = round(mps, 3)
    if pack12_rmse is not None:
        payload["pack12_rmse_vs_uint16_m"] = round(pack12_rmse, 7)
    if stream_mps is not None:
        payload["stream_mps"] = round(stream_mps, 3)
        payload["stream_scenes"] = stream_n
    payload["e2e_scene_timings"] = best_scene_timings
    # The best run's wall without the finish's wait for the device-to-host
    # copy of the scene.
    payload["e2e_mps_excl_d2h_wait"] = round(
        out_mp / max(1e-9, best - float(best_scene_timings["d2h_wait_s"])), 2
    )
    payload["parity_gate"] = parity
    if pipe_hard is not None:
        payload["hard_window_mps"] = round(pipe_hard, 2)
        payload["hard_windows_per_s"] = round(win_hard, 1)
        payload["hard_window_vs_baseline"] = round(win_hard / BASELINE_WINDOWS_PER_S, 2)
        payload["hard_window_vs_baseline_output_rate"] = round(
            pipe_hard / BASELINE_COMPUTE_MPS, 2
        )
    if pipe_bf16 is not None:
        payload["bf16_mps"] = round(pipe_bf16, 2)
        payload["bf16_windows_per_s"] = round(win_bf16, 1)
        payload["bf16_vs_baseline"] = round(win_bf16 / BASELINE_WINDOWS_PER_S, 2)
        # bf16 against the f32 output of this scene, measured in this run.
        payload["bf16_rmse_vs_f32_m"] = round(bf16_rmse, 7)
        payload["bf16_parity_gate"] = bool(bf16_rmse <= GATE_RMSE_M)
    return payload


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--device", default="cuda",
        help="the CUDA device to measure (default: cuda); the bench never runs on the CPU",
    )
    args = parser.parse_args(argv)

    import torch

    if not args.device.startswith("cuda"):
        print(f"bench_torch: --device {args.device} is not a CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    if os.environ.get("FLOODSR_BENCH_DEBUG"):
        logging.basicConfig(level=logging.DEBUG, stream=sys.stderr)

    with tempfile.TemporaryDirectory(prefix="floodsr-bench-torch-") as tmp:
        root = Path(tmp)
        payload = run(args.device, HR_SHAPE, LR_SHAPE, make_model(root), root)
    print(json.dumps(payload))
    return 1 if payload["parity_gate"]["pass"] is False else 0


if __name__ == "__main__":
    raise SystemExit(main())
