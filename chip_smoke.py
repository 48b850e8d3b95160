#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``floodsr_tpu_torch``) end to end on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py                # every phase, seed 0
    python3 chip_smoke.py --profile      # and device time by kernel

Phases (any failure raises and exits non-zero; none is caught):

1. device — the CUDA device's name, ``nvidia-smi`` name and power limit;
2. build — ``nvcc`` builds every kernel from ``floodsr_tpu_torch/csrc``;
3. tile_stats (K2) against its plain torch version on the card, bit for bit,
   on ``[16, 512, 512]`` DEM-like tiles with negatives, ties and a constant
   tile; kernel, plain and ``torch.quantile`` times;
4. hr_tail (K1) against its plain torch version on the card, at the flagship
   artifact's fuse/head weights and ``[8,128,128,128] + [8,128,128,32]``;
5. ``tohr`` on every ``tests/data/synth_*`` case, metrics equal to
   ``case_spec.json`` at its precision; K2 launched on every case, K1 on
   ``synth_flagship``;
6. a timed 4096² scene (256² LR depth) with the flagship artifact, the
   kernels' launch counts read from that run, and the worker's stage times
   (with ``--profile``, a third run traced by ``torch.profiler``: device time
   by kernel and the device's idle share, from the kernel and copy events);
7. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line last.

It exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
FLAGSHIP = DATA / "_artifacts" / "model_infer_flagship.fsrz"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the f32 (non-tensor) peak.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

SCENE_SIZE = 4096  # HR pixels per side of the timed scene (256² LR depth)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time in ms for the work: bytes at HBM rate vs f32 ops at peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    return {"kind": name, "count": torch.cuda.device_count(), "smi": smi}


def phase_build() -> None:
    from floodsr_tpu_torch.ops.kernels import KERNEL_SOURCES, _build

    t0 = time.perf_counter()
    logs = _build.build(KERNEL_SOURCES)
    log(f"[build] {len(logs)} kernel source(s) built in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for name in KERNEL_SOURCES:
        _build.load(name)


def dem_like_tiles(rng, n: int, size: int) -> np.ndarray:
    """Terrain-like tiles; tile 1 dips below 0, tile 2 has ties, tile 3 is flat."""
    tiles = 200.0 + np.cumsum(rng.normal(0.0, 0.5, (n, size, size)), axis=2)
    tiles += np.linspace(0.0, 40.0, size)[None, :, None]
    tiles = tiles.astype(np.float32)
    tiles[1] -= np.float32(tiles[1].mean())            # negatives clamp to 0
    tiles[2] = np.round(tiles[2] * 2.0) / 2.0          # many ties
    tiles[3] = np.float32(123.25)                      # constant tile
    return tiles


def phase_tile_stats(torch, rng) -> dict:
    from floodsr_tpu_torch.ops.kernels import tile_stats as ts

    n, size, pct = 16, 512, 95.0
    dem = torch.from_numpy(dem_like_tiles(rng, n, size)).cuda()
    got = ts.tile_stats_cuda(dem, pct)
    want = ts.tile_stats_reference(dem, pct)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got - want).abs().max().item()
        raise AssertionError(f"tile_stats kernel != plain version (max |diff| {diff})")
    # Library yardstick: linear-interpolated quantile of the clamped tiles.
    clamped = torch.clamp_min(dem.reshape(n, -1), 0.0)
    lib = torch.quantile(clamped, pct / 100.0, dim=1, interpolation="linear")
    lib_err = (lib - want[:, 0]).abs().max().item()
    ms = time_ms(torch, lambda: ts.tile_stats_cuda(dem, pct))
    plain_ms = time_ms(torch, lambda: ts.tile_stats_reference(dem, pct), reps=3, warmup=1)
    library_ms = time_ms(
        torch, lambda: torch.quantile(
            torch.clamp_min(dem.reshape(n, -1), 0.0), pct / 100.0, dim=1,
            interpolation="linear",
        ), reps=5, warmup=1,
    )
    count = size * size
    bound_ms, bound_by = bound(
        nbytes=dem.numel() * 4 + n * 3 * 4,
        # two compares per element for min/max, two per bisection step
        nops=n * count * (2 + 2 * ts.BISECT_ITERS),
    )
    log(
        f"[tile_stats] [{n},{size},{size}] bitwise equal to plain; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, torch.quantile {library_ms:.3f} ms "
        f"(max |quantile - p_clip| {lib_err:.3e}), bound {bound_ms:.5f} ms ({bound_by})"
    )
    return {
        "name": "tile_stats",
        "route": "cuda",
        "source": "floodsr_tpu_torch/csrc/tile_stats.cu",
        "replaces": "floodsr_tpu/ops/pallas/tile_stats.py:85",
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "launches": None,
    }


def phase_hr_tail(torch, rng) -> dict:
    import torch.nn.functional as F

    from floodsr_tpu_torch.engine import EngineTorch
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    engine = EngineTorch(FLAGSHIP, device="cuda")
    model, cfg = engine.model, engine.config
    weights = ht.pack_hr_tail_weights(model.fuse[0], model.fuse[1], model.head, bn_eps=cfg.bn_eps)
    b = 8
    hw = cfg.hr_tile // cfg.hr_s2d
    ca = cfg.base_filters * cfg.hr_s2d
    cb = cfg.fuse_filters
    # Post-ReLU features, as the tail sees them.
    sr = torch.from_numpy(np.abs(rng.normal(0, 1, (b, hw, hw, ca))).astype(np.float32)).cuda()
    dem = torch.from_numpy(np.abs(rng.normal(0, 1, (b, hw, hw, cb))).astype(np.float32)).cuda()
    got = ht.hr_tail_cuda(sr, dem, *weights)
    want = ht.hr_tail_reference(sr, dem, *weights)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    # f32 sums in another order than cuDNN's: ~1e-6 relative per layer
    # through five convolutions; 1e-4 of the output's range bounds it.
    if not err <= 1e-4 * scale:
        raise AssertionError(f"hr_tail kernel vs plain: max |diff| {err} > 1e-4 * {scale}")
    ms = time_ms(torch, lambda: ht.hr_tail_cuda(sr, dem, *weights), reps=10)
    plain_ms = time_ms(torch, lambda: ht.hr_tail_reference(sr, dem, *weights), reps=10)

    # Library yardstick: the same chain of cuDNN convolutions on NCHW inputs
    # (no layout changes), TF32 off.
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    oihw = {k: (v.permute(3, 2, 0, 1).contiguous() if v.ndim == 4 else v.t()[:, :, None, None].contiguous())
            for k, v in w.items() if k.endswith(("_w1", "_w2", "_pw", "head_w"))}
    x_nchw = torch.cat([sr, dem], dim=-1).permute(0, 3, 1, 2).contiguous()

    def cudnn_chain():
        def ar(v, a, c):
            return torch.relu(v * a[None, :, None, None] + c[None, :, None, None])

        y = F.conv2d(ar(x_nchw, w["f1_a1"], w["f1_c1"]), oihw["f1_w1"], w["f1_b1"], padding=1)
        y = F.conv2d(ar(y, w["f1_a2"], w["f1_c2"]), oihw["f1_w2"], w["f1_b2"], padding=1)
        y1 = y + F.conv2d(x_nchw, oihw["f1_pw"], w["f1_pb"])
        y = F.conv2d(ar(y1, w["f2_a1"], w["f2_c1"]), oihw["f2_w1"], w["f2_b1"], padding=1)
        y = F.conv2d(ar(y, w["f2_a2"], w["f2_c2"]), oihw["f2_w2"], w["f2_b2"], padding=1)
        return F.conv2d(y + y1, oihw["head_w"], w["head_b"])

    library_ms = time_ms(torch, cudnn_chain, reps=10)
    cin, cm, ch = ca + cb, ca, cfg.hr_s2d ** 2
    macs = b * hw * hw * (9 * cin * cm + 3 * 9 * cm * cm + cin * cm + cm * ch)
    nbytes = (sr.numel() + dem.numel() + got.numel() + sum(t.numel() for t in weights)) * 4
    bound_ms, bound_by = bound(nbytes=nbytes, nops=2 * macs)
    log(
        f"[hr_tail] [{b},{hw},{hw},{ca}]+[{b},{hw},{hw},{cb}] max |kernel - plain| "
        f"{err:.3e} (max |plain| {scale:.3e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"cuDNN chain {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, "
        f"{2 * macs / 1e9:.1f} GFLOP)"
    )
    engine.close()
    return {
        "name": "hr_tail",
        "route": "cuda",
        "source": "floodsr_tpu_torch/csrc/hr_tail.cu",
        "replaces": "floodsr_tpu/ops/pallas/hr_tail.py:594",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "launches": None,
    }


def phase_tohr_cases() -> None:
    from floodsr_tpu_torch.eval import compute_depth_error_metrics
    from floodsr_tpu_torch.io import read_raster
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from floodsr_tpu_torch.ops.normalize import replace_nodata_with_zero
    from floodsr_tpu_torch.tohr import tohr

    cases = sorted(p.parent for p in DATA.glob("synth_*/case_spec.json"))
    assert cases, f"no synth cases under {DATA}"
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        for case_dir in cases:
            spec = json.loads((case_dir / "case_spec.json").read_text())
            model_fp = DATA / spec.get("model_artifact", "_artifacts/model_infer_test.fsrz")
            truth_raw, truth_nodata, _ = read_raster(case_dir / spec["inputs"]["truth_fp"])
            truth = replace_nodata_with_zero(truth_raw, truth_nodata)
            for label, run in spec["expected"].items():
                out_fp = Path(tmp) / f"{case_dir.name}_{label}.tif"
                reset_launch_counts()
                diag = tohr(
                    model_fp=model_fp,
                    depth_lr_fp=case_dir / spec["inputs"]["lowres_fp"],
                    dem_hr_fp=case_dir / spec["inputs"]["dem_fp"],
                    output_fp=out_fp,
                    device="cuda",
                    **run["params"],
                )
                counts = launch_counts()
                pred, _, _ = read_raster(out_fp)
                assert pred.dtype == np.float32 and np.isfinite(pred).all()
                metrics = compute_depth_error_metrics(truth, pred, max_depth=5.0)
                precision = int(run["metrics"].get("precision", 3))
                got = {k: round(float(metrics[k]), precision) for k in ("mase_m", "rmse_m", "ssim")}
                want = {k: round(float(run["metrics"][k]), precision) for k in got}
                log(
                    f"[tohr] {case_dir.name}/{label}: {got} (expected {want}) "
                    f"launches {counts} tiles {diag['preprocess']['tile_cache_size']}"
                )
                if got != want:
                    raise AssertionError(f"{case_dir.name}/{label}: {got} != {want}")
                if counts["tile_stats"] <= 0:
                    raise AssertionError(f"{case_dir.name}: tile_stats kernel never launched")
                if case_dir.name == "synth_flagship" and counts["hr_tail"] <= 0:
                    raise AssertionError("synth_flagship: hr_tail kernel never launched")


class _StageLog(logging.Handler):
    """Collects the worker's ``stage timings: name=secondss`` debug lines."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.stages: dict[str, float] = {}

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("stage timings:"):
            for item in msg.split(":", 1)[1].split():
                key, _, value = item.partition("=")
                self.stages[key] = float(value.rstrip("s"))


def scene_inputs(tmp: Path, seed: int, size: int) -> tuple[Path, Path]:
    """A ``size``² HR DEM and a ``size/16``² LR depth from ``seed``, as GeoTIFFs."""
    from floodsr_tpu_torch.io import from_origin, write_raster

    rng = np.random.default_rng(seed)
    scale = 16
    lr = size // scale
    hr_res, lr_res = 2.0, 2.0 * scale
    x0, y0 = 500000.0, 4000000.0 + size * hr_res
    dem = (
        300.0
        + np.cumsum(rng.normal(0.0, 0.3, (size, size)), axis=1)
        + np.linspace(0.0, 60.0, size)[:, None]
    ).astype(np.float32)
    depth = np.clip(rng.gamma(1.5, 0.6, (lr, lr)) - 0.4, 0.0, 5.0).astype(np.float32)

    def profile(shape, res):
        return {
            "driver": "GTiff", "height": shape[0], "width": shape[1], "count": 1,
            "dtype": "float32", "crs": "EPSG:32633", "nodata": -9999.0,
            "transform": from_origin(x0, y0, res, res), "compress": "LZW",
        }

    dem_fp, depth_fp = tmp / "dem.tif", tmp / "depth.tif"
    write_raster(dem_fp, dem, profile(dem.shape, hr_res))
    write_raster(depth_fp, depth, profile(depth.shape, lr_res))
    return dem_fp, depth_fp


# Kernel-name fragments of each hand-written kernel, for its share of the
# traced device time.
KERNEL_NAMES = {
    "tile_stats": ("tile_stats_kernel",),
    "hr_tail": ("affine_relu_conv3x3_kernel", "conv1x1_kernel"),
}


def device_profile(torch, run) -> dict:
    """``torch.profiler`` over one ``run()``: device time by kernel and busy time.

    Only device-side events (kernels, copies, sets) are summed: an operator's
    row in ``key_averages()`` repeats the time of the kernels it launched.
    Busy time is the union of those events' intervals.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True
    ) as prof:
        run()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    spans = []
    by_name = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        t_start, t_end = float(evt.time_range.start), float(evt.time_range.end)
        if t_end <= t_start:
            continue
        spans.append((t_start, t_end))
        by_name[evt.name] = by_name.get(evt.name, 0.0) + (t_end - t_start)
    if not spans:
        raise AssertionError("the profiler recorded no device events")
    spans.sort()
    busy_us, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for t_start, t_end in spans[1:]:
        if t_start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = t_start, t_end
        else:
            cur_end = max(cur_end, t_end)
    busy_us += cur_end - cur_start
    kernel_ms = {
        kname: sum(us for name, us in by_name.items() if any(f in name for f in frags)) / 1e3
        for kname, frags in KERNEL_NAMES.items()
    }
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # The traced run's wall time includes the profiler's own overhead; the
    # caller sets the device busy time against an untraced run instead.
    return {
        "traced_wall_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_event_sum_s": sum(by_name.values()) / 1e6,
        "kernel_device_ms": kernel_ms,
        "kernel_share_of_busy": {k: v / (busy_us / 1e3) for k, v in kernel_ms.items()},
        "top_device_ms": {k[:80]: v / 1e3 for k, v in top},
    }


def phase_scene(torch, seed: int, size: int, with_profile: bool = False) -> dict:
    from floodsr_tpu_torch.io import read_raster
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from floodsr_tpu_torch.tohr import tohr

    stage_log = _StageLog()
    logger = logging.getLogger("chip_smoke.scene")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    logger.addHandler(stage_log)
    lr = size // 16
    with tempfile.TemporaryDirectory(prefix="chip-smoke-scene-") as tmp:
        dem_fp, depth_fp = scene_inputs(Path(tmp), seed, size)
        out_fp = Path(tmp) / "pred.tif"
        kw = dict(
            model_version="ResUNet_16x_DEM", model_fp=FLAGSHIP, depth_lr_fp=depth_fp,
            dem_hr_fp=dem_fp, output_fp=out_fp, device="cuda", logger=logger,
        )
        t0 = time.perf_counter()
        tohr(**kw)
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        diag = tohr(**kw)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        stages = dict(stage_log.stages)
        pred, _, _ = read_raster(out_fp)
        prof = device_profile(torch, lambda: tohr(**kw)) if with_profile else None
    assert pred.shape == (size, size), pred.shape
    assert np.isfinite(pred).all() and pred.min() >= 0.0 and pred.max() <= 5.0
    tiles = int(diag["preprocess"]["tile_cache_size"])
    timings = diag["scene_timings"]
    log(
        f"[scene] {size}x{size} HR from {lr}x{lr} LR, {tiles} tiles (feather): "
        f"warm-up run {warm_s:.3f} s, timed run {e2e_s:.3f} s end to end, "
        f"{tiles / e2e_s:.1f} tiles/s, {size * size / e2e_s / 1e6:.1f} MP/s HR output; "
        f"device exec {timings['exec_s']:.4f} s ({tiles / timings['exec_s']:.1f} tiles/s); "
        f"peak allocated {peak / 2**20:.1f} MiB; launches {counts}"
    )
    log(f"[scene] timings {json.dumps(timings)}")
    # tohr = worker set-up (artifact load onto the device) + worker.run.
    stages["worker_run"] = float(diag["runtime_s"])
    stages["setup"] = e2e_s - stages["worker_run"]
    log(f"[scene] worker stages (s) {json.dumps(stages)}")
    if prof is not None:
        prof["device_idle_share_of_timed_run"] = 1.0 - prof["device_busy_s"] / e2e_s
        prof["device_idle_share_of_traced_run"] = 1.0 - prof["device_busy_s"] / prof["traced_wall_s"]
        log(f"[profile] {json.dumps(prof)}")
    for name in ("tile_stats", "hr_tail"):
        if counts[name] <= 0:
            raise AssertionError(f"timed scene: {name} kernel never launched")
    return {"launches": counts, "e2e_s": e2e_s, "tiles": tiles, "timings": timings}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--profile", action="store_true",
        help="also trace a third scene run with torch.profiler (device time by kernel)",
    )
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import floodsr_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    device = phase_device(torch)
    phase_build()
    rng = np.random.default_rng(args.seed)
    kernels = [phase_tile_stats(torch, rng), phase_hr_tail(torch, rng)]
    phase_tohr_cases()
    scene = phase_scene(torch, args.seed, SCENE_SIZE, args.profile)
    for k in kernels:
        k["launches"] = scene["launches"][k["name"]]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(device["smi"])
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device["kind"], "count": device["count"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
