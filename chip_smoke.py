#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``floodsr_tpu_torch``) end to end on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py                # every phase, seed 0
    python3 chip_smoke.py --profile      # and device time by kernel (traced scenes)

Phases (any failure raises and exits non-zero; none is caught):

1. device — the CUDA device's name, ``nvidia-smi`` name and power limit;
2. build — ``nvcc`` builds every kernel from ``floodsr_tpu_torch/csrc``;
3. tile_stats (K2) against its plain torch version on the card, bit for bit,
   on ``[16, 512, 512]`` DEM-like tiles with negatives, ties and a constant
   tile (the one-read route) and on the same tiles one float off 16-byte
   alignment (the streaming route); kernel times at 16, 32 and 25 tiles,
   plain and ``torch.quantile`` times;
4. hr_tail (K1) against its plain torch version on the card, at the flagship
   artifact's fuse/head weights and ``[8,128,128,128] + [8,128,128,32]``: the
   tensor-core route (3xTF32 ``wgmma``) at 8 tiles and at 1, and the direct
   route (f32 on the CUDA cores) at 8 tiles beside it; then the bf16
   arithmetic against ITS plain version (``hr_tail_reference_bf16``): the
   bf16 ``wgmma`` route (TMA-fed bf16 operands) at 8 tiles and at 1, with its
   launches' device times (traced) and ``-Xptxas -v`` lines, and the direct
   bf16 route at the narrow test artifact's widths, timed beside the cuDNN
   chain in bf16;
   hr_tail layouts — K1 at the JAX package's other two HR layouts
   (``hr_s2d`` 2: 64 + 32 -> 64 -> 4 on 256² tiles; 1: 32 + 32 -> 32 -> 1 on
   512²), weights from ``init_resunet(--seed)``, 8 tiles: the direct f32 and
   bf16 routes, the plain versions and both cuDNN chains held and timed
   first (what these widths ran before), then the 3xTF32 route and the
   bf16 band route (one launch, every intermediate on chip) against their
   plain versions at 8 tiles and 1, timed and traced by launch, with the
   bounds, each route's own device-memory traffic and the peak memory of
   one 8-tile call; the band route's one-tile grid from the trace (at least
   128 blocks, ``band_plan``'s); the kernels' ``-Xptxas -v`` lines; then
   ``tohr`` on a 1024² scene (9 tiles) with an artifact of each layout
   (``init_resunet`` + ``save_artifact``) under ``float32`` and ``bfloat16``:
   K1 on the 3xTF32 route and the band route at every call and never direct;
   f32 against
   ``device="cpu"`` at 1e-3 m RMSE, bf16 against the same scene on the card
   with K1 through its plain version (a quarter of the policy's own distance
   to f32), its distance to ``device="cpu"`` logged;
5. ``tohr`` on every ``tests/data/synth_*`` case, metrics equal to
   ``case_spec.json`` at its precision; K2 launched on every case, K1 on
   ``synth_flagship`` (its tensor-core route); ``depth_metrics_torch`` on the
   card equal to the numpy metrics at 3 decimals;
6. a timed 4096² scene (256² LR depth) with the flagship artifact, the
   kernels' launch counts read from that run (every K1 call on the
   tensor-core route, every K2 launch on the one-read route), and the
   worker's stage times (with ``--profile``, a third run traced by
   ``torch.profiler``: device time by kernel and the device's idle share,
   from the kernel and copy events);
7. relax_step (K3) against its plain torch version on the card, bit for bit
   after 1 and after 64 relaxations, on a ``[4096, 4096]`` grid (costs in
   [1, 5] with ``inf`` walls, a few hundred seeds, one on the edge, two
   equidistant from the cells between them) and on ``[1000, 1537]``;
8. ``mcp_fill`` on the card against the Dijkstra oracle on a 512² case;
9. ``tohr`` for ``CostGrow`` and ``CostGrow_pcraster`` on a 4096² valley DEM
   (side channels, a nodata hole) with a 256² WSE over the channel, default
   parameters: K3's launch count read from the CostGrow run, the three
   solves' relaxations, convergence checks and seconds (with ``--profile``,
   a traced CostGrow run as well);
10. both CostGrow workers at 64² and 512², with and without buildings and
    once from a depth raster: the card's output equals ``device="cpu"``'s bit
    for bit;
11. ``tohr`` on ``ResUNet_16x_DEM`` with ``input_kind="wse"`` on a synth case
    (WSE = DEM at LR + depth) against the depth-input run;
12. stream — six 4096² flagship scenes over three DEM files (each DEM used by
    two scenes that are not neighbours): six single ``tohr`` calls, then one
    ``tohr_many`` over the same jobs. The stream's rasters equal the single
    calls' bit for bit; three DEM decodes in all (one inside ``run``, two by
    the prefetch thread) and five ``run`` calls that found their DEM
    resident; K1 on the tensor-core route and K2 on the one-read route in
    every scene; one JSON line of timings;
13. serve — ``TohrService`` + ``make_server`` on ``127.0.0.1`` (loopback only),
    served from a thread of this process with a bearer token and a data
    root, one 4096×4096 geometry warmed: three ``POST /v1/tohr`` (two on one
    DEM), one ``POST /v1/tohr_many`` whose middle job names a missing file,
    ``/v1/healthz``, ``/v1/metrics``, ``/v1/doctor``, one request without the
    token (401) and one outside the data root (400); outputs equal
    ``tohr``'s. A second service on ``CostGrow`` answers one 512² request
    (K3 through the daemon; ``warmup`` returns 0). One JSON line of request
    latencies;
14. cli — child processes ``python3 -m floodsr_tpu_torch.cli doctor`` and
    ``... cli tohr --in a.tif b.tif --dem dem.tif --out <dir>`` at 1024²,
    exit code 0 each, the files equal to ``tohr``'s;
    examples — ``examples/run_tohr_torch.py``, ``serve_scenes_torch.py`` and
    ``tutorial_torch.py --no-figure`` in-process with ``--device cuda``: K2
    launched by each, K1 on its tensor-core route in the tutorial and not at
    all in the two others (their small artifact's one fuse block runs the
    unfused tail); the tutorial's SR metrics equal to ``case_spec.json``'s at
    its precision; one ``[examples]`` line with each script's wall time;
    gate — ``python3 bin/parity_gate_torch.py --out <tmp>`` as a child
    process: exit 0, every ``tests/data/synth_*`` case, ``synth_mersch@hard``
    and ``synth_mersch@pack12`` within 1e-3 m RMSE of the same ``tohr`` on the
    CPU, the banded row passing, the card named in the result;
    bench — ``python3 bench_torch.py`` as a child process with
    ``FLOODSR_BENCH_REPEATS=2 FLOODSR_BENCH_STREAM_SCENES=2
    FLOODSR_BENCH_PARITY=0`` (the gate ran just before): exit 0, a last line
    with every key of ``bench_torch.PAYLOAD_KEYS`` and every rate above 0; K1
    and K2 launches read from the run lines of its stderr (a flagship
    scene's, K1 on the tensor-core route; the ``bfloat16`` run's on the bf16
    route);
    mesh — the multi-GPU paths on the one card: the 4096² flagship scene
    through ``tohr`` banded over ``make_mesh(devices=[cuda:0] * 4)`` and over
    ``parse_mesh_spec("auto")``, and replicated over ``[cuda:0] * 4`` (each
    raster within one uint16 step of the plain ``tohr`` raster; K1 and K2
    counted by the wrappers and seen by the profiler; seconds, ``exec_s``, K1
    and K2 device ms, peak MiB), ``run_scene`` with the float32 transfer
    within 1e-4 m of the plain scene with the per-tile stats equal in grid
    order, a 1024 × 8192 scene on the column path, the 4096² valley's
    penalized-fill inputs through ``mcp_fill_sharded`` over 4 bands equal to
    ``mcp_fill`` bit for bit (K3's launches and seconds for both), and
    ``tohr --mesh auto --scene-mode banded`` as a child process at 1024²
    against the plain CLI raster; a real 2-GPU mesh where the machine has
    two GPUs. One ``{"mesh": ...}`` JSON line;
15. policies — the 4096² flagship scene under ``compute_dtype="bfloat16"``
    (16 K1 calls on the bf16 route, none other) and ``"mixed"`` (16 on the
    3xTF32 route): end to end, ``exec_s`` and the RMSE in metres against the
    f32 scene of the same seed;
16. finish — one 4096² scene whose DEM is a 3840² raster over the same extent,
    so the output is resampled onto the DEM's grid: ``output_transfer="uint12"``
    against ``"float32"`` (within ``max_depth / 4095``), and the device
    postprocess against the host resampler (``FLOODSR_DEVICE_POSTPROC=0``),
    with the finish stage's seconds each way;
17. onnx — the tf2onnx-idiom replica of the released graph
    (``tests/onnx_replica.py``, 12.2 M parameters, 32² → 512² tiles) written
    to a temporary ``.onnx``: interpreter, converted graph and the replica's
    own torch module agree on a batch of tiles; the ``.onnx`` through ``tohr``
    at 4096² (121 tiles, single-phase executor, K2 launched, K1 not), then
    ``convert_onnx_to_fsrz`` and the same scene through the ``.fsrz``;
18. train — the flagship configuration (16,661,616 parameters, from
    ``init_resunet(--seed)``) on 24 synthetic 512² scenes
    (``train/synth.py``), staged on the card, batch 8: the first train step
    on the card against the same step with ``device="cpu"`` (loss, grad
    norm, BN running stats, Adam moments, and the card's update against
    optax's formula on its own moments); the step's FLOPs counted and from
    the config; three timed calls of the resident loop (10 steps each, after
    one warm-up call) in ``float32`` and in ``bfloat16`` (steps/s, ms a
    step, peak MiB, share of the f32 peak, the loss curve, every loss
    finite); the eval step on the held-out scenes (K1 on its tensor-core
    route, counted and timed; metrics equal to the CPU's to 1e-3); the
    training checkpoint saved and restored bit for bit; the exported
    inference artifact through ``tohr`` on ``synth_flagship`` (K1 and K2
    launched). One JSON line of the phase's numbers;
19. train_mesh — the same configuration and batch on a mesh of the one
    card: ``make_mesh(devices=[cuda:0] * 4)`` (dp=4) and ``... tp=2`` (dp=2,
    tp=2). Each mesh's first step against the single step on the card (loss
    and grad norm to rtol 1e-5; moments and running stats to
    ``tests/test_torch_train_mesh.py``'s tolerances widened by the single
    step's own distance from the CPU's; the parameters against Adam's update
    from the step's own moments, as ``train`` holds the card), the ``dp``
    replicas bit-equal and the ``tp`` pieces slices of their leaves; 10 timed
    steps (CUDA events, peak MiB) beside the single step's; the sharded eval
    step (K1 once per ``dp`` row, on its tensor-core route; with
    ``--profile`` seen by the profiler) against the unsharded eval; the
    placed state's checkpoint restored bit for bit; over two GPUs where the
    machine has them. Four entries share one card: the times read the mesh's
    overheads, not a speed-up. One ``{"train_mesh": ...}`` JSON line;
20. a ``{"kernels": [...]}`` line (K1 with ``launches_train_eval`` and
    ``launches_train_mesh_eval``; each kernel with ``launches_mesh``; K1, its
    bf16 route and K2 with ``launches_bench`` and ``launches_examples``; K1
    and the bf16 band route (``hr_tail_bf16_band``, its top-level numbers
    ``hr_s2d`` 1's) with ``layouts``, an entry per (Cm, Ch) beside the
    flagship's: ms, bound, plain, library and direct-route ms, peak MiB and
    the launches of that layout's scene), the card's name and power limit,
    then the ``{"ok": true, ...}`` line last.

It exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
FLAGSHIP = DATA / "_artifacts" / "model_infer_flagship.fsrz"

# NVIDIA H100 SXM data sheet (700 W): HBM3 bandwidth, the f32 (non-tensor)
# peak and the dense TF32 tensor-core peak.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12
PEAK_BF16_PER_S = 989e12

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


def bound(nbytes: float, nops: float, ops_per_s: float = PEAK_F32_PER_S) -> tuple[float, str]:
    """Least time in ms for the work: bytes at HBM rate vs operations at their peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
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
    tiles = dem_like_tiles(rng, 32, size)
    dem32 = torch.from_numpy(tiles).cuda()
    dem = dem32[:n]
    ts.route_launches.update(one_read=0, stream=0)
    got = ts.tile_stats_cuda(dem, pct)
    want = ts.tile_stats_reference(dem, pct)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got - want).abs().max().item()
        raise AssertionError(f"tile_stats kernel != plain version (max |diff| {diff})")
    if ts.route_launches != {"one_read": 1, "stream": 0}:
        raise AssertionError(f"tile_stats at {size}² did not take the one-read route: {ts.route_launches}")
    # The same tiles one float into their storage: off 16-byte alignment, so
    # the streaming route with scalar loads.
    store = torch.empty(dem.numel() + 1, device="cuda")
    store[1:] = dem.reshape(-1)
    off = store[1:].view(n, size, size)
    got_off = ts.tile_stats_cuda(off, pct)
    torch.cuda.synchronize()
    if not torch.equal(got_off, want) or ts.route_launches != {"one_read": 1, "stream": 1}:
        raise AssertionError(f"tile_stats streaming route != plain version ({ts.route_launches})")
    # Library yardstick: linear-interpolated quantile of the clamped tiles.
    clamped = torch.clamp_min(dem.reshape(n, -1), 0.0)
    lib = torch.quantile(clamped, pct / 100.0, dim=1, interpolation="linear")
    lib_err = (lib - want[:, 0]).abs().max().item()
    # The scene's batches: 32 tiles three times, then 25. Clusters of 8 blocks,
    # one block an SM, so these run in two waves: each is held against the
    # plain version too, twice (a race would not repeat), before it is timed.
    dem25 = dem32[:25]
    for batch in (dem32, dem25):
        want_b = ts.tile_stats_reference(batch, pct)
        for _ in range(2):
            got_b = ts.tile_stats_cuda(batch, pct)
            torch.cuda.synchronize()
            if not torch.equal(got_b, want_b):
                bad = int((got_b != want_b).any(dim=1).sum())
                raise AssertionError(
                    f"tile_stats kernel != plain version at {batch.shape[0]} tiles ({bad} tiles differ)"
                )
    if ts.route_launches != {"one_read": 5, "stream": 1}:
        raise AssertionError(f"tile_stats at 32 and 25 tiles did not take the one-read route: {ts.route_launches}")
    ms = time_ms(torch, lambda: ts.tile_stats_cuda(dem, pct))
    ms32 = time_ms(torch, lambda: ts.tile_stats_cuda(dem32, pct))
    ms25 = time_ms(torch, lambda: ts.tile_stats_cuda(dem25, pct))
    stream_ms = time_ms(torch, lambda: ts.tile_stats_cuda(off, pct))
    plain_ms = time_ms(torch, lambda: ts.tile_stats_reference(dem, pct), reps=3, warmup=1)
    library_ms = time_ms(
        torch, lambda: torch.quantile(
            torch.clamp_min(dem.reshape(n, -1), 0.0), pct / 100.0, dim=1,
            interpolation="linear",
        ), reps=5, warmup=1,
    )
    count = size * size
    # One compare per element for each of min and max, and one bin index per
    # element for each of the select's (at most three) digit passes.
    bound_ms, bound_by = bound(nbytes=dem.numel() * 4 + n * 3 * 4, nops=n * count * (2 + 3))
    bound32_ms = bound(nbytes=dem32.numel() * 4 + 32 * 3 * 4, nops=0)[0]
    log(
        f"[tile_stats] [{n},{size},{size}] bitwise equal to plain on both routes, [32,...] and "
        f"[25,...] on the one-read route; one-read "
        f"kernel {ms:.4f} ms ({bound_ms / ms:.1%} of the bound), streaming route (scalar loads) "
        f"{stream_ms:.4f} ms, plain {plain_ms:.3f} ms, torch.quantile {library_ms:.3f} ms "
        f"(max |quantile - p_clip| {lib_err:.3e}), bound {bound_ms:.5f} ms ({bound_by})"
    )
    log(
        f"[tile_stats] the scene's batches: [32,{size},{size}] {ms32:.4f} ms (bound "
        f"{bound32_ms:.5f} ms), [25,{size},{size}] {ms25:.4f} ms (bound {bound32_ms * 25 / 32:.5f} ms)"
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
        "ms_32_tiles": ms32,
        "ms_25_tiles": ms25,
        "stream_route_ms": stream_ms,
    }


def phase_hr_tail(torch, rng) -> list[dict]:
    from floodsr_tpu_torch.engine import EngineTorch
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht
    from floodsr_tpu_torch.ops.kernels import reset_launch_counts

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
    tc_pack = ht.pack_hr_tail_tc(weights)
    reset_launch_counts()
    got = ht.hr_tail_cuda(sr, dem, *weights, tc_pack=tc_pack)
    want = ht.hr_tail_reference(sr, dem, *weights)
    torch.cuda.synchronize()
    if ht.route_launches != {**dict.fromkeys(ht.route_launches, 0), "tensor": 1}:
        raise AssertionError(f"hr_tail at the flagship widths did not take the tensor-core route: {ht.route_launches}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    # 3xTF32 products summed in the tensor core's f32 accumulator, in another
    # order than cuDNN's f32: f32-rounding level per layer through five
    # convolutions; 1e-4 of the output's range bounds it.
    if not err <= 1e-4 * scale:
        raise AssertionError(f"hr_tail kernel vs plain: max |diff| {err} > 1e-4 * {scale}")
    # The scene's last batch is one tile.
    got1 = ht.hr_tail_cuda(sr[:1], dem[:1], *weights, tc_pack=tc_pack)
    direct = ht.hr_tail_cuda(sr, dem, *weights, route="direct")
    torch.cuda.synchronize()
    err1 = (got1 - want[:1]).abs().max().item()
    err_direct = (direct - want).abs().max().item()
    if not max(err1, err_direct) <= 1e-4 * scale:
        raise AssertionError(f"hr_tail vs plain: one tile {err1}, direct route {err_direct} > 1e-4 * {scale}")
    ms = time_ms(torch, lambda: ht.hr_tail_cuda(sr, dem, *weights, tc_pack=tc_pack), reps=10)
    ms1 = time_ms(torch, lambda: ht.hr_tail_cuda(sr[:1], dem[:1], *weights, tc_pack=tc_pack), reps=10)
    direct_ms = time_ms(torch, lambda: ht.hr_tail_cuda(sr, dem, *weights, route="direct"), reps=5)
    plain_ms = time_ms(torch, lambda: ht.hr_tail_reference(sr, dem, *weights), reps=10)

    library_ms = time_ms(torch, cudnn_tail_chain(torch, ht, weights, sr, dem, torch.float32), reps=10)
    cin, cm, ch = ca + cb, ca, cfg.hr_s2d ** 2
    macs = b * hw * hw * (9 * cin * cm + 3 * 9 * cm * cm + cin * cm + cm * ch)
    nbytes = (sr.numel() + dem.numel() + got.numel() + sum(t.numel() for t in weights)) * 4
    # Every MAC is three TF32 products on the tensor cores (lo*Whi, hi*Wlo,
    # hi*Whi), so the route's operations are 3 x 2 x MACs at the TF32 peak.
    bound_ms, bound_by = bound(nbytes=nbytes, nops=3 * 2 * macs, ops_per_s=PEAK_TF32_PER_S)
    f32_bound_ms = bound(nbytes=nbytes, nops=2 * macs)[0]
    one_product_ms = bound(nbytes=nbytes, nops=2 * macs, ops_per_s=PEAK_TF32_PER_S)[0]
    log(
        f"[hr_tail] [{b},{hw},{hw},{ca}]+[{b},{hw},{hw},{cb}] max |kernel - plain| "
        f"{err:.3e} (max |plain| {scale:.3e}; one tile {err1:.3e}, direct route {err_direct:.3e}); "
        f"tensor-core kernel {ms:.3f} ms ({bound_ms / ms:.1%} of the bound), one tile {ms1:.3f} ms, "
        f"direct route {direct_ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN chain {library_ms:.3f} ms"
    )
    log(
        f"[hr_tail] bound {bound_ms:.3f} ms ({bound_by}: 3xTF32 on the tensor cores, "
        f"{3 * 2 * macs / 1e9:.1f} GFLOP at {PEAK_TF32_PER_S / 1e12:.0f} TFLOP/s); beside it "
        f"{f32_bound_ms:.3f} ms (f32 on the CUDA cores, the direct route's bound) and "
        f"{one_product_ms:.3f} ms (one TF32 product); at one tile {bound_ms / b:.4f} ms"
    )
    bf16 = hr_tail_bf16(torch, rng, ht, sr, dem, weights, macs, nbytes)
    engine.close()
    return [{
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
        "bound_peak": "3xTF32 on the tensor cores",
        "ms_1_tile": ms1,
        "direct_route_ms": direct_ms,
        "direct_route_bound_ms": f32_bound_ms,
    }, bf16]


#: Share of max |plain| the bf16 routes may differ from hr_tail_reference_bf16
#: by. The products are exact in f32 on both sides; the f32 sums run in another
#: order, and an activation within an f32 rounding of a bf16 tie then rounds
#: the other way: 2^-9 of one operand among 1,152 to 1,440. With the flagship
#: artifact's weights the intermediates are some hundred times the output, so
#: one such flip shows as 3.5e-3 of max |out| (measured on an H100; 2e-3 holds
#: for weights of unit scale, as the CUDA tests use). Far under the 0.15 of the
#: range that separates bf16 from f32 in the TPU kernel's own test; and the
#: flips are rare: their root mean square must stay under a quarter of the
#: distance between the bf16 and the f32 result.
BF16_GATE = 1e-2


def hr_tail_bf16(torch, rng, ht, sr, dem, weights, macs, nbytes) -> dict:
    """K1's bf16 arithmetic on the card against its plain version, and its times."""
    from floodsr_tpu_torch.ops.kernels import reset_launch_counts

    b = int(sr.shape[0])
    pack = ht.pack_hr_tail_bf16(weights)
    want = ht.hr_tail_reference_bf16(sr, dem, *weights)
    f32 = ht.hr_tail_reference(sr, dem, *weights)
    reset_launch_counts()
    got = ht.hr_tail(sr, dem, *weights, tc_pack=pack, mode="bf16")
    got1 = ht.hr_tail(sr[:1], dem[:1], *weights, tc_pack=pack, mode="bf16")
    again = ht.hr_tail(sr, dem, *weights, tc_pack=pack, mode="bf16")
    torch.cuda.synchronize()
    if ht.route_launches != {**dict.fromkeys(ht.route_launches, 0), "bf16": 3}:
        raise AssertionError(f"hr_tail in bf16 at the flagship widths took another route: {ht.route_launches}")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    err1 = (got1 - want[:1]).abs().max().item()
    gap = (want - f32).abs().max().item()
    if not torch.equal(got, again):
        raise AssertionError("hr_tail bf16 route: two calls on the same inputs differ")
    rms_err = (got - want).square().mean().sqrt().item()
    rms_gap = (want - f32).square().mean().sqrt().item()
    if not max(err, err1) <= BF16_GATE * scale:
        raise AssertionError(
            f"hr_tail bf16 route vs plain: {err} (one tile {err1}) > {BF16_GATE} * {scale}; "
            f"rms {rms_err}, |bf16 - f32| max {gap} rms {rms_gap}"
        )
    if not rms_err < 0.25 * rms_gap:
        raise AssertionError(
            f"hr_tail bf16 route: not the bf16 arithmetic? rms |kernel - plain| {rms_err}, "
            f"rms |bf16 - f32| {rms_gap}"
        )

    # The direct bf16 route at the narrow test artifact's widths (16+8 -> 16 -> 4).
    narrow = narrow_tail_weights(torch, rng, 16, 8, 16, 4)
    nsr = torch.from_numpy(np.abs(rng.normal(0, 1, (2, 70, 45, 16))).astype(np.float32)).cuda()
    ndem = torch.from_numpy(np.abs(rng.normal(0, 1, (2, 70, 45, 8))).astype(np.float32)).cuda()
    reset_launch_counts()
    ngot = ht.hr_tail(nsr, ndem, *narrow, mode="bf16")
    torch.cuda.synchronize()
    if ht.route_launches != {**dict.fromkeys(ht.route_launches, 0), "bf16_direct": 1}:
        raise AssertionError(f"hr_tail in bf16 at narrow widths took another route: {ht.route_launches}")
    nwant = ht.hr_tail_reference_bf16(nsr, ndem, *narrow)
    nerr, nscale = (ngot - nwant).abs().max().item(), nwant.abs().max().item()
    if not nerr <= BF16_GATE * nscale:
        raise AssertionError(f"hr_tail direct bf16 route vs plain: {nerr} > {BF16_GATE} * {nscale}")
    direct = ht.hr_tail_cuda(sr, dem, *weights, route="bf16_direct")
    torch.cuda.synchronize()
    err_direct = (direct - want).abs().max().item()
    if not err_direct <= BF16_GATE * scale:
        raise AssertionError(f"hr_tail direct bf16 route at the flagship widths: {err_direct} > {BF16_GATE} * {scale}")

    ms = time_ms(torch, lambda: ht.hr_tail(sr, dem, *weights, tc_pack=pack, mode="bf16"), reps=10)
    ms1 = time_ms(torch, lambda: ht.hr_tail(sr[:1], dem[:1], *weights, tc_pack=pack, mode="bf16"), reps=10)
    direct_ms = time_ms(torch, lambda: ht.hr_tail_cuda(sr, dem, *weights, route="bf16_direct"), reps=5)
    plain_ms = time_ms(torch, lambda: ht.hr_tail_reference_bf16(sr, dem, *weights), reps=10)

    library_ms = time_ms(torch, cudnn_tail_chain(torch, ht, weights, sr, dem, torch.bfloat16), reps=10)
    # One bf16 product per MAC on the tensor cores.
    bound_ms, bound_by = bound(nbytes=nbytes, nops=2 * macs, ops_per_s=PEAK_BF16_PER_S)
    # The route's launches, traced over a few calls at 8 tiles and at 1; at
    # one tile the trace's grids of the two convolution kernels too.
    calls = 5
    conv_kernels = ("conv_bf16_kernel", "conv_bf16_head_kernel")
    by_launch = {}
    for tiles in (b, 1):
        prof = device_profile(torch, lambda: [
            ht.hr_tail(sr[:tiles], dem[:tiles], *weights, tc_pack=pack, mode="bf16") for _ in range(calls)
        ], grids_of=conv_kernels if tiles == 1 else ())
        if prof["hr_tail_bf16_calls"] != calls:
            raise AssertionError(f"bf16 route: {prof['hr_tail_bf16_calls']} traced calls of {calls}")
        by_launch[tiles] = {k: v / calls for k, v in prof["hr_tail_bf16_ms_by_launch"].items()}
    grids1 = prof["grids"]
    blocks1 = min(int(np.prod(g)) for gs in grids1.values() for g in gs)
    if blocks1 < 128:
        raise AssertionError(f"bf16 route: a one-tile launch of {blocks1} blocks leaves SMs idle: {grids1}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[hr_tail bf16] ms by launch at {b} tiles {json.dumps(by_launch[b])}, at one tile "
        f"{json.dumps(by_launch[1])} (traced grids {json.dumps(grids1)} on {sms} SMs)")
    kernels = (*conv_kernels, "bf16_prepass_kernel")
    for kernel, usage in ptxas_usage("hr_tail", kernels).items():
        log(f"[hr_tail bf16] ptxas {kernel}: {usage}")
    log(
        f"[hr_tail bf16] max |kernel - plain| {err:.3e} (max |plain| {scale:.3e}, "
        f"{err / scale:.2e} of it; gate {BF16_GATE}; one tile {err1:.3e}; rms {rms_err:.3e}; "
        f"|bf16 - f32| max {gap:.3e} rms {rms_gap:.3e}); "
        f"direct bf16 route at 16+8->16->4 {nerr:.3e} of {nscale:.3e}, at the flagship widths "
        f"{err_direct:.3e}; bf16 wgmma route {ms:.3f} ms at {b} tiles ({bound_ms / ms:.1%} of the "
        f"bound {bound_ms:.3f} ms, {bound_by}: {2 * macs / 1e9:.1f} GFLOP at "
        f"{PEAK_BF16_PER_S / 1e12:.0f} TFLOP/s), one tile {ms1:.3f} ms, direct bf16 route "
        f"{direct_ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN chain in bf16 {library_ms:.3f} ms"
    )
    return {
        "name": "hr_tail_bf16",
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
        "bound_peak": "bf16 on the tensor cores",
        "ms_1_tile": ms1,
        "ms_by_launch": by_launch[b],
        "ms_by_launch_1_tile": by_launch[1],
        "grids_1_tile": grids1,
        "direct_route_ms": direct_ms,
        "max_abs_err_share_of_max": err / scale,
    }


def cudnn_tail_chain(torch, ht, weights, sr, dem, dtype):
    """K1's function as a chain of cuDNN convolutions on NCHW inputs (no layout
    changes): a library yardstick, timed here and used nowhere in the port.
    ``torch.float32`` runs under the card's strict-f32 setting (TF32 off);
    ``torch.bfloat16`` on bf16 tensors, with bf16 intermediates (which the
    kernel does not keep) and the head in f32. Returns the chain as a callable."""
    import torch.nn.functional as F

    w = dict(zip(ht.WEIGHT_KEYS, weights))
    oihw = {k: (v.permute(3, 2, 0, 1).contiguous() if v.ndim == 4 else v.t()[:, :, None, None].contiguous())
            for k, v in w.items() if k.endswith(("_w1", "_w2", "_pw", "head_w"))}
    h = {k: v.to(dtype) for k, v in {**w, **oihw}.items()}
    x = torch.cat([sr, dem], dim=-1).permute(0, 3, 1, 2).contiguous().to(dtype)

    def ar(v, a, c):
        return torch.relu(v * a[None, :, None, None] + c[None, :, None, None])

    def chain():
        y = F.conv2d(ar(x, h["f1_a1"], h["f1_c1"]), h["f1_w1"], h["f1_b1"], padding=1)
        y = F.conv2d(ar(y, h["f1_a2"], h["f1_c2"]), h["f1_w2"], h["f1_b2"], padding=1)
        y1 = y + F.conv2d(x, h["f1_pw"], h["f1_pb"])
        y = F.conv2d(ar(y1, h["f2_a1"], h["f2_c1"]), h["f2_w1"], h["f2_b1"], padding=1)
        y = F.conv2d(ar(y, h["f2_a2"], h["f2_c2"]), h["f2_w2"], h["f2_b2"], padding=1)
        return F.conv2d((y + y1).float(), oihw["head_w"], w["head_b"])

    return chain


# ---------------------------------------------------------------------------
# K1 at the JAX package's other two HR layouts (ResUNetConfig.hr_s2d)
# ---------------------------------------------------------------------------

#: hr_s2d of the layouts beside the flagship's 4, at the flagship's other
#: widths: 2 (round 1's artifacts: 64 + 32 -> 64 -> 4 on 256² a tile) and 1
#: (the original floodsr's full-resolution fusion: 32 + 32 -> 32 -> 1 on 512²).
HR_TAIL_LAYOUTS = (2, 1)
LAYOUT_TILES = 8     # K1's batch in the kernel phase, as the flagship's
LAYOUT_SCENE = 1024  # HR pixels a side of each layout's tohr scene (9 tiles)


def layout_config(s2d: int):
    """The flagship artifact's configuration with ``hr_s2d=s2d``."""
    import dataclasses
    import zipfile

    from floodsr_tpu_torch.nn.resunet import ResUNetConfig

    with zipfile.ZipFile(FLAGSHIP) as zf:
        cfg = ResUNetConfig.from_dict(json.loads(zf.read("manifest.json"))["config"])
    return dataclasses.replace(cfg, hr_s2d=s2d)


def layout_tail(torch, seed: int, s2d: int) -> dict:
    """K1's weights and inputs at one layout: the fuse blocks and head of
    ``init_resunet(seed, cfg)``, post-ReLU ``|normal|`` features on 8 tiles."""
    from floodsr_tpu_torch.nn.checkpoint import params_from_jax
    from floodsr_tpu_torch.nn.resunet import ResUNet, init_resunet
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    cfg = layout_config(s2d)
    model = ResUNet(cfg)
    model.load_state_dict(params_from_jax(*init_resunet(seed, cfg)), strict=True)
    model = model.eval().cuda()
    weights = ht.pack_hr_tail_weights(model.fuse[0], model.fuse[1], model.head, bn_eps=cfg.bn_eps)
    hw = cfg.hr_tile // s2d
    ca, cb = cfg.base_filters * s2d, cfg.fuse_filters
    rng = np.random.default_rng(seed + s2d)
    shape = (LAYOUT_TILES, hw, hw)
    sr = torch.from_numpy(np.abs(rng.normal(0, 1, (*shape, ca))).astype(np.float32)).cuda()
    dem = torch.from_numpy(np.abs(rng.normal(0, 1, (*shape, cb))).astype(np.float32)).cuda()
    return {"s2d": s2d, "weights": weights, "sr": sr, "dem": dem, "dims": (ca, cb, ca, s2d * s2d)}


def tail_work(sr, dem, weights, cm: int, ch: int) -> dict:
    """K1's work on these inputs: MACs; the bytes of one read of the inputs and
    the weights and one write of the output (the bound's); and the bytes each
    tensor-core route moves through device memory as designed, its
    intermediates included: the 3xTF32 route's four launches read x twice and
    write and read three f32 [.., Cm] tensors (y, y1, z; y1 twice); the bf16
    route's pre-pass reads x and writes bf16(x) twice, its launches store and
    read bf16 operands and y1 in f32 (csrc/hr_tail.cu's header); the bf16
    band route reads x once a unit, halos included (``band_plan``: 64 columns
    and the band's rows and 8 for 56 columns and its rows), and writes the
    output: no intermediate."""
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    b, h, w, ca = (int(v) for v in sr.shape)
    cin, pix = ca + int(dem.shape[3]), b * h * w
    rows, bands, strips = ht.band_plan(b, h, w)
    band_x = b * strips * bands * (rows + 2 * ht.BAND_HALO) * (ht.BAND_COLS + 2 * ht.BAND_HALO)
    return {
        "macs": pix * (9 * cin * cm + 3 * 9 * cm * cm + cin * cm + cm * ch),
        "bytes": pix * (cin + ch) * 4 + sum(t.numel() for t in weights) * 4,
        "route_bytes": {
            "tensor": pix * 4 * (2 * cin + 7 * cm + ch),
            "bf16": pix * (12 * cin + 20 * cm + 4 * ch),
            "bf16_band": band_x * cin * 4 + pix * ch * 4,
        },
    }


def hr_tail_layout_baseline(torch, t: dict) -> dict:
    """What K1 costs at a layout on the routes it had before it had tensor-core
    kernels there (the direct f32 and bf16 routes), beside the plain versions
    and the cuDNN chains, with the bounds: each route held against its plain
    version first, then timed at 8 tiles (CUDA events)."""
    from floodsr_tpu_torch.device import set_strict_f32
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    set_strict_f32()
    sr, dem, weights = t["sr"], t["dem"], t["weights"]
    ca, cb, cm, ch = t["dims"]
    want = ht.hr_tail_reference(sr, dem, *weights)
    want16 = ht.hr_tail_reference_bf16(sr, dem, *weights)
    direct = ht.hr_tail_cuda(sr, dem, *weights, route="direct")
    direct16 = ht.hr_tail_cuda(sr, dem, *weights, route="bf16_direct")
    torch.cuda.synchronize()
    scale, scale16 = want.abs().max().item(), want16.abs().max().item()
    err, err16 = (direct - want).abs().max().item(), (direct16 - want16).abs().max().item()
    if not (err <= 1e-4 * scale and err16 <= BF16_GATE * scale16):
        raise AssertionError(
            f"hr_tail s2d={t['s2d']} direct routes vs plain: f32 {err} of {scale}, bf16 {err16} of {scale16}"
        )
    work = tail_work(sr, dem, weights, cm, ch)
    macs, nbytes = work["macs"], work["bytes"]
    out = {
        "widths": f"{ca}+{cb}->{cm}->{ch}",
        "want": want, "want16": want16, "scale": scale, "scale16": scale16, "work": work,
        "direct_route_ms": time_ms(torch, lambda: ht.hr_tail_cuda(sr, dem, *weights, route="direct"), reps=3),
        "direct_bf16_route_ms": time_ms(
            torch, lambda: ht.hr_tail_cuda(sr, dem, *weights, route="bf16_direct"), reps=3
        ),
        "plain_ms": time_ms(torch, lambda: ht.hr_tail_reference(sr, dem, *weights), reps=5),
        "plain_bf16_ms": time_ms(torch, lambda: ht.hr_tail_reference_bf16(sr, dem, *weights), reps=5),
        "library_ms": time_ms(torch, cudnn_tail_chain(torch, ht, weights, sr, dem, torch.float32), reps=5),
        "library_bf16_ms": time_ms(
            torch, cudnn_tail_chain(torch, ht, weights, sr, dem, torch.bfloat16), reps=10
        ),
        "direct_max_abs_err": err, "direct_bf16_max_abs_err": err16,
        # 3xTF32: three TF32 products a MAC; bf16: one; the direct routes: f32 FMAs
        "bound_3xtf32": bound(nbytes, 3 * 2 * macs, PEAK_TF32_PER_S),
        "bound_bf16": bound(nbytes, 2 * macs, PEAK_BF16_PER_S),
        "bound_f32": bound(nbytes, 2 * macs),
        "route_bytes_ms": {k: v / PEAK_BYTES_PER_S * 1e3 for k, v in work["route_bytes"].items()},
    }
    log(
        f"[hr_tail layouts] s2d={t['s2d']} {out['widths']} at {tuple(sr.shape[:3])}: direct route "
        f"{out['direct_route_ms']:.3f} ms (bound {out['bound_f32'][0]:.3f}, f32 on the CUDA cores), "
        f"direct bf16 route {out['direct_bf16_route_ms']:.3f} ms, plain {out['plain_ms']:.3f} / "
        f"{out['plain_bf16_ms']:.3f} ms, cuDNN chain TF32 off {out['library_ms']:.3f} ms, on bf16 "
        f"tensors {out['library_bf16_ms']:.3f} ms; bounds 3xTF32 {out['bound_3xtf32']}, bf16 "
        f"{out['bound_bf16']}; the routes' own traffic {json.dumps(out['route_bytes_ms'])} ms at "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; max |direct - plain| {err:.3e} (f32, of {scale:.3e}), "
        f"{err16:.3e} (bf16, of {scale16:.3e})"
    )
    return out


def peak_mib(torch, fn) -> float:
    """Device memory one call of ``fn`` allocates at its peak above what was
    allocated before it (its output and any workspace), MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak / 2**20


def phase_hr_tail_layouts(torch, seed: int) -> dict:
    """K1's tensor-core routes at ``hr_s2d`` 2 and 1 (3xTF32, and bf16 on the
    band route: one launch, every intermediate on chip) against their plain
    versions at 8 tiles and at 1, then timed beside the direct routes they
    replace, the plain versions and the cuDNN chains, with the peak device
    memory of one 8-tile call; the band route's one-tile grid read from the
    trace. Returns an entry per layout for each of the two routes."""
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht
    from floodsr_tpu_torch.ops.kernels import reset_launch_counts

    entries = {"tensor": {}, "bf16_band": {}}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for s2d in HR_TAIL_LAYOUTS:
        t = layout_tail(torch, seed, s2d)
        base = hr_tail_layout_baseline(torch, t)
        sr, dem, weights = t["sr"], t["dem"], t["weights"]
        ca, cb, cm, ch = t["dims"]
        if not ht.tc_eligible(ca, cb, cm, ch):
            raise AssertionError(f"hr_tail s2d={s2d}: {base['widths']} is not a tensor-core width")
        packs = {"tensor": ht.pack_hr_tail_tc(weights), "bf16_band": ht.pack_hr_tail_bf16(weights)}
        modes = {"tensor": "f32", "bf16_band": "bf16"}
        for route, pack in packs.items():
            bf16 = route == "bf16_band"
            want = base["want16" if bf16 else "want"]
            scale = base["scale16" if bf16 else "scale"]

            def call(tiles, pack=pack, route=route):
                return ht.hr_tail(sr[:tiles], dem[:tiles], *weights, tc_pack=pack, mode=modes[route])

            reset_launch_counts()
            got, got1, again = call(LAYOUT_TILES), call(1), call(LAYOUT_TILES)
            torch.cuda.synchronize()
            if ht.route_launches != {**dict.fromkeys(ht.route_launches, 0), route: 3}:
                raise AssertionError(f"hr_tail s2d={s2d} took another route than {route}: {ht.route_launches}")
            if not torch.equal(got, again):
                raise AssertionError(f"hr_tail s2d={s2d} {route} route: two calls on the same inputs differ")
            err = (got - want).abs().max().item()
            err1 = (got1 - want[:1]).abs().max().item()
            report = {"max_abs_err": err, "max_abs_err_1_tile": err1, "max_abs_plain": scale}
            if route == "tensor":
                # 3xTF32 summed in the tensor core's f32 accumulator: the
                # flagship's bar, 1e-4 of the output's range
                ok = max(err, err1) <= 1e-4 * scale
            else:
                rms = (got - want).square().mean().sqrt().item()
                gap = (want - base["want"]).square().mean().sqrt().item()
                report.update(rms_err=rms, rms_bf16_vs_f32=gap)
                ok = max(err, err1) <= BF16_GATE * scale and rms < 0.25 * gap
            if not ok:
                raise AssertionError(f"hr_tail s2d={s2d} {route} route vs plain: {report}")
            ms = time_ms(torch, lambda: call(LAYOUT_TILES), reps=10)
            ms1 = time_ms(torch, lambda: call(1), reps=10)
            prof = device_profile(torch, lambda: [call(LAYOUT_TILES) for _ in range(3)])
            if bf16:
                # one launch a call, the band kernel's alone: no pre-pass, no
                # launch that stores an intermediate
                if prof["kernel_events"]["hr_tail"] != 3:
                    raise AssertionError(
                        f"hr_tail s2d={s2d} bf16_band route: {prof['kernel_events']['hr_tail']} "
                        f"launches in 3 calls; top {json.dumps(prof['top_device_ms'])}"
                    )
                by_launch = {"band": prof["kernel_device_ms"]["hr_tail"] / 3}
                # one tile must still fill the card: the grid from the trace
                grids = device_profile(torch, lambda: call(1), grids_of=("bf16_band_kernel",))["grids"]
                blocks1 = min(int(np.prod(g)) for g in grids["bf16_band_kernel"])
                rows, bands, strips = ht.band_plan(1, *sr.shape[1:3], sms)
                if blocks1 < 128 or blocks1 != bands * strips:
                    raise AssertionError(
                        f"hr_tail s2d={s2d} bf16_band route: a one-tile launch of {grids} blocks, "
                        f"band_plan {bands} x {strips}"
                    )
                report["grids_1_tile"] = grids["bf16_band_kernel"]
            else:
                by_launch = {k: v / 3 for k, v in prof["hr_tail_tc_ms_by_launch"].items()}
            bound_ms, bound_by = base["bound_bf16" if bf16 else "bound_3xtf32"]
            # one tile's bound: its share of the 8 tiles' work
            bound_1_ms = bound_ms / LAYOUT_TILES
            direct_ms = base["direct_bf16_route_ms" if bf16 else "direct_route_ms"]
            library_ms = base["library_bf16_ms" if bf16 else "library_ms"]
            route_bytes_ms = base["route_bytes_ms"][route]
            peak = peak_mib(torch, lambda: call(LAYOUT_TILES))
            entries[route][f"{cm},{ch}"] = {
                "hr_s2d": s2d, "widths": base["widths"], "route": route, "ms": ms, "ms_1_tile": ms1,
                "ms_by_launch": by_launch, "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / ms, "share_of_bound_1_tile": bound_1_ms / ms1,
                "route_bytes_ms": route_bytes_ms, "peak_mib_8_tiles": peak,
                "plain_ms": base["plain_bf16_ms" if bf16 else "plain_ms"],
                "library_ms": library_ms, "direct_route_ms": direct_ms, "launches": None, **report,
            }
            log(
                f"[hr_tail layouts] s2d={s2d} {base['widths']} {route} route {ms:.3f} ms at "
                f"{LAYOUT_TILES} tiles ({bound_ms / ms:.1%} of the bound {bound_ms:.3f} ms, {bound_by}; "
                f"its own traffic {route_bytes_ms:.3f} ms), one tile {ms1:.3f} ms "
                f"({bound_1_ms / ms1:.1%} of {bound_1_ms:.3f} ms), by launch "
                f"{json.dumps(by_launch)}; peak {peak:.1f} MiB a call of {LAYOUT_TILES} tiles; "
                f"the direct route it replaces {direct_ms:.3f} ms "
                f"({direct_ms / ms:.2f}x), cuDNN chain {library_ms:.3f} ms; {json.dumps(report)}"
            )
        del t, base
        torch.cuda.empty_cache()
    usage = ptxas_usage(
        "hr_tail", ("conv_tc_kernel", "conv_tc_rs_kernel", "conv_bf16_kernel", "conv_bf16_head_kernel",
                    "bf16_band_kernel")
    )
    for kernel, line in usage.items():
        log(f"[hr_tail layouts] ptxas {kernel}: {line}")
    return entries


@contextlib.contextmanager
def k1_plain_on_card(ht):
    """K1 through its plain version for CUDA tensors too: the kernels'
    yardstick inside a scene, with everything around K1 unchanged."""
    kernel = ht.hr_tail

    def plain(sr, dem, *weights, tc_pack=None, mode="f32"):
        reference = ht.hr_tail_reference_bf16 if mode == "bf16" else ht.hr_tail_reference
        return reference(sr, dem, *weights)

    ht.hr_tail = plain
    try:
        yield
    finally:
        ht.hr_tail = kernel


def phase_layout_scenes(torch, seed: int) -> dict:
    """``tohr`` on a 1024² scene (9 tiles) with an artifact of each layout,
    from ``init_resunet(seed, cfg)`` + ``save_artifact``, under ``float32`` and
    ``bfloat16``: K1 on its tensor-core route at every call (no direct launch).
    f32: the raster against ``device="cpu"``'s at 1e-3 m RMSE (BASELINE.md).
    bf16: against the same scene on the card with K1 through its plain
    version, within a quarter of the policy's own distance to f32. The
    distance to ``device="cpu"``'s bf16 raster is logged, with K1's kernel and
    with its plain version: it comes from the bf16 trunk and SR upsample,
    not from K1 (the two are equal, PERF.md). Returns K1's launches by layout
    and policy."""
    from floodsr_tpu_torch.io import read_raster
    from floodsr_tpu_torch.nn.checkpoint import save_artifact
    from floodsr_tpu_torch.nn.resunet import init_resunet
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht
    from floodsr_tpu_torch.tohr import tohr

    want_route = {"float32": "tensor", "bfloat16": "bf16_band"}
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-layouts-") as tmp:
        tmp = Path(tmp)
        dem_fp, depth_fp = scene_inputs(tmp, seed, LAYOUT_SCENE, tag="_layouts")
        for s2d in HR_TAIL_LAYOUTS:
            cfg = layout_config(s2d)
            model_fp = save_artifact(tmp / f"s2d{s2d}.fsrz", cfg, *init_resunet(seed, cfg), {"seed": seed})
            rasters, report = {}, {}
            for dtype, route in want_route.items():
                kw = dict(
                    model_version="ResUNet_16x_DEM", model_fp=model_fp, depth_lr_fp=depth_fp,
                    dem_hr_fp=dem_fp, engine_options={"compute_dtype": dtype, "output_transfer": "float32"},
                )

                def raster(tag, device="cuda", **extra):
                    fp = tmp / f"s2d{s2d}_{dtype}_{tag}.tif"
                    tohr(output_fp=fp, device=device, **kw, **extra)
                    return read_raster(fp)[0]

                run = timed_tohr(torch, output_fp=tmp / f"s2d{s2d}_{dtype}.tif", device="cuda", **kw)
                k1 = run["routes"]["hr_tail"]
                if not (k1[route] > 0 and k1 == {**dict.fromkeys(k1, 0), route: k1[route]}):
                    raise AssertionError(f"s2d={s2d} {dtype} scene: hr_tail by route {k1}, expected {route} only")
                with k1_plain_on_card(ht):
                    plain = raster("plain_k1")
                cpu = raster("cpu", device="cpu")
                rasters[dtype] = run["pred"]
                report[dtype] = {
                    "e2e_s": run["e2e_s"], "exec_s": run["timings"]["exec_s"], "tiles": run["tiles"],
                    "hr_tail_by_route": k1, "rmse_vs_plain_k1_m": rmse_m(run["pred"], plain),
                    "rmse_card_vs_cpu_m": rmse_m(run["pred"], cpu),
                    "rmse_plain_k1_vs_cpu_m": rmse_m(plain, cpu),
                    "max_abs_card_vs_cpu_m": float(np.abs(run["pred"] - cpu).max()),
                    "mean_m": float(run["pred"].mean()),
                }
            gap = rmse_m(rasters["bfloat16"], rasters["float32"])
            report["bfloat16"]["rmse_vs_f32_m"] = gap
            if not report["float32"]["rmse_card_vs_cpu_m"] <= 1e-3:
                raise AssertionError(f"s2d={s2d} f32 scene, the card against the CPU: {report}")
            if not (gap > 0.0 and report["bfloat16"]["rmse_vs_plain_k1_m"] < 0.25 * gap):
                raise AssertionError(f"s2d={s2d} bfloat16 scene, K1 against its plain version: {report}")
            log(f"[layout scenes] s2d={s2d} {LAYOUT_SCENE}x{LAYOUT_SCENE} {json.dumps(report)}")
            out[s2d] = {dtype: report[dtype]["hr_tail_by_route"][route] for dtype, route in want_route.items()}
    return out


def ptxas_usage(source: str, kernels: tuple) -> dict:
    """``-Xptxas -v``'s registers, shared memory and spills for each instance of
    the named kernels (a template's as ``name<arguments>``), from the last
    build log of ``csrc/<source>.cu``."""
    from floodsr_tpu_torch.ops.kernels import _build

    def label(mangled):
        for k in kernels:
            m = re.search(rf"{k}(I(?:L[ib]\d+E)+E)?", mangled)
            if m:
                args = re.findall(r"L[ib](\d+)E", m.group(1) or "")
                return f"{k}<{','.join(args)}>" if args else k
        return None

    out, current = {}, None
    for line in (_build.BUILD_DIR / f"{source}.log").read_text().splitlines():
        m = re.search(r"(?:entry function|properties for|(?:in|for) the function) '?(\w+)", line)
        if m:
            current = label(m.group(1))
            note = re.search(r"\(C\d+\)[^:]*", line)
            if current is None or note is None:
                continue
            line = note.group(0)
        elif not (current and ("registers" in line or "spill" in line)):
            continue
        out[current] = (out.get(current, "") + "; " + line.split(":", 1)[-1].strip()).strip("; ")
    return out


def narrow_tail_weights(torch, rng, ca: int, cb: int, cm: int, ch: int) -> list:
    """Random ``hr_tail`` weights of the given widths, on the card."""
    from floodsr_tpu_torch.ops.kernels.hr_tail import WEIGHT_KEYS

    cin = ca + cb
    shapes = {
        "f1_a1": (cin,), "f1_c1": (cin,), "f1_w1": (3, 3, cin, cm), "f1_b1": (cm,),
        "f1_a2": (cm,), "f1_c2": (cm,), "f1_w2": (3, 3, cm, cm), "f1_b2": (cm,),
        "f1_pw": (cin, cm), "f1_pb": (cm,),
        "f2_a1": (cm,), "f2_c1": (cm,), "f2_w1": (3, 3, cm, cm), "f2_b1": (cm,),
        "f2_a2": (cm,), "f2_c2": (cm,), "f2_w2": (3, 3, cm, cm), "f2_b2": (cm,),
        "head_w": (cm, ch), "head_b": (ch,),
    }
    out = []
    for key in WEIGHT_KEYS:
        shape = shapes[key]
        if key.endswith(("_a1", "_a2")):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) > 1:
            v = rng.normal(0.0, 1.0 / np.sqrt(int(np.prod(shape[:-1]))), shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        out.append(torch.from_numpy(v.astype(np.float32)).cuda())
    return out


def phase_tohr_cases(torch) -> None:
    from floodsr_tpu_torch.eval import compute_depth_error_metrics, depth_metrics_torch
    from floodsr_tpu_torch.io import read_raster
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, route_counts
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
                on_card = depth_metrics_torch(
                    torch.from_numpy(truth).cuda(), torch.from_numpy(pred).cuda(), max_depth=5.0
                )
                for key, value in on_card.items():
                    host = metrics.get(key)
                    if value.device.type != "cuda" or (
                        host is not None and round(float(value), 3) != round(float(host), 3)
                    ):
                        raise AssertionError(
                            f"{case_dir.name}/{label}: depth_metrics_torch {key}={float(value)} "
                            f"on {value.device}, numpy {host}"
                        )
                precision = int(run["metrics"].get("precision", 3))
                got = {k: round(float(metrics[k]), precision) for k in ("mase_m", "rmse_m", "ssim")}
                want = {k: round(float(run["metrics"][k]), precision) for k in got}
                log(
                    f"[tohr] {case_dir.name}/{label}: {got} (expected {want}; csi on the card "
                    f"{float(on_card['csi']):.4f}) "
                    f"launches {counts} tiles {diag['preprocess']['tile_cache_size']}"
                )
                if got != want:
                    raise AssertionError(f"{case_dir.name}/{label}: {got} != {want}")
                if counts["tile_stats"] <= 0:
                    raise AssertionError(f"{case_dir.name}: tile_stats kernel never launched")
                if case_dir.name == "synth_flagship" and (
                    counts["hr_tail"] <= 0 or route_counts()["hr_tail"]["tensor"] != counts["hr_tail"]
                ):
                    raise AssertionError(
                        f"synth_flagship: hr_tail's tensor-core route did not run: {route_counts()}"
                    )


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


def scene_inputs(
    tmp: Path, seed: int, size: int, tag: str = "", dem: bool = True, dem_size: "int | None" = None,
) -> tuple["Path | None", Path]:
    """A ``size``² HR DEM and a ``size/16``² LR depth from ``seed``, as GeoTIFFs.

    With ``dem=False`` only the depth is written (another scene over a DEM
    that exists already): the DEM's path comes back as ``None``. ``dem_size``
    writes the DEM as a raster of that many pixels a side over the same
    extent: the model still runs at ``size``² and its output is resampled onto
    the DEM's own grid.
    """
    from floodsr_tpu_torch.io import from_origin, write_raster

    rng = np.random.default_rng(seed)
    scale = 16
    lr = size // scale
    hr_res, lr_res = 2.0, 2.0 * scale
    x0, y0 = 500000.0, 4000000.0 + size * hr_res
    dem_px = size if dem_size is None else int(dem_size)
    dem_arr = (
        300.0
        + np.cumsum(rng.normal(0.0, 0.3, (dem_px, dem_px)), axis=1)
        + np.linspace(0.0, 60.0, dem_px)[:, None]
    ).astype(np.float32)
    depth = np.clip(rng.gamma(1.5, 0.6, (lr, lr)) - 0.4, 0.0, 5.0).astype(np.float32)

    def profile(shape, res):
        return {
            "height": shape[0], "width": shape[1], "count": 1,
            "dtype": "float32", "crs": "EPSG:32633", "nodata": -9999.0,
            "transform": from_origin(x0, y0, res, res), "compress": "LZW",
        }

    dem_fp, depth_fp = tmp / f"dem{tag}.tif", tmp / f"depth{tag}.tif"
    if dem:
        write_raster(dem_fp, dem_arr, profile(dem_arr.shape, hr_res * size / dem_px))
    write_raster(depth_fp, depth, profile(depth.shape, lr_res))
    return (dem_fp if dem else None), depth_fp


# Kernel-name fragments of each hand-written kernel, for its share of the
# traced device time.
KERNEL_NAMES = {
    "tile_stats": ("tile_stats_one_read_kernel", "tile_stats_stream_kernel"),
    "hr_tail": (
        "conv_tc_", "conv_bf16_kernel", "conv_bf16_head_kernel", "bf16_prepass_kernel",
        "bf16_band_kernel", "affine_relu_conv3x3_kernel", "conv1x1_kernel",
    ),
    "relax_step": ("relax_step_kernel",),
}
# The four convolution launches of one hr_tail call on either tensor-core
# route, in order (the bf16 route's pre-pass comes before them).
HR_TAIL_TC_LAUNCHES = ("f1.conv1", "f1.conv2 + proj", "f2.conv1", "f2.conv2 + y1 + head")


def device_profile(torch, run, grids_of: tuple = ()) -> dict:
    """``torch.profiler`` over one ``run()``: device time by kernel and busy time.

    Only device-side events (kernels, copies, sets) are summed: an operator's
    row in ``key_averages()`` repeats the time of the kernels it launched.
    Busy time is the union of those events' intervals. Raises if a kernel of
    ``KERNEL_NAMES`` that ``run()`` launched shows no traced device time.
    For each name in ``grids_of``, the grids its launches had, as the trace
    records them (``grids``: name -> sorted distinct ``[x, y, z]``).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True
    ) as prof:
        run()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    spans = []
    by_name = {}
    n_by_name = {}
    # (conv_tc_ matches the 3xTF32 route's kernel at every width, conv_tc_kernel
    # and the small widths' conv_tc_rs_kernel; conv_bf16_ the bf16 route's
    # three body launches and its head's)
    conv_events = {"conv_tc_": [], "conv_bf16_": []}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        t_start, t_end = float(evt.time_range.start), float(evt.time_range.end)
        if t_end <= t_start:
            continue
        spans.append((t_start, t_end))
        by_name[evt.name] = by_name.get(evt.name, 0.0) + (t_end - t_start)
        n_by_name[evt.name] = n_by_name.get(evt.name, 0) + 1
        for kname, events in conv_events.items():
            if kname in evt.name:
                events.append((t_start, t_end - t_start))
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
    # device launches by kernel, as the trace records them (a K1 call is
    # four to six launches, a K2 or K3 call one)
    kernel_events = {
        kname: sum(n for name, n in n_by_name.items() if any(f in name for f in frags))
        for kname, frags in KERNEL_NAMES.items()
    }
    for kname, count in launch_counts().items():
        if count > 0 and not kernel_ms[kname] > 0.0:
            raise AssertionError(
                f"{kname} launched {count} time(s) in the traced run but no device event "
                f"matches {KERNEL_NAMES[kname]}"
            )
    # K1's device time by its place in a call (one stream, so start order is
    # launch order), for each tensor-core route.
    by_launch = {}
    for kname, events in conv_events.items():
        events.sort()
        if len(events) % len(HR_TAIL_TC_LAUNCHES):
            raise AssertionError(f"{len(events)} {kname} launches are not whole hr_tail calls")
        by_launch[kname] = {
            name: sum(us for _, us in events[i :: len(HR_TAIL_TC_LAUNCHES)]) / 1e3
            for i, name in enumerate(HR_TAIL_TC_LAUNCHES)
        }
    by_launch["conv_bf16_"]["pre-pass"] = sum(
        us for name, us in by_name.items() if "bf16_prepass_kernel" in name
    ) / 1e3
    grids = {}
    if grids_of:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-trace-") as tmp:
            trace_fp = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(trace_fp))
            trace = json.loads(trace_fp.read_text())
        for kname in grids_of:
            found = {
                tuple(evt["args"]["grid"])
                for evt in trace["traceEvents"]
                if evt.get("cat") == "kernel" and re.search(rf"\b{kname}\b", evt.get("name", ""))
            }
            if not found:
                raise AssertionError(f"the trace records no grid of {kname}")
            grids[kname] = sorted(list(g) for g in found)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # The traced run's wall time includes the profiler's own overhead; the
    # caller sets the device busy time against an untraced run instead.
    return {
        "traced_wall_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_event_sum_s": sum(by_name.values()) / 1e6,
        "kernel_device_ms": kernel_ms,
        "kernel_events": kernel_events,
        "hr_tail_tc_calls": len(conv_events["conv_tc_"]) // len(HR_TAIL_TC_LAUNCHES),
        "hr_tail_tc_ms_by_launch": by_launch["conv_tc_"],
        "hr_tail_bf16_calls": len(conv_events["conv_bf16_"]) // len(HR_TAIL_TC_LAUNCHES),
        "hr_tail_bf16_ms_by_launch": by_launch["conv_bf16_"],
        "kernel_share_of_busy": {k: v / (busy_us / 1e3) for k, v in kernel_ms.items()},
        "top_device_ms": {k[:80]: v / 1e3 for k, v in top},
        "grids": grids,
    }


def phase_scene(torch, seed: int, size: int, with_profile: bool = False) -> dict:
    from floodsr_tpu_torch.io import read_raster
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, route_counts
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
        routes = route_counts()
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
        f"peak allocated {peak / 2**20:.1f} MiB; launches {counts}, by route {routes}"
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
    for name, route in (("tile_stats", "one_read"), ("hr_tail", "tensor")):
        if counts[name] <= 0:
            raise AssertionError(f"timed scene: {name} kernel never launched")
        if routes[name][route] != counts[name]:
            raise AssertionError(
                f"timed scene: {name} took another route than {route!r}: {routes[name]}"
            )
    return {"launches": counts, "e2e_s": e2e_s, "tiles": tiles, "timings": timings}


# ---------------------------------------------------------------------------
# CostGrow: relax_step (K3), the solves, and both workers
# ---------------------------------------------------------------------------


def relax_grid(rng, h: int, w: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(dist0, value0, cost)``: terrain-like costs in [1, 5] with ``inf`` walls.

    A few hundred seeds, one on the grid's edge and one in its corner; two of
    them lie 8 cells apart on a flat patch of cost 1, so the cells between
    them are reached at exactly the same distance from both (a tie).
    """
    rough = np.cumsum(rng.normal(0.0, 0.05, (h, w)).astype(np.float32), axis=1)
    cost = (3.0 + 2.0 * np.sin(rough + np.linspace(0.0, 9.0, h, dtype=np.float32)[:, None]))
    cost = np.clip(cost, 1.0, 5.0).astype(np.float32)
    for k in range(6):  # walls with gaps
        r = (k + 1) * h // 7
        cost[r, : w - (k + 1) * w // 9] = np.inf
        c = (k + 1) * w // 7
        cost[(k + 1) * h // 11 :, c] = np.inf
    cost[16:32, 16:48] = 1.0
    dist = np.full((h, w), np.inf, np.float32)
    value = np.full((h, w), np.nan, np.float32)
    n = 300
    cells = list(zip(rng.integers(0, h, n).tolist(), rng.integers(0, w, n).tolist()))
    cells += [(0, 0), (h - 1, w // 2), (24, 24), (24, 32)]
    for k, (r, c) in enumerate(cells):
        if np.isfinite(cost[r, c]):
            dist[r, c], value[r, c] = 0.0, 100.0 + 0.01 * k
    return dist, value, cost


def same_state(torch, got, want) -> float:
    """Raise unless ``(dist, value)`` pairs are equal bit for bit (NaN payloads
    aside); returns the largest |difference| over the finite cells (0.0)."""
    (gd, gv), (wd, wv) = got, want
    if not torch.equal(gd, wd):
        bad = int((gd != wd).sum())
        raise AssertionError(f"relax_step kernel != plain version: {bad} distances differ")
    if not torch.equal(torch.isnan(gv), torch.isnan(wv)):
        raise AssertionError("relax_step kernel != plain version: NaN patterns differ")
    if not torch.equal(torch.nan_to_num(gv, nan=0.0), torch.nan_to_num(wv, nan=0.0)):
        raise AssertionError("relax_step kernel != plain version: values differ")
    fin = torch.isfinite(wd)
    return float((gd[fin] - wd[fin]).abs().max()) if bool(fin.any()) else 0.0


def phase_relax_step(torch, rng) -> dict:
    from floodsr_tpu_torch.ops.kernels import relax_step as rs

    err = 0.0
    for h, w in ((SCENE_SIZE, SCENE_SIZE), (1000, 1537)):
        dist, value, cost = (torch.from_numpy(a).cuda() for a in relax_grid(rng, h, w))
        got, want = (dist, value), (dist, value)
        for step in range(1, 65):
            got = rs.relax_step_cuda(*got, cost)
            want = rs.relax_step_reference(*want, cost)
            if step in (1, 64):
                torch.cuda.synchronize()
                err = max(err, same_state(torch, got, want))
        reached = int(torch.isfinite(got[0]).sum())
        tie = got[0][24, 28].item()
        log(
            f"[relax_step] [{h},{w}] bitwise equal to plain after 1 and 64 relaxations; "
            f"{reached} cells reached, tie cell (24,28) dist {tie} value {got[1][24, 28].item()}"
        )
        if (h, w) != (SCENE_SIZE, SCENE_SIZE):
            continue
        # Timed at the scene's size on the 64-step state; each call relaxes
        # the last one's result, as mcp_fill does.
        state = {"cur": got}

        def step_kernel():
            state["cur"] = rs.relax_step_cuda(*state["cur"], cost)

        ms = time_ms(torch, step_kernel, reps=50)
        plain_ms = time_ms(torch, lambda: rs.relax_step_reference(*got, cost), reps=3, warmup=1)
        # 3 arrays read, 2 written; per cell 8 candidates of 2 adds, 1
        # multiply and 1 compare.
        bound_ms, bound_by = bound(nbytes=5 * h * w * 4, nops=8 * 4 * h * w)
        log(
            f"[relax_step] [{h},{w}] kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {5 * h * w * 4 / (ms * 1e-3) / 1e9:.1f} GB/s "
            f"of the bound's bytes; no library call computes this"
        )
    return {
        "name": "relax_step",
        "route": "cuda",
        "source": "floodsr_tpu_torch/csrc/relax_step.cu",
        "replaces": "floodsr_tpu/ops/pallas/costgrow_stencil.py:141",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": None,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "launches": None,
    }


def phase_mcp_fill_oracle(torch, rng) -> None:
    """``mcp_fill`` on the card against the sequential Dijkstra oracle, 512²."""
    from floodsr_tpu_torch.ops import costgrow as cg
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    h = w = 512
    cost = rng.uniform(1.0, 5.0, (h, w)).astype(np.float32)
    domain = rng.random((h, w)) > 0.08
    domain[200:204, 40:480] = False  # a wall
    seeds = rng.random((h, w)) > 0.9995
    seeds[0, 0] = True
    seed_values = np.where(seeds, rng.uniform(100.0, 120.0, (h, w)), np.nan).astype(np.float32)
    stats = {}
    reset_launch_counts()
    filled, dist = cg.mcp_fill(
        *(torch.from_numpy(a).cuda() for a in (seed_values, seeds, cost, domain)), stats=stats
    )
    launches = launch_counts()["relax_step"]
    filled, dist = filled.cpu().numpy(), dist.cpu().numpy()
    t0 = time.perf_counter()
    want_fill, want_dist = cg.mcp_fill_numpy(seed_values, seeds, cost, domain)
    oracle_s = time.perf_counter() - t0
    finite = np.isfinite(want_dist)
    if not np.array_equal(np.isfinite(dist), finite):
        raise AssertionError("mcp_fill: reached cells differ from the Dijkstra oracle's")
    # f32 sums along a path against the oracle's float64.
    np.testing.assert_allclose(dist[finite], want_dist[finite], rtol=1e-4)
    if not np.array_equal(np.isnan(filled), np.isnan(want_fill)):
        raise AssertionError("mcp_fill: filled cells differ from the Dijkstra oracle's")
    ok = np.isfinite(want_fill)
    differs = float((filled[ok] != want_fill[ok]).mean())
    log(
        f"[mcp_fill] 512x512, {int(seeds.sum())} seeds: {stats['relaxations']} relaxations "
        f"({launches} launches), {stats['checks']} checks, {stats['seconds']:.3f} s on the card; "
        f"Dijkstra oracle {oracle_s:.1f} s on the host; distances within rtol 1e-4, "
        f"filled values differ on {differs:.5%} of cells (ties)"
    )
    if launches != stats["relaxations"] or launches <= 0:
        raise AssertionError(f"mcp_fill: {launches} launches for {stats['relaxations']} relaxations")
    if differs > 0.05:
        raise AssertionError(f"mcp_fill: {differs:.3%} of filled values differ from the oracle")


def valley_scene(tmp: Path, seed: int, size: int, scale: int = 16) -> dict:
    """A ``size``² valley DEM and a ``size/scale``² WSE over its channel.

    The valley runs west to east and falls 3 m along the way; its sides rise
    1 cm per pixel, with small roughness. Side channels 2 m deep run up the
    northern slope. A block of nodata sits in the channel. The WSE covers a
    band over the channel, 2.5 m above the valley floor.
    """
    from floodsr_tpu_torch.io import from_origin, write_raster

    rng = np.random.default_rng(seed)
    lr = size // scale
    hr_res, lr_res = 2.0, 2.0 * scale
    x0, ytop = 500000.0, 4000000.0 + size * hr_res
    yy = np.abs(np.arange(size, dtype=np.float32) - size / 2)[:, None]
    fall = np.linspace(3.0, 0.0, size, dtype=np.float32)[None, :]
    dem = (100.0 + yy * 0.01 * (4096 / size) + fall).astype(np.float32)
    dem += rng.normal(0.0, 0.02, (size, size)).astype(np.float32)
    for k in range(1, 6):  # side channels up the northern slope
        c = k * size // 6
        dem[: size // 2, c : c + max(2, size // 512)] -= 2.0
    hole = np.s_[
        size // 2 - size // 40 : size // 2 + size // 40,
        3 * size // 4 : 3 * size // 4 + size // 20,
    ]
    nodata = -9999.0
    dem_out = dem.copy()
    dem_out[hole] = nodata
    wse = np.full((lr, lr), nodata, np.float32)
    band_rows = 2 * max(1, lr // 32)
    wse[lr // 2 - band_rows // 2 : lr // 2 + band_rows // 2, :] = 102.5 + np.linspace(3.0, 0.0, lr, dtype=np.float32)[None, :]
    depth = np.where(wse == nodata, nodata, 1.25).astype(np.float32)

    def profile(shape, res):
        return {
            "height": shape[0], "width": shape[1], "count": 1,
            "dtype": "float32", "crs": "EPSG:32633", "nodata": nodata,
            "transform": from_origin(x0, ytop, res, res), "compress": "LZW",
        }

    fps = {k: tmp / f"valley{size}_{k}.tif" for k in ("dem", "wse", "depth")}
    write_raster(fps["dem"], dem_out, profile(dem.shape, hr_res))
    write_raster(fps["wse"], wse, profile(wse.shape, lr_res))
    write_raster(fps["depth"], depth, profile(depth.shape, lr_res))
    # A building across the channel, a quarter of the way along it.
    bx0 = x0 + (size // 4) * hr_res
    by0 = ytop - (size // 2 + size // 16) * hr_res
    bx1, by1 = bx0 + max(3, size // 64) * hr_res, by0 + (size // 8) * hr_res
    fps["buildings"] = tmp / f"valley{size}_buildings.geojson"
    fps["buildings"].write_text(json.dumps({
        "type": "Polygon",
        "crs": {"type": "name", "properties": {"name": "EPSG:32633"}},
        "coordinates": [[[bx0, by0], [bx1, by0], [bx1, by1], [bx0, by1], [bx0, by0]]],
    }))
    fps.update(dem_arr=dem, hole=hole, scale=scale, band_rows=band_rows * scale)
    return fps


COSTGROW_VERSIONS = ("CostGrow", "CostGrow_pcraster")


def costgrow_params(tmp: Path) -> dict:
    """Each version's default parameter artifact, materialized offline."""
    from floodsr_tpu_torch.model_registry import fetch_model

    return {v: fetch_model(v, cache_dir=tmp / "models") for v in COSTGROW_VERSIONS}


def read_wse(fp) -> np.ndarray:
    from floodsr_tpu_torch.io import read_raster

    arr, nodata, _ = read_raster(fp)
    return np.where(np.isclose(arr, nodata), np.nan, arr).astype(np.float32)


def phase_costgrow_scene(torch, seed: int, size: int, with_profile: bool = False) -> dict:
    """``tohr`` for both CostGrow versions at full size, default parameters."""
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from floodsr_tpu_torch.tohr import tohr

    stage_log = _StageLog()
    logger = logging.getLogger("chip_smoke.costgrow")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    logger.addHandler(stage_log)
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-costgrow-") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        scene = valley_scene(tmp, seed, size)
        params = costgrow_params(tmp)
        log(f"[costgrow] {size}x{size} valley written in {time.perf_counter() - t0:.1f} s")
        for version in COSTGROW_VERSIONS:
            out_fp = tmp / f"{version}.tif"
            kw = dict(
                model_version=version, model_fp=params[version], depth_lr_fp=scene["wse"],
                dem_hr_fp=scene["dem"], output_fp=out_fp, device="cuda", logger=logger,
            )
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stage_log.stages.clear()
            reset_launch_counts()
            t0 = time.perf_counter()
            diag = tohr(**kw)
            torch.cuda.synchronize()
            e2e_s = time.perf_counter() - t0
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            pre, solves = diag["preprocess"], diag["solves"]
            out = read_wse(out_fp)
            wet = np.isfinite(out)
            solve_s = sum(s["seconds"] for s in solves.values())
            relaxations = sum(s["relaxations"] for s in solves.values())
            log(
                f"[costgrow] {version} {size}x{size} from {size // scene['scale']}² WSE: "
                f"{e2e_s:.3f} s end to end, {solve_s:.3f} s in {len(solves)} solve(s), "
                f"{relaxations} relaxations ({counts['relax_step']} K3 launches), "
                f"{sum(s['checks'] for s in solves.values())} convergence checks, "
                f"wet {int(wet.sum())} cells, peak allocated {peak / 2**20:.1f} MiB"
            )
            log(f"[costgrow] {version} solves {json.dumps(solves)}")
            log(f"[costgrow] {version} worker stages (s) {json.dumps(stage_log.stages)}")
            assert out.shape == (size, size), out.shape
            assert pre["downscale"] == scene["scale"], pre["downscale"]
            assert pre["wet_pixel_count"] == int(wet.sum()) > 0
            assert (out[wet] > scene["dem_arr"][wet]).all(), "a wet cell's WSE is not above the DEM"
            assert not wet[scene["hole"]].any(), "a wet cell in the DEM's nodata hole"
            # The band under the WSE is wet, and growth went beyond it.
            assert wet.sum() > scene["band_rows"] * size
            if counts["relax_step"] != relaxations or relaxations <= 0:
                raise AssertionError(
                    f"{version}: {counts['relax_step']} K3 launches for {relaxations} relaxations"
                )
            results[version] = {
                "launches": counts, "e2e_s": e2e_s, "solve_s": solve_s, "solves": solves,
            }
            if with_profile and version == "CostGrow":
                prof = device_profile(torch, lambda: tohr(**kw))
                prof["device_idle_share_of_timed_run"] = 1.0 - prof["device_busy_s"] / e2e_s
                # K3's device time against the wall time of the (untraced) solves.
                prof["relax_step_device_s_over_solve_s"] = (
                    prof["kernel_device_ms"]["relax_step"] / 1e3 / solve_s
                )
                log(f"[profile] costgrow {json.dumps(prof)}")
    return results


def phase_costgrow_small(torch, seed: int) -> None:
    """Both workers at 64² and 512²: the card's output equals the CPU's bit for bit."""
    from floodsr_tpu_torch.tohr import tohr

    runs = 0
    with tempfile.TemporaryDirectory(prefix="chip-smoke-costgrow-small-") as tmp:
        tmp = Path(tmp)
        params = costgrow_params(tmp)
        for size, scale in ((64, 8), (512, 16)):
            scene = valley_scene(tmp, seed, size, scale)
            variants = [("wse", {}), ("wse", {"buildings_fp": scene["buildings"]})]
            if size == 64:
                variants.append(("depth", {"input_kind": "depth"}))
            for version in COSTGROW_VERSIONS:
                for lr, kw in variants:
                    outs = {}
                    for device in ("cuda", "cpu"):
                        out_fp = tmp / f"{version}_{size}_{device}.tif"
                        diag = tohr(
                            model_version=version, model_fp=params[version],
                            depth_lr_fp=scene[lr], dem_hr_fp=scene["dem"],
                            output_fp=out_fp, device=device, **kw,
                        )
                        outs[device] = read_wse(out_fp)
                    wet = np.isfinite(outs["cpu"])
                    if not np.array_equal(outs["cuda"], outs["cpu"], equal_nan=True):
                        bad = int((np.nan_to_num(outs["cuda"]) != np.nan_to_num(outs["cpu"])).sum())
                        raise AssertionError(
                            f"{version} {size}² {lr} {sorted(kw)}: card != cpu on {bad} cells"
                        )
                    assert wet.any() and not wet[scene["hole"]].any()
                    if "buildings_fp" in kw:
                        assert diag["preprocess"]["building_blocked_cells"] > 0
                    runs += 1
                    log(
                        f"[costgrow-small] {version} {size}x{size} lr={lr} {sorted(kw)}: "
                        f"card == cpu bit for bit, {int(wet.sum())} wet cells"
                    )
    assert runs == 10, runs


def phase_resunet_wse() -> None:
    """``tohr(input_kind="wse")`` on a synth case against its depth-input run."""
    from floodsr_tpu_torch.io import read_raster, write_raster
    from floodsr_tpu_torch.ops.resample import reproject_bilinear
    from floodsr_tpu_torch.tohr import tohr

    case_dir = DATA / "synth_single_tile"
    spec = json.loads((case_dir / "case_spec.json").read_text())
    model_fp = DATA / spec.get("model_artifact", "_artifacts/model_infer_test.fsrz")
    depth_fp, dem_fp = (case_dir / spec["inputs"][k] for k in ("lowres_fp", "dem_fp"))
    depth, depth_nodata, depth_prof = read_raster(depth_fp)
    dem, dem_nodata, dem_prof = read_raster(dem_fp)
    assert dem_nodata is None or not np.isclose(dem, dem_nodata).any()
    # WSE = DEM at LR + depth on the wet cells, nodata on the dry ones.
    dem_lr = reproject_bilinear(
        dem.astype(np.float32), dem_prof["transform"], depth.shape, depth_prof["transform"]
    )
    nodata = -9999.0
    wet = depth > 0 if depth_nodata is None else (depth > 0) & ~np.isclose(depth, depth_nodata)
    wse = np.where(wet, dem_lr + depth, nodata).astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-wse-") as tmp:
        wse_fp = Path(tmp) / "wse.tif"
        prof = dict(depth_prof)
        prof.update(dtype="float32", nodata=nodata, compress="LZW")
        write_raster(wse_fp, wse, prof)
        outs = {}
        for kind, lr_fp in (("depth", depth_fp), ("wse", wse_fp)):
            out_fp = Path(tmp) / f"pred_{kind}.tif"
            diag = tohr(
                model_version="ResUNet_16x_DEM", model_fp=model_fp, depth_lr_fp=lr_fp,
                dem_hr_fp=dem_fp, output_fp=out_fp, input_kind=kind, device="cuda",
            )
            assert diag["preprocess"]["input_kind"] == kind
            outs[kind], _, _ = read_raster(out_fp)
    err = float(np.abs(outs["wse"] - outs["depth"]).max())
    log(
        f"[wse] ResUNet_16x_DEM synth_single_tile: max |wse-input - depth-input| {err:.3e} m "
        f"over {outs['depth'].shape}, max depth {float(outs['depth'].max()):.3f} m"
    )
    # (DEM + d) - DEM rounds d in f32 at elevation scale; the tolerance of
    # the JAX package's own WSE-vs-depth test.
    if not err <= 1e-3:
        raise AssertionError(f"WSE input differs from depth input by {err} m")


# ---------------------------------------------------------------------------
# the path that serves: a stream through one worker, the daemon, the CLI
# ---------------------------------------------------------------------------

# Per 4096² flagship scene (121 feathered tiles): K1 calls and K2 launches.
SCENE_K1_CALLS, SCENE_K2_LAUNCHES = 16, 4
# The DEM of each of the stream's six scenes: each DEM twice, never by
# neighbours, so the cache (not only the prefetch) is exercised.
STREAM_DEM_ORDER = (0, 1, 2, 0, 1, 2)


def same_raster(a_fp, b_fp, what: str) -> None:
    """Raise unless the two GeoTIFFs decode to equal rasters, bit for bit."""
    from floodsr_tpu_torch.io import read_raster

    a, _, _ = read_raster(a_fp)
    b, _, _ = read_raster(b_fp)
    if a.shape != b.shape or not np.array_equal(a, b):
        bad = int((a != b).sum()) if a.shape == b.shape else -1
        raise AssertionError(f"{what}: {a_fp} != {b_fp} ({bad} cells differ)")


def scene_routes_ok(what: str, counts: dict, routes: dict, scenes: int) -> None:
    """Raise unless ``scenes`` flagship scenes ran K1 on the tensor-core route
    and K2 on the one-read route, every launch of them."""
    want = {"hr_tail": ("tensor", SCENE_K1_CALLS), "tile_stats": ("one_read", SCENE_K2_LAUNCHES)}
    for name, (route, per_scene) in want.items():
        if counts[name] != scenes * per_scene or routes[name][route] != counts[name]:
            raise AssertionError(
                f"{what}: {name} launched {counts[name]} time(s), by route {routes[name]}; "
                f"expected {scenes} x {per_scene} on {route!r}"
            )


def phase_stream(torch, seed: int, size: int, tmp: Path) -> dict:
    """Six single ``tohr`` calls against one ``tohr_many`` over the same jobs."""
    from floodsr_tpu_torch.io import native
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, route_counts
    from floodsr_tpu_torch.tohr import tohr, tohr_many

    t0 = time.perf_counter()
    dems, depths = [], []
    for k in range(len(STREAM_DEM_ORDER)):
        dem_fp, depth_fp = scene_inputs(tmp, seed + 100 + k, size, tag=str(k), dem=k < 3)
        depths.append(depth_fp)
        if dem_fp is not None:
            dems.append(dem_fp)
    scenes = [(dems[d], depths[k]) for k, d in enumerate(STREAM_DEM_ORDER)]
    log(f"[stream] six {size}x{size} scenes over three DEM files written in {time.perf_counter() - t0:.1f} s")
    shared = dict(model_version="ResUNet_16x_DEM", model_fp=FLAGSHIP, device="cuda")

    # (a) six calls of tohr: set-up, decode and upload paid by every scene.
    single_fps = [tmp / f"single{k}.tif" for k in range(len(scenes))]
    single_s, single_setup_s, single_read_s = [], [], []
    for (dem_fp, depth_fp), out_fp in zip(scenes, single_fps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diag = tohr(depth_lr_fp=depth_fp, dem_hr_fp=dem_fp, output_fp=out_fp, **shared)
        torch.cuda.synchronize()
        single_s.append(time.perf_counter() - t0)
        single_setup_s.append(single_s[-1] - float(diag["runtime_s"]))
        single_read_s.append(float(diag["scene_timings"]["read_s"]))
        if diag["scene_timings"]["dem_resident"]:
            raise AssertionError("a single tohr call found its DEM resident in a new worker")

    # (b) one tohr_many over the same jobs: the counts are read around it.
    many_fps = [tmp / f"many{k}.tif" for k in range(len(scenes))]
    jobs = [
        {"depth_lr_fp": depth_fp, "dem_hr_fp": dem_fp, "output_fp": out_fp}
        for (dem_fp, depth_fp), out_fp in zip(scenes, many_fps)
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = tohr_many(jobs=jobs, **shared)
    torch.cuda.synchronize()
    many_s = time.perf_counter() - t0
    counts, routes = launch_counts(), route_counts()
    peak = torch.cuda.max_memory_allocated()

    for k, (single_fp, many_fp) in enumerate(zip(single_fps, many_fps)):
        same_raster(single_fp, many_fp, f"stream scene {k}")
    timings = [r["scene_timings"] for r in results]
    dem_counts = timings[-1]["dem_counts"]
    if dem_counts != {"decoded_in_run": 1, "decoded_by_prefetch": 2, "resident": 5}:
        raise AssertionError(f"stream: DEM counts {dem_counts}")
    if [t["dem_resident"] for t in timings] != [False, True, True, True, True, True]:
        raise AssertionError(f"stream: residency by scene {[t['dem_resident'] for t in timings]}")
    scene_routes_ok("stream", counts, routes, len(scenes))
    runtime_s = [float(r["runtime_s"]) for r in results]
    line = {
        "scenes": len(scenes),
        "size": size,
        "single_s_per_scene": sum(single_s) / len(single_s),
        "single_s": single_s,
        "single_setup_s": single_setup_s,
        "single_read_s": single_read_s,
        "stream_s_per_scene": many_s / len(scenes),
        "stream_total_s": many_s,
        "stream_setup_once_s": many_s - sum(runtime_s),
        "stream_run_s": runtime_s,
        "stream_read_s_miss": [t["read_s"] for t in timings if not t["dem_resident"]],
        # Scenes 1 and 2 wait for (or find) the prefetch thread's upload;
        # scenes 3 to 5 take a DEM an earlier scene left in the cache.
        "stream_read_s_prefetched": [t["read_s"] for t in timings[1:3]],
        "stream_read_s_cached": [t["read_s"] for t in timings[3:]],
        "stream_exec_s": [t["exec_s"] for t in timings],
        "stream_finish_s": [t["finish_s"] for t in timings],
        "dem_counts": dem_counts,
        "launches": counts,
        "io_native_codec": bool(native.available()),
        "peak_allocated_mib": peak / 2**20,
    }
    log(f"[stream] {json.dumps(line)}")
    log(
        f"[stream] six single tohr calls {line['single_s_per_scene']:.3f} s a scene; one tohr_many "
        f"{line['stream_s_per_scene']:.3f} s a scene, its outputs equal bit for bit; DEM decodes "
        f"{dem_counts}"
    )
    return {"scenes": scenes, "single_fps": single_fps, "launches": counts}


def http_json(opener, method: str, url: str, payload=None, token=None):
    """``(status, body, seconds)`` of one request; the body parsed as JSON
    unless it is the metrics text."""
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=headers, method=method)
    t0 = time.perf_counter()
    try:
        with opener.open(req, timeout=600) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as err:
        status, raw = err.code, err.read()
    seconds = time.perf_counter() - t0
    text = raw.decode()
    return status, (text if url.endswith("/metrics") else json.loads(text)), seconds


class ServedDaemon:
    """A started ``TohrService`` behind ``make_server`` on loopback, port 0,
    served from a thread of this process; closed on exit."""

    def __init__(self, **service_kw):
        from floodsr_tpu_torch.serve import TohrService, make_server

        self.service = TohrService(**service_kw)
        self._make_server = make_server

    def __enter__(self):
        self.service.start()
        self.server = self._make_server(self.service, host="127.0.0.1", port=0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_port}"
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        self.service.close()
        return False


def phase_serve(torch, seed: int, size: int, tmp: Path, stream: dict) -> dict:
    """The daemon on loopback: requests, a batch with a failing job, the GET
    endpoints, 401 and 400; then ``CostGrow`` through a second service."""
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, route_counts
    from floodsr_tpu_torch.tohr import tohr

    # Loopback only, whatever proxy the environment names.
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    token = "chip-smoke-token"
    scenes, single_fps = stream["scenes"], stream["single_fps"]
    card = torch.cuda.get_device_name(0)

    def body(k: int, out_fp: Path) -> dict:
        dem_fp, depth_fp = scenes[k]
        return {"in": str(depth_fp), "dem": str(dem_fp), "out": str(out_fp)}

    with ServedDaemon(
        model_version="ResUNet_16x_DEM", model_fp=FLAGSHIP, auth_token=token,
        data_root=tmp, device="cuda",
    ) as daemon:
        t0 = time.perf_counter()
        warmed = daemon.service.warmup([(size, size)])
        warmup_s = time.perf_counter() - t0
        if warmed != 1:
            raise AssertionError(f"serve: warmup returned {warmed}, expected 1 geometry")
        torch.cuda.synchronize()
        reset_launch_counts()
        # Scenes 0, 1 and 3: the third request names scene 0's DEM again.
        latencies, stages = [], []
        for k in (0, 1, 3):
            out_fp = tmp / f"served{k}.tif"
            status, answer, seconds = http_json(
                opener, "POST", daemon.base + "/v1/tohr", body(k, out_fp), token
            )
            if status != 200 or answer.get("output_fp") != str(out_fp):
                raise AssertionError(f"serve: POST /v1/tohr scene {k}: {status} {answer}")
            same_raster(single_fps[k], out_fp, f"served scene {k}")
            latencies.append(seconds)
            # Where the request's time went: the worker's run inside the
            # handler's span inside the client's round trip.
            stages.append({
                "client_s": seconds, "handler_s": answer["serve_runtime_s"],
                "run_s": answer["runtime_s"],
                **{key: answer["scene_timings"][key] for key in ("read_s", "exec_s", "finish_s")},
            })
            resident = answer["scene_timings"]["dem_resident"]
            if resident != (k == 3):
                raise AssertionError(f"serve: scene {k} dem_resident={resident}")
        # A batch of three whose middle job names a missing depth file.
        missing = body(5, tmp / "served_missing.tif")
        missing["in"] = str(tmp / "no_such_depth.tif")
        batch = {"jobs": [body(2, tmp / "served2.tif"), missing, body(4, tmp / "served4.tif")]}
        status, answer, batch_s = http_json(
            opener, "POST", daemon.base + "/v1/tohr_many", batch, token
        )
        oks = [r.get("ok") for r in answer.get("results", [])] if status == 200 else None
        if oks != [True, False, True]:
            raise AssertionError(f"serve: POST /v1/tohr_many: {status} ok={oks} {answer}")
        for k in (2, 4):
            same_raster(single_fps[k], tmp / f"served{k}.tif", f"served batch scene {k}")
        if (tmp / "served_missing.tif").exists():
            raise AssertionError("serve: the failed job left an output file")
        torch.cuda.synchronize()
        counts, routes = launch_counts(), route_counts()
        scene_routes_ok("serve", counts, routes, 5)

        status, health, _ = http_json(opener, "GET", daemon.base + "/v1/healthz")
        if status != 200 or health.get("status") != "ok" or health.get("requests_done") != 4:
            raise AssertionError(f"serve: GET /v1/healthz: {status} {health}")
        status, metrics, _ = http_json(opener, "GET", daemon.base + "/v1/metrics", token=token)
        if status != 200 or "floodsr_scenes_done 5\n" not in metrics:
            raise AssertionError(f"serve: GET /v1/metrics: {status}\n{metrics}")
        status, doctor, _ = http_json(opener, "GET", daemon.base + "/v1/doctor", token=token)
        if status != 200 or doctor.get("cuda_available") is not True or card not in doctor["cuda_devices"]:
            raise AssertionError(f"serve: GET /v1/doctor does not name {card!r}: {status} {doctor}")
        status, answer, _ = http_json(opener, "POST", daemon.base + "/v1/tohr", body(0, tmp / "noauth.tif"))
        if status != 401:
            raise AssertionError(f"serve: a request without the token got {status} {answer}")
        outside = body(0, tmp.parent / "outside_data_root.tif")
        status, answer, _ = http_json(opener, "POST", daemon.base + "/v1/tohr", outside, token)
        if status != 400 or "data root" not in answer.get("error", ""):
            raise AssertionError(f"serve: a path outside data_root got {status} {answer}")
        status, answer, _ = http_json(
            opener, "POST", daemon.base + "/v1/tohr", {**body(0, tmp / "dev.tif"), "device": "cpu"}, token
        )
        if status != 400:
            raise AssertionError(f"serve: a request naming 'device' got {status} {answer}")

    # CostGrow through the daemon at 512²: every relaxation a K3 launch.
    valley = valley_scene(tmp, seed, 512)
    params = costgrow_params(tmp)["CostGrow"]
    grown_fp, direct_fp = tmp / "served_costgrow.tif", tmp / "direct_costgrow.tif"
    with ServedDaemon(
        model_version="CostGrow", model_fp=params, auth_token=token, data_root=tmp, device="cuda"
    ) as daemon:
        if daemon.service.warmup([(512, 512)]) != 0:
            raise AssertionError("serve: the CostGrow service's warmup did not return 0")
        torch.cuda.synchronize()
        reset_launch_counts()
        status, answer, costgrow_s = http_json(
            opener, "POST", daemon.base + "/v1/tohr",
            {"in": str(valley["wse"]), "dem": str(valley["dem"]), "out": str(grown_fp)}, token,
        )
        k3 = launch_counts()["relax_step"]
        if status != 200:
            raise AssertionError(f"serve: CostGrow request: {status} {answer}")
        relaxations = sum(s["relaxations"] for s in answer["solves"].values())
        if k3 != relaxations or k3 <= 0:
            raise AssertionError(f"serve: CostGrow request: {k3} K3 launches for {relaxations} relaxations")
    tohr(
        model_version="CostGrow", model_fp=params, depth_lr_fp=valley["wse"],
        dem_hr_fp=valley["dem"], output_fp=direct_fp, device="cuda",
    )
    if not np.array_equal(read_wse(grown_fp), read_wse(direct_fp), equal_nan=True):
        raise AssertionError("serve: the CostGrow request's output differs from tohr's")

    line = {
        "warmup_s": warmup_s,
        "first_request_s": latencies[0],
        "second_request_s": latencies[1],
        "cache_hit_request_s": latencies[2],
        "batch_s_per_scene": batch_s / 2,
        "batch_s": batch_s,
        "request_stages": stages,
        "costgrow_512_request_s": costgrow_s,
        "launches": counts,
        "costgrow_relax_step_launches": k3,
    }
    log(f"[serve] {json.dumps(line)}")
    log(
        "[serve] 3 requests and a batch of 3 (ok true, false, true) answered with tohr's rasters; "
        f"401 without the token, 400 outside the data root and for 'device'; doctor names {card!r}; "
        f"CostGrow at 512x512 through the daemon in {costgrow_s:.3f} s ({k3} K3 launches)"
    )
    return {"launches": counts, "relax_step_launches": k3}


def phase_cli(torch, seed: int, tmp: Path) -> None:
    """``doctor`` and a two-input ``tohr`` as child processes; exit code 0 each."""
    from floodsr_tpu_torch.tohr import tohr

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])
    ))
    cli = [sys.executable, "-m", "floodsr_tpu_torch.cli"]

    def child(args: list[str]) -> tuple[str, float]:
        t0 = time.perf_counter()
        done = subprocess.run(
            cli + args, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600
        )
        if done.returncode != 0:
            raise AssertionError(
                f"cli {' '.join(args[:2])}: exit code {done.returncode}\n{done.stdout}\n{done.stderr}"
            )
        return done.stdout, time.perf_counter() - t0

    card = torch.cuda.get_device_name(0)
    out, doctor_s = child(["doctor"])
    if "cuda_available=True" not in out.splitlines() or card not in out:
        raise AssertionError(f"cli doctor does not report the card {card!r}:\n{out}")
    built = [ln for ln in out.splitlines() if ln.startswith("kernels_built=")]
    if built != ["kernels_built=tile_stats,hr_tail,relax_step"]:
        raise AssertionError(f"cli doctor: the child does not find the kernels built: {built}")
    if "hr_tail_bf16_built=True" not in out.splitlines():
        raise AssertionError(f"cli doctor: the built hr_tail library lacks the bf16 route:\n{out}")

    size = 1024
    dem_fp, depth_a = scene_inputs(tmp, seed + 200, size, tag="_cli_a")
    _, depth_b = scene_inputs(tmp, seed + 201, size, tag="_cli_b", dem=False)
    out_dir = tmp / "cli_out"
    out, tohr_s = child([
        "tohr", "--model-path", str(FLAGSHIP), "--in", str(depth_a), str(depth_b),
        "--dem", str(dem_fp), "--out", str(out_dir),
    ])
    printed = [Path(ln) for ln in out.strip().splitlines()]
    want = [out_dir / f"{fp.stem}_sr.tif" for fp in (depth_a, depth_b)]
    if printed != want:
        raise AssertionError(f"cli tohr printed {printed}, expected {want}")
    for depth_fp, cli_fp in zip((depth_a, depth_b), want):
        lib_fp = tmp / f"lib_{depth_fp.stem}.tif"
        tohr(
            model_version="ResUNet_16x_DEM", model_fp=FLAGSHIP, depth_lr_fp=depth_fp,
            dem_hr_fp=dem_fp, output_fp=lib_fp, device="cuda",
        )
        same_raster(lib_fp, cli_fp, f"cli tohr {depth_fp.name}")
    log(
        f"[cli] doctor exit 0 in {doctor_s:.1f} s (cuda_available=True, {card!r}, kernels found "
        f"built); tohr with two inputs at {size}x{size} exit 0 in {tohr_s:.1f} s, both files equal "
        "to tohr's"
    )


#: The user examples ``phase_examples`` runs, with the route K1 takes in each.
#: ``run_tohr_torch`` and ``serve_scenes_torch`` build the JAX examples' small
#: artifact (the same bytes), whose one fuse block runs the unfused tail, as
#: the JAX package's ``_pallas_tail_eligible`` rules: K1 is not on their path
#: (``None``). The tutorial runs the flagship artifact: K1's tensor-core route.
EXAMPLE_K1_ROUTES = {
    "run_tohr_torch": None,
    "serve_scenes_torch": None,
    "tutorial_torch": "tensor",
}


def phase_examples(torch, tmp: Path) -> dict:
    """The three user examples in-process with ``--device cuda``: K2 launched
    by each, K1 on the route of ``EXAMPLE_K1_ROUTES`` and on no other; the
    tutorial's SR row equal to ``case_spec.json``'s metrics at its precision."""
    import importlib.util

    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, route_counts

    report, launches = {}, {}
    for name, route in EXAMPLE_K1_ROUTES.items():
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        argv = [str(tmp / f"example_{name}"), "--device", "cuda"]
        if name == "tutorial_torch":
            argv.append("--no-figure")  # the metrics are what is checked; no figure
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = example.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts, k1 = launch_counts(), route_counts()["hr_tail"]
        want_k1 = dict.fromkeys(k1, 0)
        if route is not None:
            want_k1[route] = counts["hr_tail"]
        if not (counts["tile_stats"] > 0 and k1 == want_k1 and sum(k1.values()) == counts["hr_tail"]
                and (route is None or counts["hr_tail"] > 0)):
            raise AssertionError(
                f"example {name}: tile_stats {counts['tile_stats']}, hr_tail by route {k1} "
                f"(expected K2 launched and K1 on route {route!r} only)"
            )
        if name == "tutorial_torch":
            case = json.loads((DATA / "synth_flagship" / "case_spec.json").read_text())
            want = case["expected"]["ResUNet_16x_DEM_default"]["metrics"]
            precision = int(want["precision"])
            got = {
                k: round(float(result["FloodSR SR"][k]), precision)
                for k in ("mase_m", "rmse_m", "ssim")
            }
            if got != {k: round(float(want[k]), precision) for k in got}:
                raise AssertionError(f"example {name}: SR metrics {got}, case_spec.json {want}")
        elif result != 0:
            raise AssertionError(f"example {name}: main returned {result}")
        report[name] = {"wall_s": wall_s, "launches": counts, "hr_tail_by_route": k1}
        launches[name] = {**counts, "hr_tail_bf16": k1["bf16"]}
    log(f"[examples] {json.dumps(report)}")
    return {
        kernel: sum(run[kernel] for run in launches.values())
        for kernel in ("tile_stats", "hr_tail", "hr_tail_bf16")
    }


def free_card_for_child(torch, what: str) -> None:
    """Hand this process's cached device memory back before a child process
    that measures the card, and log what the card holds then."""
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    used = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used,memory.total", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[{what}] this process had {reserved / 2**20:.0f} MiB reserved; the card holds {used} "
        "after empty_cache")


def phase_gate(torch, tmp: Path) -> dict:
    """``bin/parity_gate_torch.py`` as a child process: exit 0, every row passing."""
    free_card_for_child(torch, "gate")
    out = tmp / "parity_gate_torch.json"
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, str(ROOT / "bin" / "parity_gate_torch.py"), "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    wall_s = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(
            f"parity_gate_torch: exit code {done.returncode}\n{done.stdout[-3000:]}\n"
            f"{done.stderr[-5000:]}"
        )
    result = json.loads(out.read_text())
    want = {d.name for d in DATA.iterdir() if (d / "case_spec.json").exists()}
    want |= {"synth_mersch@hard", "synth_mersch@pack12"}
    if set(result["cases"]) != want:
        raise AssertionError(f"parity_gate_torch ran {sorted(result['cases'])}, expected {sorted(want)}")
    failed = [label for label, row in result["cases"].items() if not row["pass"]]
    if failed or not result["banded_vs_replicated"]["pass"] or not result["pass"]:
        raise AssertionError(f"parity_gate_torch: rows over the bar: {failed} {result}")
    if not result["device"]["name"]:
        raise AssertionError(f"parity_gate_torch names no card: {result['device']}")
    for label, row in {**result["cases"], "banded_vs_replicated": result["banded_vs_replicated"]}.items():
        log(f"[gate] {label}: {json.dumps(row)}")
    log(f"[gate] exit 0 in {wall_s:.1f} s, every row within {result['gate_rmse_m']} m RMSE "
        f"on {result['device']}")
    return result


def run_line_launches(stderr: str, run: str) -> tuple[dict, dict]:
    """The kernels' launches and routes a ``# run <run>: ...`` line of the bench printed."""
    found = re.findall(
        rf"^# run {run}: .* launches (\{{.*?\}}) routes (\{{.*\}})\)?$", stderr, re.MULTILINE
    )
    if not found:
        raise AssertionError(f"bench_torch printed no launches for run {run}:\n{stderr[-3000:]}")
    launches, routes = found[-1]
    return json.loads(launches), json.loads(routes)


def phase_bench(torch, tmp: Path) -> dict:
    """``bench_torch.py`` as a child process at 2 repeats and a stream of 2:
    exit 0 and a full last line; K1's and K2's launches from its run lines."""
    import bench_torch

    free_card_for_child(torch, "bench")
    env = dict(
        os.environ, FLOODSR_BENCH_REPEATS="2", FLOODSR_BENCH_STREAM_SCENES="2",
        FLOODSR_BENCH_PARITY="0", TMPDIR=str(tmp),
    )
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    wall_s = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(
            f"bench_torch: exit code {done.returncode}\n{done.stdout[-3000:]}\n{done.stderr[-5000:]}"
        )
    for line in done.stderr.splitlines():
        if line.startswith("# "):
            log(f"[bench] {line[2:]}")
    payload = json.loads(done.stdout.strip().splitlines()[-1])
    missing = [k for k in bench_torch.PAYLOAD_KEYS if k not in payload]
    if missing:
        raise AssertionError(f"bench_torch's line lacks {missing}")
    rates = [k for k in payload if k.endswith(("_mps", "_per_s")) or k == "value"]
    if not all(payload[k] > 0 for k in rates):
        raise AssertionError(f"bench_torch: a rate is not above 0: {payload}")
    f32, f32_routes = run_line_launches(done.stderr, "1")
    bf16, bf16_routes = run_line_launches(done.stderr, "bfloat16")
    if not (f32["tile_stats"] > 0 and f32["hr_tail"] == f32_routes["hr_tail"]["tensor"] > 0):
        raise AssertionError(f"bench_torch's flagship scene: K1/K2 launches {f32} {f32_routes}")
    if not bf16["hr_tail"] == bf16_routes["hr_tail"]["bf16"] > 0:
        raise AssertionError(f"bench_torch's bfloat16 scene: K1 launches {bf16} {bf16_routes}")
    log(f"[bench] exit 0 in {wall_s:.1f} s; K2 {f32['tile_stats']} and K1 {f32['hr_tail']} "
        f"launches a flagship scene, K1's bf16 route {bf16['hr_tail']} a bfloat16 scene")
    log(f"[bench] {json.dumps(payload)}")
    return {
        "payload": payload,
        "launches": {**f32, "hr_tail_bf16": bf16["hr_tail"]},
        "wall_s": wall_s,
    }


# ---------------------------------------------------------------------------
# precision policies, the finish stage, the ONNX path
# ---------------------------------------------------------------------------

#: Ceiling on the RMSE of a bf16 or mixed scene against the f32 scene of the
#: same seed, in metres, by policy. The flagship artifact is trained (50,000
#: steps, tests/data/synth_flagship/readme.md), but this scene's random-walk
#: DEM lies outside its training family: under either policy, in either
#: package, single pixels move by the whole of max_depth. The JAX package's
#: own distance on this scene (scene_inputs(tmp, 0, 4096, tag="_policy"), the
#: flagship artifact, floodsr_tpu.tohr.tohr with engine_options
#: {"compute_dtype": ...} against "float32", on the CPU; measured by
#: ``JAX_PLATFORMS=cpu python tests/flagship_rounding_study.py --policies``):
#: bfloat16 0.3211 m, mixed 0.2028 m RMSE (the port's on the CPU: 0.2547 /
#: 0.2041 m). Each ceiling is at most twice the JAX package's distance: mixed
#: 0.4; bfloat16 keeps the earlier 0.5, under its 0.642. This only catches a
#: broken policy; the arithmetic itself is held against the JAX package by the
#: CPU tests.
POLICY_RMSE_CEILING_M = {"bfloat16": 0.5, "mixed": 0.4}


def rmse_m(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(a.astype(np.float64) - b.astype(np.float64)))))


def timed_tohr(torch, warm: bool = True, **kw) -> dict:
    """``tohr(**kw)`` once unrecorded (``warm``), then timed with the kernels'
    counts set to 0 just before and read just after."""
    from floodsr_tpu_torch.io import read_raster
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, route_counts
    from floodsr_tpu_torch.tohr import tohr

    if warm:
        tohr(**kw)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    diag = tohr(**kw)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    pred, _, _ = read_raster(kw["output_fp"])
    if not (np.isfinite(pred).all() and pred.min() >= 0.0 and pred.max() <= 5.0):
        raise AssertionError(f"{kw['output_fp']}: values outside [0, max_depth] or not finite")
    return {
        "pred": pred, "e2e_s": e2e_s, "counts": launch_counts(), "routes": route_counts(),
        "timings": diag["scene_timings"], "tiles": int(diag["preprocess"]["tile_cache_size"]),
    }


def traced(torch, what: str, e2e_s: float, **kw) -> None:
    """Trace one more ``tohr(**kw)`` and log device time by kernel and the idle share."""
    from floodsr_tpu_torch.tohr import tohr

    prof = device_profile(torch, lambda: tohr(**kw))
    prof["device_idle_share_of_timed_run"] = 1.0 - prof["device_busy_s"] / e2e_s
    log(f"[profile] {what} {json.dumps(prof)}")


# ---------------------------------------------------------------------------
# multi-GPU inference: banded and replicated scenes, the banded fill, --mesh
# ---------------------------------------------------------------------------

MESH_BANDS = 4  # bands (or shards) of the virtual mesh on the one card
MESH_WIDE = (1024, 8192)  # a scene that takes the column path over 4 bands
# Tiles a batch in every path of the equal-width holds: the 4096² scene's
# 121 tiles and its four bands' 33/33/22/33 all split into batches of 11, the
# wide scene's 63 tiles and its bands' 18/15/15/15 into batches of 3.
MESH_WIDTH = 11
MESH_WIDE_WIDTH = 3


@contextlib.contextmanager
def engine_batch_width(scene_chunk: int, trunk_chunk: int):
    """Every ``EngineTorch`` made inside takes these scene chunk widths by
    default (the worker passes neither)."""
    from floodsr_tpu_torch.engine import EngineTorch

    defaults = EngineTorch.__init__.__kwdefaults__
    saved = dict(defaults)
    defaults.update(scene_chunk=scene_chunk, scene_trunk_chunk=trunk_chunk)
    try:
        yield
    finally:
        defaults.clear()
        defaults.update(saved)


def held_scene(what: str, got, want, atol: float) -> float:
    """``run_scene`` outputs and per-tile stats of a meshed engine against the
    plain one's: the scene within ``atol``, the stats the same bits in grid
    order. Returns the max |diff|."""
    (out, stats), (out0, stats0) = got, want
    if out.shape != out0.shape or not np.isfinite(out).all():
        raise AssertionError(f"{what}: shape {out.shape} (want {out0.shape}) or values not finite")
    diff = float(np.abs(out - out0).max())
    if not diff <= atol:
        raise AssertionError(f"{what}: max |diff| {diff} m against the plain scene, over {atol}")
    for k in stats0:
        if not np.array_equal(stats[k], stats0[k]):
            raise AssertionError(f"{what}: per-tile {k} differ from the plain scene's in grid order")
    return diff


def phase_mesh(torch, seed: int, size: int, tmp: Path, card: str) -> dict:
    """The multi-GPU paths on the card: the flagship scene banded over
    ``[cuda:0] * 4`` and over ``parse_mesh_spec("auto")``, replicated over
    ``[cuda:0] * 4``, a wide scene on the column path, the banded CostGrow
    fill, and ``tohr --mesh auto --scene-mode banded`` as a child process.

    cuDNN picks a convolution algorithm by batch size, and the flagship
    artifact (trained, but on this random-walk DEM outside its training
    family, where single pixels saturate) carries the change of algorithm
    to the output: the plain path run at another batch width moves its own
    raster by up to 1.7e-2 m. So the numbers are read at the default widths
    (what a user runs), and the holds run every path at one batch width
    (``MESH_WIDTH``), where a tile's prediction is the same bits in every
    path and only the sums at a seam differ."""
    from floodsr_tpu_torch.engine import EngineTorch
    from floodsr_tpu_torch.io import read_raster
    from floodsr_tpu_torch.ops import costgrow
    from floodsr_tpu_torch.ops.costgrow_banded import mcp_fill_sharded
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from floodsr_tpu_torch.parallel.mesh import make_mesh, parse_mesh_spec
    from floodsr_tpu_torch.tohr import tohr

    dev = torch.device("cuda", 0)
    meshes = {
        "banded x4": (make_mesh(devices=[dev] * MESH_BANDS), "banded"),
        "banded auto": (parse_mesh_spec("auto"), "banded"),
        "replicated x4": (make_mesh(devices=[dev] * MESH_BANDS), "replicated"),
    }
    if torch.cuda.device_count() >= 2:
        meshes["banded 2 GPUs"] = (make_mesh(2), "banded")
        meshes["replicated 2 GPUs"] = (make_mesh(2), "replicated")
    else:
        log("[mesh] one GPU on this machine: the real 2-GPU mesh is not run (device count 1)")
    # one uint16 code, plus the f32 rounding of two dequantized values near 5 m
    step = 5.0 / 65535 + 1e-6
    report = {"card": card, "scenes": {}}

    # 1. the flagship scene through tohr at the default widths: times, launches
    dem_fp, depth_fp = scene_inputs(tmp, seed, size, tag="_mesh")
    kw = dict(
        model_version="ResUNet_16x_DEM", model_fp=FLAGSHIP, depth_lr_fp=depth_fp,
        dem_hr_fp=dem_fp, device="cuda",
    )
    torch.cuda.reset_peak_memory_stats()
    plain = timed_tohr(torch, output_fp=tmp / "mesh_plain.tif", **kw)
    report["scenes"]["plain"] = {
        "e2e_s": plain["e2e_s"], "exec_s": plain["timings"]["exec_s"],
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
    }
    launches = {}
    for what, (mesh, mode) in meshes.items():
        opts = {"engine_options": {"mesh": mesh, "scene_mode": mode}}
        out_fp = tmp / f"mesh_{what.replace(' ', '_')}.tif"
        torch.cuda.reset_peak_memory_stats()
        run = timed_tohr(torch, output_fp=out_fp, **kw, **opts)
        peak = torch.cuda.max_memory_allocated() / 2**20
        for name in ("tile_stats", "hr_tail"):
            if not run["counts"][name] > 0:
                raise AssertionError(f"[mesh] {what}: {name} never launched: {run['counts']}")
        prof = device_profile(torch, lambda: tohr(output_fp=out_fp, **kw, **opts))
        for name in ("tile_stats", "hr_tail"):
            if not prof["kernel_events"][name] > 0:
                raise AssertionError(f"[mesh] {what}: the profiler saw no {name} launch: {prof}")
        diff = np.abs(run["pred"] - plain["pred"])
        launches[what] = run["counts"]
        report["scenes"][what] = {
            "e2e_s": run["e2e_s"], "exec_s": run["timings"]["exec_s"], "peak_mib": peak,
            "launches": run["counts"], "profiler_launches": prof["kernel_events"],
            "k1_device_ms": prof["kernel_device_ms"]["hr_tail"],
            "k2_device_ms": prof["kernel_device_ms"]["tile_stats"],
            "device_busy_s": prof["device_busy_s"],
            # against the plain raster at the default widths: not a hold (see above)
            "default_widths_max_abs_m": float(diff.max()),
            "default_widths_share_over_one_step": float((diff > step).mean()),
        }
        log(f"[mesh] {what}: {json.dumps(report['scenes'][what])} ({card})")

    # 2. the holds at one batch width: tohr rasters within one uint16 step,
    # run_scene with the float32 transfer within 1e-4 m, stats in grid order
    def width(mode, dp):
        chunk = MESH_WIDTH * (dp if mode == "replicated" else 1)
        return engine_batch_width(chunk, MESH_WIDTH)

    with width("plain", 1):
        tohr(output_fp=tmp / "mesh_plain_w.tif", **kw)
    want_raster = read_raster(tmp / "mesh_plain_w.tif")[0]
    for what, (mesh, mode) in meshes.items():
        dp = mesh.shape["dp"]
        with width(mode, dp):
            tohr(
                output_fp=tmp / "mesh_w.tif", **kw,
                engine_options={"mesh": mesh, "scene_mode": mode, "max_batch": MESH_WIDTH},
            )
        diff = float(np.abs(read_raster(tmp / "mesh_w.tif")[0] - want_raster).max())
        if not diff <= step:
            raise AssertionError(f"[mesh] {what}: tohr raster {diff} m from the plain one (step {step})")
        report["scenes"][what]["tohr_max_abs_m"] = diff

    depth = read_raster(depth_fp)[0]
    dem = read_raster(dem_fp)[0]

    def run_scene(mesh, mode, d, m, w):
        dp = 1 if mesh is None else mesh.shape["dp"]
        eng = EngineTorch(
            FLAGSHIP, mesh=mesh, scene_mode=mode, output_transfer="float32", max_batch=w,
            scene_chunk=w * (dp if mode == "replicated" else 1), scene_trunk_chunk=w,
        )
        cfg = eng.config
        overlap = cfg.lr_tile // 4 * cfg.scale  # the worker's feather default
        stride = cfg.hr_tile - overlap
        out = eng.run_scene(
            d, m, crop_shape=m.shape, stride_hr=stride, overlap_hr=overlap, max_depth=5.0,
            dem_pct_clip=95.0,
        )
        geometry = None
        if mode == "banded":
            _, bucket, _, _, transposed = eng.banded_scene_executor(
                m.shape, stride_hr=stride, overlap_hr=overlap, max_depth=5.0, dem_pct_clip=95.0,
            )
            geometry = (bucket, transposed)
        eng.close()
        return out, geometry

    want, _ = run_scene(None, "replicated", depth, dem, MESH_WIDTH)
    for what, (mesh, mode) in meshes.items():
        got, _ = run_scene(mesh, mode, depth, dem, MESH_WIDTH)
        report["scenes"][what]["run_scene_f32_max_abs_m"] = held_scene(what, got, want, 1e-4)

    # 3. column banding: a wide scene over 4 bands
    rng = np.random.default_rng(seed + 300)
    wide_dem = (300.0 + np.cumsum(rng.normal(0.0, 0.3, MESH_WIDE), axis=1)).astype(np.float32)
    wide_depth = np.clip(
        rng.gamma(1.5, 0.6, (MESH_WIDE[0] // 16, MESH_WIDE[1] // 16)) - 0.4, 0.0, 5.0
    ).astype(np.float32)
    want, _ = run_scene(None, "replicated", wide_depth, wide_dem, MESH_WIDE_WIDTH)
    got, (bucket, transposed) = run_scene(
        meshes["banded x4"][0], "banded", wide_depth, wide_dem, MESH_WIDE_WIDTH
    )
    if not transposed:
        raise AssertionError(f"[mesh] the {MESH_WIDE} scene did not take the column path: {bucket}")
    report["wide"] = {
        "shape": list(MESH_WIDE), "bucket": list(bucket),
        "max_abs_m": held_scene("column banding", got, want, 1e-4),
    }

    # 4. the banded fill on the 4096² valley scene's penalized-fill inputs
    scene = valley_scene(tmp, seed, size)
    params = costgrow_params(tmp)
    captured = []
    real_fill = costgrow.mcp_fill

    def capture(*args, **kwargs):
        if kwargs.get("target_mask") is not None:
            captured.append(tuple(a.clone() for a in args[:4]))
        return real_fill(*args, **kwargs)

    costgrow.mcp_fill = capture
    try:
        tohr(
            model_version="CostGrow", model_fp=params["CostGrow"], depth_lr_fp=scene["wse"],
            dem_hr_fp=scene["dem"], output_fp=tmp / "mesh_costgrow.tif", device="cuda",
        )
    finally:
        costgrow.mcp_fill = real_fill
    if len(captured) != 1:
        raise AssertionError(f"[mesh] captured {len(captured)} penalized fills, not 1")
    fill_args = captured[0]
    fills = {}
    for what, fill in (
        ("mcp_fill", lambda st: real_fill(*fill_args, stats=st)),
        ("mcp_fill_sharded x4", lambda st: mcp_fill_sharded(*fill_args, meshes["banded x4"][0], stats=st)),
    ):
        stats = {}
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        filled, dist = fill(stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k3 = launch_counts()["relax_step"]
        if isinstance(filled, torch.Tensor):
            filled, dist = filled.cpu().numpy(), dist.cpu().numpy()
        fills[what] = (filled, dist)
        report[what] = {"seconds": seconds, "k3_launches": k3, **stats}
        if not k3 > 0:
            raise AssertionError(f"[mesh] {what}: relax_step never launched")
    (f0, d0), (f1, d1) = fills.values()
    if not (np.array_equal(d0, d1) and np.array_equal(f0, f1, equal_nan=True)):
        raise AssertionError(
            f"[mesh] the banded fill differs from mcp_fill: dist max |diff| "
            f"{np.nanmax(np.abs(d0 - d1))}, {int((f0 != f1).sum())} fill cells"
        )
    launches["mcp_fill_sharded x4"] = {"relax_step": report["mcp_fill_sharded x4"]["k3_launches"]}
    log(
        f"[mesh] banded fill on the {size}² valley's penalized fill: bit-equal to mcp_fill; "
        f"{json.dumps({k: report[k] for k in ('mcp_fill', 'mcp_fill_sharded x4')})} ({card})"
    )

    # 5. the CLI: tohr --mesh auto --scene-mode banded, equal to the library's
    # tohr with the same mesh
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])
    ))
    cli_dem, cli_depth = scene_inputs(tmp, seed + 202, 1024, tag="_cli_mesh")
    cli_fp = tmp / "cli_mesh.tif"
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "floodsr_tpu_torch.cli", "tohr", "--model-path", str(FLAGSHIP),
         "--in", str(cli_depth), "--dem", str(cli_dem), "--out", str(cli_fp),
         "--mesh", "auto", "--scene-mode", "banded"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    if done.returncode != 0:
        raise AssertionError(f"cli tohr --mesh auto: exit code {done.returncode}\n{done.stderr}")
    report["cli_s"] = time.perf_counter() - t0
    tohr(
        model_version="ResUNet_16x_DEM", model_fp=FLAGSHIP, depth_lr_fp=cli_depth,
        dem_hr_fp=cli_dem, output_fp=tmp / "lib_mesh.tif", device="cuda",
        engine_options={"mesh": meshes["banded auto"][0], "scene_mode": "banded"},
    )
    same_raster(tmp / "lib_mesh.tif", cli_fp, "cli tohr --mesh auto --scene-mode banded")
    print(json.dumps({"mesh": report}), flush=True)
    return {"launches": launches}


def phase_policies(torch, seed: int, size: int, tmp: Path, with_profile: bool = False) -> dict:
    """The flagship scene under ``bfloat16`` and ``mixed`` against ``float32``."""
    dem_fp, depth_fp = scene_inputs(tmp, seed, size, tag="_policy")
    runs = {}
    for dtype in ("float32", "bfloat16", "mixed"):
        kw = dict(
            model_version="ResUNet_16x_DEM", model_fp=FLAGSHIP, depth_lr_fp=depth_fp,
            dem_hr_fp=dem_fp, output_fp=tmp / f"policy_{dtype}.tif", device="cuda",
            engine_options={"compute_dtype": dtype},
        )
        runs[dtype] = timed_tohr(torch, **kw)
        if with_profile and dtype != "float32":
            traced(torch, f"{dtype} scene", runs[dtype]["e2e_s"], **kw)
    want_route = {"float32": "tensor", "bfloat16": "bf16", "mixed": "tensor"}
    out = {}
    for dtype, run in runs.items():
        k1 = run["routes"]["hr_tail"]
        expected = {**dict.fromkeys(k1, 0), want_route[dtype]: SCENE_K1_CALLS}
        if k1 != expected or run["counts"]["tile_stats"] != SCENE_K2_LAUNCHES:
            raise AssertionError(
                f"{dtype} scene: hr_tail by route {k1} (expected {expected}), "
                f"tile_stats {run['counts']['tile_stats']} (expected {SCENE_K2_LAUNCHES})"
            )
        err = rmse_m(run["pred"], runs["float32"]["pred"])
        if dtype != "float32" and not 0.0 < err <= POLICY_RMSE_CEILING_M[dtype]:
            raise AssertionError(
                f"{dtype} scene: RMSE {err} m against the f32 scene, "
                f"ceiling {POLICY_RMSE_CEILING_M[dtype]}"
            )
        out[dtype] = {
            "e2e_s": run["e2e_s"], "exec_s": run["timings"]["exec_s"],
            "finish_s": run["timings"]["finish_s"], "rmse_vs_f32_m": err,
            "max_abs_vs_f32_m": float(np.abs(run["pred"] - runs["float32"]["pred"]).max()),
            "hr_tail_by_route": k1,
        }
    log(f"[policies] {size}x{size} flagship scene, {runs['float32']['tiles']} tiles {json.dumps(out)}")
    policies_card_vs_cpu(tmp)
    return {"bf16_launches": runs["bfloat16"]["routes"]["hr_tail"]["bf16"], **out}


def policies_card_vs_cpu(tmp: Path) -> None:
    """Each policy on the card against ``device="cpu"`` on a regression case.

    On the card a bf16 stage's products run as TF32 on the tensor cores, on the
    CPU as f32: both exact for bf16 values, so the two differ only by flipped
    bf16 roundings (f32 sums in another order). Held to a quarter of the
    policy's own distance to f32, on the trained test artifact and one of its
    cases (on the flagship scene's random-walk DEM, outside the flagship
    artifact's training family, a single flip can move a pixel across the
    whole range).
    """
    from floodsr_tpu_torch.io import read_raster
    from floodsr_tpu_torch.tohr import tohr

    case_dir = DATA / "synth_mersch"
    spec = json.loads((case_dir / "case_spec.json").read_text())
    model_fp = DATA / spec.get("model_artifact", "_artifacts/model_infer_test.fsrz")

    def run(dtype: str, device: str) -> np.ndarray:
        out_fp = tmp / f"mersch_{dtype}_{device}.tif"
        tohr(
            model_version="ResUNet_16x_DEM", model_fp=model_fp, output_fp=out_fp, device=device,
            depth_lr_fp=case_dir / spec["inputs"]["lowres_fp"],
            dem_hr_fp=case_dir / spec["inputs"]["dem_fp"],
            engine_options={"compute_dtype": dtype, "output_transfer": "float32"},
        )
        return read_raster(out_fp)[0]

    f32 = run("float32", "cuda")
    report = {}
    for dtype in ("bfloat16", "mixed"):
        card, cpu = run(dtype, "cuda"), run(dtype, "cpu")
        gap, err = rmse_m(card, f32), rmse_m(card, cpu)
        report[dtype] = {"rmse_card_vs_cpu_m": err, "rmse_vs_f32_m": gap}
        if not (gap > 0.0 and err < 0.25 * gap):
            raise AssertionError(
                f"{dtype} on the card against the CPU on {case_dir.name}: RMSE {err} m, "
                f"the policy's distance to f32 {gap} m"
            )
    log(f"[policies] {case_dir.name}, the card against device='cpu' {json.dumps(report)}")


def phase_finish(torch, seed: int, size: int, tmp: Path) -> None:
    """``uint12`` and the device postprocess on a scene resampled onto its DEM's grid."""
    dem_size = size * 15 // 16  # 3840 of 4096: the DEM's cell is 16/15 of the model's
    dem_fp, depth_fp = scene_inputs(tmp, seed + 300, size, tag="_finish", dem_size=dem_size)

    def run(transfer: str, device_post: bool, warm: bool = False) -> dict:
        os.environ["FLOODSR_DEVICE_POSTPROC"] = "1" if device_post else "0"
        try:
            return timed_tohr(
                torch, warm=warm, model_version="ResUNet_16x_DEM", model_fp=FLAGSHIP,
                depth_lr_fp=depth_fp, dem_hr_fp=dem_fp, device="cuda",
                output_fp=tmp / f"finish_{transfer}_{int(device_post)}.tif",
                engine_options={"output_transfer": transfer},
            )
        finally:
            os.environ.pop("FLOODSR_DEVICE_POSTPROC", None)

    runs = {
        ("uint16", True): run("uint16", True, warm=True),
        ("uint16", False): run("uint16", False),
        ("float32", True): run("float32", True),
        ("float32", False): run("float32", False),
        ("uint12", True): run("uint12", True),
        ("uint12", False): run("uint12", False),
    }
    step16, step12 = 5.0 / 65535.0, 5.0 / 4095.0
    for key, r in runs.items():
        if r["pred"].shape != (dem_size, dem_size):
            raise AssertionError(f"finish {key}: output {r['pred'].shape}, DEM grid {dem_size}")
        # The device masks before it requantizes, so a kept depth may come
        # back half a code under the threshold; nothing lower survives.
        floor = 1e-3 - {"float32": 0.0, "uint16": step16, "uint12": step12}[key[0]]
        if ((r["pred"] > 0) & (r["pred"] < floor)).any():
            raise AssertionError(f"finish {key}: depths under the low-depth mask survived")
    ref = runs[("float32", True)]["pred"]
    # uint12 against float32, both through the device postprocess: within one
    # 12-bit step (half a step of the 12-bit code, the uint16 codes before and
    # after the resample, f32 lerp rounding)
    err12 = float(np.abs(runs[("uint12", True)]["pred"] - ref).max())
    if not err12 <= step12 + 1e-6:  # f32 rounding of the step itself
        raise AssertionError(f"uint12 vs float32: max |diff| {err12} > max_depth/4095 = {step12}")
    # device postprocess against the host resampler, the switch off
    # (uint12: a 12-bit code taken before the lerp on one side and after it on
    # the other, so up to two of its steps)
    gates = {"float32": 1e-5, "uint16": step16 + 1e-5, "uint12": 2 * step12}
    errs = {}
    for transfer, gate in gates.items():
        dev, host = runs[(transfer, True)]["pred"], runs[(transfer, False)]["pred"]
        # a pixel at the low-depth threshold may fall on either side of it
        both = (dev >= 1e-3) == (host >= 1e-3)
        errs[transfer] = float(np.abs(dev - host)[both].max())
        if not (errs[transfer] <= gate and float(np.mean(both)) > 0.9999):
            raise AssertionError(
                f"device postprocess vs host resampler ({transfer}): max |diff| {errs[transfer]} "
                f"> {gate}, or {float(np.mean(~both))} of the pixels masked on one side only"
            )
    report = {
        f"{transfer}_{'device' if dev else 'host'}": {
            k: r["timings"][k]
            for k in ("finish_s", "device_post_s", "d2h_wait_s", "d2h_bytes", "host_dequant_s",
                      "host_resample_s", "host_sink_s")
        } | {"e2e_s": r["e2e_s"]}
        for (transfer, dev), r in runs.items()
    }
    log(
        f"[finish] {size}x{size} model grid onto a {dem_size}x{dem_size} DEM grid: max |uint12 - "
        f"float32| {err12:.3e} m (step {step12:.3e}); device postprocess vs host resampler "
        f"{json.dumps(errs)} (gates {json.dumps(gates)})"
    )
    log(f"[finish] stage seconds {json.dumps(report)}")


def phase_onnx(torch, seed: int, size: int, tmp: Path, with_profile: bool = False) -> dict:
    """The replica graph: interpreter, converted graph and torch module; two scenes."""
    sys.path.insert(0, str(ROOT / "tests"))
    from onnx_replica import HR_TILE, LR_TILE, build_reference_replica

    from floodsr_tpu_torch.device import set_strict_f32
    from floodsr_tpu_torch.nn.checkpoint import load_artifact
    from floodsr_tpu_torch.nn.onnx_convert import GraphProgram, convert_onnx_to_fsrz
    from floodsr_tpu_torch.nn.onnx_exec import OnnxGraphExecutor
    from floodsr_tpu_torch.nn.onnx_reader import count_parameters, load_model

    t0 = time.perf_counter()
    data, torch_net = build_reference_replica(seed=seed, f=40)
    onnx_fp, fsrz_fp = tmp / "replica.onnx", tmp / "replica.fsrz"
    onnx_fp.write_bytes(data)
    convert_onnx_to_fsrz(onnx_fp, fsrz_fp)
    model = load_model(onnx_fp)
    n_params = count_parameters(model)
    build_s = time.perf_counter() - t0

    # A batch of tiles through the three: full f32 everywhere (TF32 off).
    set_strict_f32()
    rng = np.random.default_rng(seed + 400)
    depth = torch.from_numpy(rng.uniform(0, 1, (4, LR_TILE, LR_TILE, 1)).astype(np.float32)).cuda()
    dem = torch.from_numpy(rng.uniform(0, 1, (4, HR_TILE, HR_TILE, 1)).astype(np.float32)).cuda()
    art = load_artifact(fsrz_fp)
    edge = art["manifest"]["graph_output_edge"]
    program = GraphProgram(art["manifest"]["graph_ir"], art["params"], depth.device)
    executor = OnnxGraphExecutor(model, depth.device)
    with torch.no_grad():
        want = torch_net.cuda()(depth, dem)
    interp = executor({"depth_lr": depth, "dem_hr": dem})["depth_hr_pred"]
    graph = program({"depth_lr": depth, "dem_hr": dem}, [edge])[edge]
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    errs = {
        "interpreter_vs_module": (interp - want).abs().max().item(),
        "converted_vs_module": (graph - want).abs().max().item(),
        "converted_vs_interpreter": (graph - interp).abs().max().item(),
    }
    # f32 sums in cuDNN's order on each side (the converted graph folds the
    # batch norms into its weights and runs channels-last): 1e-4 of the range
    if not (tuple(want.shape) == (4, HR_TILE, HR_TILE, 1) and max(errs.values()) <= 1e-4 * scale):
        raise AssertionError(f"onnx replica on a batch of tiles: {errs} > 1e-4 * {scale}")
    interp_ms = time_ms(torch, lambda: executor({"depth_lr": depth, "dem_hr": dem}), reps=3, warmup=1)
    graph_ms = time_ms(torch, lambda: program({"depth_lr": depth, "dem_hr": dem}, [edge]), reps=3, warmup=1)
    del program, executor, interp, graph, want
    torch_net.cpu()
    torch.cuda.empty_cache()

    dem_fp, depth_fp = scene_inputs(tmp, seed + 401, size, tag="_onnx")
    runs = {}
    for name, fp in (("onnx", onnx_fp), ("converted", fsrz_fp)):
        torch.cuda.reset_peak_memory_stats()
        kw = dict(
            model_version="ResUNet_16x_DEM", model_fp=fp, depth_lr_fp=depth_fp,
            dem_hr_fp=dem_fp, output_fp=tmp / f"onnx_{name}.tif", device="cuda",
        )
        runs[name] = timed_tohr(torch, **kw)
        runs[name]["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        if with_profile:
            traced(torch, f"onnx scene ({name})", runs[name]["e2e_s"], **kw)
    tiles = runs["onnx"]["tiles"]
    chunks = -(-tiles // 8)  # one whole forward, and one K2 launch, per chunk of 8 tiles
    for name, run in runs.items():
        counts = run["counts"]
        if counts["hr_tail"] != 0 or counts["tile_stats"] != chunks or counts["relax_step"] != 0:
            raise AssertionError(
                f"onnx scene ({name}): launches {counts}; expected tile_stats {chunks}, no other"
            )
        if run["routes"]["tile_stats"]["one_read"] != chunks:
            raise AssertionError(f"onnx scene ({name}): tile_stats by route {run['routes']['tile_stats']}")
        if run["pred"].shape != (size, size) or not float(run["pred"].max()) > 0.0:
            raise AssertionError(f"onnx scene ({name}): empty or misshapen output")
    err = rmse_m(runs["onnx"]["pred"], runs["converted"]["pred"])
    if not err <= 1e-4:
        raise AssertionError(f"onnx scene: interpreter vs converted graph RMSE {err} m > 1e-4")
    report = {
        name: {"e2e_s": r["e2e_s"], "exec_s": r["timings"]["exec_s"],
               "finish_s": r["timings"]["finish_s"], "peak_mib": r["peak_mib"]}
        for name, r in runs.items()
    }
    log(
        f"[onnx] replica f=40, {n_params:,} parameters, built and converted in {build_s:.2f} s; "
        f"4 tiles: {json.dumps(errs)} of max |out| {scale:.3f}; interpreter {interp_ms:.1f} ms, "
        f"converted graph {graph_ms:.1f} ms a batch of 4"
    )
    log(
        f"[onnx] {size}x{size} scene, {tiles} tiles, single-phase, {chunks} K2 launches, K1 none: "
        f"{json.dumps(report)}; interpreter vs converted RMSE {err:.3e} m"
    )
    return {"launches": runs["onnx"]["counts"]}


TRAIN_SCENES = 24   # synthetic 512² scenes, as bin/train_flagship.py::build_dataset
TRAIN_BATCH = 8     # the reference's batch (bin/train_flagship.py)
TRAIN_CALLS = 3     # timed resident loop calls after one warm-up call
TRAIN_STEPS_PER_CALL = 10


def forward_macs(cfg, n: int) -> int:
    """Multiply-adds of one ResUNet forward over ``n`` LR tiles, from the config
    (every convolution, transposed convolution and the head)."""
    from floodsr_tpu_torch.nn.resunet import split_scale

    def conv(hw, k, cin, cout):
        return n * hw * hw * k * k * cin * cout

    def block(hw, cin, cout):
        return conv(hw, 3, cin, cout) + conv(hw, 3, cout, cout) + (conv(hw, 1, cin, cout) if cin != cout else 0)

    f, hw = cfg.base_filters, cfg.lr_tile
    macs, cin = conv(hw, 3, 2, f), f
    for stage, w in enumerate(cfg.widths):
        for bi in range(cfg.enc_blocks):
            hw //= 2 if (stage > 0 and bi == 0) else 1
            macs += block(hw, cin, w)
            cin = w
    for w in reversed(cfg.widths[:-1]):
        macs += n * hw * hw * cin * 4 * w  # kernel == stride 2: one matmul
        hw, cin = hw * 2, 2 * w
        for _ in range(cfg.dec_blocks):
            macs += block(hw, cin, w)
            cin = w
    s2d = int(cfg.hr_s2d)
    s0, s1 = split_scale(cfg.scale // s2d)
    macs += n * hw * hw * cin * s0 * s0 * f
    hw *= s0
    macs += n * hw * hw * f * s1 * s1 * f * s2d
    hw *= s1
    macs += conv(hw, 3, s2d * s2d, cfg.fuse_filters)
    cin = f * s2d + cfg.fuse_filters
    for _ in range(cfg.fuse_blocks):
        macs += block(hw, cin, f * s2d)
        cin = f * s2d
    return macs + conv(hw, 1, f * s2d, s2d * s2d)


def flat_tree(tree, prefix: str = "") -> dict:
    """``{dotted path: float64 array}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in flat_tree(tree[k], f"{prefix}.{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat_tree(v, f"{prefix}.{i}").items()}
    return {prefix: np.asarray(tree, dtype=np.float64)}


def train_max_errs(tt, a, b, p0: dict, lr: float) -> dict:
    """Card state ``a`` against CPU state ``b`` after one step from the
    parameters ``p0``: the largest differences, each as its tolerance reads it.

    BN running stats in absolute terms; each Adam moment against the largest
    moment of its kind (a leaf whose gradient is small through cancellation,
    or rounding noise as every block's ``conv1.b``, which feeds a batch norm
    alone, differs far more than 1e-3 of its own max); the card's parameters
    against optax's update computed in float64 from the card's own moments,
    in units of ``lr`` (Adam divides each element by its own ``|g|``, so an
    element whose gradient is noise may move by ``lr`` either way on the two
    devices: that share is reported, not held).
    """
    from floodsr_tpu_torch.nn.checkpoint import params_to_jax

    pa, sa = (flat_tree(t) for t in params_to_jax(a.model.state_dict()))
    pb, sb = (flat_tree(t) for t in params_to_jax(b.model.state_dict()))
    oa, ob = flat_tree(tt.opt_state_to_numpy(a.opt_state)), flat_tree(tt.opt_state_to_numpy(b.opt_state))
    out = {"bn_stats_abs": max(float(np.abs(sa[k] - sb[k]).max()) for k in sb)}
    for name, kind in (("mu", ".1.0.1"), ("nu", ".1.0.2")):
        keys = [k for k in ob if k.startswith(kind + ".")]
        top = max(np.abs(ob[k]).max() for k in keys)
        errs = {k: float(np.abs(oa[k] - ob[k]).max() / top) for k in keys}
        worst = max(errs, key=errs.get)
        out[f"adam_{name}_of_top"] = errs[worst]
        out[f"adam_{name}_worst_leaf"] = worst[len(kind) + 1:]
    for key in (".1.0.0", ".1.1.0"):
        if oa[key] != ob[key]:
            raise AssertionError(f"train: optimizer count {key} {oa[key]} != {ob[key]}")
    update, moved = 0.0, 0
    for key, p1 in pa.items():
        u = (oa[".1.0.1" + key] / (1 - 0.9)) / (np.sqrt(oa[".1.0.2" + key] / (1 - 0.999)) + 1e-8)
        update = max(update, float(np.abs(p1 - (p0[key] - lr * u)).max() / lr))
        moved += int((np.abs(p1 - pb[key]) > 1e-3 * lr).sum())
    out["update_vs_formula_of_lr"] = update
    out["share_moved_apart"] = moved / sum(v.size for v in pa.values())
    return out


def phase_train(torch, seed: int, tmp: Path, card: str, with_profile: bool = False) -> dict:
    """Train the flagship configuration on the card: card vs CPU, timed
    resident loops in float32 and bfloat16 (with ``with_profile``, one more
    call of each traced), the eval step (K1), checkpoint round trip, export
    and ``tohr`` with the exported artifact."""
    import zipfile

    from torch.utils.flop_counter import FlopCounterMode

    import floodsr_tpu_torch.ops.kernels.hr_tail as ht
    from floodsr_tpu_torch.io import read_raster
    from floodsr_tpu_torch.nn.checkpoint import params_to_jax
    from floodsr_tpu_torch.nn.resunet import ResUNet, ResUNetConfig, count_params, init_resunet
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, route_counts
    from floodsr_tpu_torch.tohr import tohr
    from floodsr_tpu_torch.train import PatchDataset, TrainConfig, split_indices
    from floodsr_tpu_torch.train import trainer as tt
    from floodsr_tpu_torch.train.synth import box_mean, make_terrain, make_truth

    with zipfile.ZipFile(FLAGSHIP) as zf:
        cfg = ResUNetConfig.from_dict(json.loads(zf.read("manifest.json"))["config"])
    n_params = count_params(init_resunet(seed, cfg)[0])
    if n_params != 16_661_616:
        raise AssertionError(f"train: flagship config has {n_params} parameters")
    t0 = time.perf_counter()
    hr = cfg.hr_tile
    dems = [make_terrain((hr, hr), 31000 + seed + i) for i in range(TRAIN_SCENES)]
    truths = [make_truth(d, 31000 + seed + i) for i, d in enumerate(dems)]
    dataset = PatchDataset(
        depth_lr=np.stack([box_mean(t, cfg.scale) for t in truths]),
        dem_hr=np.stack(dems), target_hr=np.stack(truths),
    )
    train_idx, val_idx = split_indices(len(dataset), val_fraction=1 / 3, seed=seed)
    data = tt.stage_dataset_to_device(dataset, train_idx, device="cuda")
    val = {k: v.numpy() for k, v in tt.stage_dataset_to_device(dataset, val_idx, device="cpu").items()}
    tcfg = TrainConfig(base_lr=4e-4, second_lr=1e-4)
    setup_s = time.perf_counter() - t0

    # 1. the first step on the card against the same step on the CPU
    batch = {k: v[:TRAIN_BATCH].cpu().numpy() for k, v in data.items()}
    first = {}
    for dev in ("cuda", "cpu"):
        state = tt.init_train_state(seed, cfg, tcfg, device=dev)
        p0 = flat_tree(params_to_jax(state.model.state_dict())[0])
        t1 = time.perf_counter()
        state, metrics = tt.make_train_step(cfg, tcfg)(state, batch)
        first[dev] = (state, {k: float(v) for k, v in metrics.items()}, time.perf_counter() - t1)
    (gpu, mg, _), (cpu, mc, cpu_s) = first["cuda"], first["cpu"]
    errs = {
        "loss_rel": abs(mg["loss"] - mc["loss"]) / abs(mc["loss"]),
        "grad_norm_rel": abs(mg["grad_norm"] - mc["grad_norm"]) / abs(mc["grad_norm"]),
        **train_max_errs(tt, gpu, cpu, p0, tcfg.base_lr),
    }
    tol = {
        "loss_rel": 1e-4, "grad_norm_rel": 1e-3, "bn_stats_abs": 1e-4,
        "adam_mu_of_top": 1e-2, "adam_nu_of_top": 1e-2, "update_vs_formula_of_lr": 1e-3,
    }
    log(f"[train] first step, card vs CPU (batch {TRAIN_BATCH}, CPU step {cpu_s:.1f} s): "
        f"{json.dumps(errs)} (tolerances {json.dumps(tol)}); loss {mg['loss']:.6f} grad_norm {mg['grad_norm']:.4f}")
    if not all(errs[k] <= tol[k] for k in tol):
        raise AssertionError(f"train: card vs CPU {errs} > {tol}")
    cpu_first = leaves_of(tt, cpu)  # the CPU's first step, phase_train_mesh's yardstick
    del first, gpu, cpu

    # FLOPs of one step: counted over the step's products, and from the config
    state = tt.init_train_state(seed, cfg, tcfg, device="cuda")
    counter = FlopCounterMode(display=False)
    with counter:
        tt.make_train_step(cfg, tcfg, donate=False)(state, batch)
    step_flops = counter.get_total_flops()
    fwd_flops = 2 * forward_macs(cfg, TRAIN_BATCH)
    if not 2.5 * fwd_flops <= step_flops <= 3.05 * fwd_flops:
        raise AssertionError(f"train: counted {step_flops:.4g} FLOPs, forward {fwd_flops:.4g} from the config")

    # 2. timed resident loops: one warm-up call, then TRAIN_CALLS calls
    runs = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        state = tt.init_train_state(seed, cfg, tcfg, device="cuda")
        loop = tt.make_resident_train_loop(
            cfg, tcfg, batch_size=TRAIN_BATCH, steps_per_call=TRAIN_STEPS_PER_CALL, compute_dtype=dtype,
        )
        rng = tt.ResidentRng.from_seed(seed, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, warm = loop(state, data, rng)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        curve = [warm]
        for _ in range(TRAIN_CALLS):
            state, losses = loop(state, data, rng)
            curve.append(losses)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (TRAIN_CALLS * TRAIN_STEPS_PER_CALL)
        losses = torch.cat(curve).cpu().numpy()
        if not (np.isfinite(losses).all() and losses.shape == ((TRAIN_CALLS + 1) * TRAIN_STEPS_PER_CALL,)):
            raise AssertionError(f"train ({name}): losses {losses}")
        if with_profile:
            prof = device_profile(torch, lambda: loop(state, data, rng))
            prof["device_idle_share"] = 1.0 - prof["device_busy_s"] / (ms * TRAIN_STEPS_PER_CALL / 1e3)
            log(f"[profile] train loop ({name}, {TRAIN_STEPS_PER_CALL} steps) {json.dumps(prof)}")
        runs[name] = {
            "ms_per_step": ms, "steps_per_s": 1e3 / ms,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "share_of_f32_peak": step_flops / (ms * 1e-3) / PEAK_F32_PER_S,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "loss_curve": [round(float(v), 5) for v in losses],
        }
        if name == "float32":
            trained = state
        else:
            del state
    log(f"[train] step: {step_flops:.4g} FLOPs counted (forward {fwd_flops:.4g} from the config, "
        f"x{step_flops / fwd_flops:.3f}); bound at the f32 peak {step_flops / PEAK_F32_PER_S * 1e3:.2f} ms")
    for name, run in runs.items():
        log(f"[train] {name} on {card}: {json.dumps(run)}")

    # 3. the eval step on the held-out batch: K1 on its tensor-core route
    eval_step = tt.make_eval_step(cfg, tcfg)
    k1_ms = []
    launch = ht.hr_tail_cuda

    def timed_launch(*args, **kw):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = launch(*args, **kw)
        ev[1].record()
        k1_ms.append(ev)
        return out

    eval_step(trained, val)  # warm
    torch.cuda.synchronize()
    reset_launch_counts()
    ht.hr_tail_cuda = timed_launch
    try:
        t1 = time.perf_counter()
        got = eval_step(trained, val)
        got = {k: float(v) for k, v in got.items()}
        eval_s = time.perf_counter() - t1
    finally:
        ht.hr_tail_cuda = launch
    counts, routes = launch_counts(), route_counts()["hr_tail"]
    if not (counts["hr_tail"] > 0 and routes["tensor"] == counts["hr_tail"] == len(k1_ms)):
        raise AssertionError(f"train: eval step's hr_tail launches {counts} by route {routes}")
    cpu_model = ResUNet(cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in trained.model.state_dict().items()})
    want = {k: float(v) for k, v in eval_step(tt.TrainState(0, cpu_model, {}, []), val).items()}
    if not all(abs(got[k] - want[k]) <= 1e-3 * max(1.0, abs(want[k])) for k in want):
        raise AssertionError(f"train: eval on the card {got} vs the CPU {want}")
    k1_eval_ms = sum(a.elapsed_time(b) for a, b in k1_ms)
    log(f"[train] eval step ({len(val_idx)} held-out tiles): {json.dumps(got)}; CPU agrees to 1e-3; "
        f"K1 {counts['hr_tail']} launch(es) on the tensor-core route, {k1_eval_ms:.3f} ms of "
        f"{eval_s * 1e3:.1f} ms")

    # 4. checkpoint round trip, export, tohr with the exported artifact
    t1 = time.perf_counter()
    ckpt = tt.save_train_state(tmp / "train_ckpt.fsrz", trained, cfg)
    restored, cfg2 = tt.restore_train_state(ckpt, tcfg, device="cuda")
    saved, back = trained.model.state_dict(), restored.model.state_dict()
    opt_saved = flat_tree(tt.opt_state_to_numpy(trained.opt_state))
    opt_back = flat_tree(tt.opt_state_to_numpy(restored.opt_state))
    same = (
        cfg2 == cfg and restored.step == trained.step and list(saved) == list(back)
        and all(torch.equal(saved[k], back[k]) for k in saved)
        and list(opt_saved) == list(opt_back)
        and all(np.array_equal(opt_saved[k], opt_back[k]) for k in opt_saved)
    )
    if not same:
        raise AssertionError("train: the restored checkpoint differs from the saved state")
    exported = tt.export_inference_artifact(tmp / "exported.fsrz", trained, cfg, {"steps": trained.step})
    ckpt_s = time.perf_counter() - t1
    case = DATA / "synth_flagship"
    spec = json.loads((case / "case_spec.json").read_text())
    reset_launch_counts()
    tohr(
        model_version="ResUNet_16x_DEM", model_fp=exported,
        depth_lr_fp=case / spec["inputs"]["lowres_fp"], dem_hr_fp=case / spec["inputs"]["dem_fp"],
        output_fp=tmp / "train_exported.tif", device="cuda",
    )
    tohr_counts = launch_counts()
    pred, _, _ = read_raster(tmp / "train_exported.tif")
    if not (np.isfinite(pred).all() and tohr_counts["hr_tail"] > 0 and tohr_counts["tile_stats"] > 0):
        raise AssertionError(f"train: tohr with the exported artifact: launches {tohr_counts}")
    log(f"[train] checkpoint ({ckpt.stat().st_size / 2**20:.1f} MiB) saved, restored bit for bit "
        f"and exported in {ckpt_s:.1f} s; tohr on synth_flagship with the export: launches {tohr_counts}")
    report = {
        "card": card, "config": "flagship", "params": n_params, "batch": TRAIN_BATCH,
        "scenes": TRAIN_SCENES,
        "phase_s": time.perf_counter() - t0, "setup_s": setup_s, "checkpoint_s": ckpt_s,
        "step_flops": step_flops, "forward_flops_from_config": fwd_flops,
        "card_vs_cpu": errs, "eval": got, "k1_eval_launches": counts["hr_tail"], "k1_eval_ms": k1_eval_ms,
        **{f"{name}_{k}": v for name, run in runs.items() for k, v in run.items() if k != "loss_curve"},
    }
    print(json.dumps({"train": report}), flush=True)
    return {
        "k1_launches_eval": counts["hr_tail"], "k1_eval_ms": k1_eval_ms,
        "cfg": cfg, "tcfg": tcfg, "batch": batch, "val": val, "cpu_first": cpu_first,
    }


MESH_TRAIN_STEPS = 10  # timed steps of each sharded step (CUDA events)


def leaves_of(tt, state) -> dict:
    """A port state's leaves as float64 numpy (a placed state gathered from
    its first row): ``p.`` parameters and running stats, ``mu.``/``nu.`` the
    Adam moments, ``counts`` the two counts."""
    whole = tt.unshard_train_state(state)
    out = {f"p.{k}": v.cpu().double().numpy() for k, v in whole.model.state_dict().items()}
    (count, mu, nu), (sched,) = whole.opt_state[-1]
    out.update({f"mu.{k}": v.cpu().double().numpy() for k, v in mu.items()})
    out.update({f"nu.{k}": v.cpu().double().numpy() for k, v in nu.items()})
    out["counts"] = np.array([int(count), int(sched)])
    return out


def mesh_vs_single(got: dict, want: dict, cpu: dict, start: dict, lr: float) -> dict:
    """One sharded step's leaves (``got``) against the single step's on the
    card (``want``), both from ``start``, with the same step on the CPU
    (``cpu``) as the yardstick of the card's own noise.

    ``tests/test_torch_train_mesh.py``'s tolerances for the moments and the
    running stats, each widened by twice the single step's distance from the
    CPU's on that leaf: cuDNN's strict-f32 algorithms put about 2e-4 of a
    leaf's largest gradient of noise into the card's gradients at the
    flagship's widths, and noise where the CPU's gradient is exactly 0
    (``tools/train_mesh_grad_noise.py``). Each moment's difference over 1e-3
    of its leaf's largest (the largest of its kind for ``conv1.b``, whose
    true gradient is 0) plus that; the running stats' over 1e-5 (``bn2.mean``:
    plus ``(1 − momentum) · 2 · 3.2 · lr``) plus that. The parameters as
    ``phase_train`` holds the card: Adam divides each element by its own
    ``|g|``, so one whose gradient is near the noise or near Adam's ``eps``
    moves apart on two devices; each parameter is held instead to optax's
    update computed in float64 from the step's own moments (in units of
    ``lr``), and to Adam's bound ``3.2 · lr``; the share of elements more than
    1e-3 of ``lr`` from the single step's is reported. Each reading but that
    share must stay at or under 1; the counts equal."""
    bound = 3.2 * lr
    tops = {kind: max(np.abs(v).max() for k, v in want.items() if k.startswith(kind))
            for kind in ("mu.", "nu.")}
    out = {"adam_bound": 0.0, "update_vs_formula": 0.0, "mu": 0.0, "nu": 0.0, "bn_stats": 0.0}
    worst, moved, size = {}, 0, 0
    for key, w in want.items():
        g, noise = got[key], key.endswith("conv1.b")
        if key == "counts":
            if not np.array_equal(g, w):
                raise AssertionError(f"train_mesh: counts {g} != {w}")
            continue
        card = 2 * np.abs(w - cpu[key]).max()
        readings = {}
        if key.startswith(("mu.", "nu.")):
            scale = 1e-3 * (tops[key[:3]] if noise else np.abs(w).max())
            readings[key[:2]] = np.abs(g - w).max() / (scale + card)
        elif key.endswith((".mean", ".var")):
            atol = 1e-5 + (0.02 * bound if key.endswith("bn2.mean") else 0.0)
            readings["bn_stats"] = np.abs(g - w).max() / (atol + card)
        else:
            mu, nu = got["mu." + key[2:]], got["nu." + key[2:]]
            update = (mu / (1 - 0.9)) / (np.sqrt(nu / (1 - 0.999)) + 1e-8)
            readings["update_vs_formula"] = np.abs(g - (start[key] - lr * update)).max() / (1e-3 * lr)
            readings["adam_bound"] = np.abs(g - start[key]).max() / bound
            moved += int((np.abs(g - w) > 1e-3 * lr).sum())
            size += g.size
        for kind, err in readings.items():
            if float(err) > out[kind]:
                out[kind], worst[kind] = float(err), key
    out["share_moved_apart"] = moved / size
    out["worst_leaf"] = worst
    return out


def placed_ok(torch, tt, placed) -> None:
    """Every replica bit-equal to row 0's, every tensor on its entry's device,
    and each ``tp`` piece a ``1/tp`` slice of the whole leaf."""
    tp = placed.mesh.shape["tp"]
    whole = tt.unshard_train_state(placed, "cuda").model.state_dict()
    for (i, j), entry in np.ndenumerate(placed.entries):
        first = placed.entries[0, j]
        sd, sd0 = entry.model.state_dict(), first.model.state_dict()
        (c, mu, nu), (s,) = entry.opt_state[-1]
        (c0, mu0, nu0), (s0,) = first.opt_state[-1]
        same = all(torch.equal(sd[k], sd0[k]) for k in sd) and all(
            torch.equal(a[k], b[k]) for a, b in ((mu, mu0), (nu, nu0)) for k in a
        ) and torch.equal(c, c0) and torch.equal(s, s0)
        if not same:
            raise AssertionError(f"train_mesh: entry {(i, j)} differs from its row-0 replica")
        if any(t.device != placed.mesh.devices[i, j] for t in sd.values()):
            raise AssertionError(f"train_mesh: entry {(i, j)} holds a tensor off its device")
        for k in placed.split:
            piece = torch.chunk(whole[k], tp, dim=0)[j]
            if sd[k].shape[0] * tp != whole[k].shape[0] or not torch.equal(sd[k], piece):
                raise AssertionError(f"train_mesh: entry {(i, j)}'s piece of {k} is not slice {j} of {tp}")


def phase_train_mesh(torch, seed: int, tmp: Path, card: str, train: dict,
                     with_profile: bool = False) -> dict:
    """Training on a mesh of the one card: the flagship config at batch 8 over
    ``make_mesh(devices=[cuda:0] * 4)`` (dp=4) and ``... tp=2`` (dp=2, tp=2),
    each first step against the single step on the card, timed steps beside
    the single step's, the sharded eval step with K1 counted (``dp`` launches
    a call), a checkpoint round trip of the placed state, and the same step
    over two GPUs where the machine has them. Four entries share one card:
    the times read the mesh's overheads, not a speed-up."""
    from floodsr_tpu_torch.device import resolve_device
    from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, route_counts
    from floodsr_tpu_torch.parallel.mesh import make_mesh
    from floodsr_tpu_torch.train import trainer as tt

    t0 = time.perf_counter()
    cfg, tcfg, val = train["cfg"], train["tcfg"], train["val"]
    cuda0 = resolve_device("cuda")
    batch = {k: torch.as_tensor(v).to(cuda0) for k, v in train["batch"].items()}
    meshes = {"dp4": make_mesh(devices=[cuda0] * 4), "dp2_tp2": make_mesh(devices=[cuda0] * 4, tp=2)}
    if torch.cuda.device_count() >= 2:
        meshes["two_gpus_dp2"] = make_mesh(2)

    def timed(step, state) -> tuple[float, float]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(MESH_TRAIN_STEPS):
            state, metrics = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"train_mesh: loss {metrics}")
        return start.elapsed_time(end) / MESH_TRAIN_STEPS, torch.cuda.max_memory_allocated() / 2**20

    # the single step on the card: the reference of the first step, then timed
    single = tt.init_train_state(seed, cfg, tcfg, device="cuda")
    start = leaves_of(tt, single)
    single_step = tt.make_train_step(cfg, tcfg)
    single, m_single = single_step(single, batch)
    want = leaves_of(tt, single)
    m_single = {k: float(v) for k, v in m_single.items()}
    ms, peak = timed(single_step, single)
    report = {"card": card, "config": "flagship", "batch": TRAIN_BATCH,
              "timed_steps": MESH_TRAIN_STEPS, "single": {"ms_per_step": ms, "peak_mib": peak}}
    if with_profile:
        prof = device_profile(torch, lambda: single_step(single, batch))
        report["single"]["step_device_busy_ms"] = prof["device_busy_s"] * 1e3
        report["single"]["step_device_idle_share"] = 1.0 - prof["device_busy_s"] * 1e3 / ms
    del single
    launches = {}
    eval_step_single = tt.make_eval_step(cfg, tcfg)
    for name, mesh in meshes.items():
        placed = tt.shard_train_state(tt.init_train_state(seed, cfg, tcfg, device="cuda"), mesh)
        step = tt.make_train_step(cfg, tcfg, mesh=mesh)
        placed, metrics = step(placed, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        errs = {
            "loss_rel": abs(metrics["loss"] - m_single["loss"]) / abs(m_single["loss"]),
            "grad_norm_rel": abs(metrics["grad_norm"] - m_single["grad_norm"]) / abs(m_single["grad_norm"]),
            **mesh_vs_single(leaves_of(tt, placed), want, train["cpu_first"], start, tcfg.base_lr),
        }
        log(f"[train_mesh] {name} first step against the single step: {json.dumps(errs)}")
        held = errs["loss_rel"] <= 1e-5 and errs["grad_norm_rel"] <= 1e-5 and all(
            errs[k] <= 1.0 for k in ("adam_bound", "update_vs_formula", "mu", "nu", "bn_stats")
        )
        if not held:
            raise AssertionError(f"train_mesh: {name} against the single step: {errs}")
        placed_ok(torch, tt, placed)
        ms, peak = timed(step, placed)
        entry = {"first_step": errs, "ms_per_step": ms, "peak_mib": peak}
        if with_profile:
            prof = device_profile(torch, lambda: step(placed, batch))
            entry["step_device_busy_ms"] = prof["device_busy_s"] * 1e3
            entry["step_device_idle_share"] = 1.0 - prof["device_busy_s"] * 1e3 / ms
            log(f"[profile] train_mesh {name} step {json.dumps(prof)}")

        eval_step = tt.make_eval_step(cfg, tcfg, mesh=mesh)
        eval_step(placed, val)  # warm: K1's weight pack, cuDNN's plans
        torch.cuda.synchronize()
        reset_launch_counts()
        t1 = time.perf_counter()
        got = {k: float(v) for k, v in eval_step(placed, val).items()}
        eval_s = time.perf_counter() - t1
        counts, routes = launch_counts(), route_counts()["hr_tail"]
        dp = mesh.shape["dp"]
        if not counts["hr_tail"] == routes["tensor"] == dp:
            raise AssertionError(f"train_mesh: {name} eval launched K1 {counts} by route {routes}, dp={dp}")
        ref = {k: float(v) for k, v in eval_step_single(tt.unshard_train_state(placed, "cuda"), val).items()}
        if not all(abs(got[k] - ref[k]) <= 1e-3 * max(1.0, abs(ref[k])) for k in ref if np.isfinite(ref[k])):
            raise AssertionError(f"train_mesh: {name} sharded eval {got} vs unsharded {ref}")
        launches[name] = counts["hr_tail"]
        entry.update({"eval_s": eval_s, "eval_k1_launches": counts["hr_tail"], "eval": got})
        if with_profile:
            prof = device_profile(torch, lambda: eval_step(placed, val))
            if not prof["kernel_device_ms"]["hr_tail"] > 0:
                raise AssertionError(f"train_mesh: the profiler saw no K1 in {name}'s eval: {prof}")
            entry["eval_k1_device_ms"] = prof["kernel_device_ms"]["hr_tail"]
            log(f"[profile] train_mesh {name} eval {json.dumps(prof)}")
        if name == "dp2_tp2":
            fp = tt.save_train_state(tmp / "train_mesh_ckpt.fsrz", placed, cfg)
            restored, _ = tt.restore_train_state(fp, tcfg, device="cuda")
            if not all(np.array_equal(a, b) for a, b in zip(
                    leaves_of(tt, restored).values(), leaves_of(tt, placed).values())):
                raise AssertionError("train_mesh: the restored checkpoint differs from the placed state")
            entry["checkpoint_restored_bit_equal"] = True
        report[name] = entry
        log(f"[train_mesh] {name} on {card} (four entries share one card where the mesh repeats "
            f"it: overheads, not a speed-up): {ms:.2f} ms a step, peak {peak:.0f} MiB "
            f"(single step {report['single']['ms_per_step']:.2f} ms, {report['single']['peak_mib']:.0f} MiB); "
            f"eval {eval_s * 1e3:.1f} ms, K1 {counts['hr_tail']} launch(es)")
        del placed
    if "two_gpus_dp2" not in meshes:
        log("[train_mesh] two GPUs: not run (this machine has one)")
    report["two_gpus"] = "two_gpus_dp2" in meshes
    report["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"train_mesh": report}), flush=True)
    return {"k1_launches_eval": launches}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--profile", action="store_true",
        help="also trace one more run of the f32, bfloat16, mixed, CostGrow and ONNX scenes "
             "and of the training loops with torch.profiler (device time by kernel, the "
             "device's idle share)",
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
    k2 = phase_tile_stats(torch, rng)
    k1, k1_bf16 = phase_hr_tail(torch, rng)
    layouts = phase_hr_tail_layouts(torch, args.seed)
    layout_launches = phase_layout_scenes(torch, args.seed)
    # K1 at the two other HR layouts: each route's entry per (Cm, Ch), with
    # its launches in that layout's tohr scene; the bf16 band route is a
    # kernel of its own (hr_s2d 1's numbers at the top, the larger gap)
    for entries, dtype in ((layouts["tensor"], "float32"), (layouts["bf16_band"], "bfloat16")):
        for entry in entries.values():
            entry["launches"] = layout_launches[entry["hr_s2d"]][dtype]
    k1["layouts"] = layouts["tensor"]
    band = layouts["bf16_band"]["32,1"]
    k1_band = {
        "name": "hr_tail_bf16_band",
        "route": "cuda",
        "source": "floodsr_tpu_torch/csrc/hr_tail.cu",
        "replaces": "floodsr_tpu/ops/pallas/hr_tail.py:594",
        "launches": sum(e["launches"] for e in layouts["bf16_band"].values()),
        **{k: band[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "kernel": "tc::band::bf16_band_kernel",
        "layouts": layouts["bf16_band"],
    }
    if not k1_band["launches"] > 0:
        raise AssertionError(f"the bf16 band route was not launched by the layout scenes: {k1_band}")
    kernels = [k2, k1]
    phase_tohr_cases(torch)
    scene = phase_scene(torch, args.seed, SCENE_SIZE, args.profile)
    for k in kernels:
        k["launches"] = scene["launches"][k["name"]]
    k3 = phase_relax_step(torch, rng)
    phase_mcp_fill_oracle(torch, rng)
    costgrow = phase_costgrow_scene(torch, args.seed, SCENE_SIZE, args.profile)
    k3["launches"] = costgrow["CostGrow"]["launches"]["relax_step"]
    kernels.append(k3)
    phase_costgrow_small(torch, args.seed)
    phase_resunet_wse()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-serving-") as tmp:
        tmp = Path(tmp).resolve()
        stream = phase_stream(torch, args.seed, SCENE_SIZE, tmp)
        serve = phase_serve(torch, args.seed, SCENE_SIZE, tmp, stream)
        phase_cli(torch, args.seed, tmp)
        examples = phase_examples(torch, tmp)
        phase_gate(torch, tmp)
        bench = phase_bench(torch, tmp)
        mesh = phase_mesh(torch, args.seed, SCENE_SIZE, tmp, device["smi"])
        policies = phase_policies(torch, args.seed, SCENE_SIZE, tmp, args.profile)
        phase_finish(torch, args.seed, SCENE_SIZE, tmp)
        onnx = phase_onnx(torch, args.seed, SCENE_SIZE, tmp, args.profile)
        train = phase_train(torch, args.seed, tmp, device["smi"], args.profile)
        train_mesh = phase_train_mesh(torch, args.seed, tmp, device["smi"], train, args.profile)
    # Each serving path's own launches, read around that path alone.
    for k in kernels:
        k["launches_stream"] = stream["launches"][k["name"]]
        k["launches_serve"] = (
            serve["relax_step_launches"] if k["name"] == "relax_step"
            else serve["launches"][k["name"]]
        )
        if k["name"] != "relax_step" and not (k["launches_stream"] > 0 and k["launches_serve"] > 0):
            raise AssertionError(f"{k['name']} was not launched on a serving path: {k}")
        k["launches_onnx"] = onnx["launches"][k["name"]]
        # the mesh paths: four bands of the flagship scene on the card (K1,
        # K2), the banded fill (K3)
        k["launches_mesh"] = (
            mesh["launches"]["mcp_fill_sharded x4"] if k["name"] == "relax_step"
            else mesh["launches"]["banded x4"]
        )[k["name"]]
        if not k["launches_mesh"] > 0:
            raise AssertionError(f"{k['name']} was not launched on a mesh path: {k}")
    if not kernels[0]["launches_onnx"] > 0:
        raise AssertionError(f"tile_stats was not launched on the ONNX path: {kernels[0]}")
    # K1's bf16 route: its launches are those of the bfloat16 scene.
    k1_bf16["launches"] = policies["bf16_launches"]
    k1["bf16_route_ms"], k1["bf16_route_launches"] = k1_bf16["ms"], k1_bf16["launches"]
    if not k1_bf16["launches"] > 0:
        raise AssertionError(f"hr_tail's bf16 route was not launched by the bfloat16 scene: {k1_bf16}")
    kernels.insert(2, k1_bf16)
    # a flagship scene of bench_torch.py (its bfloat16 scene for the bf16 route);
    # the three user examples together (K1 in the tutorial only); neither
    # runs an hr_s2d 2 or 1 artifact, so the band route's launches are the
    # layout scenes' alone
    for k in kernels:
        if k["name"] != "relax_step":
            k["launches_bench"] = bench["launches"][k["name"]]
            k["launches_examples"] = examples[k["name"]]
    kernels.insert(3, k1_band)
    # K1 in the training path's eval step (the train step itself runs unfused)
    k1["launches_train_eval"], k1["train_eval_ms"] = train["k1_launches_eval"], train["k1_eval_ms"]
    # and once per dp row in the sharded eval step of each mesh
    k1["launches_train_mesh_eval"] = train_mesh["k1_launches_eval"]
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
