#!/usr/bin/env python3
"""K1's bf16 route against an earlier version of it, on one GPU, in one process.

    git show <commit>:floodsr_tpu_torch/csrc/hr_tail.cu > _tree/parent_hr_tail.cu
    python3 tools/hr_tail_bf16_vs_parent.py _tree/parent_hr_tail.cu

The earlier source's ``hr_tail_bf16_launch`` takes one of three argument
layouts, told apart by ``hr_tail_bf16_abi()``: a source without that symbol
has the layout from before the route read its operands by TMA, ``(sr, dem, B,
H, W, ca, cb, weights, packs, buf_p, buf_y, out, stream)`` with two f32 ``[B,
H, W, 128]`` scratch buffers; one that returns 2 the TMA route's, before the
tensor-core launchers took ``cm, ch`` after ``cb`` (``hr_tail_tc_launch``
too); one that returns 3 the current layout. Any other source is refused
before it is called. It is built with the same
``nvcc`` flags into ``floodsr_tpu_torch/_build/parent/`` (git-ignored) and
called through the same wrapper (``hr_tail_cuda(route="bf16")``: the same
checks and one workspace allocation, of which the older layout takes its two
buffers), so the two differ only in the library's entry point. Both routes
get the flagship artifact's fuse/head weights and the same post-ReLU features
at 8 tiles of 128x128 and at 1: their outputs are compared bit for bit, then
timed with CUDA events in turns (earlier, current, current, earlier), then
traced with ``torch.profiler`` for the device time of each launch. At one tile
the host's time per call (``time.perf_counter`` around the wrapper's call,
the launches enqueued, the card idle before each call) is taken with the two
interleaved call by call, twice, each time in the other order. The other routes (3xTF32 tensor cores, direct, direct bf16) of both
libraries are compared bit for bit at 8 tiles, with a sha256 of each output's
bytes, and the 3xTF32 route is timed in turns too. Then at the JAX
package's other two HR layouts (``hr_tail_s2d`` 2 and
1: ``chip_smoke.layout_tail``'s weights from ``init_resunet(--seed)`` and
features at 8 tiles), the earlier library's ``"bf16"`` route against this
one's ``"bf16_band"`` route (one launch, no scratch): bit for bit at 8 tiles,
at 1 and at a ragged 2 x 37 x 133, timed in turns at 8 tiles and 1, the
device time of each call traced, and the peak device memory of one 8-tile
call of each (the workspace included). One JSON line, with the card's name and
power limit; the exit code is 1 when any comparison differs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (time_ms, device_profile, bound, peak_mib, layout_tail)


_P, _I = ctypes.c_void_p, ctypes.c_int
#: hr_tail_bf16_launch's argument types by layout (hr_tail_bf16_abi(); 1 where
#: the source exports no such symbol)
BF16_ARGS = {
    1: [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    2: [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    3: [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
}
#: hr_tail_tc_launch's argument types: (cm, ch) after cb from layout 3 on
TC_ARGS = {
    1: [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    2: [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    3: [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
}


def build_parent(source: Path) -> tuple[ctypes.CDLL, int]:
    from floodsr_tpu_torch.ops.kernels import _build

    out_dir = _build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libhr_tail_parent.so"
    subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)],
        check=True, capture_output=True, text=True,
    )
    dll = ctypes.CDLL(str(lib))
    if not hasattr(dll, "hr_tail_bf16_launch"):
        raise SystemExit(f"{source} has no bf16 route (hr_tail_bf16_launch)")
    abi = 1
    if hasattr(dll, "hr_tail_bf16_abi"):
        dll.hr_tail_bf16_abi.restype = ctypes.c_int
        dll.hr_tail_bf16_abi.argtypes = []
        abi = dll.hr_tail_bf16_abi()
    if abi not in BF16_ARGS:
        raise SystemExit(
            f"{source}: hr_tail_bf16_launch argument layout {abi} is not one of {list(BF16_ARGS)}"
        )
    for name, argtypes in (
        ("hr_tail_bf16_launch", BF16_ARGS[abi]),
        ("hr_tail_tc_launch", TC_ARGS[abi]),
        ("hr_tail_launch", [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
        ("hr_tail_bf16_direct_launch", [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    ):
        fn = getattr(dll, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return dll, abi


class EarlierLibrary:
    """The wrapper's library with the earlier ``hr_tail_bf16_launch`` in its place."""

    def __init__(self, parent, abi: int, cm: int):
        self._parent, self._abi, self._cm = parent, abi, cm

    def __getattr__(self, name):
        # the routes whose entry points kept their signature: the earlier ones
        return getattr(self._parent, name)

    def hr_tail_tc_launch(self, sr, dem, b, h, w, ca, cb, cm, ch, weights, packs,
                          buf_p, buf_y, out, stream):
        if self._abi >= 3:
            return self._parent.hr_tail_tc_launch(
                sr, dem, b, h, w, ca, cb, cm, ch, weights, packs, buf_p, buf_y, out, stream
            )
        return self._parent.hr_tail_tc_launch(
            sr, dem, b, h, w, ca, cb, weights, packs, buf_p, buf_y, out, stream
        )

    def hr_tail_bf16_launch(self, sr, dem, b, h, w, ca, cb, cm, ch, weights, packs,
                            x_act, x_raw, act_a, act_b, y1, out, stream):
        if self._abi >= 3:
            return self._parent.hr_tail_bf16_launch(
                sr, dem, b, h, w, ca, cb, cm, ch, weights, packs, x_act, x_raw, act_a, act_b,
                y1, out, stream,
            )
        if self._abi == 2:
            return self._parent.hr_tail_bf16_launch(
                sr, dem, b, h, w, ca, cb, weights, packs, x_act, x_raw, act_a, act_b, y1, out,
                stream,
            )
        # layout 1: the workspace starts at x_act and holds more than two f32 [b,h,w,cm]
        buf = b * h * w * self._cm * 4
        return self._parent.hr_tail_bf16_launch(
            sr, dem, b, h, w, ca, cb, weights, packs, x_act, x_act + buf, out, stream
        )


def digest(t) -> str:
    """sha256 of a tensor's bytes (on the host), the first 16 hex digits."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def host_us(torch, fns, calls: int) -> list:
    """Median host microseconds of one call of each of ``fns``, interleaved
    call by call (so a drift of the host's speed reaches all alike), with the
    card idle before each call."""
    times = [[] for _ in fns]
    for _ in range(calls):
        for fn, acc in zip(fns, times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            acc.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return [statistics.median(t) * 1e6 for t in times]


def layouts(torch, ht, earlier_lib_for, seed: int, reps: int) -> dict:
    """The earlier ``"bf16"`` route against the ``"bf16_band"`` route at
    ``hr_s2d`` 2 and 1 (the module docstring)."""
    lib = ht._lib
    out = {}
    for s2d in chip_smoke.HR_TAIL_LAYOUTS:
        t = chip_smoke.layout_tail(torch, seed, s2d)
        weights, sr8, dem8 = t["weights"], t["sr"], t["dem"]
        ca, cb, cm, ch = t["dims"]
        pack = ht.pack_hr_tail_bf16(weights)
        earlier_lib = earlier_lib_for(cm)

        def earlier(sr, dem):
            ht._lib = lambda: earlier_lib
            try:
                return ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16")
            finally:
                ht._lib = lib

        def current(sr, dem):
            return ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16_band")

        work = chip_smoke.tail_work(sr8, dem8, weights, cm, ch)
        bound_ms = chip_smoke.bound(work["bytes"], 2 * work["macs"], chip_smoke.PEAK_BF16_PER_S)[0]
        entry = {"widths": f"{ca}+{cb}->{cm}->{ch}"}
        shapes = {
            "tiles_8": (sr8, dem8), "tiles_1": (sr8[:1], dem8[:1]),
            "ragged": (sr8[:2, :37, :133].contiguous(), dem8[:2, :37, :133].contiguous()),
        }
        for name, (sr, dem) in shapes.items():
            a, c = earlier(sr, dem), current(sr, dem)
            again = current(sr, dem)
            torch.cuda.synchronize()
            row = {
                "bit_equal": bool(torch.equal(a, c)), "repeatable": bool(torch.equal(c, again)),
                "sha256": {"earlier": digest(a), "current": digest(c)},
                "max_abs_diff": float((a - c).abs().max()),
            }
            if name != "ragged":
                turns = [
                    chip_smoke.time_ms(torch, lambda: earlier(sr, dem), reps=reps),
                    chip_smoke.time_ms(torch, lambda: current(sr, dem), reps=reps),
                    chip_smoke.time_ms(torch, lambda: current(sr, dem), reps=reps),
                    chip_smoke.time_ms(torch, lambda: earlier(sr, dem), reps=reps),
                ]
                tiles = int(sr.shape[0])
                device = {}
                for label, fn in (("earlier", earlier), ("current", current)):
                    prof = chip_smoke.device_profile(torch, lambda: [fn(sr, dem) for _ in range(5)])
                    device[label] = prof["kernel_device_ms"]["hr_tail"] / 5
                row.update(
                    ms_earlier=[turns[0], turns[3]], ms_current=[turns[1], turns[2]],
                    speedup=(turns[0] + turns[3]) / (turns[1] + turns[2]),
                    device_ms=device, bound_ms=bound_ms * tiles / 8,
                    share_of_bound=bound_ms * tiles / 8 / min(turns[1], turns[2]),
                )
            entry[name] = row
        entry["peak_mib_8_tiles"] = {
            "earlier": chip_smoke.peak_mib(torch, lambda: earlier(sr8, dem8)),
            "current": chip_smoke.peak_mib(torch, lambda: current(sr8, dem8)),
        }
        out[f"s2d_{s2d}"] = entry
        del t, weights, sr8, dem8, pack
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent_source", type=Path, help="the earlier csrc/hr_tail.cu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--host-calls", type=int, default=200)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("hr_tail_bf16_vs_parent: CUDA is not available", file=sys.stderr)
        return 2
    from floodsr_tpu_torch.engine import EngineTorch
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    parent, abi = build_parent(args.parent_source)
    engine = EngineTorch(chip_smoke.FLAGSHIP, device="cuda")
    model, cfg = engine.model, engine.config
    weights = ht.pack_hr_tail_weights(model.fuse[0], model.fuse[1], model.head, bn_eps=cfg.bn_eps)
    pack = ht.pack_hr_tail_bf16(weights)
    rng = np.random.default_rng(args.seed)
    hw, ca, cb = cfg.hr_tile // cfg.hr_s2d, cfg.base_filters * cfg.hr_s2d, cfg.fuse_filters
    sr8 = torch.from_numpy(np.abs(rng.normal(0, 1, (8, hw, hw, ca))).astype(np.float32)).cuda()
    dem8 = torch.from_numpy(np.abs(rng.normal(0, 1, (8, hw, hw, cb))).astype(np.float32)).cuda()
    cm, ch = ca, cfg.hr_s2d ** 2
    lib = ht._lib
    earlier_lib = EarlierLibrary(parent, abi, cm)

    def earlier(sr, dem):
        ht._lib = lambda: earlier_lib
        try:
            return ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16")
        finally:
            ht._lib = lib

    def earlier_route(sr, dem, route, pack_for):
        ht._lib = lambda: earlier_lib
        try:
            return ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack_for, route=route)
        finally:
            ht._lib = lib

    def current(sr, dem):
        return ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16")

    macs = 8 * hw * hw * (9 * (ca + cb) * cm + 3 * 9 * cm ** 2 + (ca + cb) * cm + cm * ch)
    report = {"device": torch.cuda.get_device_name(0), "smi": smi, "parent_abi": abi}
    for tiles in (8, 1):
        sr, dem = sr8[:tiles], dem8[:tiles]
        a, c = earlier(sr, dem), current(sr, dem)
        torch.cuda.synchronize()
        turns = [
            chip_smoke.time_ms(torch, lambda: earlier(sr, dem), reps=args.reps),
            chip_smoke.time_ms(torch, lambda: current(sr, dem), reps=args.reps),
            chip_smoke.time_ms(torch, lambda: current(sr, dem), reps=args.reps),
            chip_smoke.time_ms(torch, lambda: earlier(sr, dem), reps=args.reps),
        ]
        host = {}
        if tiles == 1:
            first = host_us(torch, [lambda: earlier(sr, dem), lambda: current(sr, dem)], args.host_calls)
            second = host_us(torch, [lambda: current(sr, dem), lambda: earlier(sr, dem)], args.host_calls)
            host = {
                "host_us_earlier": [first[0], second[1]],
                "host_us_current": [first[1], second[0]],
            }
        traced = {}
        for name, fn in (("earlier", earlier), ("current", current)):
            prof = chip_smoke.device_profile(torch, lambda: [fn(sr, dem) for _ in range(5)])
            # layout 1's route ran the 3xTF32 route's kernel with bf16 operands
            tma_route = name == "current" or abi == 2
            key = "hr_tail_bf16_ms_by_launch" if tma_route else "hr_tail_tc_ms_by_launch"
            traced[name] = {k: v / 5 for k, v in prof[key].items()}
        bound_ms = chip_smoke.bound(
            nbytes=0, nops=2 * macs * tiles / 8, ops_per_s=chip_smoke.PEAK_BF16_PER_S
        )[0]
        report[f"tiles_{tiles}"] = {
            "bit_equal": bool(torch.equal(a, c)),
            "sha256": {"earlier": digest(a), "current": digest(c)},
            "max_abs_diff": float((a - c).abs().max()),
            "ms_earlier": [turns[0], turns[3]],
            "ms_current": [turns[1], turns[2]],
            "speedup": (turns[0] + turns[3]) / (turns[1] + turns[2]),
            "ms_by_launch": traced,
            "bound_ms": bound_ms,
            **host,
        }
    tc_pack = ht.pack_hr_tail_tc(weights)
    others, hashes = {}, {}
    for route in ("tensor", "direct", "bf16_direct"):
        pack_for = tc_pack if route == "tensor" else None
        a = earlier_route(sr8, dem8, route, pack_for)
        c = ht.hr_tail_cuda(sr8, dem8, *weights, tc_pack=pack_for, route=route)
        torch.cuda.synchronize()
        others[route] = bool(torch.equal(a, c))
        hashes[route] = {"earlier": digest(a), "current": digest(c)}
    report["other_routes_bit_equal_8_tiles"] = others
    report["other_routes_sha256_8_tiles"] = hashes
    # the flagship's 3xTF32 route, timed in turns as the bf16 route above
    tc_turns = [
        chip_smoke.time_ms(torch, lambda: earlier_route(sr8, dem8, "tensor", tc_pack), reps=args.reps),
        chip_smoke.time_ms(torch, lambda: ht.hr_tail_cuda(sr8, dem8, *weights, tc_pack=tc_pack,
                                                          route="tensor"), reps=args.reps),
        chip_smoke.time_ms(torch, lambda: ht.hr_tail_cuda(sr8, dem8, *weights, tc_pack=tc_pack,
                                                          route="tensor"), reps=args.reps),
        chip_smoke.time_ms(torch, lambda: earlier_route(sr8, dem8, "tensor", tc_pack), reps=args.reps),
    ]
    report["tensor_ms_8_tiles"] = {"earlier": [tc_turns[0], tc_turns[3]],
                                   "current": [tc_turns[1], tc_turns[2]]}
    engine.close()
    report["layouts"] = layouts(
        torch, ht, lambda layout_cm: EarlierLibrary(parent, abi, layout_cm), args.seed, args.reps
    )
    print(json.dumps({"hr_tail_bf16_vs_parent": report}))
    same = all(report[f"tiles_{t}"]["bit_equal"] for t in (8, 1)) and all(others.values())
    same = same and all(
        row["bit_equal"] and row["repeatable"]
        for entry in report["layouts"].values() for name, row in entry.items()
        if name in ("tiles_8", "tiles_1", "ragged")
    )
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
