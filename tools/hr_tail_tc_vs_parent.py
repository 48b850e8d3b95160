#!/usr/bin/env python3
"""K1's 3xTF32 route at the small widths against an earlier version, on one GPU, in one process.

    git show <commit>:floodsr_tpu_torch/csrc/hr_tail.cu > _tree/parent_hr_tail.cu
    python3 tools/hr_tail_tc_vs_parent.py _tree/parent_hr_tail.cu

The 3xTF32 twin of ``tools/hr_tail_bf16_vs_parent.py``: the earlier source is
built with the same ``nvcc`` flags into ``floodsr_tpu_torch/_build/parent/``
(git-ignored) and called through the same wrapper (``hr_tail_cuda(route=
"tensor")``), so the two differ only in the library's entry point and in the
pack each takes: the earlier library gets the slabs in the natural channel
order, the current one :func:`pack_hr_tail_tc`'s (transposed per chunk where
``a_from_registers``; the same bytes elsewhere). For each of
``chip_smoke.py``'s small layouts (``hr_s2d`` 2 and 1: post-ReLU ``|normal|``
features, weights from ``init_resunet(seed, cfg)``) at 8 tiles and at 1: both
outputs against the plain f32 version (``hr_tail_reference``, the bar 1e-4 of
the output's range: the summation order differs, so the two are not
bit-equal), then timed with CUDA events in turns (earlier, current, current,
earlier), then traced with ``torch.profiler`` for the device time of each of
the four launches; each time beside the route's bound (operations, 3xTF32).
At the flagship's widths (its artifact's weights, 8 tiles) the 3xTF32, bf16,
direct and direct bf16 routes of both libraries are compared bit for bit with
a sha256 of each output, and the 3xTF32 route is timed in turns too. One
JSON line with the card's name and power limit; the exit code is 1 when a
layout misses its bar or a flagship route differs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402  (time_ms, device_profile, bound, layout_tail, FLAGSHIP)
from hr_tail_bf16_vs_parent import EarlierLibrary, build_parent, digest  # noqa: E402


def natural_pack(torch, ht, weights) -> list:
    """:func:`pack_hr_tail_tc` with every slab in the natural channel order,
    the layout of the tensor-core route before A came from registers."""
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    w["head_w"] = ht._padded_head(w["head_w"])
    return [torch.cat([ht._tc_slabs(w[k]) for k in keys]).contiguous() for keys in ht.TC_PACK_KEYS]


def turns(torch, earlier, current, reps: int) -> dict:
    """ms of each in turns: earlier, current, current, earlier."""
    t = [
        chip_smoke.time_ms(torch, earlier, reps=reps),
        chip_smoke.time_ms(torch, current, reps=reps),
        chip_smoke.time_ms(torch, current, reps=reps),
        chip_smoke.time_ms(torch, earlier, reps=reps),
    ]
    return {"ms_earlier": [t[0], t[3]], "ms_current": [t[1], t[2]],
            "speedup": (t[0] + t[3]) / (t[1] + t[2])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent_source", type=Path, help="the earlier csrc/hr_tail.cu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("hr_tail_tc_vs_parent: CUDA is not available", file=sys.stderr)
        return 2
    from floodsr_tpu_torch.device import set_strict_f32
    from floodsr_tpu_torch.engine import EngineTorch
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    set_strict_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    parent, abi = build_parent(args.parent_source)
    lib = ht._lib

    def with_lib(library, fn):
        ht._lib = lambda: library
        try:
            return fn()
        finally:
            ht._lib = lib

    report = {"device": torch.cuda.get_device_name(0), "smi": smi, "parent_abi": abi}
    ok = True
    for s2d in chip_smoke.HR_TAIL_LAYOUTS:
        t = chip_smoke.layout_tail(torch, args.seed, s2d)
        sr8, dem8, weights = t["sr"], t["dem"], t["weights"]
        ca, cb, cm, ch = t["dims"]
        earlier_lib = EarlierLibrary(parent, abi, cm)
        packs = {"earlier": natural_pack(torch, ht, weights), "current": ht.pack_hr_tail_tc(weights)}
        layout = {"widths": f"{ca}+{cb}->{cm}->{ch}"}
        for tiles in (8, 1):
            sr, dem = sr8[:tiles], dem8[:tiles]

            def earlier():
                return with_lib(earlier_lib, lambda: ht.hr_tail_cuda(
                    sr, dem, *weights, tc_pack=packs["earlier"], route="tensor"))

            def current():
                return ht.hr_tail_cuda(sr, dem, *weights, tc_pack=packs["current"], route="tensor")

            want = ht.hr_tail_reference(sr, dem, *weights)
            a, c = earlier(), current()
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            errs = {"earlier": (a - want).abs().max().item(), "current": (c - want).abs().max().item()}
            held = max(errs.values()) <= 1e-4 * scale
            ok = ok and held
            work = chip_smoke.tail_work(sr, dem, weights, cm, ch)
            bound_ms, bound_by = chip_smoke.bound(
                work["bytes"], 3 * 2 * work["macs"], chip_smoke.PEAK_TF32_PER_S
            )
            timed = turns(torch, earlier, current, args.reps)
            traced = {}
            for name, fn in (("earlier", earlier), ("current", current)):
                prof = chip_smoke.device_profile(torch, lambda: [fn() for _ in range(5)])
                traced[name] = {k: v / 5 for k, v in prof["hr_tail_tc_ms_by_launch"].items()}
            layout[f"tiles_{tiles}"] = {
                "max_abs_err_vs_plain": errs, "max_abs_plain": scale, "held_1e-4": held,
                "max_abs_earlier_vs_current": (a - c).abs().max().item(),
                **timed,
                "share_of_bound": {
                    "earlier": [bound_ms / v for v in timed["ms_earlier"]],
                    "current": [bound_ms / v for v in timed["ms_current"]],
                },
                "bound_ms": bound_ms, "bound_by": bound_by, "ms_by_launch": traced,
            }
        report[f"s2d={s2d}"] = layout
        del t, sr8, dem8
        torch.cuda.empty_cache()

    # the flagship's widths: every route bit for bit, the 3xTF32 route in turns
    engine = EngineTorch(chip_smoke.FLAGSHIP, device="cuda")
    model, cfg = engine.model, engine.config
    weights = ht.pack_hr_tail_weights(model.fuse[0], model.fuse[1], model.head, bn_eps=cfg.bn_eps)
    rng = np.random.default_rng(args.seed)
    hw, ca, cb = cfg.hr_tile // cfg.hr_s2d, cfg.base_filters * cfg.hr_s2d, cfg.fuse_filters
    sr = torch.from_numpy(np.abs(rng.normal(0, 1, (8, hw, hw, ca))).astype(np.float32)).cuda()
    dem = torch.from_numpy(np.abs(rng.normal(0, 1, (8, hw, hw, cb))).astype(np.float32)).cuda()
    earlier_lib = EarlierLibrary(parent, abi, ca)
    tc_pack = ht.pack_hr_tail_tc(weights)
    route_packs = {"tensor": tc_pack, "bf16": ht.pack_hr_tail_bf16(weights),
                   "direct": None, "bf16_direct": None}
    same, hashes = {}, {}
    for route, pack in route_packs.items():
        a = with_lib(earlier_lib, lambda: ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route=route))
        c = ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route=route)
        torch.cuda.synchronize()
        same[route] = bool(torch.equal(a, c))
        hashes[route] = {"earlier": digest(a), "current": digest(c)}
    report["flagship_bit_equal_8_tiles"] = same
    report["flagship_sha256_8_tiles"] = hashes
    report["flagship_tensor_8_tiles"] = turns(
        torch,
        lambda: with_lib(earlier_lib, lambda: ht.hr_tail_cuda(
            sr, dem, *weights, tc_pack=tc_pack, route="tensor")),
        lambda: ht.hr_tail_cuda(sr, dem, *weights, tc_pack=tc_pack, route="tensor"),
        args.reps,
    )
    engine.close()
    print(json.dumps({"hr_tail_tc_vs_parent": report}))
    return 0 if ok and all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
