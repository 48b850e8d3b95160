#!/usr/bin/env python3
"""K1's bf16 band route in variants of its design, on one GPU, in one process.

    python3 tools/hr_tail_band_variants.py

Builds copies of ``floodsr_tpu_torch/csrc/hr_tail.cu``, each with one part of
the band kernel (``tc::band::bf16_band_kernel``) taken away by a text patch,
one ``nvcc`` each, all at once, into ``floodsr_tpu_torch/_build/variants_band/``
(git-ignored). Every variant but ``committed`` computes a wrong result: they
exist to show where the time goes.

- ``committed``: the source as it stands;
- ``no_feed``: the streamed weights (Cm 64) are never waited for and never
  copied: the compute warpgroups read whatever a ring stage holds;
- ``no_head``: no f2.conv2 epilogue and head (nothing is stored);
- ``no_x``: x is never loaded (zeros), so the loads' latency and bytes go.

Prints each variant's ``-Xptxas -v`` lines of the band kernel, then times
every variant through the wrapper (``route="bf16_band"``) at 8 tiles and at 1
of each of ``chip_smoke.py``'s small HR layouts (``hr_s2d`` 2 and 1, weights
from ``init_resunet(0, cfg)``), in turns (every variant, then every variant in
the reverse order), with CUDA events and, once, traced device time. One JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (layout_tail, time_ms, device_profile)

#: variant -> ``(old, new)`` text edits of csrc/hr_tail.cu
VARIANTS = {
    "committed": (),
    "no_feed": (
        ("""  const int st = f.g % P::NS;
  mbar_wait_ptx(f.full + 8 * st, (f.g / P::NS) & 1);
  return f.w + st * P::STAGE;""", """  return f.w + (f.g % P::NS) * P::STAGE;"""),
        ("""    int g = 0;
    for (int t = 0; t <= last; ++t)
      for (int k = 1; k <= 4 && k <= t; ++k) {""", """    int g = 0;
    for (int t = 0; t < 0; ++t)
      for (int k = 1; k <= 4 && k <= t; ++k) {"""),
    ),
    "no_head": (
        ("""      head_rows<P>(acc, nvec""", """      if (a.H < 0) head_rows<P>(acc, nvec"""),
    ),
    "no_x": (
        ("""    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
      const size_t pix = ((size_t)b * a.H + gy) * a.W + gx;
      v = ch < a.ca""", """    if (a.H < 0) {
      const size_t pix = ((size_t)b * a.H + gy) * a.W + gx;
      v = ch < a.ca"""),
    ),
}


def build_all() -> dict:
    from floodsr_tpu_torch.ops.kernels import _build

    src = (_build.SRC_DIR / "hr_tail.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants_band"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: anchor not found once: {old[:60]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"hr_tail_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libhr_tail_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), lib)
    libs, ptxas = {}, {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log[-4000:]}")
        lines = log.splitlines()
        ptxas[name] = [
            lines[i + k].strip() for i, line in enumerate(lines) if "bf16_band_kernel" in line
            and "Function properties" in line for k in (1, 2) if i + k < len(lines)
        ]
        dll = ctypes.CDLL(str(lib))
        fn = dll.hr_tail_bf16_band_launch
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, i32, i32, i32, i32, i32, i32, i32, p, p, p, p]
        libs[name] = dll
    return libs, ptxas


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("hr_tail_band_variants: CUDA is not available", file=sys.stderr)
        return 2
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    libs, ptxas = build_all()
    lib = ht._lib
    report = {"device": torch.cuda.get_device_name(0), "smi": smi, "ptxas": ptxas}
    for s2d in chip_smoke.HR_TAIL_LAYOUTS:
        t = chip_smoke.layout_tail(torch, 0, s2d)
        weights, sr8, dem8 = t["weights"], t["sr"], t["dem"]
        pack = ht.pack_hr_tail_bf16(weights)
        calls = {}
        for name, dll in libs.items():
            def call(tiles, dll=dll):
                ht._lib = lambda: dll
                try:
                    return ht.hr_tail_cuda(
                        sr8[:tiles], dem8[:tiles], *weights, tc_pack=pack, route="bf16_band"
                    )
                finally:
                    ht._lib = lib
            calls[name] = call
        entry = {}
        for tiles in (8, 1):
            ms = {name: [] for name in calls}
            for order in (list(calls), list(reversed(list(calls)))):
                for name in order:
                    ms[name].append(chip_smoke.time_ms(torch, lambda: calls[name](tiles), reps=10))
            device = {}
            for name, call in calls.items():
                prof = chip_smoke.device_profile(torch, lambda: [call(tiles) for _ in range(3)])
                device[name] = prof["kernel_device_ms"]["hr_tail"] / 3
            entry[f"tiles_{tiles}"] = {"ms": ms, "device_ms": device}
        report[f"s2d_{s2d}"] = entry
        del t, weights, sr8, dem8, pack
        torch.cuda.empty_cache()
    print(json.dumps({"hr_tail_band_variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
