#!/usr/bin/env python3
"""Where a step of K1's bf16 band kernel goes, by clock counters, on one GPU.

    python3 tools/hr_tail_band_probe.py

Builds a copy of ``floodsr_tpu_torch/csrc/hr_tail.cu`` into
``floodsr_tpu_torch/_build/probe_band/`` (git-ignored) in which the first
thread of every block of ``tc::band::bf16_band_kernel`` reads ``clock64()``
at the boundaries of a step's phases (outside every ``wgmma`` group, so the
products are issued as in the committed kernel) and adds each phase's clocks
to device counters at the block's end. A phase's clocks include the barrier
that ends it, so a wait for the other warpgroup, or for the weights, shows in
the phase before it. Runs the band route once at 8 tiles of each of
``chip_smoke.py``'s small HR layouts (``hr_s2d`` 2 and 1, weights from
``init_resunet(0, cfg)``) and prints one JSON line: per layout each phase's
mean clocks a block and share of the block's time, the steps a block, and the
card's name and power limit. The copy is patched by text anchors: update
them when the kernel changes.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (layout_tail)

#: The phases, in step order, each ending at the probe point that closes it.
PHASES = (
    "x act store + barrier", "f1.conv1 products", "f1.conv1 epilogue + barrier",
    "f1.conv2 + proj products", "f1.conv2 epilogue, raw store, x loads + barriers",
    "f2.conv1 products", "f2.conv1 epilogue + barrier", "f2.conv2 products", "head",
    "step-end barrier",
)

#: ``(old, new)`` edits of csrc/hr_tail.cu: counters, probe points, readout.
EDITS = (
    ("""template <int N, int CH, int CIN>
__global__ void __launch_bounds__(kThreads, 1) bf16_band_kernel(const Args a) {""",
     """__device__ unsigned long long band_probe_acc[16];
#define BAND_PROBE(k) if (tid == 0) { const long long now = clock64(); pacc[k] += now - pt; pt = now; }
template <int N, int CH, int CIN>
__global__ void __launch_bounds__(kThreads, 1) bf16_band_kernel(const Args a) {"""),
    ("""  load_x<P>(px, a, b, y0 - kHalo, gx0, tid);
  for (int t = 0; t <= last; ++t) {""",
     """  load_x<P>(px, a, b, y0 - kHalo, gx0, tid);
  long long pt = clock64();
  long long pacc[10] = {};
  for (int t = 0; t <= last; ++t) {"""),
    ("""    store_x<P, true>(px, x_ring, vec, yr, y0 + yr, gx0, a.H, a.W, tid);
    sync_compute();
""", """    store_x<P, true>(px, x_ring, vec, yr, y0 + yr, gx0, a.H, a.W, tid);
    sync_compute();
    BAND_PROBE(0)
"""),
    ("""      conv_rows<P, false>(acc, false, x_s, y, P::C1, 0, 0, f, lane);
""", """      conv_rows<P, false>(acc, false, x_s, y, P::C1, 0, 0, f, lane);
      BAND_PROBE(1)
"""),
    ("""    sync_compute();
    if (t >= 2) {""", """    sync_compute();
    BAND_PROBE(2)
    if (t >= 2) {"""),
    ("""      conv_rows<P, true>(acc, false, y_s, y, P::CM, P::W1, raw_s + wg * XROWB, f, lane);
""", """      conv_rows<P, true>(acc, false, y_s, y, P::CM, P::W1, raw_s + wg * XROWB, f, lane);
      BAND_PROBE(3)
"""),
    ("""    sync_compute();
    if (t >= 3) {""", """    sync_compute();
    BAND_PROBE(4)
    if (t >= 3) {"""),
    ("""      conv_rows<P, false>(acc, false, y1_s, y, P::CM, P::W1 + P::W2, 0, f, lane);
""", """      conv_rows<P, false>(acc, false, y1_s, y, P::CM, P::W1 + P::W2, 0, f, lane);
      BAND_PROBE(5)
"""),
    ("""    sync_compute();
    if (t >= 4) {""", """    sync_compute();
    BAND_PROBE(6)
    if (t >= 4) {"""),
    ("""      conv_rows<P, false>(acc, true, z_s, o, P::CM, P::W1 + P::W2 + P::W3, 0, f, lane);
""", """      conv_rows<P, false>(acc, true, z_s, o, P::CM, P::W1 + P::W2 + P::W3, 0, f, lane);
      BAND_PROBE(7)
"""),
    ("""                   base + P::OFF_H, a, b, o, rows, y0 + o, gx0, wg, wq, lane);
    }
""", """                   base + P::OFF_H, a, b, o, rows, y0 + o, gx0, wg, wq, lane);
      BAND_PROBE(8)
    }
"""),
    ("""    named_barrier(1, 256);
  }
}

template <int N, int CH, int CIN>
cudaError_t launch(""", """    named_barrier(1, 256);
    BAND_PROBE(9)
  }
  if (tid == 0) {
    for (int k = 0; k < 10; ++k) atomicAdd(&band_probe_acc[k], (unsigned long long)pacc[k]);
    atomicAdd(&band_probe_acc[14], (unsigned long long)(last + 1));
    atomicAdd(&band_probe_acc[15], 1ull);
  }
}

template <int N, int CH, int CIN>
cudaError_t launch("""),
    ("""extern "C" int hr_tail_bf16_band_launch(""", """extern "C" int band_probe_read(unsigned long long* host, int reset) {
  static const unsigned long long zeros[16] = {};
  if (reset) return (int)cudaMemcpyToSymbol(tc::band::band_probe_acc, zeros, sizeof(zeros));
  return (int)cudaMemcpyFromSymbol(host, tc::band::band_probe_acc, sizeof(zeros));
}

extern "C" int hr_tail_bf16_band_launch("""),
)


def build() -> ctypes.CDLL:
    from floodsr_tpu_torch.ops.kernels import _build

    text = (_build.SRC_DIR / "hr_tail.cu").read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise SystemExit(f"probe anchor not found once: {old[:70]!r}")
        text = text.replace(old, new)
    out_dir = _build.BUILD_DIR / "probe_band"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / "hr_tail_probe.cu", out_dir / "libhr_tail_probe.so"
    cu.write_text(text)
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"the probe failed to build:\n{done.stdout[-4000:]}{done.stderr[-2000:]}")
    dll = ctypes.CDLL(str(lib))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    dll.hr_tail_bf16_band_launch.restype = ctypes.c_int
    dll.hr_tail_bf16_band_launch.argtypes = [p, p, i32, i32, i32, i32, i32, i32, i32, p, p, p, p]
    dll.band_probe_read.restype = ctypes.c_int
    dll.band_probe_read.argtypes = [p, i32]
    return dll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("hr_tail_band_probe: CUDA is not available", file=sys.stderr)
        return 2
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dll = build()
    lib = ht._lib
    report = {"device": torch.cuda.get_device_name(0), "smi": smi}
    for s2d in chip_smoke.HR_TAIL_LAYOUTS:
        t = chip_smoke.layout_tail(torch, 0, s2d)
        weights, sr, dem = t["weights"], t["sr"], t["dem"]
        pack = ht.pack_hr_tail_bf16(weights)
        ht._lib = lambda: dll
        try:
            ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16_band")  # warm
            torch.cuda.synchronize()
            counters = (ctypes.c_ulonglong * 16)()
            if dll.band_probe_read(counters, 1) != 0:
                raise SystemExit("band_probe_read failed")
            ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16_band")
            torch.cuda.synchronize()
            if dll.band_probe_read(counters, 0) != 0:
                raise SystemExit("band_probe_read failed")
        finally:
            ht._lib = lib
        blocks = counters[15]
        clocks = [counters[k] / blocks for k in range(len(PHASES))]
        total = sum(clocks)
        report[f"s2d_{s2d}"] = {
            "blocks": blocks, "steps_a_block": counters[14] / blocks, "clocks_a_block": total,
            "phases": {name: {"clocks": c, "share": c / total} for name, c in zip(PHASES, clocks)},
        }
        del t, weights, sr, dem, pack
        torch.cuda.empty_cache()
    print(json.dumps({"hr_tail_band_probe": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
