#!/usr/bin/env python3
"""Where K1's 3xTF32 route spends its time at the small widths, on one GPU.

    python3 tools/hr_tail_tc_probe.py

Builds a copy of ``floodsr_tpu_torch/csrc/hr_tail.cu`` with clock counters
added to the tensor-core kernel (``conv_tc_kernel``, every launch of the
chain) into ``floodsr_tpu_torch/_build/probe/`` (git-ignored), runs the
route through the wrapper at 8 tiles of each of ``chip_smoke.py``'s other
two HR layouts (``hr_s2d`` 2 and 1, weights from ``init_resunet(0, cfg)``)
and prints, per block and averaged over the chain's four launches, the
cycles the first consumer thread spent from the block's start to its first
product (set-up, the residual's loads), in its chunk loop, waiting there for
a staged patch and for a weight slab, and in its epilogue (bias, stores or
the fused head); and the cycles the first stager thread spent waiting for a
free patch buffer, in its copies (issue to landing), in its
activate-and-split pass, and in all. One JSON line with the card's name and power
limit. The counters slow the kernel they count; read them as shares.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

COUNTERS = [
    # (text in hr_tail.cu, the same with counters)
    ("namespace tc {\n",
     "namespace tc {\n__device__ unsigned long long g_probe[16];\n"),
    ("""  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // with PTX, warp-uniform""",
     """  const long long p_start = clock64();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // with PTX, warp-uniform"""),
    ("""    uint32_t it = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int sa = c & 1;
      consumer_wait<PTX>(full_a + 8 * sa, (c >> 1) & 1);""",
     """    uint32_t it = 0;
    long long p_loop = clock64(), p_wa = 0, p_wb = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int sa = c & 1;
      long long w0 = clock64();
      consumer_wait<PTX>(full_a + 8 * sa, (c >> 1) & 1);
      p_wa += clock64() - w0;"""),
    ("""        consumer_wait<PTX>(full_b + 8 * sb, (it / NB) & 1);""",
     """        long long w1 = clock64();
        consumer_wait<PTX>(full_b + 8 * sb, (it / NB) & 1);
        p_wb += clock64() - w1;"""),
    ("""    wgmma_wait<0>();
    // Keep the compiler from reading the accumulators before the wait.""",
     """    wgmma_wait<0>();
    long long p_epi = clock64();
    // Keep the compiler from reading the accumulators before the wait."""),
    ("""        // The tile is read; the next one may overwrite it.
        named_barrier(2 + wg, 128);
      }
    }""",
     """        // The tile is read; the next one may overwrite it.
        named_barrier(2 + wg, 128);
      }
    }
    if (tid == 0) {
      atomicAdd(&g_probe[0], (unsigned long long)(p_loop - p_start));
      atomicAdd(&g_probe[1], (unsigned long long)(p_epi - p_loop));
      atomicAdd(&g_probe[2], (unsigned long long)p_wa);
      atomicAdd(&g_probe[3], (unsigned long long)p_wb);
      atomicAdd(&g_probe[4], (unsigned long long)(clock64() - p_epi));
      atomicAdd(&g_probe[5], 1ull);
    }"""),
    ("""    const int t = tid - 288;
    const int q = t & 3;    // channel quad of the chunk
    const int pc = t >> 2;  // pixel lane along the patch row
    for (int c = 0; c < nchunks; ++c) {
      const int sa = c & 1;
      mbar_wait(empty_a + 8 * sa, ((c >> 1) & 1) ^ 1);""",
     """    const int t = tid - 288;
    const int q = t & 3;    // channel quad of the chunk
    const int pc = t >> 2;  // pixel lane along the patch row
    long long s_wait = 0, s_load = 0, s_split = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int sa = c & 1;
      long long w2 = clock64();
      mbar_wait(empty_a + 8 * sa, ((c >> 1) & 1) ^ 1);
      s_wait += clock64() - w2;
      long long l0 = clock64();"""),
    ("""        cp_async_wait_all();
""",
     """        cp_async_wait_all();
        long long l1 = clock64();
        s_load += l1 - l0;
"""),
    ("""            split_store(*reinterpret_cast<const float4*>(dst + A_HALF), ok, activate, fa, fc,
                        dst, A_HALF);
          }
        }
""",
     """            split_store(*reinterpret_cast<const float4*>(dst + A_HALF), ok, activate, fa, fc,
                        dst, A_HALF);
          }
        }
        s_split += clock64() - l1;
"""),
    ("""      // Make the generic-proxy stores visible to wgmma's async-proxy reads.
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
      mbar_arrive(full_a + 8 * sa);
    }""",
     """      // Make the generic-proxy stores visible to wgmma's async-proxy reads.
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
      mbar_arrive(full_a + 8 * sa);
    }
    if (t == 0) {
      atomicAdd(&g_probe[6], (unsigned long long)s_wait);
      atomicAdd(&g_probe[7], (unsigned long long)(clock64() - p_start));
      atomicAdd(&g_probe[8], (unsigned long long)s_load);
      atomicAdd(&g_probe[9], (unsigned long long)s_split);
    }"""),
]

READ_COUNTERS = """
extern "C" int probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, tc::g_probe, sizeof(unsigned long long) * 16);
  unsigned long long z[16] = {};
  cudaMemcpyToSymbol(tc::g_probe, z, sizeof(z));
  return (int)e;
}
"""


def build(name: str, source: str) -> ctypes.CDLL:
    from floodsr_tpu_torch.ops.kernels import _build

    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    src.write_text(source)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("hr_tail_tc_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    source = (ROOT / "floodsr_tpu_torch" / "csrc" / "hr_tail.cu").read_text()
    for old, new in COUNTERS:
        if source.count(old) != 1:
            raise RuntimeError(f"hr_tail.cu changed; no single place for the counter at {old[:60]!r}")
        source = source.replace(old, new)
    counted = build("hr_tail_tc_counted", source + READ_COUNTERS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    counted.hr_tail_tc_launch.restype = ctypes.c_int
    counted.hr_tail_tc_launch.argtypes = [ptr, ptr] + [i32] * 7 + [ptr] * 6
    lib = ht._lib
    report = {}
    for s2d in chip_smoke.HR_TAIL_LAYOUTS:
        t = chip_smoke.layout_tail(torch, 0, s2d)
        pack = ht.pack_hr_tail_tc(t["weights"])
        counts = (ctypes.c_ulonglong * 16)()
        ht._lib = lambda: counted
        try:
            ht.hr_tail_cuda(t["sr"], t["dem"], *t["weights"], tc_pack=pack, route="tensor")
            torch.cuda.synchronize()
            counted.probe_read(counts)
            for _ in range(3):
                ht.hr_tail_cuda(t["sr"], t["dem"], *t["weights"], tc_pack=pack, route="tensor")
            torch.cuda.synchronize()
            counted.probe_read(counts)
        finally:
            ht._lib = lib
        v = list(counts)
        blocks = v[5]
        per = {
            "blocks": blocks,
            "setup_clk": v[0] / blocks, "loop_clk": v[1] / blocks,
            "loop_wait_patch_clk": v[2] / blocks, "loop_wait_weights_clk": v[3] / blocks,
            "epilogue_clk": v[4] / blocks,
            "stager_wait_clk": v[6] / blocks, "stager_total_clk": v[7] / blocks,
            "stager_load_clk": v[8] / blocks, "stager_split_clk": v[9] / blocks,
        }
        total = per["setup_clk"] + per["loop_clk"] + per["epilogue_clk"]
        per["shares"] = {k: per[k] / total for k in ("setup_clk", "loop_clk", "epilogue_clk",
                                                      "loop_wait_patch_clk", "loop_wait_weights_clk")}
        report[f"s2d={s2d} {t['dims']}"] = per
        del t
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"hr_tail_tc_probe": {"smi": smi, "per_block": report}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
