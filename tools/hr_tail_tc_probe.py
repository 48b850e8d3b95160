#!/usr/bin/env python3
"""Where K1's 3xTF32 route spends its time at the small widths, on one GPU.

    python3 tools/hr_tail_tc_probe.py

Builds copies of ``floodsr_tpu_torch/csrc/hr_tail.cu`` into
``floodsr_tpu_torch/_build/probe/`` (git-ignored): two with clock counters
added to the small widths' kernel (``conv_tc_rs_kernel``, every launch of the
chain), one for each place of the affine and ReLU (in one pass of the
stagers over the landed patch, as the source has it, or in the consumers'
registers: ``hr_tail_tc_variants.ACT_IN_REGISTERS``), and one of each place
without counters. It runs the route
through the wrapper at 8 tiles of each of ``chip_smoke.py``'s small HR
layouts (``hr_s2d`` 2 and 1, weights from ``init_resunet(0, cfg)``) and
prints, per block and averaged over the chain's four launches, the cycles the
first consumer thread spent from the block's start to its chunk loop (set-up,
the residual's loads), in the loop, waiting there for a chunk's patch and for
its weights, loading, activating and splitting its fragments, and in its
epilogue (bias, stores or the fused head); and the cycles the first stager
thread spent waiting for a free stage, issuing its copies, waiting for them
to land and in its activation pass (the stagers' place only), and in all.
Then the two places, without counters, timed in turns with CUDA events
(registers, stagers, stagers, registers). One JSON line with
the card's name and power limit. The counters slow the kernel they count;
read them as shares.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from hr_tail_tc_variants import ACT_IN_REGISTERS, patch  # noqa: E402

COUNTERS = [
    # (text in hr_tail.cu, the same with counters, how often the text occurs)
    ("namespace tc {\n",
     "namespace tc {\n__device__ unsigned long long g_probe[16];\n", 1),
    ("""  const uint32_t full_h = full_a + 48;           // the head's weights have landed
""",
     """  const uint32_t full_h = full_a + 48;           // the head's weights have landed
  const long long p_start = clock64();
""", 1),
    ("""    uint32_t frag[2][2][2][4];  // [buffer][hi, lo][k8 step][register]
""",
     """    uint32_t frag[2][2][2][4];  // [buffer][hi, lo][k8 step][register]
    long long p_loop = clock64(), p_wa = 0, p_wb = 0;
""", 1),
    ("""      mbar_wait_ptx(full_a + 8 * s, (c >> 1) & 1);
      mbar_wait_ptx(full_b + 8 * s, (c >> 1) & 1);""",
     """      long long w0 = clock64();
      mbar_wait_ptx(full_a + 8 * s, (c >> 1) & 1);
      long long w1 = clock64();
      mbar_wait_ptx(full_b + 8 * s, (c >> 1) & 1);
      p_wa += w1 - w0;
      p_wb += clock64() - w1;""", 2),
    ("""  constexpr int PIX = CK * 4, BUF = (3 * J + DX) & 1;
""",
     """  constexpr int PIX = CK * 4, BUF = (3 * J + DX) & 1;
  const long long f0 = clock64();
""", 1),
    ("""  split_frag(v0, v1, frag[BUF]);
  wgmma_fence();""",
     """  split_frag(v0, v1, frag[BUF]);
  pin(frag[BUF]);
  if (threadIdx.x == 0) atomicAdd(&g_probe[6], (unsigned long long)(clock64() - f0));
  wgmma_fence();""", 1),
    ("""    fence_acc(acc);
    finish_tiles<N, CH, MT, HEAD, true>""",
     """    long long p_epi = clock64();
    fence_acc(acc);
    finish_tiles<N, CH, MT, HEAD, true>""", 1),
    ("""                                        y0 + wg * MT, wg, wq, lane);
  } else if (warp == 8) {""",
     """                                        y0 + wg * MT, wg, wq, lane);
    if (tid == 0) {
      atomicAdd(&g_probe[0], (unsigned long long)(p_loop - p_start));
      atomicAdd(&g_probe[1], (unsigned long long)(p_epi - p_loop));
      atomicAdd(&g_probe[2], (unsigned long long)p_wa);
      atomicAdd(&g_probe[3], (unsigned long long)p_wb);
      atomicAdd(&g_probe[4], (unsigned long long)(clock64() - p_epi));
      atomicAdd(&g_probe[5], 1ull);
    }
  } else if (warp == 8) {""", 1),
    ("""    const int pc = t >> 2;  // pixel lane along the patch row
    for (int c = 0; c < nchunks; ++c) {
      const int s = c & 1;
      mbar_wait(empty + 8 * s, ((c >> 1) & 1) ^ 1);""",
     """    const int pc = t >> 2;  // pixel lane along the patch row
    long long s_wait = 0, s_issue = 0, s_land = 0, s_act = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int s = c & 1;
      long long w2 = clock64();
      mbar_wait(empty + 8 * s, ((c >> 1) & 1) ^ 1);
      long long l0 = clock64();
      s_wait += l0 - w2;""", 1),
    ("""      if (second) {
        cp_async_arrive_noinc(full_a + 8 * s);""",
     """      long long l1 = clock64();
      s_issue += l1 - l0;
      if (second) {
        cp_async_arrive_noinc(full_a + 8 * s);""", 1),
    ("""      cp_async_wait_all();
      const float4 fa""",
     """      cp_async_wait_all();
      long long l2 = clock64();
      s_land += l2 - l1;
      const float4 fa""", 1),
    ("""      mbar_arrive(full_a + 8 * s);
    }
  }
}""",
     """      s_act += clock64() - l2;
      mbar_arrive(full_a + 8 * s);
    }
    if (t == 0) {
      atomicAdd(&g_probe[7], (unsigned long long)s_wait);
      atomicAdd(&g_probe[8], (unsigned long long)(clock64() - p_start));
      atomicAdd(&g_probe[9], (unsigned long long)s_issue);
      atomicAdd(&g_probe[10], (unsigned long long)s_land);
      atomicAdd(&g_probe[11], (unsigned long long)s_act);
    }
  }
}""", 1),
]

READ_COUNTERS = """
extern "C" int probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, tc::g_probe, sizeof(unsigned long long) * 16);
  unsigned long long z[16] = {};
  cudaMemcpyToSymbol(tc::g_probe, z, sizeof(z));
  return (int)e;
}
"""


def variant(source: str, in_registers: bool, counted: bool) -> str:
    if counted:
        for old, new, times in COUNTERS:
            if source.count(old) != times:
                raise RuntimeError(f"hr_tail.cu changed; not {times} place(s) for the counter at {old[:60]!r}")
            source = source.replace(old, new)
        source += READ_COUNTERS
    return patch(source, *ACT_IN_REGISTERS) if in_registers else source


def build_all(sources: dict) -> dict:
    """One nvcc per source, all at once; ``{name: CDLL}``."""
    from floodsr_tpu_torch.ops.kernels import _build

    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        dll = ctypes.CDLL(str(lib))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        dll.hr_tail_tc_launch.restype = ctypes.c_int
        dll.hr_tail_tc_launch.argtypes = [ptr, ptr] + [i32] * 7 + [ptr] * 6
        libs[name] = dll
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("hr_tail_tc_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    source = (ROOT / "floodsr_tpu_torch" / "csrc" / "hr_tail.cu").read_text()
    libs = build_all({
        "counted_registers": variant(source, True, True),
        "counted_stagers": variant(source, False, True),
        "registers": variant(source, True, False),
        "stagers": variant(source, False, False),
    })
    lib = ht._lib
    report = {}
    for s2d in chip_smoke.HR_TAIL_LAYOUTS:
        t = chip_smoke.layout_tail(torch, 0, s2d)
        pack = ht.pack_hr_tail_tc(t["weights"])

        def call(library=None):
            if library is not None:
                ht._lib = lambda: library
            try:
                return ht.hr_tail_cuda(t["sr"], t["dem"], *t["weights"], tc_pack=pack, route="tensor")
            finally:
                ht._lib = lib

        entry = {}
        for place in ("registers", "stagers"):
            counted = libs[f"counted_{place}"]
            counts = (ctypes.c_ulonglong * 16)()
            call(counted)
            torch.cuda.synchronize()
            counted.probe_read(counts)
            for _ in range(3):
                call(counted)
            torch.cuda.synchronize()
            counted.probe_read(counts)
            v = list(counts)
            blocks = v[5]
            per = {
                "blocks": blocks,
                "setup_clk": v[0] / blocks, "loop_clk": v[1] / blocks,
                "loop_wait_patch_clk": v[2] / blocks, "loop_wait_weights_clk": v[3] / blocks,
                "loop_load_act_split_clk": v[6] / blocks, "epilogue_clk": v[4] / blocks,
                "stager_wait_clk": v[7] / blocks, "stager_total_clk": v[8] / blocks,
                "stager_issue_clk": v[9] / blocks, "stager_land_clk": v[10] / blocks,
                "stager_act_clk": v[11] / blocks,
            }
            total = per["setup_clk"] + per["loop_clk"] + per["epilogue_clk"]
            per["shares"] = {
                k: per[k] / total
                for k in ("setup_clk", "loop_clk", "epilogue_clk", "loop_wait_patch_clk",
                          "loop_wait_weights_clk", "loop_load_act_split_clk")
            }
            entry[place] = per
        # the two places without counters, in turns
        ms = [
            chip_smoke.time_ms(torch, lambda: call(libs[place]), reps=10)
            for place in ("registers", "stagers", "stagers", "registers")
        ]
        entry["ms_8_tiles"] = {"registers": [ms[0], ms[3]], "stagers": [ms[1], ms[2]]}
        report[f"s2d={s2d} {t['dims']}"] = entry
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
