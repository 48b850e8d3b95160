#!/usr/bin/env python3
"""K1's 3xTF32 route at the small widths in variants of its design, on one GPU, in one process.

    python3 tools/hr_tail_tc_variants.py

Builds copies of ``floodsr_tpu_torch/csrc/hr_tail.cu``, each with one design
choice of the small widths' kernel (``conv_tc_rs_kernel``) turned the other
way by a text patch, one ``nvcc`` each, all at once, into
``floodsr_tpu_torch/_build/variants/`` (git-ignored):

- ``committed``: the source as it stands;
- ``setmaxnreg``: the consumers raise their registers to 232 and the producer
  warpgroup lowers its to 40;
- ``mt4_at_cm64`` / ``mt3_at_cm64``: 8-row (6-row) blocks at Cm 64 for every
  grid, where the source takes 8 rows only when one wave covers the grid;
- ``mt6_at_cm32``: 12-row blocks at Cm 32;
- ``act_in_registers``: the affine and ReLU in the consumers' registers, once
  per loaded fragment, instead of the stagers' pass (:data:`ACT_IN_REGISTERS`,
  which ``tools/hr_tail_tc_probe.py`` builds with its counters too).

Prints each variant's ``-Xptxas -v`` lines of ``conv_tc_rs_kernel`` (registers,
spills, the ``C75xx`` notes where ``ptxas`` serializes the ``wgmma``), then
times every variant through the wrapper at 8 tiles and at 1 of each of
``chip_smoke.py``'s small HR layouts (``hr_s2d`` 2 and 1, weights from
``init_resunet(0, cfg)``), in turns (every variant, then every variant in the
reverse order), each against the plain f32 version (``hr_tail_reference``,
strict f32). One JSON line with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CONSUMERS = """    // ---- consumers: warpgroup wg multiplies image rows MT*wg .. MT*wg + MT-1 ----
    const int wg = warp >> 2;
    const int wq = warp & 3;
    float acc[MT][N / 2];
    start_sums<N, MT>"""
PRODUCERS = """  } else if (warp == 8) {
    // ---- producer warp 0: a chunk's slabs per stage, then the head's ----"""
KERNEL_END = """      mbar_arrive(full_a + 8 * s);
    }
  }
}
"""

#: The small widths' kernel with the affine and ReLU of a 3x3 chunk in the
#: consumers' registers, once per loaded fragment (zeros outside the image,
#: after the activation), and the stagers only copying: ``(old, new)`` edits.
ACT_IN_REGISTERS = (
    ("""__device__ __forceinline__ void rs_group(float (&acc)[MT][N / 2], uint32_t (&frag)[2][2][2][4],
                                         uint32_t a_st, uint64_t b_desc) {""",
     """__device__ __forceinline__ void rs_group(float (&acc)[MT][N / 2], uint32_t (&frag)[2][2][2][4],
                                         uint32_t a_st, uint64_t b_desc, float4 fa, float4 fc,
                                         int gy, int gx, int H, int W) {"""),
    ("""  const float4 v0 = lds128<(J * PW + DX) * PIX>(a_st);
  const float4 v1 = lds128<(J * PW + DX + 8) * PIX>(a_st);""",
     """  const bool row_ok = gy >= 0 && gy < H;
  const float4 v0 = act4(lds128<(J * PW + DX) * PIX>(a_st), fa, fc, row_ok && gx >= 0 && gx < W);
  const float4 v1 =
      act4(lds128<(J * PW + DX + 8) * PIX>(a_st), fa, fc, row_ok && gx + 8 >= 0 && gx + 8 < W);"""),
    ("""                                         uint32_t a_st, uint64_t b_desc) {
  (rs_group<N, MT, G / 3, G % 3>(acc, frag, a_st, b_desc), ...);""",
     """                                         uint32_t a_st, uint64_t b_desc, float4 fa, float4 fc,
                                         int gy0, int gx0, int H, int W) {
  (rs_group<N, MT, G / 3, G % 3>(acc, frag, a_st, b_desc, fa, fc, gy0 + G / 3, gx0 + G % 3, H, W),
   ...);"""),
    ("""    for (int c = 0; c < n1; ++c) {
      const int s = c & 1;
""",
     """    const int gx0 = x0 + 16 * wq + (lane >> 2) - 1;
    for (int c = 0; c < n1; ++c) {
      const int s = c & 1;
      const float4 fa = __ldg(reinterpret_cast<const float4*>(aff_a + c * CK + 4 * t4));
      const float4 fc = __ldg(reinterpret_cast<const float4*>(aff_c + c * CK + 4 * t4));
"""),
    ("""      rs_chunk<N, MT>(std::make_integer_sequence<int, 3 * (MT + 2)>{}, acc, frag,
                      a_thread + s * A_STAGE, smem_desc(b_smem + s * B_STAGE, QB, 128));""",
     """      rs_chunk<N, MT>(std::make_integer_sequence<int, 3 * (MT + 2)>{}, acc, frag,
                      a_thread + s * A_STAGE, smem_desc(b_smem + s * B_STAGE, QB, 128), fa, fc,
                      y0 + wg * MT - 1, gx0, H, W);"""),
    ("""      if (second) {
        cp_async_arrive_noinc(full_a + 8 * s);""",
     """      if (true) {  // no pass: the consumers activate
        cp_async_arrive_noinc(full_a + 8 * s);"""),
)


def patch(source: str, *edits) -> str:
    """``source`` with each ``(old, new)`` made, each ``old`` found exactly once."""
    for old, new in edits:
        if source.count(old) != 1:
            raise RuntimeError(f"hr_tail.cu changed; no single place for {old[:60]!r}")
        source = source.replace(old, new)
    return source


def variants(source: str) -> dict:
    cm64 = ("tc_chain<64, 4, 4>(", "tc_chain<64, 4, 3>(")
    if not all(source.count(c) == 1 for c in cm64):
        raise RuntimeError("hr_tail.cu changed; not one tc_chain<64, 4, MT> of each MT")
    return {
        "committed": source,
        "setmaxnreg": patch(
            source,
            (CONSUMERS, CONSUMERS.replace(
                "----\n", '----\n    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: "memory");\n', 1)),
            (PRODUCERS, '  } else {\n    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n" ::: "memory");\n'
                        '    if (warp == 8) {\n    // ---- producer warp 0: a chunk\'s slabs per stage, then the head\'s ----'),
            (KERNEL_END, KERNEL_END[:-2] + "  }\n}\n"),
        ),
        "mt4_at_cm64": source.replace(cm64[1], cm64[0]),
        "mt3_at_cm64": source.replace(cm64[0], cm64[1]),
        "mt6_at_cm32": patch(source, ("return tc_chain<32, 1, 4>(", "return tc_chain<32, 1, 6>(")),
        "act_in_registers": patch(source, *ACT_IN_REGISTERS),
    }


def ptxas_lines(log: str) -> dict:
    """``{conv_tc_rs_kernel<N,CH,MT,HEAD>: its -Xptxas -v lines}``."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|properties for|(?:in|for) the function) '?(\w+)", line)
        if m:
            k = re.search(r"conv_tc_rs_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)", m.group(1))
            cur = f"conv_tc_rs_kernel<{','.join(k.groups())}>" if k else None
            if cur and "C75" in line:
                out[cur] = (out.get(cur, "") + "; " + re.search(r"\(C\d+\)[^:]*", line).group(0)).strip("; ")
        elif cur and ("registers" in line or "spill" in line):
            out[cur] = (out.get(cur, "") + "; " + line.split(":", 1)[-1].strip()).strip("; ")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("hr_tail_tc_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from floodsr_tpu_torch.device import set_strict_f32
    from floodsr_tpu_torch.ops.kernels import _build
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    set_strict_f32()
    source = (ROOT / "floodsr_tpu_torch" / "csrc" / "hr_tail.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(source).items():
        src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), lib)
    libs, ptxas = {}, {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        ptxas[name] = ptxas_lines(log)
        dll = ctypes.CDLL(str(lib))
        dll.hr_tail_tc_launch.restype = ctypes.c_int
        dll.hr_tail_tc_launch.argtypes = [ptr, ptr] + [i32] * 7 + [ptr] * 6
        libs[name] = dll
    lib = ht._lib
    times = {}
    for s2d in chip_smoke.HR_TAIL_LAYOUTS:
        t = chip_smoke.layout_tail(torch, 0, s2d)
        pack = ht.pack_hr_tail_tc(t["weights"])
        for tiles in (8, 1):
            sr, dem = t["sr"][:tiles], t["dem"][:tiles]
            want = ht.hr_tail_reference(sr, dem, *t["weights"])
            scale = want.abs().max().item()

            def call(name):
                ht._lib = lambda: libs[name]
                try:
                    return ht.hr_tail_cuda(sr, dem, *t["weights"], tc_pack=pack, route="tensor")
                finally:
                    ht._lib = lib

            entry = {}
            for name in libs:
                got = call(name)
                torch.cuda.synchronize()
                entry[name] = {"err_of_range": (got - want).abs().max().item() / scale, "ms": []}
            for name in [*libs, *reversed(list(libs))]:
                entry[name]["ms"].append(chip_smoke.time_ms(torch, lambda: call(name), reps=10))
            times[f"s2d={s2d} tiles={tiles}"] = entry
        del t
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"hr_tail_tc_variants": {"smi": smi, "ptxas": ptxas, "times": times}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
