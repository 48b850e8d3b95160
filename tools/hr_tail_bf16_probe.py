#!/usr/bin/env python3
"""Where K1's bf16 route spends its time, on one GPU: clock counters and a wgmma loop.

    python3 tools/hr_tail_bf16_probe.py

1. Builds a copy of ``floodsr_tpu_torch/csrc/hr_tail.cu`` with clock counters
   added to the body kernel (``conv_bf16_kernel``: f1.conv1, f1.conv2 + proj,
   f2.conv1) into ``floodsr_tpu_torch/_build/probe/`` (git-ignored), runs the
   route through the wrapper at 8 flagship-width tiles of 128x128 and prints,
   per block, the cycles its first MMA thread spent waiting for ring stages
   (the loads), waiting to hand a tile to the epilogue warpgroup, and in all,
   and the cycles the epilogue warpgroup spent waiting for tiles.
2. Builds and runs a loop of the route's wgmma (m64n128k16 bf16, both operands
   from shared memory in the route's no-swizzle layout: the patch's octet
   planes 4224 bytes apart, the nine tap offsets, weight slabs 4 KB apart, 9
   products between a commit and a wait), two warpgroups on every SM, and
   prints its rate against the 989 TFLOP/s dense bf16 peak.

One JSON line with the card's name and power limit. The counters slow the
kernel they count; read them as shares, not as times.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

COUNTERS = [
    # (text in hr_tail.cu, the same with counters)
    ("namespace bf {\n",
     "namespace bf {\n__device__ unsigned long long g_probe[8];\n"),
    ("""  for (int s = 0; s < n1; ++s, ++g) {
    const int st = g % NS;
    mbar_wait_ptx(full + 8 * st, (g / NS) & 1);""",
     """  for (int s = 0; s < n1; ++s, ++g) {
    const int st = g % NS;
    long long w0 = clock64();
    mbar_wait_ptx(full + 8 * st, (g / NS) & 1);
    if (threadIdx.x == 0 && NS == P::NS_BODY) atomicAdd(&g_probe[0], (unsigned long long)(clock64() - w0));"""),
    ("""    float acc[MT][P::NACC];
    for (int u = blockIdx.x, k = 0; u < units; u += gridDim.x, ++k) {
      g = mma_unit<P, NS>(acc, false, g, ring, full, empty, n1, n2, wg, lane);""",
     """    float acc[MT][P::NACC];
    long long t_start = clock64();
    for (int u = blockIdx.x, k = 0; u < units; u += gridDim.x, ++k) {
      g = mma_unit<P, NS>(acc, false, g, ring, full, empty, n1, n2, wg, lane);"""),
    ("""        // Hand the tile over once the epilogue has read the previous one.
        mbar_wait_ptx(tempty + 8 * r, (k & 1) ^ 1);""",
     """        // Hand the tile over once the epilogue has read the previous one.
        long long e0 = clock64();
        mbar_wait_ptx(tempty + 8 * r, (k & 1) ^ 1);
        if (threadIdx.x == 0) atomicAdd(&g_probe[1], (unsigned long long)(clock64() - e0));"""),
    ("""        mbar_arrive(tfull + 8 * r);
      }
    }""",
     """        mbar_arrive(tfull + 8 * r);
      }
    }
    if (threadIdx.x == 0) {
      atomicAdd(&g_probe[2], (unsigned long long)(clock64() - t_start));
      atomicAdd(&g_probe[3], 1ull);
    }"""),
    ("""        mbar_wait_ptx(tfull + 8 * r, k & 1);""",
     """        long long f0 = clock64();
        mbar_wait_ptx(tfull + 8 * r, k & 1);
        if (threadIdx.x == 256) atomicAdd(&g_probe[4], (unsigned long long)(clock64() - f0));"""),
]

READ_COUNTERS = """
extern "C" int probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, tc::bf::g_probe, sizeof(unsigned long long) * 8);
  unsigned long long z[8] = {};
  cudaMemcpyToSymbol(tc::bf::g_probe, z, sizeof(z));
  return (int)e;
}
"""

WGMMA_LOOP = r"""
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
    "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
    "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,"
    "%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
    : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),"+f"(d[6]),"+f"(d[7]),
      "+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),"+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15]),
      "+f"(d[16]),"+f"(d[17]),"+f"(d[18]),"+f"(d[19]),"+f"(d[20]),"+f"(d[21]),"+f"(d[22]),"+f"(d[23]),
      "+f"(d[24]),"+f"(d[25]),"+f"(d[26]),"+f"(d[27]),"+f"(d[28]),"+f"(d[29]),"+f"(d[30]),"+f"(d[31]),
      "+f"(d[32]),"+f"(d[33]),"+f"(d[34]),"+f"(d[35]),"+f"(d[36]),"+f"(d[37]),"+f"(d[38]),"+f"(d[39]),
      "+f"(d[40]),"+f"(d[41]),"+f"(d[42]),"+f"(d[43]),"+f"(d[44]),"+f"(d[45]),"+f"(d[46]),"+f"(d[47]),
      "+f"(d[48]),"+f"(d[49]),"+f"(d[50]),"+f"(d[51]),"+f"(d[52]),"+f"(d[53]),"+f"(d[54]),"+f"(d[55]),
      "+f"(d[56]),"+f"(d[57]),"+f"(d[58]),"+f"(d[59]),"+f"(d[60]),"+f"(d[61]),"+f"(d[62]),"+f"(d[63])
    : "l"(a), "l"(b), "r"(1));
}
__global__ void __launch_bounds__(256, 1) loop(float* out, int iters) {
  extern __shared__ __align__(128) unsigned char sm[];
  for (int i = threadIdx.x; i < 65536 / 4; i += blockDim.x) reinterpret_cast<uint32_t*>(sm)[i] = 0;
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sm);
  const int w = threadIdx.x / 128;
  float acc[64];
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint64_t da = desc(base + w * 66 * 16, 4224, 128);
  const uint64_t db = desc(base + 8448, 2048, 128);
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < 9; ++t) wg(acc, da + (t / 3) * 66 + t % 3, db + t * 256);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int wgmma_loop_ms(int blocks, int iters, float* ms) {
  float* out;
  cudaMalloc(&out, blocks * 256 * sizeof(float));
  cudaFuncSetAttribute(loop, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  loop<<<blocks, 256, 65536>>>(out, iters);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  loop<<<blocks, 256, 65536>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaFree(out);
  return (int)cudaGetLastError();
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
        print("hr_tail_bf16_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from floodsr_tpu_torch.engine import EngineTorch
    from floodsr_tpu_torch.ops.kernels import hr_tail as ht

    source = (ROOT / "floodsr_tpu_torch" / "csrc" / "hr_tail.cu").read_text()
    for old, new in COUNTERS:
        if source.count(old) != 1:
            raise RuntimeError(f"hr_tail.cu changed; no single place for the counter at {old[:60]!r}")
        source = source.replace(old, new)
    counted = build("hr_tail_counted", source + READ_COUNTERS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    counted.hr_tail_bf16_launch.restype = ctypes.c_int
    counted.hr_tail_bf16_launch.argtypes = [ptr, ptr] + [i32] * 7 + [ptr] * 9

    engine = EngineTorch(chip_smoke.FLAGSHIP, device="cuda")
    m, cfg = engine.model, engine.config
    weights = ht.pack_hr_tail_weights(m.fuse[0], m.fuse[1], m.head, bn_eps=cfg.bn_eps)
    pack = ht.pack_hr_tail_bf16(weights)
    rng = np.random.default_rng(0)
    hw, ca, cb = cfg.hr_tile // cfg.hr_s2d, cfg.base_filters * cfg.hr_s2d, cfg.fuse_filters
    sr = torch.from_numpy(np.abs(rng.normal(0, 1, (8, hw, hw, ca))).astype(np.float32)).cuda()
    dem = torch.from_numpy(np.abs(rng.normal(0, 1, (8, hw, hw, cb))).astype(np.float32)).cuda()
    lib = ht._lib
    ht._lib = lambda: counted
    try:
        counts = (ctypes.c_ulonglong * 8)()
        for _ in range(3):
            ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16")
        torch.cuda.synchronize()
        counted.probe_read(counts)
        for _ in range(10):
            ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16")
        torch.cuda.synchronize()
        counted.probe_read(counts)
    finally:
        ht._lib = lib
    v = list(counts)
    blocks = v[3]
    body = {
        "blocks": blocks,
        "stage_wait_clk": v[0] / blocks, "handoff_wait_clk": v[1] / blocks,
        "total_clk": v[2] / blocks, "epilogue_idle_clk": v[4] / blocks,
    }
    body["stage_wait_share"] = body["stage_wait_clk"] / body["total_clk"]

    looped = build("wgmma_loop", WGMMA_LOOP)
    looped.wgmma_loop_ms.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_float)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, ms = 2000, ctypes.c_float()
    rc = looped.wgmma_loop_ms(sms, iters, ctypes.byref(ms))
    flops = 2.0 * sms * 2 * iters * 9 * 64 * 128 * 16
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    engine.close()
    print(json.dumps({"hr_tail_bf16_probe": {
        "smi": smi, "body_kernel_per_block": body, "wgmma_loop_rc": rc,
        "wgmma_loop_tflops": flops / ms.value / 1e9,
        "wgmma_loop_share_of_peak": flops / ms.value / 1e9 / (chip_smoke.PEAK_BF16_PER_S / 1e12),
    }}))
    return 0 if rc == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
