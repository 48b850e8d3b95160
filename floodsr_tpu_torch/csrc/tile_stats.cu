// Per-tile DEM normalization stats: [N, H*W] f32 -> [N, 3] = (p_clip, dem_min, dem_max).
//
// Replaces the TPU kernel floodsr_tpu/ops/pallas/tile_stats.py::dem_tile_stats_pallas
// (pallas_call at :85, kernel _tile_stats_kernel :30-64).
//
// What it computes, per tile: clamp to >= 0; min and max; 30 steps of
// value-domain bisection for the order statistics at ranks k and
// min(k+1, n-1) (both counted in one pass per step); the linear
// interpolation p_clip = a + frac * (b - a); then min(lo, p) and min(hi, p).
// The arithmetic (mid = 0.5f * (lo + hi), the test count >= rank + 1, the
// lerp) is the TPU kernel's, in f32 and in the same order, written with
// round-to-nearest intrinsics so nvcc cannot contract it into an FMA: the
// result equals the plain torch version bit for bit. Counts are exact
// integers, reduced by warp shuffle and then through shared memory.
//
// What bounds it on the card: the one read of each tile from device memory
// (1 MiB per 512x512 tile, about 0.31 us at 3.35 TB/s) is the bound; the
// kernel pays 31 streaming passes over the tile instead, served from L2
// (a 32-tile chunk is 32 MiB, inside the 50 MB L2). One 1024-thread block
// per tile keeps every pass inside one SM with block-wide reductions and no
// second launch. A radix select, or a cluster per tile, is the way to the
// bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 30;  // bracket shrinks to range / 2^30, as on the TPU

__device__ __forceinline__ float clamp0(float v) { return v > 0.f ? v : 0.f; }

__device__ __forceinline__ void count_le(float v, float mid_a, float mid_b,
                                         unsigned& ca, unsigned& cb) {
  v = clamp0(v);
  ca += v <= mid_a ? 1u : 0u;
  cb += v <= mid_b ? 1u : 0u;
}

__global__ void __launch_bounds__(kThreads)
tile_stats_kernel(const float* __restrict__ dem, float* __restrict__ out,
                  long long count, long long rank_lo, long long rank_hi,
                  float frac) {
  const float* x = dem + (size_t)blockIdx.x * (size_t)count;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  // float4 loads only where the tile starts on a 16-byte boundary (a view
  // with a storage offset may not).
  const bool vec = (count & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long count4 = count >> 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ float s_min[kWarps];
  __shared__ float s_max[kWarps];
  __shared__ unsigned s_ca[kWarps];
  __shared__ unsigned s_cb[kWarps];
  __shared__ float s_lohi[2];
  __shared__ unsigned s_tot[2];

  // Pass 1: min and max of the clamped tile.
  float lo = INFINITY, hi = -INFINITY;
  if (vec) {
    for (long long i = tid; i < count4; i += kThreads) {
      float4 q = x4[i];
      float a = clamp0(q.x), b = clamp0(q.y), c = clamp0(q.z), d = clamp0(q.w);
      lo = fminf(lo, fminf(fminf(a, b), fminf(c, d)));
      hi = fmaxf(hi, fmaxf(fmaxf(a, b), fmaxf(c, d)));
    }
  } else {
    for (long long i = tid; i < count; i += kThreads) {
      float v = clamp0(x[i]);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    s_min[warp] = lo;
    s_max[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = s_min[lane];
    hi = s_max[lane];
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      s_lohi[0] = lo;
      s_lohi[1] = hi;
    }
  }
  __syncthreads();
  const float lo0 = s_lohi[0];
  const float hi0 = s_lohi[1];

  // Bisect both bracketing order statistics together.
  const unsigned long long want_a = (unsigned long long)rank_lo + 1ull;
  const unsigned long long want_b = (unsigned long long)rank_hi + 1ull;
  float lo_a = lo0, hi_a = hi0, lo_b = lo0, hi_b = hi0;
  for (int it = 0; it < kIters; ++it) {
    const float mid_a = __fmul_rn(0.5f, __fadd_rn(lo_a, hi_a));
    const float mid_b = __fmul_rn(0.5f, __fadd_rn(lo_b, hi_b));
    unsigned ca = 0, cb = 0;
    if (vec) {
      for (long long i = tid; i < count4; i += kThreads) {
        float4 q = x4[i];
        count_le(q.x, mid_a, mid_b, ca, cb);
        count_le(q.y, mid_a, mid_b, ca, cb);
        count_le(q.z, mid_a, mid_b, ca, cb);
        count_le(q.w, mid_a, mid_b, ca, cb);
      }
    } else {
      for (long long i = tid; i < count; i += kThreads) {
        count_le(x[i], mid_a, mid_b, ca, cb);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      ca += __shfl_xor_sync(0xffffffffu, ca, off);
      cb += __shfl_xor_sync(0xffffffffu, cb, off);
    }
    if (lane == 0) {
      s_ca[warp] = ca;
      s_cb[warp] = cb;
    }
    __syncthreads();
    if (warp == 0) {
      ca = s_ca[lane];
      cb = s_cb[lane];
      for (int off = 16; off > 0; off >>= 1) {
        ca += __shfl_xor_sync(0xffffffffu, ca, off);
        cb += __shfl_xor_sync(0xffffffffu, cb, off);
      }
      if (lane == 0) {
        s_tot[0] = ca;
        s_tot[1] = cb;
      }
    }
    __syncthreads();
    const bool hit_a = (unsigned long long)s_tot[0] >= want_a;
    const bool hit_b = (unsigned long long)s_tot[1] >= want_b;
    lo_a = hit_a ? lo_a : mid_a;
    hi_a = hit_a ? mid_a : hi_a;
    lo_b = hit_b ? lo_b : mid_b;
    hi_b = hit_b ? mid_b : hi_b;
  }

  if (tid == 0) {
    const float p = __fadd_rn(hi_a, __fmul_rn(frac, __fsub_rn(hi_b, hi_a)));
    float* o = out + 3 * (size_t)blockIdx.x;
    o[0] = p;
    o[1] = fminf(lo0, p);
    o[2] = fminf(hi0, p);
  }
}

}  // namespace

extern "C" int tile_stats_launch(const float* dem, float* out, long long n_tiles,
                                 long long count, long long rank_lo,
                                 long long rank_hi, float frac, void* stream) {
  if (n_tiles <= 0) return 0;
  tile_stats_kernel<<<(unsigned)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      dem, out, count, rank_lo, rank_hi, frac);
  return (int)cudaGetLastError();
}
