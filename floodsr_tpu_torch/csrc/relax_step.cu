// One 8-neighbour Bellman-Ford relaxation of (distance, carried value) on an
// [H, W] f32 grid: (dist, value, cost) -> (dist', value').
//
// Replaces the TPU kernel floodsr_tpu/ops/pallas/costgrow_stencil.py::relax_step_pallas
// (pallas_call at :141, kernel _relax_kernel :45-109).
//
// What it computes, per cell: the candidates
//     cand = dist[n] + k * (cost[n] + cost[c]),  k = 0.5 (orthogonal) or
//     float32(sqrt(2) * 0.5) (diagonal), both folded on the host,
// over the in-grid neighbours n in the TPU kernel's order W, E, N, NW, NE, S,
// SW, SE; a candidate strictly below the best so far replaces it and brings
// its neighbour's value along, so the first neighbour to reach the minimum
// keeps its value. It is a Jacobi step: every read is from the input arrays,
// every write to the output arrays, which the caller ping-pongs. An
// out-of-grid neighbour gives no candidate; that is what the TPU kernel's
// 3e38 sentinel rows and columns overflow to. inf and NaN follow IEEE: a
// candidate through an infinite cost is inf and never strictly below, and a
// NaN candidate (a NaN cost) compares false. The sum and the product use
// round-to-nearest intrinsics so nvcc cannot contract them into an FMA: the
// result equals the plain torch version bit for bit (NaN payloads aside).
//
// What bounds it on the card: bytes. Each cell needs 3 reads and 2 writes of
// 4 bytes (320 MiB for a 4096 x 4096 grid, about 0.10 ms at 3.35 TB/s)
// against some 40 f32 operations. One thread per cell in a 32 x 8 tile; the
// nine-point reads of dist and cost go through the read-only cache, where a
// warp's three rows of 34 values are shared by its neighbours, and only the
// winning neighbour's value is read. A cell outside the domain (infinite
// cost) can take no candidate and is copied. Shared-memory or TMA tiles,
// several relaxations per launch and a device-side convergence flag are the
// way closer to the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__global__ void __launch_bounds__(kTileX * kTileY)
relax_step_kernel(const float* __restrict__ dist, const float* __restrict__ value,
                  const float* __restrict__ cost, float* __restrict__ dist_out,
                  float* __restrict__ value_out, int h, int w, float k_orth,
                  float k_diag) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t row = (size_t)y * (size_t)w;
  const size_t c = row + (size_t)x;

  float best = __ldg(dist + c);
  size_t from = c;
  const float cc = __ldg(cost + c);

  // Every candidate through an infinite centre cost is inf (or NaN): none
  // can be strictly below, so the cell keeps what it has.
  if (cc != INFINITY) {
    const bool west = x > 0, east = x + 1 < w, north = y > 0, south = y + 1 < h;
    const size_t up = c - (size_t)w, dn = c + (size_t)w;

#define CONSIDER(ok, idx, k)                                                  \
  if (ok) {                                                                   \
    const size_t n = (idx);                                                   \
    const float cand =                                                        \
        __fadd_rn(__ldg(dist + n), __fmul_rn((k), __fadd_rn(__ldg(cost + n), cc))); \
    if (cand < best) {                                                        \
      best = cand;                                                            \
      from = n;                                                               \
    }                                                                         \
  }

    CONSIDER(west, c - 1, k_orth)
    CONSIDER(east, c + 1, k_orth)
    CONSIDER(north, up, k_orth)
    CONSIDER(north && west, up - 1, k_diag)
    CONSIDER(north && east, up + 1, k_diag)
    CONSIDER(south, dn, k_orth)
    CONSIDER(south && west, dn - 1, k_diag)
    CONSIDER(south && east, dn + 1, k_diag)
#undef CONSIDER
  }

  dist_out[c] = best;
  value_out[c] = __ldg(value + from);
}

}  // namespace

extern "C" int relax_step_launch(const float* dist, const float* value,
                                 const float* cost, float* dist_out,
                                 float* value_out, int h, int w, float k_orth,
                                 float k_diag, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(kTileX, kTileY);
  const dim3 grid((unsigned)((w + kTileX - 1) / kTileX),
                  (unsigned)((h + kTileY - 1) / kTileY));
  relax_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      dist, value, cost, dist_out, value_out, h, w, k_orth, k_diag);
  return (int)cudaGetLastError();
}
