// n 8-neighbour Bellman-Ford relaxations of (distance, carried value) on an
// [H, W] f32 grid in one launch: (dist, value, cost, n) -> (dist', value'),
// and a flag raised if some distance fell.
//
// Replaces the TPU kernel floodsr_tpu/ops/pallas/costgrow_stencil.py::relax_step_pallas
// (pallas_call at :141, kernel _relax_kernel :45-109).
//
// What one relaxation computes, per cell: the candidates
//     cand = dist[n] + k * (cost[n] + cost[c]),  k = 0.5 (orthogonal) or
//     float32(sqrt(2) * 0.5) (diagonal), both folded on the host,
// over the in-grid neighbours n in the TPU kernel's order W, E, N, NW, NE, S,
// SW, SE; a candidate strictly below the best so far replaces it and brings
// its neighbour's value along, so the first neighbour to reach the minimum
// keeps its value. It is a Jacobi step: every read is from the previous
// step's arrays. An out-of-grid neighbour gives no candidate; that is what
// the TPU kernel's 3e38 sentinel rows and columns overflow to. inf and NaN
// follow IEEE: a candidate through an infinite cost is inf and never strictly
// below, and a NaN candidate (a NaN cost) compares false. The sum and the
// product use round-to-nearest intrinsics so nvcc cannot contract them into
// an FMA: n relaxations of a launch equal n of the plain torch version bit
// for bit (NaN payloads aside).
//
// What bounds it on the card: one relaxation is 3 reads and 2 writes of 4
// bytes a cell against some 40 f32 operations, so one launch per relaxation
// is bound by bytes (0.088 ms at 3840^2 at 3.35 TB/s). This kernel makes up
// to 8 relaxations a launch instead, and is bound by its candidates: their
// instructions and the latency of each cell's chain of 8 compares. A block
// loads a 128 x 40 tile of dist, value and cost into shared memory (107,528 B
// with spare rows, two blocks an SM); its outputs are the tile less an 8-cell
// halo (112 x 24), since a Jacobi step moves information one cell. Step s of
// n relaxes only the rows within n - s of the outputs, ping-ponging dist and
// value between two shared buffers, so the outputs after n steps are the
// grid's after n steps. Cells outside the grid load as dist inf and cost NaN:
// every candidate through them is NaN and never taken, so only the grid's
// edge stops a path, and a tile's edge inside the grid is halo. One thread
// owns a column of a strip of 10 rows and walks down it, so each dist and
// cost it reads serves three rows; all of its global loads are in flight at
// once. The block writes its outputs once and raises `fell` if any of them is
// below its input, which the thread kept from the load: (dist' < dist).any()
// over the block. Every launch reads every cell (a halo's cells twice or
// more) and writes every cell, whatever number of relaxations it makes.
// Skipping tiles that have settled is the way closer to the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTileW = 128;      // columns of a tile: one thread each
constexpr int kStrips = 4;       // strips of rows: threadIdx.y
constexpr int kStripRows = 10;   // rows a thread walks in its strip
constexpr int kTileH = kStrips * kStripRows;
constexpr int kRowsPerThread = kTileH / kStrips;  // in the load and the write
// Five planes in shared memory: dist and value twice each (ping-pong), cost
// once. A plane holds the tile and a spare row above and below it, and a
// spare float lies at either end, so that a window that reaches past the
// tile's edge reads junk inside the allocation; only cells that no output
// depends on read it.
constexpr int kPlane = (kTileH + 2) * kTileW;
constexpr int kSmemBytes = (5 * kPlane + 2) * (int)sizeof(float);
// Relaxations a launch makes at most: the halo, as a Jacobi step moves
// information one cell.
constexpr int kHalo = 8;
constexpr int kOutW = kTileW - 2 * kHalo, kOutH = kTileH - 2 * kHalo;

// Row 0, column 0 of plane b.
__device__ __forceinline__ float* plane(float* smem, int b) {
  return smem + 1 + b * kPlane + kTileW;
}

__global__ void __launch_bounds__(kTileW * kStrips, 2)
relax_step_kernel(const float* __restrict__ dist, const float* __restrict__ value,
                  const float* __restrict__ cost, float* __restrict__ dist_out,
                  float* __restrict__ value_out, unsigned char* __restrict__ fell,
                  int h, int w, int n, float k_orth, float k_diag) {
  extern __shared__ float smem[];
  float* const sc = plane(smem, 4);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kOutW - kHalo, y0 = blockIdx.y * kOutH - kHalo;
  const int gx = x0 + tx;
  const bool col_in = gx >= 0 && gx < w;

  // Load rows ty, ty + kStrips, ...: a warp reads 32 neighbouring cells of a
  // row. Every load reads a cell of the grid (cell 0 stands in outside it)
  // and is chosen after, so that all of a thread's loads are in flight at
  // once. The thread keeps its input distances for the flag.
  float d0[kRowsPerThread];
  {
    float v0[kRowsPerThread], c0[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int gy = y0 + ty + k * kStrips;
      const bool in = col_in && gy >= 0 && gy < h;
      const size_t g = in ? (size_t)gy * (size_t)w + (size_t)gx : 0;
      d0[k] = __ldg(dist + g);
      v0[k] = __ldg(value + g);
      c0[k] = __ldg(cost + g);
      if (!in) {
        d0[k] = INFINITY;
        v0[k] = __int_as_float(0x7fc00000);
        c0[k] = __int_as_float(0x7fc00000);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = (ty + k * kStrips) * kTileW + tx;
      plane(smem, 0)[i] = d0[k];
      plane(smem, 1)[i] = d0[k];
      plane(smem, 2)[i] = v0[k];
      plane(smem, 3)[i] = v0[k];
      sc[i] = c0[k];
    }
  }
  __syncthreads();

  const int r0 = ty * kStripRows;
  for (int s = 1; s <= n; ++s) {
    const int src = (s - 1) & 1;
    const float* __restrict__ d_in = plane(smem, src);
    float* __restrict__ d_out = plane(smem, src ^ 1);
    const float* __restrict__ v_in = plane(smem, 2 + src);
    float* __restrict__ v_out = plane(smem, 3 - src);
    // The rows step s has to get right: the outputs grown by n - s (>= 1
    // from the tile's edge). Every thread of a strip relaxes them, each in
    // its column: columns and rows outside that region hold junk, which no
    // output depends on.
    const int lo = kHalo - (n - s);
    const int row_lo = max(lo, r0), row_hi = min(kTileH - lo, r0 + kStripRows);
    if (row_lo < row_hi) {
      // Slot k % 3 holds row r0 - 1 + k of columns tx - 1, tx, tx + 1: row
      // r is computed from the slots of r - 1, r and r + 1, so each value
      // read serves three rows.
      const int base = r0 * kTileW + tx;
      float wd[3][3], wc[3][3];
#pragma unroll
      for (int k = 0; k < kStripRows + 2; ++k) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          wd[k % 3][j] = d_in[base + (k - 1) * kTileW + j - 1];
          wc[k % 3][j] = sc[base + (k - 1) * kTileW + j - 1];
        }
        const int r = r0 + k - 2;  // the row relaxed now
        if (k < 2 || r < row_lo || r >= row_hi) continue;
        const float* du = wd[(k + 1) % 3];  // row r - 1
        const float* cu = wc[(k + 1) % 3];
        const float* dm = wd[(k + 2) % 3];  // row r
        const float* cm = wc[(k + 2) % 3];
        const float* dd = wd[k % 3];        // row r + 1
        const float* cd = wc[k % 3];
        const int ic = base + (k - 2) * kTileW;
        const float cc = cm[1];
        float best = dm[1];
        int from = 0;  // offset of the neighbour whose value the cell takes
        // Through an infinite centre cost every candidate is inf or NaN, so
        // none is strictly below and the cell keeps what it has.
#define CONSIDER(dn, cn, kn, off)                                             \
  {                                                                           \
    const float cand = __fadd_rn((dn), __fmul_rn((kn), __fadd_rn((cn), cc))); \
    if (cand < best) {                                                        \
      best = cand;                                                            \
      from = (off);                                                           \
    }                                                                         \
  }
        CONSIDER(dm[0], cm[0], k_orth, -1)           // W
        CONSIDER(dm[2], cm[2], k_orth, 1)            // E
        CONSIDER(du[1], cu[1], k_orth, -kTileW)      // N
        CONSIDER(du[0], cu[0], k_diag, -kTileW - 1)  // NW
        CONSIDER(du[2], cu[2], k_diag, -kTileW + 1)  // NE
        CONSIDER(dd[1], cd[1], k_orth, kTileW)       // S
        CONSIDER(dd[0], cd[0], k_diag, kTileW - 1)   // SW
        CONSIDER(dd[2], cd[2], k_diag, kTileW + 1)   // SE
#undef CONSIDER
        d_out[ic] = best;
        v_out[ic] = v_in[ic + from];
      }
    }
    __syncthreads();
  }

  // Write the outputs among the rows the thread loaded. Outside the grid no
  // cost is a number, so no cell there falls.
  bool fell_here = false;
  if (col_in && tx >= kHalo && tx < kTileW - kHalo) {
    const float* __restrict__ d_fin = plane(smem, n & 1);
    const float* __restrict__ v_fin = plane(smem, 2 + (n & 1));
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = ty + k * kStrips, gy = y0 + r;
      if (r < kHalo || r >= kTileH - kHalo || gy >= h) continue;
      const size_t g = (size_t)gy * (size_t)w + (size_t)gx;
      const float d = d_fin[r * kTileW + tx];
      fell_here |= d < d0[k];
      dist_out[g] = d;
      value_out[g] = v_fin[r * kTileW + tx];
    }
  }
  if (__syncthreads_or(fell_here) && tx == 0 && ty == 0) *fell = 1;
}

}  // namespace

// n relaxations (1..8) in one launch; `fell` is zeroed first when
// `clear_fell` is set, and set to 1 if some distance fell.
extern "C" int relax_step_launch(const float* dist, const float* value,
                                 const float* cost, float* dist_out,
                                 float* value_out, unsigned char* fell,
                                 int clear_fell, int h, int w, int n,
                                 float k_orth, float k_diag, void* stream) {
  if (n < 1 || n > kHalo) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (clear_fell) {
    const cudaError_t e = cudaMemsetAsync(fell, 0, 1, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (h <= 0 || w <= 0) return 0;
  // Shared memory above 48 KB is opted into once for each device.
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!bit || !(ready.load() & bit)) {
    e = cudaFuncSetAttribute(relax_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(relax_step_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(bit);
  }
  const dim3 block(kTileW, kStrips);
  const dim3 grid((unsigned)((w + kOutW - 1) / kOutW), (unsigned)((h + kOutH - 1) / kOutH));
  relax_step_kernel<<<grid, block, kSmemBytes, s>>>(dist, value, cost, dist_out, value_out,
                                                    fell, h, w, n, k_orth, k_diag);
  return (int)cudaGetLastError();
}
