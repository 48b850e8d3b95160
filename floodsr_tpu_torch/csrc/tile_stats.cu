// Per-tile DEM normalization stats: [N, H*W] f32 -> [N, 3] = (p_clip, dem_min, dem_max).
//
// Replaces the TPU kernel floodsr_tpu/ops/pallas/tile_stats.py::dem_tile_stats_pallas
// (pallas_call at :85, kernel _tile_stats_kernel :30-64).
//
// What it computes, per tile: clamp to >= 0; min and max; the two order
// statistics at ranks k and min(k+1, n-1) as 30 steps of value-domain
// bisection would find them; the linear interpolation
// p_clip = a + frac * (b - a); then min(lo, p) and min(hi, p).
//
// The bisection (the TPU kernel's, and the plain torch version's) touches
// the data only through the test count(v <= mid) >= rank + 1, which is true
// exactly when the rank-th smallest value s_rank satisfies s_rank <= mid. So
// this kernel finds the exact order statistics s_k and s_k1 by a radix
// select, and one thread then replays the 30 steps as scalar arithmetic with
// hit = (s <= mid): the midpoints, brackets and lerp are the same f32
// operations in the same order (round-to-nearest intrinsics, so nvcc cannot
// contract them into an FMA), and the result equals the plain version bit
// for bit.
//
// The select: clamped values are non-negative, so their bit patterns order
// like unsigned integers. Each pass histograms the candidates' keys relative
// to the bracket's base into 4096 bins (the shift is chosen from the
// bracket's span, so a tile's own range, not the whole f32 range, is what
// gets divided: two passes for terrain, three at most), carries the
// remaining rank into the bin that holds it, and ends when a bin is one
// value wide. A thread merges runs of equal bins before its shared-memory
// atomic, so plateaus (a tile that is half zeros after the clamp) do not
// serialize. s_k1 is s_k when at least two of the values equal to s_k lie at
// or above rank k, else the smallest value above s_k, which the last pass
// finds on its way (the next non-empty bin, or the smallest key past the
// bracket).
//
// What bounds it on the card: the one read of each tile from device memory
// (1 MiB per 512x512 tile, about 0.31 us at 3.35 TB/s). Two routes, chosen
// by the wrapper from the tile's size and alignment:
//  - One-read route: a cluster of 8 blocks per tile; each block loads an
//    eighth of the tile into its shared memory (128 KiB at 512x512) with
//    16-byte loads, clamping as it stores; every later pass reads shared
//    memory; min/max, histograms and the next-above value are merged across
//    the cluster through distributed shared memory, one cluster barrier a
//    pass. Reading peers' shared memory is slow (eight blocks each reading
//    eight whole histograms took longer than the histogram pass itself), so
//    a block does not merge whole histograms: every block publishes 32 coarse
//    counts beside its histogram, and one warp reads the peers' coarse counts
//    and then only the 128 fine bins under the count that holds the rank.
//    Every block does the same redundantly, so nothing is broadcast. 16 tiles
//    are 128 blocks on the card's 132 SMs. What holds it above the bound: the
//    histogram passes are bound by the rate of shared-memory atomics, and the
//    cluster barriers wait for the slowest of eight blocks.
//  - Streaming route (a tile that does not split into eight 16-byte-aligned
//    slices that fit shared memory): one block per tile, the same passes
//    streaming from device memory / L2 (2-3 digit passes and the
//    min/max pass in place of the 31 passes of the bisection), float4
//    loads where the tile starts on a 16-byte boundary, scalar loads else.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 30;  // bracket shrinks to range / 2^30, as on the TPU
constexpr int kCluster = 8;
constexpr int kBinBits = 12;
constexpr int kBins = 1 << kBinBits;  // four bins a thread
constexpr int kCoarse = kBins / kWarps;  // bins under one coarse count (a warp's bins)
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // no key: above every clamped value's bits
// The largest slice the wrapper sends down the one-read route (MAX_SLICE_BYTES
// in tile_stats.py): with Shared it stays inside a block's 227 KB.
constexpr int kMaxSliceBytes = 192 * 1024;
constexpr int kMaxDevices = 64;

struct __align__(16) Shared {
  uint32_t hist[2][kBins];  // this pass's histogram; the other is zeroed for the next
  uint32_t warp_a[kWarps];
  uint32_t warp_b[kWarps];
  uint32_t mm[2];   // this block's min and max keys (cluster peers read them)
  uint32_t tile_mm[2];  // the tile's, merged over the cluster
  uint32_t coarse[2][kWarps];  // per pass: the counts of each warp's kCoarse bins
  uint32_t above;   // this block's smallest key above the last pass's bracket (peers read it)
  uint32_t sel[3];  // the bin that holds the rank, the rank within it, s_k1 (last pass)
};

// Where a block's keys come from: its slice in shared memory (already
// clamped), or the tile in device memory (clamped as it is read).
struct Source {
  const uint32_t* keys;
  int n4;
  const float* x;
  long long count;
  bool vec;
};

// NaN and -0 become +0, as v > 0 ? v : 0 does in the plain version.
__device__ __forceinline__ uint32_t clamp_key(float v) {
  return __float_as_uint(v > 0.f ? v : 0.f);
}

template <bool ONE_READ, class F>
__device__ __forceinline__ void for_each_key(const Source& s, int tid, F&& f) {
  if (ONE_READ) {
    const uint4* k4 = reinterpret_cast<const uint4*>(s.keys);
    for (int i = tid; i < s.n4; i += kThreads) {
      const uint4 q = k4[i];
      f(q.x); f(q.y); f(q.z); f(q.w);
    }
  } else if (s.vec) {
    // Four loads in flight a thread: one block streams the whole tile.
    const float4* x4 = reinterpret_cast<const float4*>(s.x);
    const long long count4 = s.count >> 2;
    for (long long i0 = tid; i0 < count4; i0 += 4 * kThreads) {
      float4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long i = i0 + (long long)u * kThreads;
        q[u] = i < count4 ? x4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + (long long)u * kThreads >= count4) continue;
        f(clamp_key(q[u].x)); f(clamp_key(q[u].y)); f(clamp_key(q[u].z)); f(clamp_key(q[u].w));
      }
    }
  } else {
    for (long long i0 = tid; i0 < s.count; i0 += 4 * kThreads) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long i = i0 + (long long)u * kThreads;
        v[u] = i < s.count ? s.x[i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + (long long)u * kThreads < s.count) f(clamp_key(v[u]));
    }
  }
}

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Block-wide min of lo and max of hi; every thread returns with both.
__device__ __forceinline__ void block_min_max(Shared& sh, uint32_t& lo, uint32_t& hi, int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    sh.warp_a[warp] = lo;
    sh.warp_b[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = __reduce_min_sync(kFull, sh.warp_a[lane]);
    hi = __reduce_max_sync(kFull, sh.warp_b[lane]);
    if (lane == 0) {
      sh.mm[0] = lo;
      sh.mm[1] = hi;
    }
  }
  __syncthreads();
  lo = sh.mm[0];
  hi = sh.mm[1];
}

template <bool ONE_READ>
__device__ __forceinline__ void tile_stats_body(const float* __restrict__ dem,
                                                float* __restrict__ out, long long count,
                                                long long rank_lo, long long rank_hi,
                                                float frac) {
  extern __shared__ __align__(16) uint32_t slice[];  // the one-read route's keys
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned crank = ONE_READ ? cluster.block_rank() : 0u;
  const long long tile = ONE_READ ? (long long)(blockIdx.x / kCluster) : (long long)blockIdx.x;
  const float* x = dem + (size_t)tile * (size_t)count;

  Source src;
  src.keys = slice;
  src.n4 = 0;
  src.x = x;
  src.count = count;
  // float4 loads only where the tile starts on a 16-byte boundary (a view
  // with a storage offset may not).
  src.vec = (count & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // Pass 0: min and max of the clamped tile; the one-read route also keeps
  // its slice's clamped keys in shared memory.
  uint32_t lo = 0xffffffffu, hi = 0u;
  if (ONE_READ) {
    const int len = (int)(count / kCluster);
    src.n4 = len >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(x + (size_t)crank * len);
    uint4* s4 = reinterpret_cast<uint4*>(slice);
    for (int base = 0; base < src.n4; base += 8 * kThreads) {
      float4 q[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * kThreads + tid;
        q[u] = i < src.n4 ? __ldg(g4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * kThreads + tid;
        if (i >= src.n4) continue;
        uint4 k;
        k.x = clamp_key(q[u].x);
        k.y = clamp_key(q[u].y);
        k.z = clamp_key(q[u].z);
        k.w = clamp_key(q[u].w);
        s4[i] = k;
        lo = min(lo, min(min(k.x, k.y), min(k.z, k.w)));
        hi = max(hi, max(max(k.x, k.y), max(k.z, k.w)));
      }
    }
  } else {
    for_each_key<false>(src, tid, [&](uint32_t key) {
      lo = min(lo, key);
      hi = max(hi, key);
    });
  }
  // Zero the first pass's histogram before the barriers inside the reduction.
  reinterpret_cast<uint4*>(sh.hist[0])[tid] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) sh.above = kNone;
  block_min_max(sh, lo, hi, tid);
  if (ONE_READ) {
    cluster.sync();
    if (warp == 0) {
      if (lane < kCluster) {
        const uint32_t* peer = cluster.map_shared_rank(&sh.mm[0], (unsigned)lane);
        lo = peer[0];
        hi = peer[1];
      }
      lo = __reduce_min_sync(kFull, lo);
      hi = __reduce_max_sync(kFull, hi);
      if (lane == 0) {
        sh.tile_mm[0] = lo;
        sh.tile_mm[1] = hi;
      }
    }
    __syncthreads();
    lo = sh.tile_mm[0];
    hi = sh.tile_mm[1];
  }

  // Select s_k, and with it s_k1. The last pass (bins one value wide) also
  // finds the smallest value above s_k: the next non-empty bin of its
  // histogram or, past the bracket, the smallest key above it.
  uint32_t s_k = lo, s_k1 = lo;
  if (lo != hi) {
    uint32_t base = lo;            // candidates are the keys with key - base < span
    uint32_t span = hi - lo + 1u;
    uint32_t r = (uint32_t)rank_lo;  // rank among the candidates
    for (int pass = 0;; ++pass) {
      const int bits = 32 - __clz((int)(span - 1u));
      const int shift = bits > kBinBits ? bits - kBinBits : 0;
      const bool last = shift == 0;
      uint32_t* h = sh.hist[pass & 1];
      uint32_t run_bin = 0u, run = 0u, above = kNone;
      for_each_key<ONE_READ>(src, tid, [&](uint32_t key) {
        const uint32_t rel = key - base;
        if (rel < span) {
          const uint32_t bin = rel >> shift;
          if (run != 0u && bin == run_bin) {
            ++run;
          } else {
            if (run != 0u) atomicAdd(&h[run_bin], run);
            run_bin = bin;
            run = 1u;
          }
        } else if (last && key > base) {
          above = min(above, key);
        }
      });
      if (run != 0u) atomicAdd(&h[run_bin], run);
      if (last) {
        above = __reduce_min_sync(kFull, above);
        if (lane == 0 && above != kNone) atomicMin(&sh.above, above);
      }
      __syncthreads();
      // This block's coarse counts: one per warp's kCoarse bins. Peers read
      // these first and then only the fine bins under the count that holds
      // the rank, not whole histograms.
      {
        const uint4 q = reinterpret_cast<const uint4*>(h)[tid];
        const uint32_t sum = __reduce_add_sync(kFull, q.x + q.y + q.z + q.w);
        if (lane == 0) sh.coarse[pass & 1][warp] = sum;
      }
      if (ONE_READ) cluster.sync(); else __syncthreads();

      // Every peer has left the pass before this one, so its histogram can
      // be zeroed for the next.
      reinterpret_cast<uint4*>(sh.hist[(pass + 1) & 1])[tid] = make_uint4(0u, 0u, 0u, 0u);

      if (warp == 0) {
        constexpr unsigned kPeers = ONE_READ ? kCluster : 1u;
        auto peer = [&](auto* ptr, unsigned k) {
          return ONE_READ ? cluster.map_shared_rank(ptr, k) : ptr;
        };
        // lane l's fine bins 4l .. 4l + 3 under coarse count cb, merged over the cluster
        auto fine = [&](int cb) {
          uint4 v[kPeers];
#pragma unroll
          for (unsigned k = 0; k < kPeers; ++k)
            v[k] = reinterpret_cast<const uint4*>(peer(h, k))[cb * 32 + lane];
          uint4 f = v[0];
#pragma unroll
          for (unsigned k = 1; k < kPeers; ++k) f = add4(f, v[k]);
          return f;
        };
        // The coarse count that holds rank r ...
        uint32_t cl = 0u;
#pragma unroll
        for (unsigned k = 0; k < kPeers; ++k) cl += peer(&sh.coarse[pass & 1][0], k)[lane];
        const uint32_t excl = warp_inclusive_sum(cl, lane) - cl;
        const int cb = __ffs(__ballot_sync(kFull, r >= excl && r - excl < cl)) - 1;
        const uint32_t r_in = r - __shfl_sync(kFull, excl, cb);
        // ... and the fine bin under it.
        const uint4 f = fine(cb);
        const uint32_t cs[4] = {f.x, f.y, f.z, f.w};
        const uint32_t mine = f.x + f.y + f.z + f.w;
        const uint32_t fexcl = warp_inclusive_sum(mine, lane) - mine;
        const bool has = r_in >= fexcl && r_in - fexcl < mine;
        uint32_t my_bin = 0u, my_left = 0u, my_eq = 0u;
        if (has) {
          uint32_t left = r_in - fexcl;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (left < cs[i]) {
              my_bin = 4u * lane + i;
              my_left = left;
              my_eq = cs[i];
              left = kNone;  // found: no later bin matches
            } else if (left != kNone) {
              left -= cs[i];
            }
          }
        }
        const int fl = __ffs(__ballot_sync(kFull, has)) - 1;
        const uint32_t bin_in = __shfl_sync(kFull, my_bin, fl);
        const uint32_t left = __shfl_sync(kFull, my_left, fl);
        const uint32_t eq = __shfl_sync(kFull, my_eq, fl);
        // s_k1, in the last pass: left of the eq values equal to s_k lie below
        // rank k; rank k + 1 is another of them unless rank k is the last of
        // them (or of the tile). Else it is the smallest value above s_k:
        uint32_t sk1 = kNone;
        if (last && rank_hi != rank_lo && eq - left < 2u) {
          // the next non-empty bin under this coarse count, ...
          uint32_t nxt = kNone;
#pragma unroll
          for (int i = 3; i >= 0; --i)
            if (cs[i] != 0u && 4u * lane + i > bin_in) nxt = 4u * lane + i;
          nxt = __reduce_min_sync(kFull, nxt);
          if (nxt != kNone) {
            nxt += (uint32_t)cb * kCoarse;
          } else {
            // ... or the first bin under the next non-empty coarse count, ...
            const unsigned later = __ballot_sync(kFull, cl != 0u && lane > cb);
            if (later != 0u) {
              const int nb = __ffs(later) - 1;
              const uint4 g = fine(nb);
              const uint32_t gs[4] = {g.x, g.y, g.z, g.w};
              uint32_t cand = kNone;
#pragma unroll
              for (int i = 3; i >= 0; --i)
                if (gs[i] != 0u) cand = 4u * lane + i;
              nxt = (uint32_t)nb * kCoarse + __reduce_min_sync(kFull, cand);
            }
          }
          if (nxt != kNone) {
            sk1 = base + nxt;
          } else {
            // ... or the smallest key past the bracket.
            uint32_t ab = kNone;
            if (lane < kPeers) ab = *peer(&sh.above, (unsigned)lane);
            sk1 = __reduce_min_sync(kFull, ab);
          }
        }
        if (lane == 0) {
          sh.sel[0] = (uint32_t)cb * kCoarse + bin_in;
          sh.sel[1] = left;
          sh.sel[2] = sk1;
        }
      }
      __syncthreads();
      const uint32_t bin = sh.sel[0];
      r = sh.sel[1];
      if (!last) {
        base += bin << shift;
        span = min(span - (bin << shift), 1u << shift);
        continue;
      }
      s_k = base + bin;
      s_k1 = sh.sel[2] != kNone ? sh.sel[2] : s_k;
      break;
    }
  }

  if (crank == 0u && tid == 0) {
    // The bisection, replayed on the two order statistics.
    const float lo0 = __uint_as_float(lo);
    const float hi0 = __uint_as_float(hi);
    const float s_a = __uint_as_float(s_k);
    const float s_b = __uint_as_float(s_k1);
    float lo_a = lo0, hi_a = hi0, lo_b = lo0, hi_b = hi0;
    for (int it = 0; it < kIters; ++it) {
      const float mid_a = __fmul_rn(0.5f, __fadd_rn(lo_a, hi_a));
      const float mid_b = __fmul_rn(0.5f, __fadd_rn(lo_b, hi_b));
      const bool hit_a = s_a <= mid_a;
      const bool hit_b = s_b <= mid_b;
      lo_a = hit_a ? lo_a : mid_a;
      hi_a = hit_a ? mid_a : hi_a;
      lo_b = hit_b ? lo_b : mid_b;
      hi_b = hit_b ? mid_b : hi_b;
    }
    const float p = __fadd_rn(hi_a, __fmul_rn(frac, __fsub_rn(hi_b, hi_a)));
    float* o = out + 3 * (size_t)tile;
    o[0] = p;
    o[1] = fminf(lo0, p);
    o[2] = fminf(hi0, p);
  }
  // No block leaves while a peer may still read its shared memory.
  if (ONE_READ) cluster.sync();
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
tile_stats_one_read_kernel(const float* __restrict__ dem, float* __restrict__ out,
                           long long count, long long rank_lo, long long rank_hi,
                           float frac) {
  tile_stats_body<true>(dem, out, count, rank_lo, rank_hi, frac);
}

__global__ void __launch_bounds__(kThreads)
tile_stats_stream_kernel(const float* __restrict__ dem, float* __restrict__ out,
                         long long count, long long rank_lo, long long rank_hi,
                         float frac) {
  tile_stats_body<false>(dem, out, count, rank_lo, rank_hi, frac);
}

}  // namespace

// one_read != 0: the cluster route; the wrapper has checked that count is a
// multiple of 32, that an eighth of a tile fits a block's shared memory and
// that dem starts on a 16-byte boundary. Else the streaming route.
extern "C" int tile_stats_launch(const float* dem, float* out, long long n_tiles,
                                 long long count, long long rank_lo,
                                 long long rank_hi, float frac, int one_read,
                                 void* stream) {
  if (n_tiles <= 0) return 0;
  if (one_read) {
    const int slice_bytes = (int)(count / kCluster) * 4;
    if (slice_bytes > kMaxSliceBytes) return (int)cudaErrorInvalidValue;
    // The opt-in to more than 48 KB of dynamic shared memory holds for the
    // life of the process: set it at the first launch on each device.
    static bool opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || !opted_in[dev]) {
      err = cudaFuncSetAttribute(tile_stats_one_read_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSliceBytes);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) opted_in[dev] = true;
    }
    tile_stats_one_read_kernel<<<(unsigned)(n_tiles * kCluster), kThreads, slice_bytes,
                                 (cudaStream_t)stream>>>(dem, out, count, rank_lo, rank_hi,
                                                         frac);
  } else {
    tile_stats_stream_kernel<<<(unsigned)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        dem, out, count, rank_lo, rank_hi, frac);
  }
  return (int)cudaGetLastError();
}
