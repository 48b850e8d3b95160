// The ResUNet HR tail: concat(sr, dem) -> residual block (projection
// shortcut) -> residual block (identity shortcut) -> 1x1 head, NHWC f32.
//
// Replaces the TPU kernel floodsr_tpu/ops/pallas/hr_tail.py::hr_tail_pallas
// (pallas_call at :594, kernel _hr_tail_kernel :385-447).
//
// What it computes: with BN folded to per-channel (a, c),
//   x   = concat(sr, dem)                               [B, H, W, Ca+Cb]
//   p   = x @ pw + pb                                   (1x1 projection)
//   y1  = conv3x3(relu(a2 * conv3x3(relu(a1 * x + c1)) + b1 + c2)) + b2 + p
//   y2  = the same on y1 with the identity shortcut
//   out = y2 @ hw + hb                                  [B, H, W, Ch]
// SAME zero padding falls on each post-activation tensor at the image edges,
// as in the TPU kernel (:412-422): pixels outside the image load as 0 after
// the affine and ReLU.
//
// How: six launches of two hand-written kernels, in the order proj,
// f1.conv1, f1.conv2 (+proj), f2.conv1, f2.conv2 (+y1), head; the
// intermediates are [B, H, W, Cm] f32 in device memory.
//  - affine_relu_conv3x3: a direct 3x3 conv. A block computes 8 rows x 32
//    columns x 32 output channels, looping over input channels in chunks of
//    16; each chunk's input patch (halo 1) and weights are staged in shared
//    memory, the folded BN-affine and ReLU applied as the patch loads. The
//    input is read as two channel ranges (sr | dem), so the concat is never
//    materialized. The epilogue adds the bias and, optionally, a residual
//    (which may alias the output: each element is read and then written by
//    the same thread).
//  - conv1x1: a tiled pointwise product (128 pixels x 32 channels a block).
// Arithmetic is f32 FMA on the CUDA cores, for parity with the JAX f32 path.
//
// What bounds it on the card: operations. 10.64 GMAC (21.3 GFLOP) per
// 128x128 tile at the flagship widths, 0.32 ms per tile at the H100 SXM's
// 67 TFLOP/s f32 (non-tensor) peak; its bytes (one read of the inputs, one
// write of the output) take under a tenth of that. This first version keeps
// a 4x8 register tile per thread (8 FMAs per shared-memory load) and
// round-trips the five intermediates through device memory; a fused
// single-pass design and the tensor cores (wgmma/TMA) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// affine_relu_conv3x3 tiling
constexpr int TH = 8;    // output rows per block
constexpr int TW = 32;   // output columns per block
constexpr int TC = 32;   // output channels per block
constexpr int CK = 16;   // input channels per shared-memory chunk
constexpr int PH = TH + 2;
constexpr int PW = TW + 2;

__global__ void __launch_bounds__(kThreads)
affine_relu_conv3x3_kernel(const float* xa, int ca, const float* xb, int cb,
                           const float* __restrict__ aff_a,
                           const float* __restrict__ aff_c,
                           const float* __restrict__ w,
                           const float* __restrict__ bias, const float* res,
                           float* out, int H, int W, int cout) {
  __shared__ float s_in[CK][PH][PW];
  __shared__ __align__(16) float s_w[9][CK][TC];

  const int cin = ca + cb;
  const int n_cblk = (cout + TC - 1) / TC;
  const int b = blockIdx.z / n_cblk;
  const int co0 = (blockIdx.z % n_cblk) * TC;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = warp & 3;   // output channels cg*8 .. cg*8+7 of the block
  const int rg = warp >> 2;  // output rows rg*4 .. rg*4+3 of the block

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    for (int i = tid; i < CK * PH * PW; i += kThreads) {
      const int ci = i % CK;
      const int pix = i / CK;
      const int py = pix / PW;
      const int px = pix % PW;
      const int gy = y0 + py - 1;
      const int gx = x0 + px - 1;
      const int gc = c0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < cin) {
        const size_t pixel = ((size_t)b * H + gy) * W + gx;
        const float raw =
            gc < ca ? xa[pixel * ca + gc] : xb[pixel * cb + (gc - ca)];
        v = fmaxf(__fadd_rn(__fmul_rn(raw, aff_a[gc]), aff_c[gc]), 0.f);
      }
      s_in[ci][py][px] = v;
    }
    for (int i = tid; i < 9 * CK * TC; i += kThreads) {
      const int co = i % TC;
      const int rest = i / TC;
      const int ci = rest % CK;
      const int tap = rest / CK;
      const int gc = c0 + ci;
      const int gco = co0 + co;
      s_w[tap][ci][co] = (gc < cin && gco < cout)
                             ? w[((size_t)tap * cin + gc) * cout + gco]
                             : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float in[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) in[r] = s_in[ci][rg * 4 + r][lane + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float4* wp =
              reinterpret_cast<const float4*>(&s_w[ky * 3 + kx][ci][cg * 8]);
          const float4 w0 = wp[0];
          const float4 w1 = wp[1];
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[r][j] = fmaf(in[r + ky], wv[j], acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

  const int gx = x0 + lane;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gy = y0 + rg * 4 + r;
    if (gy >= H || gx >= W) continue;
    const size_t base = (((size_t)b * H + gy) * W + gx) * cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + cg * 8 + j;
      if (co >= cout) continue;
      float v = acc[r][j] + bias[co];
      if (res != nullptr) v = v + res[base + co];
      out[base + co] = v;
    }
  }
}

// conv1x1 tiling
constexpr int PM = 128;  // pixels per block
constexpr int PN = 32;   // output channels per block
constexpr int PK = 16;   // input channels per shared-memory chunk

__global__ void __launch_bounds__(kThreads)
conv1x1_kernel(const float* xa, int ca, const float* xb, int cb,
               const float* __restrict__ w, const float* __restrict__ bias,
               float* out, long long npix, int cout) {
  __shared__ float s_x[PK][PM];
  __shared__ __align__(16) float s_w[PK][PN];

  const int cin = ca + cb;
  const long long p0 = (long long)blockIdx.x * PM;
  const int n0 = blockIdx.y * PN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // output channels warp*4 .. warp*4+3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += PK) {
    for (int i = tid; i < PK * PM; i += kThreads) {
      const int k = i % PK;
      const int m = i / PK;
      const long long gp = p0 + m;
      const int gk = k0 + k;
      float v = 0.f;
      if (gp < npix && gk < cin) {
        v = gk < ca ? xa[(size_t)gp * ca + gk] : xb[(size_t)gp * cb + (gk - ca)];
      }
      s_x[k][m] = v;
    }
    for (int i = tid; i < PK * PN; i += kThreads) {
      const int n = i % PN;
      const int k = i / PN;
      const int gk = k0 + k;
      const int gn = n0 + n;
      s_w[k][n] = (gk < cin && gn < cout) ? w[(size_t)gk * cout + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < PK; ++k) {
      float xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = s_x[k][lane + 32 * i];
      const float4 wq = *reinterpret_cast<const float4*>(&s_w[k][warp * 4]);
      const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gp = p0 + lane + 32 * i;
    if (gp >= npix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + warp * 4 + j;
      if (co < cout) out[(size_t)gp * cout + co] = acc[i][j] + bias[co];
    }
  }
}

cudaError_t launch_conv3x3(const float* xa, int ca, const float* xb, int cb,
                           const float* a, const float* c, const float* w,
                           const float* bias, const float* res, float* out,
                           int B, int H, int W, int cout, cudaStream_t stream) {
  const int n_cblk = (cout + TC - 1) / TC;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_cblk);
  affine_relu_conv3x3_kernel<<<grid, kThreads, 0, stream>>>(
      xa, ca, xb, cb, a, c, w, bias, res, out, H, W, cout);
  return cudaGetLastError();
}

cudaError_t launch_conv1x1(const float* xa, int ca, const float* xb, int cb,
                           const float* w, const float* bias, float* out,
                           long long npix, int cout, cudaStream_t stream) {
  dim3 grid((unsigned)((npix + PM - 1) / PM), (cout + PN - 1) / PN, 1);
  conv1x1_kernel<<<grid, kThreads, 0, stream>>>(xa, ca, xb, cb, w, bias, out,
                                                npix, cout);
  return cudaGetLastError();
}

// Positions in the packed weight list (WEIGHT_KEYS in hr_tail.py).
enum {
  F1_A1, F1_C1, F1_W1, F1_B1, F1_A2, F1_C2, F1_W2, F1_B2, F1_PW, F1_PB,
  F2_A1, F2_C1, F2_W1, F2_B1, F2_A2, F2_C2, F2_W2, F2_B2, HEAD_W, HEAD_B,
  N_WEIGHTS
};

}  // namespace

// sr [B,H,W,ca], dem [B,H,W,cb]; weights: N_WEIGHTS device pointers in
// WEIGHT_KEYS order; buf_p and buf_y are [B,H,W,cm] scratch; out [B,H,W,ch].
extern "C" int hr_tail_launch(const float* sr, const float* dem, int B, int H,
                              int W, int ca, int cb, int cm, int ch,
                              const void* const* weights, float* buf_p,
                              float* buf_y, float* out, void* stream_ptr) {
  const float* const* wt = reinterpret_cast<const float* const*>(weights);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long npix = (long long)B * H * W;
  cudaError_t err;
  // p = proj(x)
  err = launch_conv1x1(sr, ca, dem, cb, wt[F1_PW], wt[F1_PB], buf_p, npix, cm,
                       stream);
  if (err != cudaSuccess) return (int)err;
  // y = conv1(relu(bn1 x))
  err = launch_conv3x3(sr, ca, dem, cb, wt[F1_A1], wt[F1_C1], wt[F1_W1],
                       wt[F1_B1], nullptr, buf_y, B, H, W, cm, stream);
  if (err != cudaSuccess) return (int)err;
  // y1 = conv2(relu(bn2 y)) + p, in place over p
  err = launch_conv3x3(buf_y, cm, nullptr, 0, wt[F1_A2], wt[F1_C2], wt[F1_W2],
                       wt[F1_B2], buf_p, buf_p, B, H, W, cm, stream);
  if (err != cudaSuccess) return (int)err;
  // z = conv1(relu(bn1 y1))
  err = launch_conv3x3(buf_p, cm, nullptr, 0, wt[F2_A1], wt[F2_C1], wt[F2_W1],
                       wt[F2_B1], nullptr, buf_y, B, H, W, cm, stream);
  if (err != cudaSuccess) return (int)err;
  // y2 = conv2(relu(bn2 z)) + y1, in place over y1
  err = launch_conv3x3(buf_y, cm, nullptr, 0, wt[F2_A2], wt[F2_C2], wt[F2_W2],
                       wt[F2_B2], buf_p, buf_p, B, H, W, cm, stream);
  if (err != cudaSuccess) return (int)err;
  // out = head(y2)
  err = launch_conv1x1(buf_p, cm, nullptr, 0, wt[HEAD_W], wt[HEAD_B], out, npix,
                       ch, stream);
  return (int)err;
}
