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
// Two routes for each arithmetic, chosen by the wrapper from the channel
// counts alone. The f32 routes read the input as two channel ranges (sr |
// dem), so the concat is never materialized; their intermediates are
// [B, H, W, Cm] f32 in device memory. The bf16 route stores bf16 operands.
//
//  - Tensor-core route (hr_tail_tc_launch; (Cm, Ch) = (128, 16), (64, 4) or
//    (32, 1): the JAX package's three HR layouts, hr_s2d 4, 2 and 1 at base
//    and fuse width 32; Ca and Cb multiples of 4, Ca + Cb a multiple of 16):
//    four launches of tc::conv_tc_kernel<N = Cm, CH = Ch, MT> (or, at the
//    small widths, tc::conv_tc_rs_kernel), one implicit-GEMM 3x3 convolution:
//        y  = f1.conv1(relu(bn1 x))
//        y1 = f1.conv2(relu(bn2 y)) + proj(x)   the projection as (Ca+Cb)/16
//                                               more chunks of K on the raw x
//        z  = f2.conv1(relu(bn1 y1))
//        out = head(f2.conv2(relu(bn2 z)) + y1) y1 starts the sums; y2 never
//                                               reaches device memory
//      * GEMM: M = pixels, N = the Cm output channels (all in one block),
//        K = taps x input channels. wgmma.mma_async m64nNk8 with TF32
//        operands from shared memory and f32 accumulators in registers.
//      * Precision: 3xTF32. Every f32 operand is split into hi = tf32(x)
//        (cvt.rna: nearest, ties away from zero) and lo = tf32(x - hi); a
//        product is lo*Whi + hi*Wlo + hi*Whi in that order, summed in the f32
//        accumulator, so the result stays at f32-rounding level. (The
//        accumulator chops where an FMA rounds: 1.4e-5 of the output's range
//        against the plain version, where the direct route has 1.8e-6.)
//      * A block is 2 MT image rows x 64 columns: two consumer warpgroups,
//        each with MT 64-pixel GEMM tiles (one per image row, MT N/2
//        accumulator registers a thread: MT = 2 at Cm 128, 4 at Cm 64 and
//        32), and one producer warpgroup. The 64 rows of a GEMM tile are 64
//        consecutive pixels of one image row, so every tap is a constant byte
//        offset into one staged patch.
//      * The patch (halo 1) is staged once per block and 16-channel chunk by
//        three producer warps: float4 loads, affine (__fmul_rn/__fadd_rn) +
//        ReLU, zero outside the image, hi/lo split, stored in the no-swizzle
//        K-major wgmma layout with the pixel as the row: plane[channel quad]
//        [patch pixel][4 channels], so a row is 16 bytes, 8 rows are one
//        128-byte core matrix wherever the tap's offset starts, SBO = 128
//        and LBO = the plane stride. Two patch buffers: the next chunk is
//        staged while this one multiplies.
//      * Weights are split and laid out once per set of weights on the host
//        (one slab [hi|lo][channel quad][cout][4] per chunk and tap); one
//        producer thread streams them through a 4-stage ring with
//        cp.async.bulk + mbarrier, 128 N bytes a stage. 256 pixels a block
//        keeps the L2 re-reads of the 1.18 MB of hi+lo weights of a 3x3 at
//        Cm 128 at 0.6 GB a convolution.
//      * The residual initializes the accumulators (its loads overlap the
//        pipeline's fill; it may alias the output: each element is read and
//        later written by the same thread); the epilogue adds the bias and
//        stores float2 from the wgmma fragment layout.
//      * The fused head: each warpgroup writes its 64-pixel tiles of y2, split
//        into hi and lo, over the then idle pipeline buffers in the A layout
//        and runs Cm/8 more k8 steps of m64nHNk8 against the head's weights,
//        HN = Ch rounded up to the wgmma's 8 (the pack's columns beyond Ch
//        are zeros; only Ch are stored).
//      * The small widths (Cm 64 and 32: hr_s2d 2 and 1) take
//        tc::conv_tc_rs_kernel, the same convolution with the A operand from
//        registers (wgmma m64nNk8 with A as four 32-bit registers a thread;
//        the flagship's conv_tc_kernel is left as it was measured, bit for
//        bit). In the design before it, with A from shared memory, an
//        m64n32k8 read 2 KB of A and 1 KB of B in its 16 clocks at peak, 192
//        bytes a clock against the SM's 128, and the consumers waited for a
//        staged patch 31-40% of their loop. Now:
//        - A consumer thread loads its fragment of one input row at one
//          column tap with two 16-byte loads, one a pixel: channels 4t ..
//          4t + 3 of the chunk (t = lane % 4), which the pack puts at k
//          columns t and t + 4 of the chunk's two k8 steps (hr_tail.py:
//          _tc_slabs, transposed). It splits them into hi and lo in registers
//          and issues the products of every output row of its warpgroup that
//          reads that row (ky = 0, 1, 2): one load and split for up to 18
//          products. The sums run input-row-major (chunk, input row, column
//          tap, output row, k8 step), so the small widths' outputs are not
//          bit-equal to the design before (held to the plain version).
//        - A group is one (row, column tap); two fragment buffers, one group
//          in flight (wait_group 1), the offsets to the tap's slab added to
//          the B descriptor in the PTX and the patch loads in PTX with
//          immediate offsets, so no descriptor or address but the stage's
//          lives in a register; the groups are unrolled at compile time
//          (std::integer_sequence).
//        - A chunk's nine weight slabs are resident in its stage (one bulk
//          copy: 36 KB at Cm 32, 72 KB at 64; two stages), so a chunk has
//          one barrier round; the head's weights go into the stage the chunk
//          after the last would take.
//        - The stagers copy the raw f32 patch by cp.async (zeros outside the
//          image) and activate it in place in one f32 pass: the affine and
//          ReLU in the consumers' registers, once per loaded fragment, was
//          1-6% slower (the act_in_registers variant of
//          tools/hr_tail_tc_variants.py and tools/hr_tail_tc_probe.py).
//        - Rows a block: 8 at Cm 32 (MT = 4). At Cm 64, four tiles of 32
//          accumulators a thread and two fragment buffers need more than the
//          168 registers a thread of a 384-thread block has: 120 bytes
//          spill and ptxas serializes the wgmma (C7512). setmaxnreg
//          (consumers up, producers down) does not help: ptxas still
//          compiles the kernel to 168, spills 0.3-0.6 KB and serializes at
//          every width, 1.4x slower. So 6 rows (MT = 3), unless one wave of
//          8-row blocks covers the grid (one 256x256 tile: 128 blocks, but
//          172 of 6 rows), where MT = 4 is still faster. Those choices turned
//          the other way: tools/hr_tail_tc_variants.py.
//        What binds it (clock counters in a copy of the kernel,
//        tools/hr_tail_tc_probe.py, H100): the consumers' own issue. A group
//        waits for its loads and split before its products go out: 26-28% of
//        the first consumer thread's time, and its wait for the patch 13%
//        (Cm 64) and 23% (Cm 32): the stagers' activation pass is on the
//        chunk's critical path. Shared memory asks about 85 bytes a
//        clock at the tensor cores' pace. 61% of the operation bound at Cm 64,
//        40% at Cm 32 (8 tiles).
//      * A barrier that is not reached within seconds traps, so a protocol
//        fault shows as a launch error and not as a hang.
//  - bf16 route (hr_tail_bf16_launch; the flagship's widths, (Cm, Ch) =
//    (128, 16)): the arithmetic of the TPU kernel's mode="bf16" (:385-447,
//    _conv3x3_im2col :183-185, _dot :122-126). Inputs, intermediates, affines, biases and residual adds stay
//    f32; at the four 3x3 convolutions and at the projection the activated
//    operand is rounded to bf16 (round to nearest even) and multiplied with
//    the bf16-rounded weight in ONE pass with f32 accumulation; the 1x1 head
//    stays at three-pass precision (head_mode "x3"), the 3xTF32 product of
//    the tensor-core route's epilogue. A pre-pass, three launches of
//    tc::bf::conv_bf16_kernel and one of conv_bf16_head_kernel, one wgmma
//    m64nNk16 .f32.bf16.bf16 per tap, 64-pixel tile and 16-channel chunk:
//      * Each operand is produced once, as bf16, by the launch that computes
//        it: an epilogue applies the NEXT convolution's affine and ReLU
//        (__fmul_rn/__fadd_rn, __floats2bfloat162_rn) and stores NHWC bf16;
//        bf16_prepass_kernel does it for f1.conv1's operand and writes bf16(x)
//        for the projection. The same values the consumer would compute, bit
//        for bit; y1 alone stays f32 (the last residual).
//      * TMA brings them in: a 4-D tensor map (channels, W, H, B) per
//        operand, a box of 8 channels x 66 x 4 rows per channel octet, no
//        swizzle, so an octet lands as [row][column][8]: the K-major core
//        matrices wgmma reads with LBO = the octet's plane and SBO = 128, and
//        every tap is a constant offset. Elements outside the tensor land as
//        zeros, which is the SAME padding after the activation: the image
//        edges need no code. The maps are encoded per call by
//        cuTensorMapEncodeTiled, looked up at run time with
//        cudaGetDriverEntryPoint, so the library links no -lcuda.
//      * One barrier round per chunk: a ring stage holds the chunk's patch and
//        its nine weight slabs (36 KB, one bulk copy), and each MMA
//        warpgroup issues 9 wgmma between two rounds. The projection reads
//        bf16(x) at the unit's own pixels, five chunks a stage, after the
//        3x3 chunks. The sums keep the order of the route before this one
//        (residual first, chunk outer, tap inner), so the result is the same
//        bit for bit.
//      * A unit is 2 MT image rows x 64 columns: MT 64-pixel GEMM tiles per
//        MMA warpgroup, 64 accumulators a thread (MT = 1 at Cm 128, the one
//        width instantiated); a 128x128 tile is 128 units, so the scene's
//        call of one tile fills the card. At Cm 128, units of 4
//        rows (256 pixels a weight read) were slower: with 4 MMA warpgroups
//        ptxas budgets 96 registers and spills, with 2 warpgroups of two
//        tiles each it serializes the wgmma (C7515). A patch octet whose size
//        is not a multiple of 128 bytes (6 or 10 rows) is padded to one in
//        the stage, TMA's alignment of a destination.
//      * The three body launches are one persistent kernel
//        (conv_bf16_kernel, a block an SM, 3 ring stages): a producer warp
//        runs ahead across units, the MMA warpgroups hand each finished tile
//        (f32) to an epilogue warpgroup through shared memory and go on to
//        the next unit, and the epilogue warpgroup adds the biases, stores y1
//        where asked and the next operand in bf16, 16 bytes a thread. The
//        head's launch (conv_bf16_head_kernel, 4 stages) takes a unit a
//        block: the residual starts its sums and its y tile goes over the
//        idle ring.
//      * A barrier that is not reached within seconds traps.
//  - bf16 band route (hr_tail_bf16_band_launch; (Cm, Ch, Ca+Cb) = (64, 4, 96)
//    and (32, 1, 64), hr_s2d 2 and 1): the same arithmetic in ONE launch of
//    tc::band::bf16_band_kernel, every intermediate on chip, as the TPU
//    kernel's row bands with 4-row halos keep theirs in VMEM (:385-447):
//      * A unit (a block) is a strip of 56 output columns down a band of
//        rows (band_rows: the fewest waves of blocks times a block's steps;
//        130 blocks at one tile of either layout). Every operand a tile row
//        reads has 64 pixels, the strip and 4 each side, so one wgmma
//        m64nNk16 (N = Cm) covers a row and each 3x3 leaves its edge pixels
//        unused: after four, the 56 are exact (a column halo recomputed, no
//        row halo but the band's first 8 rows).
//      * Rows go down the band two a step. Step t brings x rows 2t-4, 2t-3
//        (f32, loaded into registers during the step before, one read of x
//        a unit), stores bf16(relu(bn1 x)) into the x ring, then warpgroup wg
//        computes row 2t-5+wg of y (f1.conv1), 2t-6+wg of y1 (f1.conv2 and
//        the projection from bf16(x) of the step before's rows), 2t-7+wg of
//        z (f2.conv1) and 2t-8+wg of the output (f2.conv2 + y1, the head).
//        Each reads the rows its predecessor wrote in this step or the one
//        before: rings of four rows ([octet][row][66 pixels][8], the
//        K-major core matrices, a tap a constant offset) hold them; y1's
//        f32 value stays in the registers of the warpgroup that adds it one
//        step later. Stage k runs from step k on.
//      * The epilogues apply the next convolution's affine and ReLU, round
//        to bf16 and zero every pixel outside the image at that tensor's own
//        rows and columns (SAME padding after the activation: TMA's zero
//        fill did it on the bf16 route). The head splits y2 into TF32 hi and
//        lo over two rows of the x ring that f1.conv1 has read for the last
//        time, 16 channels at a time, and runs the bf16 route's 3xTF32 head.
//      * Weights: at Cm 32 all five matrices (94 KB) stay in shared memory
//        for the block's life; at Cm 64 (336 KB) a producer warp streams
//        them chunk by chunk (nine slabs, 18 KB) through two ring stages.
//      * The sums run in the bf16 route's order (residual first, chunk
//        outer, tap inner, the projection after), so the output is the same
//        bit for bit (tools/hr_tail_bf16_vs_parent.py). Only the output
//        reaches device memory: no pre-pass and no scratch.
//  - Direct route (hr_tail_launch; any channel counts): the first version of
//    this port, f32 FMA on the CUDA cores, six launches (proj, four 3x3, the
//    head). affine_relu_conv3x3 computes 8 rows x 32 columns x 32 output
//    channels a block, looping over input channels in chunks of 16 staged in
//    shared memory; conv1x1 is a tiled pointwise product (128 pixels x 32
//    channels a block).
//  - Direct bf16 route (hr_tail_bf16_direct_launch; any channel counts): the
//    direct kernels with the activated operand and the weight rounded to
//    bf16 in registers (__float2bfloat16_rn and back) before the f32 FMA, at
//    the four 3x3 convolutions and the projection; the head stays an f32 FMA
//    product. It carries the bf16 policy at widths the tensor cores do not
//    take.
//
// What bounds it on the card: operations. 10.64 GMAC (21.3 GFLOP) per
// 128x128 tile at the flagship widths. On the tensor-core route every MAC is
// three TF32 products: 3 x 170.2 GFLOP at 8 tiles over the H100 SXM's 495
// TFLOP/s dense TF32 is 1.032 ms (one product alone: 0.344 ms). On the
// direct route 170.2 GFLOP over 67 TFLOP/s f32 (non-tensor) is 2.540 ms. The
// bytes (one read of the inputs, one write of the output) take under a
// tenth of either. What holds the tensor-core route above its bound: every
// m64n128k8 reads 6 KB of operands from shared memory in the 64 clocks it
// needs at peak, three quarters of the SM's 128 bytes a clock before the
// stagers' and the bulk copies' writes; a block's fill and epilogue are not
// overlapped with another block's sums (168 registers a thread and 169 KB of
// shared memory allow one block an SM).
// The bf16 route does one product per MAC: 170.2 GFLOP at 8 tiles over 989
// TFLOP/s dense bf16 is 0.172 ms. Its launches also move 0.6 GB at 8 tiles
// (the pre-pass 168 MB, the bf16 operands read with their halo and written,
// y1 written and read in f32): 0.18 ms at 3.35 TB/s, as much as the
// operations. The products themselves run at the tensor cores' peak from this layout (a
// loop of the same wgmma on the same operands: 98% of 989 TFLOP/s). What
// holds the route above its bound, measured with clock counters in a copy of
// the kernel on an H100: the body launches' MMA warpgroups wait for their
// stages a third of their time. A chunk brings 45 KB (the patch and the
// 36 KB of its weights) for 128 pixels, and at that rate all 132 SMs
// together read about 6 TB/s from L2: the loads, not the tensor cores, set
// the pace. Sharing each weight slab between the two blocks of a cluster
// (multicast) was tried and was slower.
// At the other two layouts (8 tiles; Ca+Cb -> Cm -> Ch, tile side): hr_s2d 2
// (96 -> 64 -> 4, 256) is 11.29 GMAC a tile, hr_s2d 1 (64 -> 32 -> 1, 512)
// 12.63: the 3xTF32 bounds are 1.095 and 1.224 ms, the bf16 bounds 0.183
// and 0.204 ms, all operations. The 3xTF32 route moves 1.35 and 2.96 GB at 8
// tiles as designed, its intermediates included (0.403 and 0.884 ms at 3.35
// TB/s). The bf16 band route reads x once a unit, its halo included (64
// columns and 8 rows more for 56 and the band's), and writes the output:
// 0.29 and 0.71 GB at most (0.085 and 0.213 ms; a neighbour's halo may come
// from L2), about its operation bound, where the bf16 route it replaces moved
// 1.28 and 2.96 GB. What holds it
// above its bound (tools/hr_tail_band_variants.py, H100): the head, x's
// loads and, at Cm 64, the weight stream (336 KB a step of 128 pixels,
// against two 18 KB stages) take a fifth to two fifths of the time; x's
// prefetch at Cm 64 shares 168 registers a thread with two residual sets and
// spills. Clock counters (tools/hr_tail_band_probe.py): the products take
// 43-44% of a block's time; x's act store, f1.conv2's epilogue with the raw
// store and x's load issue, the head and the other epilogues the rest, none
// of it overlapped with products. A second accumulator chain a warpgroup,
// and A from registers without reuse across rows, were both slower.
// -Xptxas -v (nvcc 12.9, sm_90a): conv_bf16_kernel and conv_bf16_head_kernel
// 90 registers each, no spills; dynamic shared memory 207,824 and 199,880
// bytes; bf16_prepass_kernel 24 registers. bf16_band_kernel 168 registers
// (a 288-thread block's budget) at <32,1,64>, no spills, and at <64,4,96>,
// spilling 400 bytes; dynamic shared memory 201,776 and 222,128 bytes; no
// wgmma serialized. conv_tc_kernel (Cm 128) 168 registers (its head variant
// spills 124 bytes), dynamic shared memory 168,552 / 184,936 (head) bytes;
// ptxas serializes its wgmma (C7518), as it always did. conv_tc_rs_kernel
// 147 / 149 (head) registers at <32,1,4>, 157 / 168 at <64,4,3>, no spills;
// 168 at <64,4,4>, spilling 120 / 132 bytes, its wgmma serialized (C7512);
// dynamic shared memory 158,264, 215,096 and 231,992 bytes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kThreads = 256;

// affine_relu_conv3x3 tiling
constexpr int TH = 8;    // output rows per block
constexpr int TW = 32;   // output columns per block
constexpr int TC = 32;   // output channels per block
constexpr int CK = 16;   // input channels per shared-memory chunk
constexpr int PH = TH + 2;
constexpr int PW = TW + 2;

// Nearest bf16 value (ties to even), as an f32.
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// With BF16 the activated operand and the weight are rounded to bf16 before
// the f32 FMA (a product of two bf16 values is exact in f32).
template <bool BF16>
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
        if (BF16) v = bf16_rn(v);
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
      float wv = (gc < cin && gco < cout)
                     ? w[((size_t)tap * cin + gc) * cout + gco]
                     : 0.f;
      if (BF16) wv = bf16_rn(wv);
      s_w[tap][ci][co] = wv;
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

template <bool BF16>
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
        if (BF16) v = bf16_rn(v);
      }
      s_x[k][m] = v;
    }
    for (int i = tid; i < PK * PN; i += kThreads) {
      const int n = i % PN;
      const int k = i / PN;
      const int gk = k0 + k;
      const int gn = n0 + n;
      float wv = (gk < cin && gn < cout) ? w[(size_t)gk * cout + gn] : 0.f;
      if (BF16) wv = bf16_rn(wv);
      s_w[k][n] = wv;
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
                           int B, int H, int W, int cout, bool bf16,
                           cudaStream_t stream) {
  const int n_cblk = (cout + TC - 1) / TC;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_cblk);
  if (bf16) {
    affine_relu_conv3x3_kernel<true><<<grid, kThreads, 0, stream>>>(
        xa, ca, xb, cb, a, c, w, bias, res, out, H, W, cout);
  } else {
    affine_relu_conv3x3_kernel<false><<<grid, kThreads, 0, stream>>>(
        xa, ca, xb, cb, a, c, w, bias, res, out, H, W, cout);
  }
  return cudaGetLastError();
}

cudaError_t launch_conv1x1(const float* xa, int ca, const float* xb, int cb,
                           const float* w, const float* bias, float* out,
                           long long npix, int cout, bool bf16,
                           cudaStream_t stream) {
  dim3 grid((unsigned)((npix + PM - 1) / PM), (cout + PN - 1) / PN, 1);
  if (bf16) {
    conv1x1_kernel<true><<<grid, kThreads, 0, stream>>>(xa, ca, xb, cb, w, bias,
                                                        out, npix, cout);
  } else {
    conv1x1_kernel<false><<<grid, kThreads, 0, stream>>>(xa, ca, xb, cb, w, bias,
                                                         out, npix, cout);
  }
  return cudaGetLastError();
}

// Positions in the packed weight list (WEIGHT_KEYS in hr_tail.py).
enum {
  F1_A1, F1_C1, F1_W1, F1_B1, F1_A2, F1_C2, F1_W2, F1_B2, F1_PW, F1_PB,
  F2_A1, F2_C1, F2_W1, F2_B1, F2_A2, F2_C2, F2_W2, F2_B2, HEAD_W, HEAD_B,
  N_WEIGHTS
};


// ---------------------------------------------------------------------------
// Tensor-core route: one implicit-GEMM convolution on wgmma, 3xTF32.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kStagers = 96;    // producer warps 1-3 stage the patch; warp 0 streams weights
constexpr int TWX = 64;         // image columns per block: the 64 rows of one wgmma
constexpr int CK = 16;          // input channels per patch stage (two k8 steps)
constexpr int NB = 4;           // weight ring stages, one (chunk, tap) slab each
constexpr int kPixLanes = kStagers / 4;  // stager threads along the patch row
constexpr int TAPS = 9;         // 3x3
constexpr int PW = TWX + 2;     // patch columns (halo 1)
constexpr int NPX = (PW + kPixLanes - 1) / kPixLanes;
constexpr int Y_PLANE = TWX * 16;  // one channel quad of a 64-pixel y tile
constexpr int kSmemMax = 232448;   // a block's shared memory on the H100

// The widths a route is instantiated for (TC_WIDTHS in hr_tail.py): N output
// channels of each convolution (one wgmma's width, all in one block), CH
// outputs of the 1x1 head, whose wgmma is HN = CH rounded up to 8 wide (the
// pack's columns beyond CH are zeros, and they are not stored), and MT 64-pixel
// GEMM tiles (image rows) per consumer warpgroup: a block is TR = 2 MT image
// rows x 64 columns. This is the plan of conv_tc_kernel, the flagship's (128,
// 16, 2); (64, 4, 3) and (32, 1, 4), hr_s2d = 2 and 1, take conv_tc_rs_kernel
// (RsPlan below).
template <int N_, int CH_, int MT_>
struct Widths {
  static constexpr int N = N_;
  static constexpr int CH = CH_;
  static constexpr int MT = MT_;
  static constexpr int HN = (CH + 7) / 8 * 8;
  static constexpr int TR = 2 * MT;   // image rows per block
  // The staged patch: the block's pixels with a halo of 1.
  static constexpr int PH = TR + 2;
  static constexpr int PIX = PH * PW;
  // Plane length in pixels, = 2 mod 8: the four channel quads that a stager
  // quarter-warp writes for two neighbouring pixels then fall into eight
  // different 16-byte bank groups.
  static constexpr int PLANE_PIX = PIX + ((2 - PIX % 8) + 8) % 8;
  static constexpr int PLANE = PLANE_PIX * 16;  // bytes: [pixel][one 16-byte row of channels]
  static constexpr int QB = N * 16;             // bytes of one plane of weights: [cout][16-byte row]
  // Stage sizes. A 16-byte row holds 4 TF32 channels, so a 16-channel chunk
  // is four planes of hi and four of lo.
  static constexpr int A_HALF = (CK / 4) * PLANE;   // the hi patch
  static constexpr int A_STAGE = 2 * A_HALF;        // hi then lo
  static constexpr int B_HALF = (CK / 4) * QB;      // hi weights of a ring stage
  static constexpr int B_STAGE = 2 * B_HALF;
  static constexpr int PIPE = 2 * A_STAGE + NB * B_STAGE;  // two patch stages, the ring
  static constexpr int HEAD_W_BYTES = 2 * N * HN * 4;      // the head's hi and lo weights
  static constexpr int Y_HALF = (N / 4) * Y_PLANE;         // the hi (or lo) y tile of one warpgroup
};

// Shared-memory plan. PIPE: the bytes before the head's weights: the
// pipeline's buffers, which with HEAD must also hold the two warpgroups' hi
// and lo y tiles once they are idle. BYTES: the pipeline, the head's weights,
// 2 + 2 + NB + NB + 1 barriers.
template <class Wd, bool HEAD>
struct Smem {
  static constexpr int PIPE = (HEAD && 4 * Wd::Y_HALF > Wd::PIPE) ? 4 * Wd::Y_HALF : Wd::PIPE;
  static constexpr int BYTES = PIPE + (HEAD ? Wd::HEAD_W_BYTES : 0) + (5 + 2 * NB) * 8;
  static_assert(BYTES <= kSmemMax, "a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase with this parity has completed; trap after
// about two seconds, so a fault in the protocol is a launch error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 4000000000ll) __trap();
  }
}

// mbar_wait with its loop inside the PTX, so the compiler sees no divergent
// branch around the wgmma that follow (a branch there makes ptxas serialize
// them, C7520). It traps, as mbar_wait does, after about two seconds.
__device__ __forceinline__ void mbar_wait_ptx(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, 4000000000;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival on the barrier from the thread whose lane is 0, predicated in
// the PTX (no branch).
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// Pin the accumulators at a pipeline stage's edges (an empty asm that reads
// and writes each), so the compiler moves no definition of them into a stage
// of wgmma in flight.
template <int MT, int NACC>
__device__ __forceinline__ void fence_acc(float (&acc)[MT][NACC]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(acc[mt][i])::"memory");
}

// A consumer's wait: in PTX (no branch around the wgmma) or the C++ loop.
template <bool PTX>
__device__ __forceinline__ void consumer_wait(uint32_t bar, uint32_t parity) {
  if (PTX) {
    mbar_wait_ptx(bar, parity);
  } else {
    mbar_wait(bar, parity);
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared by cp.async, the bytes past src_bytes (all 16
// with 0) filled with zeros; then this thread's copies all landed.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Barrier id among count threads (id 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Shared-memory matrix descriptor, no swizzle, K-major: a core matrix is 8
// rows of 16 bytes, contiguous; lbo is the byte stride between the two core
// matrices of a k8 step, sbo the stride between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Nearest TF32 value, ties away from zero (the low 13 mantissa bits come out 0).
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}


__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// One k16 step in bf16: both operands K-major from shared memory; with
// accumulate 0 the sums start from the products (d is not read).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}


__device__ __forceinline__ void wgmma_tf32(float (&d)[4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float act(float raw, float a, float c) {
  return fmaxf(__fadd_rn(__fmul_rn(raw, a), c), 0.f);
}


// The stagers' last step for 4 channels of a patch pixel: the affine and
// ReLU (where activate), zero outside the image, split into TF32 hi and lo,
// stored at dst and dst + lo_off.
__device__ __forceinline__ void split_store(float4 v, bool ok, bool activate, float4 fa,
                                            float4 fc, unsigned char* dst, int lo_off) {
  if (activate) {
    v.x = act(v.x, fa.x, fc.x);
    v.y = act(v.y, fa.y, fc.y);
    v.z = act(v.z, fa.z, fc.z);
    v.w = act(v.w, fa.w, fc.w);
  }
  if (!ok) v = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 hi, lo;
  hi.x = tf32_rna(v.x); lo.x = tf32_rna(v.x - hi.x);
  hi.y = tf32_rna(v.y); lo.y = tf32_rna(v.y - hi.y);
  hi.z = tf32_rna(v.z); lo.z = tf32_rna(v.z - hi.z);
  hi.w = tf32_rna(v.w); lo.w = tf32_rna(v.w - hi.w);
  *reinterpret_cast<float4*>(dst) = hi;
  *reinterpret_cast<float4*>(dst + lo_off) = lo;
}

// A pixel's head outputs from its m64nHN fragment: lane l holds columns
// 8j + 2(l%4) and + 1 of its two rows as hacc[4j + 2*half + 0/1]; px_out is
// the pixel's row of CH floats, and the columns at CH and beyond (the zeros
// of the padded head) are not stored.
template <int CH, int NH>
__device__ __forceinline__ void store_head(float* px_out, const float (&hacc)[NH], int half,
                                           int lane, const float* __restrict__ head_bias) {
#pragma unroll
  for (int j = 0; j < NH / 4; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (CH % 2 == 0) {
      if (col < CH) {
        const float2 hb = *reinterpret_cast<const float2*>(head_bias + col);
        float2 v;
        v.x = hacc[4 * j + 2 * half] + hb.x;
        v.y = hacc[4 * j + 2 * half + 1] + hb.y;
        *reinterpret_cast<float2*>(px_out + col) = v;
      }
    } else {
      if (col < CH) px_out[col] = hacc[4 * j + 2 * half] + head_bias[col];
      if (col + 1 < CH) px_out[col + 1] = hacc[4 * j + 2 * half + 1] + head_bias[col + 1];
    }
  }
}

// The residual starts the sums (zeros without one); its loads overlap the
// pipeline's fill. The m64nN fragment: thread (warp wq of the warpgroup, lane
// l) holds rows 16 wq + l/4 and + 8, columns 8j + 2(l%4) and + 1, as
// acc[mt][4j + 2*half + 0/1]; tile mt is image row y_first + mt.
template <int N, int MT>
__device__ __forceinline__ void start_sums(float (&acc)[MT][N / 2], const float* res, int b,
                                           int H, int W, int x0, int y_first, int wq, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int gy = y_first + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + wq * 16 + (lane >> 2) + 8 * half;
      const bool live = res != nullptr && gy < H && gx < W;
      const size_t base = (((size_t)b * H + gy) * W + gx) * N + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        float2 r = make_float2(0.f, 0.f);
        if (live) r = *reinterpret_cast<const float2*>(res + base + 8 * j);
        acc[mt][4 * j + 2 * half] = r.x;
        acc[mt][4 * j + 2 * half + 1] = r.y;
      }
    }
  }
}

// The consumers' epilogue, after their last products. Without HEAD: bias (+
// bias2), stored (the residual may alias out: each element was read by the
// thread that writes it here). With HEAD: y = sums + biases, split into hi and
// lo, over the idle pipeline buffers at smem in the A layout (plane[channel
// quad][pixel][4], two y tiles a warpgroup), then N/8 more k8 steps of
// m64nHNk8 against the head's weights at h_smem (landed on full_h).
template <int N, int CH, int MT, bool HEAD, bool PTX>
__device__ __forceinline__ void finish_tiles(float (&acc)[MT][N / 2],
                                             const float* __restrict__ bias,
                                             const float* __restrict__ bias2,
                                             const float* __restrict__ head_bias, float* out,
                                             unsigned char* smem, uint32_t h_smem, uint32_t full_h,
                                             int b, int H, int W, int x0, int y_first, int wg,
                                             int wq, int lane) {
  constexpr int HN = (CH + 7) / 8 * 8;
  constexpr int Y_HALF = (N / 4) * Y_PLANE;
  if (!HEAD) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int gy = y_first + mt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gx = x0 + wq * 16 + (lane >> 2) + 8 * half;
        if (gy >= H || gx >= W) continue;
        const size_t base = (((size_t)b * H + gy) * W + gx) * N + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * (lane & 3));
          float2 v;
          v.x = acc[mt][4 * j + 2 * half] + bv.x;
          v.y = acc[mt][4 * j + 2 * half + 1] + bv.y;
          if (bias2 != nullptr) {
            const float2 b2 = *reinterpret_cast<const float2*>(bias2 + 8 * j + 2 * (lane & 3));
            v.x = v.x + b2.x;
            v.y = v.y + b2.y;
          }
          *reinterpret_cast<float2*>(out + base + 8 * j) = v;
        }
      }
    }
    return;
  }
  // Both warpgroups have finished reading the pipeline's buffers; each takes
  // its own part of them for its y tiles.
  named_barrier(1, 256);
  consumer_wait<PTX>(full_h, 0);
  unsigned char* y_buf = smem + wg * 2 * Y_HALF;
  const uint32_t y_smem = smem_u32(y_buf);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = wq * 16 + (lane >> 2) + 8 * half;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const float2 bv = *reinterpret_cast<const float2*>(bias + col);
        float2 v;
        v.x = acc[mt][4 * j + 2 * half] + bv.x;
        v.y = acc[mt][4 * j + 2 * half + 1] + bv.y;
        if (bias2 != nullptr) {
          const float2 b2 = *reinterpret_cast<const float2*>(bias2 + col);
          v.x = v.x + b2.x;
          v.y = v.y + b2.y;
        }
        float2 hi, lo;
        hi.x = tf32_rna(v.x); lo.x = tf32_rna(v.x - hi.x);
        hi.y = tf32_rna(v.y); lo.y = tf32_rna(v.y - hi.y);
        unsigned char* dst = y_buf + (col >> 2) * Y_PLANE + px * 16 + (col & 3) * 4;
        *reinterpret_cast<float2*>(dst) = hi;
        *reinterpret_cast<float2*>(dst + Y_HALF) = lo;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(2 + wg, 128);
    float hacc[HN / 2];
#pragma unroll
    for (int i = 0; i < HN / 2; ++i) hacc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < N / 8; ++ks) {
      constexpr int HQ = HN * 16;  // bytes of one channel quad of head weights
      const uint32_t hw = h_smem + (ks >> 1) * (2 * CK * HN * 4) + (ks & 1) * 2 * HQ;
      const uint64_t dbh = smem_desc(hw, HQ, 128);
      const uint64_t dbl = smem_desc(hw + CK * HN * 4, HQ, 128);
      const uint64_t dah = smem_desc(y_smem + ks * 2 * Y_PLANE, Y_PLANE, 128);
      const uint64_t dal = smem_desc(y_smem + Y_HALF + ks * 2 * Y_PLANE, Y_PLANE, 128);
      wgmma_tf32(hacc, dal, dbh);
      wgmma_tf32(hacc, dah, dbl);
      wgmma_tf32(hacc, dah, dbh);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < HN / 2; ++i) asm volatile("" : "+f"(hacc[i])::"memory");
    const int gy = y_first + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + wq * 16 + (lane >> 2) + 8 * half;
      if (gy >= H || gx >= W) continue;
      store_head<CH>(out + (((size_t)b * H + gy) * W + gx) * CH, hacc, half, lane, head_bias);
    }
    // The tile is read; the next one may overwrite it.
    named_barrier(2 + wg, 128);
  }
}

// out[b, y, x, :N] = bias (+ bias2) (+ res) + sum over taps and input channels
// of f(x)[b, y+ky-1, x+kx-1, ci] * w[tap, ci, :] (+ x2[b, y, x, :] @ w2), with
// f = relu(a*x + c), zero outside the image. x = (xa | xb) is the convolved
// input; x2 = (x2a | x2b), when it has channels, is a second input
// that enters raw through a 1x1 product (the block's projection shortcut):
// more K for the same accumulators, at the patch's centre tap. res, when
// given, initializes the accumulators. wpack holds one slab
// [hi|lo][CK/4][N][4] per (chunk, tap) of x, then one per chunk of x2. Every
// channel count is a multiple of 4, ca + cb and c2a + c2b multiples of CK.
//
// With HEAD, the result y is not stored: out[b, y, x, :CH] = y @ head_w +
// head_b. Each warpgroup writes a 64-pixel tile of y, split into
// hi and lo, over the idle pipeline buffers in the A-operand layout and
// multiplies it with the head's hi/lo weights (head_pack: N/CK slabs of
// [hi|lo][CK/4][HN][4], loaded once at the start) in N/8 more k8 steps.
template <int N, int CH, int MT, bool HEAD>
__global__ void __launch_bounds__(kThreads, 1)
conv_tc_kernel(const float* xa, int ca, const float* xb, int cb,
               const float* __restrict__ aff_a, const float* __restrict__ aff_c,
               const float* x2a, int c2a, const float* x2b, int c2b,
               const float* __restrict__ wpack, const float* __restrict__ bias,
               const float* __restrict__ bias2, const float* res,
               const float* __restrict__ head_pack, const float* __restrict__ head_bias,
               float* out, int H, int W) {
  using Wd = Widths<N, CH, MT>;
  constexpr int TR = Wd::TR, PH = Wd::PH;
  constexpr int PLANE = Wd::PLANE, QB = Wd::QB, A_HALF = Wd::A_HALF, A_STAGE = Wd::A_STAGE;
  constexpr int B_HALF = Wd::B_HALF, B_STAGE = Wd::B_STAGE, HEAD_W_BYTES = Wd::HEAD_W_BYTES;
  static_assert(N == 128, "the small widths take conv_tc_rs_kernel");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* a_buf = smem;
  unsigned char* b_buf = smem + 2 * A_STAGE;
  const uint32_t a_smem = smem_u32(a_buf);
  const uint32_t b_smem = smem_u32(b_buf);
  const uint32_t h_smem = a_smem + Smem<Wd, HEAD>::PIPE;  // the head's weights, hi then lo per slab
  const uint32_t bars = h_smem + (HEAD ? HEAD_W_BYTES : 0);
  const uint32_t full_a = bars;             // [2] the stagers' arrivals
  const uint32_t empty_a = bars + 16;       // [2] one arrival per consumer warp
  const uint32_t full_b = bars + 32;        // [NB] the bulk copy's bytes
  const uint32_t empty_b = full_b + 8 * NB; // [NB] one arrival per consumer warp
  const uint32_t full_h = empty_b + 8 * NB; // the head's weights have landed

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * TWX;
  const int y0 = blockIdx.y * TR;
  const int b = blockIdx.z;
  const int n1 = (ca + cb) / CK;          // chunks of the convolved input
  const int nchunks = n1 + (c2a + c2b) / CK;  // then the chunks of the 1x1 input

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_a + 8 * s, kStagers);
      mbar_init(empty_a + 8 * s, 8);
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, 8);
    }
    mbar_init(full_h, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 8) {
    // ---- consumers: warpgroup wg multiplies image rows MT*wg .. MT*wg + MT-1 ----
    const int wg = warp >> 2;
    // The m64nN fragment: thread (warp w, lane l) of the warpgroup holds rows
    // 16w + l/4 and + 8, columns 8j + 2(l%4) and + 1, as acc[4j + 2*half + 0/1].
    const int wq = warp & 3;
    float acc[MT][N / 2];
    start_sums<N, MT>(acc, res, b, H, W, x0, y0 + wg * MT, wq, lane);

    uint32_t it = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int sa = c & 1;
      mbar_wait(full_a + 8 * sa, (c >> 1) & 1);
      const uint32_t a_rows = a_smem + sa * A_STAGE + (wg * MT * PW) * 16;
      const int ntaps = c < n1 ? TAPS : 1;
      const int tap0 = c < n1 ? 0 : TAPS / 2;  // the 1x1 input sits at the centre tap
#pragma unroll 1
      for (int t = 0; t < ntaps; ++t, ++it) {
        const int tap = tap0 + t;
        const uint32_t sb = it & (NB - 1);
        mbar_wait(full_b + 8 * sb, (it / NB) & 1);
        const int ky = tap / 3;
        const int kx = tap - 3 * ky;
        const uint32_t a_tap = a_rows + (ky * PW + kx) * 16;
        const uint32_t b_hi = b_smem + sb * B_STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CK / 8; ++kk) {
          const uint64_t dbh = smem_desc(b_hi + kk * 2 * QB, QB, 128);
          const uint64_t dbl = smem_desc(b_hi + B_HALF + kk * 2 * QB, QB, 128);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t a0 = a_tap + kk * 2 * PLANE + mt * PW * 16;
            const uint64_t dah = smem_desc(a0, PLANE, 128);
            const uint64_t dal = smem_desc(a0 + A_HALF, PLANE, 128);
            wgmma_tf32(acc[mt], dal, dbh);  // small terms first
            wgmma_tf32(acc[mt], dah, dbl);
            wgmma_tf32(acc[mt], dah, dbh);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        // The group before this one has finished reading its stages.
        if (it > 0 && lane == 0) {
          mbar_arrive(empty_b + 8 * ((it - 1) & (NB - 1)));
          if (t == 0) mbar_arrive(empty_a + 8 * ((c - 1) & 1));
        }
      }
    }
    wgmma_wait<0>();
    // Keep the compiler from reading the accumulators before the wait.
    fence_acc(acc);
    finish_tiles<N, CH, MT, HEAD, false>(acc, bias, bias2, head_bias, out, smem, h_smem, full_h, b,
                                        H, W, x0, y0 + wg * MT, wg, wq, lane);
  } else if (warp == 8) {
    // ---- producer warp 0: stream the weight slabs through the ring ----
    if (lane == 0) {
      if (HEAD) {
        mbar_arrive_expect_tx(full_h, HEAD_W_BYTES);
        bulk_load(h_smem, head_pack, HEAD_W_BYTES, full_h);
      }
      const uint32_t total = (uint32_t)(n1 * TAPS + (nchunks - n1));
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wpack);
      for (uint32_t it = 0; it < total; ++it) {
        const uint32_t sb = it & (NB - 1);
        mbar_wait(empty_b + 8 * sb, ((it / NB) & 1) ^ 1);
        mbar_arrive_expect_tx(full_b + 8 * sb, B_STAGE);
        bulk_load(b_smem + sb * B_STAGE, src + (size_t)it * B_STAGE, B_STAGE, full_b + 8 * sb);
      }
    }
  } else {
    // ---- producer warps 1-3: stage the activated, split patch ----
    const int t = tid - 288;
    const int q = t & 3;    // channel quad of the chunk
    const int pc = t >> 2;  // pixel lane along the patch row
    for (int c = 0; c < nchunks; ++c) {
      const int sa = c & 1;
      mbar_wait(empty_a + 8 * sa, ((c >> 1) & 1) ^ 1);
      const bool second = c >= n1;  // a chunk of the raw 1x1 input
      const int gc = (second ? c - n1 : c) * CK + q * 4;
      const float* pa = second ? x2a : xa;
      const float* pb = second ? x2b : xb;
      const int na = second ? c2a : ca;
      const int nb = second ? c2b : cb;
      const float* src;
      int cs, coff;
      if (gc < na) {
        src = pa; cs = na; coff = gc;
      } else {
        src = pb; cs = nb; coff = gc - na;
      }
      const bool activate = !second;
      float4 fa = make_float4(1.f, 1.f, 1.f, 1.f);
      float4 fc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (activate) {
        fa = *reinterpret_cast<const float4*>(aff_a + gc);
        fc = *reinterpret_cast<const float4*>(aff_c + gc);
      }
      // plane q: a 16-byte row of 4 channels
      unsigned char* hi_plane = a_buf + sa * A_STAGE + q * PLANE;
      // Two patch rows a step, so six loads are in flight per thread.
      for (int py0 = 0; py0 < PH; py0 += 2) {
        float4 raw[2][NPX];
        bool ok[2][NPX];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int gy = y0 + py0 + r - 1;  // the halo
#pragma unroll
          for (int j = 0; j < NPX; ++j) {
            const int px = pc + kPixLanes * j;
            const int gx = x0 + px - 1;  // the halo
            ok[r][j] = px < PW && gy >= 0 && gy < H && gx >= 0 && gx < W;
            raw[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (ok[r][j]) {
              raw[r][j] = __ldg(reinterpret_cast<const float4*>(
                  src + (((size_t)b * H + gy) * W + gx) * cs + coff));
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int j = 0; j < NPX; ++j) {
            const int px = pc + kPixLanes * j;
            if (px >= PW) continue;
            split_store(raw[r][j], ok[r][j], activate, fa, fc,
                        hi_plane + ((py0 + r) * PW + px) * 16, A_HALF);
          }
        }
      }
      // Make the generic-proxy stores visible to wgmma's async-proxy reads.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full_a + 8 * sa);
    }
  }
}

// ---- the small widths (N < 128): the A operand from registers ----

// One k8 step of m64nNk8 with A from registers: a[0..3] is the thread's
// fragment (rows 16w + l/4 and + 8, k columns l%4 and + 4, in the order
// (row, k) = (l/4, l%4), (l/4 + 8, l%4), (l/4, l%4 + 4), (l/4 + 8, l%4 + 4));
// B at desc's start address plus OFF 16-byte units, added in the PTX so that
// no descriptor but the stage's own lives in a register.
template <int OFF>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "add.s64 db, %36, %37;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(OFF), "r"(1));
}

template <int OFF>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "add.s64 db, %20, %21;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, db, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(OFF), "r"(1));
}

// 16 bytes of shared memory at addr + OFF, in program order with the
// barrier waits and products around it.
template <int OFF>
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4+%5];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr), "n"(OFF)
               : "memory");
  return v;
}

// One arrival on the barrier once every cp.async this thread has issued has
// landed; the thread goes on at once (the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Keep fragment registers alive (and unmoved) up to this point: wgmma reads
// them asynchronously, after the instruction the compiler sees.
template <int K>
__device__ __forceinline__ void pin(uint32_t (&r)[2][2][K]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[h][kk][i])::"memory");
}

__device__ __forceinline__ float4 act4(float4 v, float4 a, float4 c, bool ok) {
  v.x = ok ? act(v.x, a.x, c.x) : 0.f;
  v.y = ok ? act(v.y, a.y, c.y) : 0.f;
  v.z = ok ? act(v.z, a.z, c.z) : 0.f;
  v.w = ok ? act(v.w, a.w, c.w) : 0.f;
  return v;
}

// The thread's A fragments of a 16-channel chunk's two k8 steps, split into
// TF32 hi and lo: v0 and v1 are its two pixels' (rows l/4 and l/4 + 8)
// channels 4(l%4) .. 4(l%4) + 3, which the pack (hr_tail.py: _tc_slabs) puts
// at k columns l%4 and l%4 + 4 of step 0 (channels +0, +1) and of step 1 (+2,
// +3). f[0] holds hi, f[1] lo, each [step][register].
__device__ __forceinline__ void split_frag(float4 v0, float4 v1, uint32_t (&f)[2][2][4]) {
  const float x[2][4] = {{v0.x, v1.x, v0.y, v1.y}, {v0.z, v1.z, v0.w, v1.w}};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float hi = tf32_rna(x[kk][i]);
      f[0][kk][i] = __float_as_uint(hi);
      f[1][kk][i] = __float_as_uint(tf32_rna(x[kk][i] - hi));
    }
}

// The plan of a small-width instantiation: a block is TR = 2 MT image rows x
// 64 columns; two patch stages of raw f32 pixels, [pixel][16 channels] as in
// device memory (64 bytes a pixel); two weight stages, each a chunk's nine
// tap slabs [hi|lo][CK/4][N][4] (one slab for a projection chunk). The head's
// y tiles go over the idle patch stages, its weights into the weight stage of
// the chunk after the last.
template <int N, int CH, int MT>
struct RsPlan {
  static constexpr int HN = (CH + 7) / 8 * 8;
  static constexpr int TR = 2 * MT;
  static constexpr int PH = TR + 2;
  static constexpr int PIX = CK * 4;               // bytes of one pixel's chunk
  static constexpr int A_STAGE = PH * PW * PIX;    // the raw patch
  static constexpr int QB = N * 16;                // one channel quad of a slab: [cout][4]
  static constexpr int B_HALF = (CK / 4) * QB;     // a slab's hi (or lo) weights
  static constexpr int SLAB = 2 * B_HALF;
  static constexpr int B_STAGE = TAPS * SLAB;      // a chunk's nine slabs
  static constexpr int HEAD_W_BYTES = 2 * N * HN * 4;
  static constexpr int Y_HALF = (N / 4) * Y_PLANE;
  static constexpr int BYTES = 2 * A_STAGE + 2 * B_STAGE + 7 * 8;  // + 7 barriers
  static_assert(BYTES <= kSmemMax, "a block's shared memory");
  static_assert(4 * Y_HALF <= 2 * A_STAGE, "the head's y tiles over the patch stages");
  static_assert(HEAD_W_BYTES <= B_STAGE, "the head's weights in a weight stage");
};

// The products of one fragment (input row J of the warpgroup's patch rows,
// column tap DX) for the output row that reads it at KY, if the warpgroup
// owns that row: both k8 steps, lo*Whi + hi*Wlo + hi*Whi each, against the
// tap's slab in the stage at b_desc.
template <int N, int MT, int J, int DX, int KY>
__device__ __forceinline__ void rs_products(float (&acc)[MT][N / 2], const uint32_t (&f)[2][2][4],
                                            uint64_t b_desc) {
  constexpr int MTI = J - KY;
  if constexpr (MTI >= 0 && MTI < MT) {
    constexpr int QB = N * 16, B_HALF = (CK / 4) * QB;
    constexpr int TAP = (3 * KY + DX) * 2 * B_HALF;  // bytes to the tap's slab
    wgmma_tf32_rs<TAP / 16>(acc[MTI], f[1][0], b_desc);  // small terms first
    wgmma_tf32_rs<(TAP + B_HALF) / 16>(acc[MTI], f[0][0], b_desc);
    wgmma_tf32_rs<TAP / 16>(acc[MTI], f[0][0], b_desc);
    wgmma_tf32_rs<(TAP + 2 * QB) / 16>(acc[MTI], f[1][1], b_desc);
    wgmma_tf32_rs<(TAP + B_HALF + 2 * QB) / 16>(acc[MTI], f[0][1], b_desc);
    wgmma_tf32_rs<(TAP + 2 * QB) / 16>(acc[MTI], f[0][1], b_desc);
  }
}

// One group of a 3x3 chunk: the thread's fragment of patch row J (relative
// to its warpgroup's first) at column tap DX, two 16-byte loads from the
// activated patch stage at a_st, split, then its products for each output
// row that reads it. The group before it is then done, and its fragment
// buffer free.
template <int N, int MT, int J, int DX>
__device__ __forceinline__ void rs_group(float (&acc)[MT][N / 2], uint32_t (&frag)[2][2][2][4],
                                         uint32_t a_st, uint64_t b_desc) {
  constexpr int PIX = CK * 4, BUF = (3 * J + DX) & 1;
  const float4 v0 = lds128<(J * PW + DX) * PIX>(a_st);
  const float4 v1 = lds128<(J * PW + DX + 8) * PIX>(a_st);
  split_frag(v0, v1, frag[BUF]);
  wgmma_fence();
  rs_products<N, MT, J, DX, 0>(acc, frag[BUF], b_desc);
  rs_products<N, MT, J, DX, 1>(acc, frag[BUF], b_desc);
  rs_products<N, MT, J, DX, 2>(acc, frag[BUF], b_desc);
  wgmma_commit();
  wgmma_wait<1>();
  pin(frag[BUF ^ 1]);
}

// A 3x3 chunk: groups G = 3 J + DX in order, the warpgroup's MT + 2 patch
// rows, each at its three column taps.
template <int N, int MT, int... G>
__device__ __forceinline__ void rs_chunk(std::integer_sequence<int, G...>,
                                         float (&acc)[MT][N / 2], uint32_t (&frag)[2][2][2][4],
                                         uint32_t a_st, uint64_t b_desc) {
  (rs_group<N, MT, G / 3, G % 3>(acc, frag, a_st, b_desc), ...);
}

// A chunk of the projection's raw input: tile M's pixels (the patch's centre,
// row M + 1, column tap 1), one slab at b_desc.
template <int N, int MT, int M>
__device__ __forceinline__ void rs_centre(float (&acc)[MT][N / 2], uint32_t (&frag)[2][2][2][4],
                                          uint32_t a_st, uint64_t b_desc) {
  constexpr int PIX = CK * 4, BUF = M & 1;
  constexpr int QB = N * 16, B_HALF = (CK / 4) * QB;
  split_frag(lds128<((M + 1) * PW + 1) * PIX>(a_st), lds128<((M + 1) * PW + 9) * PIX>(a_st),
             frag[BUF]);
  wgmma_fence();
  wgmma_tf32_rs<0>(acc[M], frag[BUF][1][0], b_desc);
  wgmma_tf32_rs<B_HALF / 16>(acc[M], frag[BUF][0][0], b_desc);
  wgmma_tf32_rs<0>(acc[M], frag[BUF][0][0], b_desc);
  wgmma_tf32_rs<2 * QB / 16>(acc[M], frag[BUF][1][1], b_desc);
  wgmma_tf32_rs<(B_HALF + 2 * QB) / 16>(acc[M], frag[BUF][0][1], b_desc);
  wgmma_tf32_rs<2 * QB / 16>(acc[M], frag[BUF][0][1], b_desc);
  wgmma_commit();
  wgmma_wait<1>();
  pin(frag[BUF ^ 1]);
}

template <int N, int MT, int... M>
__device__ __forceinline__ void rs_centre_chunk(std::integer_sequence<int, M...>,
                                                float (&acc)[MT][N / 2],
                                                uint32_t (&frag)[2][2][2][4], uint32_t a_st,
                                                uint64_t b_desc) {
  (rs_centre<N, MT, M>(acc, frag, a_st, b_desc), ...);
}

// conv_tc_kernel's function for N < 128, with the A operand from registers:
// each consumer thread loads its fragment of an input row and column tap (two
// 16-byte loads, one a pixel), splits it into hi and lo in registers and
// feeds it to every output row of its warpgroup that reads that row (ky = 0,
// 1, 2): one load and split serve up to three taps' products. The stagers
// copy the raw patch and, for a 3x3 chunk, apply the affine and ReLU to it in
// place; a chunk's nine weight slabs come in one bulk copy. Sums run input-row-major: for each chunk, each
// input row, each column tap, each output row, the two k8 steps, lo*Whi +
// hi*Wlo + hi*Whi. Arguments as conv_tc_kernel's; wpack's 3x3 and projection
// slabs hold each chunk's channels in the order split_frag reads them.
template <int N, int CH, int MT, bool HEAD>
__global__ void __launch_bounds__(kThreads, 1)
conv_tc_rs_kernel(const float* xa, int ca, const float* xb, int cb,
                  const float* __restrict__ aff_a, const float* __restrict__ aff_c,
                  const float* x2a, int c2a, const float* x2b, int c2b,
                  const float* __restrict__ wpack, const float* __restrict__ bias,
                  const float* __restrict__ bias2, const float* res,
                  const float* __restrict__ head_pack, const float* __restrict__ head_bias,
                  float* out, int H, int W) {
  using P = RsPlan<N, CH, MT>;
  constexpr int TR = P::TR, PH = P::PH, PIX = P::PIX, QB = P::QB, A_STAGE = P::A_STAGE;
  constexpr int SLAB = P::SLAB, B_STAGE = P::B_STAGE;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t b_smem = smem_u32(smem) + 2 * A_STAGE;
  const uint32_t full_a = b_smem + 2 * B_STAGE;  // [2] the stagers' copies have landed
  const uint32_t full_b = full_a + 16;           // [2] the bulk copy's bytes
  const uint32_t empty = full_a + 32;            // [2] one arrival per consumer warp
  const uint32_t full_h = full_a + 48;           // the head's weights have landed

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // warp-uniform as far as the compiler can tell (the role branch below)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int x0 = blockIdx.x * TWX;
  const int y0 = blockIdx.y * TR;
  const int b = blockIdx.z;
  const int n1 = (ca + cb) / CK;              // chunks of the convolved input
  const int nchunks = n1 + (c2a + c2b) / CK;  // then the chunks of the 1x1 input

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_a + 8 * s, kStagers);
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(full_h, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 8) {
    // ---- consumers: warpgroup wg multiplies image rows MT*wg .. MT*wg + MT-1 ----
    const int wg = warp >> 2;
    const int wq = warp & 3;
    float acc[MT][N / 2];
    start_sums<N, MT>(acc, res, b, H, W, x0, y0 + wg * MT, wq, lane);
    // The thread's first fragment pixel: patch row wg*MT, column 16 wq + l/4
    // (image column gx0 + 1 .. at column tap dx = 1), channels 4(l%4) ..
    const int t4 = lane & 3;
    const uint32_t a_thread =
        smem_u32(smem) + (wg * MT * PW + 16 * wq + (lane >> 2)) * PIX + 16 * t4;
    uint32_t frag[2][2][2][4];  // [buffer][hi, lo][k8 step][register]
    for (int c = 0; c < n1; ++c) {
      const int s = c & 1;
      mbar_wait_ptx(full_a + 8 * s, (c >> 1) & 1);
      mbar_wait_ptx(full_b + 8 * s, (c >> 1) & 1);
      rs_chunk<N, MT>(std::make_integer_sequence<int, 3 * (MT + 2)>{}, acc, frag,
                      a_thread + s * A_STAGE, smem_desc(b_smem + s * B_STAGE, QB, 128));
      wgmma_wait<0>();
      pin(frag[0]);
      pin(frag[1]);
      mbar_arrive_lane0(empty + 8 * s, lane);
    }
    // The projection's chunks: the raw 1x1 input at each output pixel (the
    // patch's centre), one slab a stage.
    for (int c = n1; c < nchunks; ++c) {
      const int s = c & 1;
      mbar_wait_ptx(full_a + 8 * s, (c >> 1) & 1);
      mbar_wait_ptx(full_b + 8 * s, (c >> 1) & 1);
      rs_centre_chunk<N, MT>(std::make_integer_sequence<int, MT>{}, acc, frag,
                             a_thread + s * A_STAGE, smem_desc(b_smem + s * B_STAGE, QB, 128));
      wgmma_wait<0>();
      pin(frag[0]);
      pin(frag[1]);
      mbar_arrive_lane0(empty + 8 * s, lane);
    }
    fence_acc(acc);
    finish_tiles<N, CH, MT, HEAD, true>(acc, bias, bias2, head_bias, out, smem,
                                        b_smem + (nchunks & 1) * B_STAGE, full_h, b, H, W, x0,
                                        y0 + wg * MT, wg, wq, lane);
  } else if (warp == 8) {
    // ---- producer warp 0: a chunk's slabs per stage, then the head's ----
    if (lane == 0) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wpack);
      for (int c = 0; c < nchunks; ++c) {
        const int s = c & 1;
        const uint32_t bytes = c < n1 ? B_STAGE : SLAB;
        const size_t off = c < n1 ? (size_t)c * B_STAGE
                                  : (size_t)n1 * B_STAGE + (size_t)(c - n1) * SLAB;
        mbar_wait(empty + 8 * s, ((c >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(full_b + 8 * s, bytes);
        bulk_load(b_smem + s * B_STAGE, src + off, bytes, full_b + 8 * s);
      }
      if (HEAD) {
        // into the stage the chunk after the last would take, once the
        // consumers have released it
        const int s = nchunks & 1;
        mbar_wait(empty + 8 * s, ((nchunks >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(full_h, P::HEAD_W_BYTES);
        bulk_load(b_smem + s * B_STAGE, head_pack, P::HEAD_W_BYTES, full_h);
      }
    }
  } else {
    // ---- producer warps 1-3: copy the raw patch, zeros outside the image ----
    const int t = tid - 288;
    const int q = t & 3;    // channel quad of the chunk
    const int pc = t >> 2;  // pixel lane along the patch row
    for (int c = 0; c < nchunks; ++c) {
      const int s = c & 1;
      mbar_wait(empty + 8 * s, ((c >> 1) & 1) ^ 1);
      const bool second = c >= n1;  // a chunk of the raw 1x1 input
      const int gc = (second ? c - n1 : c) * CK + q * 4;
      const float* pa = second ? x2a : xa;
      const float* pb = second ? x2b : xb;
      const int na = second ? c2a : ca;
      const int nb = second ? c2b : cb;
      const float* src;
      int cs, coff;
      if (gc < na) {
        src = pa; cs = na; coff = gc;
      } else {
        src = pb; cs = nb; coff = gc - na;
      }
      unsigned char* quad = smem + s * A_STAGE + q * 16;
      for (int py = 0; py < PH; ++py) {
        const int gy = y0 + py - 1;  // the halo
#pragma unroll
        for (int j = 0; j < NPX; ++j) {
          const int px = pc + kPixLanes * j;
          const int gx = x0 + px - 1;  // the halo
          const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
          if (px < PW) {
            cp_async_16(smem_u32(quad + (py * PW + px) * PIX),
                        ok ? src + (((size_t)b * H + gy) * W + gx) * cs + coff : src,
                        ok ? 16 : 0);
          }
        }
      }
      if (second) {
        cp_async_arrive_noinc(full_a + 8 * s);
        continue;
      }
      cp_async_wait_all();
      const float4 fa = *reinterpret_cast<const float4*>(aff_a + gc);
      const float4 fc = *reinterpret_cast<const float4*>(aff_c + gc);
      for (int py = 0; py < PH; ++py) {
        const int gy = y0 + py - 1;
#pragma unroll
        for (int j = 0; j < NPX; ++j) {
          const int px = pc + kPixLanes * j;
          const int gx = x0 + px - 1;
          if (px >= PW) continue;
          float4* p = reinterpret_cast<float4*>(quad + (py * PW + px) * PIX);
          *p = act4(*p, fa, fc, gy >= 0 && gy < H && gx >= 0 && gx < W);
        }
      }
      mbar_arrive(full_a + 8 * s);
    }
  }
}

// The small widths take A from registers (conv_tc_rs_kernel); their packs
// hold each chunk's channels transposed (hr_tail.py: _tc_slabs).
template <int N>
constexpr bool kAFromRegisters = N < 128;

template <int N, int CH, int MT, bool HEAD>
cudaError_t launch(const float* xa, int ca, const float* xb, int cb, const float* a,
                   const float* c, const float* x2a, int c2a, const float* x2b, int c2b,
                   const float* wpack, const float* bias, const float* bias2,
                   const float* res, const float* head_pack, const float* head_bias,
                   float* out, int B, int H, int W, cudaStream_t stream) {
  constexpr bool RS = kAFromRegisters<N>;
  auto kern = [] {
    if constexpr (RS) return conv_tc_rs_kernel<N, CH, MT, HEAD>;
    else return conv_tc_kernel<N, CH, MT, HEAD>;
  }();
  constexpr int smem = [] {
    if constexpr (RS) return RsPlan<N, CH, MT>::BYTES;
    else return Smem<Widths<N, CH, MT>, HEAD>::BYTES;
  }();
  constexpr int TR = 2 * MT;  // image rows per block
  // The opt-in to more than 48 KB of dynamic shared memory holds for the life
  // of the process: set it at this kernel's first launch on each device.
  constexpr int kMaxDevices = 64;
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  dim3 grid((W + TWX - 1) / TWX, (H + TR - 1) / TR, B);
  kern<<<grid, kThreads, smem, stream>>>(xa, ca, xb, cb, a, c, x2a, c2a, x2b, c2b, wpack, bias,
                                         bias2, res, head_pack, head_bias, out, H, W);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: one implicit-GEMM 3x3 convolution on wgmma m64nNk16, its
// operands brought in by TMA, already activated and rounded to bf16.
// ---------------------------------------------------------------------------

namespace bf {

// The plan of one instantiation (N, CH as in tc::Widths). A unit is TR = 2 MT
// image rows x 64 columns: MT 64-pixel GEMM tiles (image rows) per MMA
// warpgroup, MT * N/2 accumulators a thread (64 at the instantiated (128,
// 16, 1)). A 128x128 tile of the flagship is 128 units, so the scene's call
// of one tile fills the card.
template <int N_, int CH_, int MT_>
struct Plan {
  static constexpr int N = N_;
  static constexpr int CH = CH_;
  static constexpr int MT = MT_;
  static constexpr int HN = (CH + 7) / 8 * 8;
  static constexpr int NACC = N / 2;
  static constexpr int QB = N * 16;
  static constexpr int TR = 2 * MT;               // image rows of a unit
  static constexpr int PH = TR + 2;               // rows of its patch (halo 1)
  static constexpr int BOX_BYTES = PH * PW * 16;  // one channel octet of the patch, [row][col][8]
  // its place in a stage, padded to TMA's 128-byte alignment of a destination
  static constexpr int BOX = (BOX_BYTES + 127) / 128 * 128;
  static constexpr int A_CHUNK = 2 * BOX;         // a chunk's two octets
  static constexpr int W_SLAB = 2 * QB;           // one (chunk, tap) slab [octet][N][8]
  static constexpr int W_CHUNK = TAPS * W_SLAB;   // a chunk's nine slabs, contiguous in the pack
  static constexpr int STAGE = A_CHUNK + W_CHUNK; // the patch, then the nine slabs
  static constexpr int STAGE_TX = 2 * BOX_BYTES + W_CHUNK;  // the bytes a chunk's copies bring
  static constexpr int XPLANE = TR * TWX * 16;    // one octet of the unit's own pixels
  static constexpr int XCHUNK = 2 * XPLANE + W_SLAB;  // a projection chunk: x and its slab
  static constexpr int KP = STAGE / XCHUNK;       // projection chunks a stage
  // The epilogue's per-channel vectors, staged once: bias, bias2, next_a, next_c.
  static constexpr int VEC_BYTES = 4 * N * 4;
  static constexpr int HEAD_W_BYTES = 2 * N * HN * 4;
  // ---- the body kernel: ring stages; the handed-over f32 tiles, a pixel's
  // row padded ----
  static constexpr int NS_BODY = 3;
  static constexpr int T_ROW = (N + 8) * 4;
  static constexpr int T_TILE = TWX * T_ROW;      // one image row's tile
  static constexpr int BODY_SMEM =
      128 + NS_BODY * STAGE + TR * T_TILE + VEC_BYTES + (2 * NS_BODY + 2 * TR) * 8;
  // ---- the head kernel: a unit a block ----
  static constexpr int NS_HEAD = 4;
  // The head's y tile of one warpgroup, half of its channels at a time:
  // [channel quad][64 pixels][4] f32, hi then lo.
  static constexpr int YH_HALF = (N / 8) * Y_PLANE;
  static constexpr int HEAD_SMEM =
      128 + NS_HEAD * STAGE + HEAD_W_BYTES + VEC_BYTES + (2 * NS_HEAD + 1) * 8;
  static_assert(KP >= 1, "a stage holds a projection chunk");
  static_assert(STAGE % 128 == 0 && XPLANE % 128 == 0, "TMA destinations are 128-byte aligned");
  static_assert(BODY_SMEM <= kSmemMax && HEAD_SMEM <= kSmemMax, "a block's shared memory");
  static_assert(NS_HEAD * STAGE >= 4 * YH_HALF, "the head's y tiles must fit over the ring");
};

// Warpgroups 0 and 1 multiply, warpgroup 2 runs the epilogue, warp 12 loads.
constexpr int kBodyThreads = 416;
constexpr int kHeadThreads = 288;        // MMA warpgroups 0 and 1, producer warp 8

// TMA: the box at (channel c, column x, row y, image b) of a 4-D tensor map;
// elements outside the tensor land as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c, int x,
                                            int y, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b), "r"(bar)
      : "memory");
}

// A unit's place: column block, row block, image.
struct Unit {
  int x0, y0, b;
};
__device__ __forceinline__ Unit unit_at(int u, int units_x, int units_y, int tr) {
  Unit r;
  r.x0 = (u % units_x) * TWX;
  r.y0 = ((u / units_x) % units_y) * tr;
  r.b = u / (units_x * units_y);
  return r;
}

// The per-channel vectors into shared memory (0 for one that is not given),
// by nthreads threads from thread t.
template <int N>
__device__ __forceinline__ void load_vecs(float* vec, const float* bias, const float* bias2,
                                          const float* next_a, const float* next_c, int t,
                                          int nthreads) {
  for (int i = t; i < 2 * N; i += nthreads) {
    const int v = i / (N / 2);
    const int c = (i % (N / 2)) * 2;
    const float* src = v == 0 ? bias : v == 1 ? bias2 : v == 2 ? next_a : next_c;
    *reinterpret_cast<float2*>(vec + v * N + c) =
        src != nullptr ? *reinterpret_cast<const float2*>(src + c) : make_float2(0.f, 0.f);
  }
}

// The producer's copies for one unit, from ring stage g on: per chunk of A
// the patch (two octets, halo 1) and its nine weight slabs, then up to KP
// projection chunks a stage (X at the unit's own pixels, one slab each).
// Returns the next stage.
template <class P, int NS>
__device__ __forceinline__ int produce_unit(int g, uint32_t ring, uint32_t full, uint32_t empty,
                                            const CUtensorMap* patch_map,
                                            const CUtensorMap* x_map, int n1, int n2,
                                            const unsigned char* wsrc, Unit un) {
  const int nstages = n1 + (n2 + P::KP - 1) / P::KP;
  for (int s = 0; s < nstages; ++s, ++g) {
    const int st = g % NS;
    mbar_wait_ptx(empty + 8 * st, ((g / NS) & 1) ^ 1);
    const uint32_t stage = ring + st * P::STAGE;
    const uint32_t bar = full + 8 * st;
    if (s < n1) {
      mbar_arrive_expect_tx(bar, P::STAGE_TX);
      tma_load_4d(stage, patch_map, s * CK, un.x0 - 1, un.y0 - 1, un.b, bar);
      tma_load_4d(stage + P::BOX, patch_map, s * CK + 8, un.x0 - 1, un.y0 - 1, un.b, bar);
      bulk_load(stage + P::A_CHUNK, wsrc + (size_t)s * P::W_CHUNK, P::W_CHUNK, bar);
    } else {
      const int j0 = (s - n1) * P::KP;
      const int k = min(P::KP, n2 - j0);
      mbar_arrive_expect_tx(bar, k * P::XCHUNK);
      for (int j = 0; j < k; ++j) {
        const int c = j0 + j;
        const uint32_t a0 = stage + j * 2 * P::XPLANE;
        tma_load_4d(a0, x_map, c * CK, un.x0, un.y0, un.b, bar);
        tma_load_4d(a0 + P::XPLANE, x_map, c * CK + 8, un.x0, un.y0, un.b, bar);
        bulk_load(stage + P::KP * 2 * P::XPLANE + j * P::W_SLAB,
                  wsrc + (size_t)n1 * P::W_CHUNK + (size_t)c * P::W_SLAB, P::W_SLAB, bar);
      }
    }
  }
  return g;
}

// One unit's sums for the warpgroup wg (image rows MT*wg .. MT*wg + MT-1),
// from ring stage g on, onto acc: the 3x3 chunks (9 taps x MT tiles, one k16
// step each, between two barrier rounds; the two octet planes are the two
// core matrices along K and every tap and tile is a constant offset from two
// descriptors: the address field counts 16 bytes and shared addresses stay
// under 256 KB, so the sum never carries), then the projection's chunks, KP a
// stage. The order of the sums is that of the route before this one. Every
// stage is released when read. Returns the next stage. Without from_acc the
// first product starts the sums (acc is not read), where 0 would: the same
// sums.
template <class P, int NS>
__device__ __forceinline__ int mma_unit(float (&acc)[P::MT][P::NACC], bool from_acc, int g,
                                        uint32_t ring, uint32_t full, uint32_t empty, int n1,
                                        int n2, int wg, int lane) {
  for (int s = 0; s < n1; ++s, ++g) {
    const int st = g % NS;
    mbar_wait_ptx(full + 8 * st, (g / NS) & 1);
    const uint32_t stage = ring + st * P::STAGE;
    const uint64_t da = smem_desc(stage + wg * P::MT * PW * 16, P::BOX, 128);
    const uint64_t db = smem_desc(stage + P::A_CHUNK, P::QB, 128);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - 3 * ky;
#pragma unroll
      for (int mt = 0; mt < P::MT; ++mt)
        wgmma_bf16(acc[mt], da + (mt + ky) * PW + kx, db + tap * (P::W_SLAB / 16),
                   tap > 0 || s > 0 || from_acc);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    // The stage before this one has been read.
    if (s > 0) mbar_arrive_lane0(empty + 8 * ((g - 1) % NS), lane);
  }
  for (int j = 0; j < n2; ++j) {
    const int jj = j % P::KP;
    if (jj == 0) {
      mbar_wait_ptx(full + 8 * (g % NS), (g / NS) & 1);
      ++g;
    }
    const uint32_t stage = ring + ((g - 1) % NS) * P::STAGE;
    const uint64_t da =
        smem_desc(stage + jj * 2 * P::XPLANE + wg * P::MT * TWX * 16, P::XPLANE, 128);
    const uint64_t db = smem_desc(stage + P::KP * 2 * P::XPLANE + jj * P::W_SLAB, P::QB, 128);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < P::MT; ++mt) wgmma_bf16(acc[mt], da + mt * TWX, db);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (jj == 0 && (n1 > 0 || j > 0)) mbar_arrive_lane0(empty + 8 * ((g - 2) % NS), lane);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  mbar_arrive_lane0(empty + 8 * ((g - 1) % NS), lane);
  return g;
}

// v[b, y, x, :N] = sum over chunks c < n1, taps (ky, kx) of
//   A[b, y+ky-1, x+kx-1, 16c .. 16c+15] . w[c, tap]
// + sum over chunks c < n2 of X[b, y, x, 16c .. 16c+15] . w2[c]  (the projection)
// + bias (+ bias2).
// A (patch_map, bf16 NHWC) is the convolution's operand as the launch before
// stored it: activated and rounded. TMA fills the pixels outside the image
// with zeros, which is the SAME padding after the activation. X (x_map) is
// bf16(x), read at the unit's own pixels. wpack: per chunk of A its nine
// slabs [2][N][8], then one slab per chunk of X.
// Outputs: out = v (f32) when given; out_act = bf16(relu(next_a * v +
// next_c)), the next convolution's operand.
// Persistent: a block walks units with a stride of the grid; the loads run
// ahead across units, and the MMA warpgroups hand each finished tile to the
// epilogue warpgroup through shared memory and go on to the next unit, so
// neither a unit's fill nor its epilogue leaves the tensor cores idle.
template <int N, int CH, int MT>
__global__ void __launch_bounds__(kBodyThreads, 1)
conv_bf16_kernel(const __grid_constant__ CUtensorMap patch_map,
                 const __grid_constant__ CUtensorMap x_map, int n1, int n2,
                 const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ bias,
                 const float* __restrict__ bias2, float* __restrict__ out,
                 __nv_bfloat16* __restrict__ out_act, const float* __restrict__ next_a,
                 const float* __restrict__ next_c, int H, int W, int units_x, int units_y,
                 int units) {
  using P = Plan<N, CH, MT>;
  constexpr int TR = P::TR, NS = P::NS_BODY, T_ROW = P::T_ROW, T_TILE = P::T_TILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 127u) & ~127u;
  unsigned char* ring_ptr = smem_raw + (ring - raw);
  unsigned char* tiles = ring_ptr + NS * P::STAGE;  // [TR] handed-over f32 tiles
  float* vec = reinterpret_cast<float*>(tiles + TR * T_TILE);
  const uint32_t bars = smem_u32(vec) + P::VEC_BYTES;
  const uint32_t full = bars;                // [NS] expect_tx + the copies' bytes
  const uint32_t empty = bars + 8 * NS;      // [NS] the MMA warps' arrivals
  const uint32_t tfull = bars + 16 * NS;     // [TR] a tile was handed over
  const uint32_t tempty = tfull + 8 * TR;    // [TR] the epilogue has read it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // warp-uniform as far as the compiler can tell (the role branch below)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    for (int r = 0; r < TR; ++r) {
      mbar_init(tfull + 8 * r, 128);
      mbar_init(tempty + 8 * r, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (warp >= 8 && warp < 12) load_vecs<N>(vec, bias, bias2, next_a, next_c, tid - 256, 128);
  __syncthreads();

  if (warp < 8) {
    // ---- MMA warpgroups: warpgroup wg multiplies rows MT*wg .. of each unit ----
    const int wg = warp >> 2;
    const int wq = warp & 3;
    int g = 0;
    float acc[MT][P::NACC];
    for (int u = blockIdx.x, k = 0; u < units; u += gridDim.x, ++k) {
      g = mma_unit<P, NS>(acc, false, g, ring, full, empty, n1, n2, wg, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wg * MT + mt;
        unsigned char* tile = tiles + r * T_TILE;
        // Hand the tile over once the epilogue has read the previous one.
        mbar_wait_ptx(tempty + 8 * r, (k & 1) ^ 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int px = wq * 16 + (lane >> 2) + 8 * half;
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int col = 8 * j + 2 * (lane & 3);
            *reinterpret_cast<float2*>(tile + px * T_ROW + col * 4) =
                make_float2(acc[mt][4 * j + 2 * half], acc[mt][4 * j + 2 * half + 1]);
          }
        }
        mbar_arrive(tfull + 8 * r);
      }
    }
  } else if (warp < 12) {
    // ---- epilogue warpgroup: 8 channels of a pixel a thread and piece ----
    const int t = tid - 256;
    const float* s_bias = vec;
    const float* s_bias2 = vec + N;
    const float* s_next_a = vec + 2 * N;
    const float* s_next_c = vec + 3 * N;
    for (int u = blockIdx.x, k = 0; u < units; u += gridDim.x, ++k) {
      const Unit un = unit_at(u, units_x, units_y, TR);
#pragma unroll 1
      for (int r = 0; r < TR; ++r) {
        mbar_wait_ptx(tfull + 8 * r, k & 1);
        const unsigned char* tile = tiles + r * T_TILE;
        const int gy = un.y0 + r;
#pragma unroll 2
        for (int p = 0; p < TWX * (N / 8) / 128; ++p) {
          const int piece = p * 128 + t;
          const int px = piece / (N / 8);
          const int c0 = (piece % (N / 8)) * 8;
          const int gx = un.x0 + px;
          float v[8];
          *reinterpret_cast<float4*>(v) =
              *reinterpret_cast<const float4*>(tile + px * T_ROW + c0 * 4);
          *reinterpret_cast<float4*>(v + 4) =
              *reinterpret_cast<const float4*>(tile + px * T_ROW + c0 * 4 + 16);
          uint32_t h[4];
#pragma unroll
          for (int i = 0; i < 8; i += 2) {
            const int col = c0 + i;
            v[i] = v[i] + s_bias[col];
            v[i + 1] = v[i + 1] + s_bias[col + 1];
            if (bias2 != nullptr) {
              v[i] = v[i] + s_bias2[col];
              v[i + 1] = v[i + 1] + s_bias2[col + 1];
            }
            // the next convolution's operand: its affine and ReLU, then bf16
            // (nearest even), the lower channel at the lower address
            const __nv_bfloat162 b2 =
                __floats2bfloat162_rn(act(v[i], s_next_a[col], s_next_c[col]),
                                      act(v[i + 1], s_next_a[col + 1], s_next_c[col + 1]));
            h[i / 2] = *reinterpret_cast<const uint32_t*>(&b2);
          }
          if (gy < H && gx < W) {
            const size_t pix = ((size_t)un.b * H + gy) * W + gx;
            if (out != nullptr) {
              *reinterpret_cast<float4*>(out + pix * N + c0) = *reinterpret_cast<const float4*>(v);
              *reinterpret_cast<float4*>(out + pix * N + c0 + 4) =
                  *reinterpret_cast<const float4*>(v + 4);
            }
            *reinterpret_cast<uint4*>(out_act + pix * N + c0) =
                make_uint4(h[0], h[1], h[2], h[3]);
          }
        }
        mbar_arrive(tempty + 8 * r);
      }
    }
  } else if (lane == 0) {
    // ---- producer warp: one thread issues every copy of the ring ----
    const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(wpack);
    int g = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x)
      g = produce_unit<P, NS>(g, ring, full, empty, &patch_map, &x_map, n1, n2, wsrc,
                              unit_at(u, units_x, units_y, TR));
  }
}

// The last launch: out[b, y, x, :CH] = (res + the 3x3 sums of patch_map's
// operand + bias) @ head_w + head_b. The head is 3xTF32 (the same products in
// the same order as conv_tc_kernel's head): each MMA warpgroup writes each of
// its y tiles, split into TF32 hi and lo, over its part of the idle ring, half
// of its channels at a time, and runs the head's k8 steps on it. A unit a
// block; the residual starts the sums.
template <int N, int CH, int MT>
__global__ void __launch_bounds__(kHeadThreads, 1)
conv_bf16_head_kernel(const __grid_constant__ CUtensorMap patch_map, int n1,
                      const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ bias,
                      const float* __restrict__ res, const float* __restrict__ head_pack,
                      const float* __restrict__ head_bias, float* __restrict__ out, int H,
                      int W) {
  using P = Plan<N, CH, MT>;
  constexpr int NS = P::NS_HEAD, HN = P::HN, YH_HALF = P::YH_HALF;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 127u) & ~127u;
  unsigned char* ring_ptr = smem_raw + (ring - raw);
  const uint32_t h_smem = ring + NS * P::STAGE;  // the head's weights, hi then lo per slab
  float* vec = reinterpret_cast<float*>(ring_ptr + NS * P::STAGE + P::HEAD_W_BYTES);
  const uint32_t bars = smem_u32(vec) + P::VEC_BYTES;
  const uint32_t full = bars;                // [NS] expect_tx + the copies' bytes
  const uint32_t empty = bars + 8 * NS;      // [NS] the MMA warps' arrivals
  const uint32_t full_h = bars + 16 * NS;    // the head's weights have landed

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const Unit un = {(int)blockIdx.x * TWX, (int)blockIdx.y * P::TR, (int)blockIdx.z};

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(full_h, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (warp < 8) load_vecs<N>(vec, bias, nullptr, nullptr, nullptr, tid, 256);
  __syncthreads();

  if (warp < 8) {
    const int wg = warp >> 2;
    const int wq = warp & 3;
    float acc[MT][P::NACC];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int gy = un.y0 + wg * MT + mt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gx = un.x0 + wq * 16 + (lane >> 2) + 8 * half;
        const bool live = gy < H && gx < W;
        const size_t base = (((size_t)un.b * H + gy) * W + gx) * N + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          // The residual starts the sums; its loads overlap the pipeline's fill.
          float2 r = make_float2(0.f, 0.f);
          if (live) r = *reinterpret_cast<const float2*>(res + base + 8 * j);
          acc[mt][4 * j + 2 * half] = r.x;
          acc[mt][4 * j + 2 * half + 1] = r.y;
        }
      }
    }
    mma_unit<P, NS>(acc, true, 0, ring, full, empty, n1, 0, wg, lane);

    // Both warpgroups have finished reading the ring.
    named_barrier(1, 256);
    mbar_wait_ptx(full_h, 0);
    unsigned char* y_buf = ring_ptr + wg * 2 * YH_HALF;
    const uint32_t y_smem = ring + wg * 2 * YH_HALF;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float hacc[HN / 2];
#pragma unroll
      for (int i = 0; i < HN / 2; ++i) hacc[i] = 0.f;
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int px = wq * 16 + (lane >> 2) + 8 * half;
#pragma unroll
          for (int jh = 0; jh < N / 16; ++jh) {
            const int j = kh * (N / 16) + jh;  // this half's column groups
            const int col = 8 * j + 2 * (lane & 3);
            const float2 bv = *reinterpret_cast<const float2*>(vec + col);
            float2 v;
            v.x = acc[mt][4 * j + 2 * half] + bv.x;
            v.y = acc[mt][4 * j + 2 * half + 1] + bv.y;
            float2 hi, lo;
            hi.x = tf32_rna(v.x); lo.x = tf32_rna(v.x - hi.x);
            hi.y = tf32_rna(v.y); lo.y = tf32_rna(v.y - hi.y);
            const int lc = col - kh * N / 2;
            unsigned char* dst = y_buf + (lc >> 2) * Y_PLANE + px * 16 + (lc & 3) * 4;
            *reinterpret_cast<float2*>(dst) = hi;
            *reinterpret_cast<float2*>(dst + YH_HALF) = lo;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_barrier(2 + wg, 128);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < N / 16; ++k) {
          const int ks = kh * N / 16 + k;  // the k8 step over all N channels
          constexpr int HQ = HN * 16;      // bytes of one channel quad of head weights
          const uint32_t hw = h_smem + (ks >> 1) * (2 * CK * HN * 4) + (ks & 1) * 2 * HQ;
          const uint64_t dbh = smem_desc(hw, HQ, 128);
          const uint64_t dbl = smem_desc(hw + CK * HN * 4, HQ, 128);
          const uint64_t dah = smem_desc(y_smem + k * 2 * Y_PLANE, Y_PLANE, 128);
          const uint64_t dal = smem_desc(y_smem + YH_HALF + k * 2 * Y_PLANE, Y_PLANE, 128);
          wgmma_tf32(hacc, dal, dbh);
          wgmma_tf32(hacc, dah, dbl);
          wgmma_tf32(hacc, dah, dbh);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < HN / 2; ++i) asm volatile("" : "+f"(hacc[i])::"memory");
        // This half's tile is read; the next one may overwrite it.
        named_barrier(2 + wg, 128);
      }
      const int gy = un.y0 + wg * MT + mt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gx = un.x0 + wq * 16 + (lane >> 2) + 8 * half;
        if (gy >= H || gx >= W) continue;
        store_head<CH>(out + (((size_t)un.b * H + gy) * W + gx) * CH, hacc, half, lane, head_bias);
      }
    }
  } else if (lane == 0) {
    // ---- producer warp ----
    mbar_arrive_expect_tx(full_h, P::HEAD_W_BYTES);
    bulk_load(h_smem, head_pack, P::HEAD_W_BYTES, full_h);
    produce_unit<P, NS>(0, ring, full, empty, &patch_map, &patch_map, n1, 0,
                        reinterpret_cast<const unsigned char*>(wpack), un);
  }
}

// x = concat(sr, dem) -> x_act = bf16(relu(a * x + c)) (f1.conv1's operand)
// and x_raw = bf16(x) (the projection's), NHWC bf16; one thread per 4 channels.
__global__ void __launch_bounds__(256)
bf16_prepass_kernel(const float* __restrict__ sr, int ca, const float* __restrict__ dem, int cb,
                    const float* __restrict__ aff_a, const float* __restrict__ aff_c,
                    __nv_bfloat16* __restrict__ x_act, __nv_bfloat16* __restrict__ x_raw,
                    long long nquads) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nquads) return;
  const int cin = ca + cb;
  const long long pix = i / (cin / 4);
  const int gc = (int)(i - pix * (cin / 4)) * 4;
  const float4 v = gc < ca ? __ldg(reinterpret_cast<const float4*>(sr + pix * ca + gc))
                           : __ldg(reinterpret_cast<const float4*>(dem + pix * cb + (gc - ca)));
  const float4 fa = *reinterpret_cast<const float4*>(aff_a + gc);
  const float4 fc = *reinterpret_cast<const float4*>(aff_c + gc);
  __nv_bfloat162 h[2];
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(x_raw + pix * cin + gc) = *reinterpret_cast<const uint2*>(h);
  h[0] = __floats2bfloat162_rn(act(v.x, fa.x, fc.x), act(v.y, fa.y, fc.y));
  h[1] = __floats2bfloat162_rn(act(v.z, fa.z, fc.z), act(v.w, fa.w, fc.w));
  *reinterpret_cast<uint2*>(x_act + pix * cin + gc) = *reinterpret_cast<const uint2*>(h);
}

// The opt-in to more than 48 KB of dynamic shared memory holds for the life
// of the process: set it at a kernel's first launch on each device.
template <typename Kernel>
cudaError_t opt_in(Kernel kern, int smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int N, int CH, int MT>
cudaError_t launch_body(const CUtensorMap& patch_map, const CUtensorMap& x_map, int n1, int n2,
                        const void* wpack, const float* bias, const float* bias2, float* out,
                        void* out_act, const float* next_a, const float* next_c, int B, int H,
                        int W, int sms, cudaStream_t stream) {
  using P = Plan<N, CH, MT>;
  static bool done[64] = {};
  cudaError_t err = opt_in(conv_bf16_kernel<N, CH, MT>, P::BODY_SMEM, done);
  if (err != cudaSuccess) return err;
  const int units_x = (W + TWX - 1) / TWX;
  const int units_y = (H + P::TR - 1) / P::TR;
  const int units = units_x * units_y * B;
  conv_bf16_kernel<N, CH, MT><<<units < sms ? units : sms, kBodyThreads, P::BODY_SMEM, stream>>>(
      patch_map, x_map, n1, n2, reinterpret_cast<const __nv_bfloat16*>(wpack), bias, bias2, out,
      reinterpret_cast<__nv_bfloat16*>(out_act), next_a, next_c, H, W, units_x, units_y, units);
  return cudaGetLastError();
}

template <int N, int CH, int MT>
cudaError_t launch_head(const CUtensorMap& patch_map, int n1, const void* wpack,
                        const float* bias, const float* res, const float* head_pack,
                        const float* head_bias, float* out, int B, int H, int W,
                        cudaStream_t stream) {
  using P = Plan<N, CH, MT>;
  static bool done[64] = {};
  cudaError_t err = opt_in(conv_bf16_head_kernel<N, CH, MT>, P::HEAD_SMEM, done);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TWX - 1) / TWX, (H + P::TR - 1) / P::TR, B);
  conv_bf16_head_kernel<N, CH, MT><<<grid, kHeadThreads, P::HEAD_SMEM, stream>>>(
      patch_map, n1, reinterpret_cast<const __nv_bfloat16*>(wpack), bias, res, head_pack,
      head_bias, out, H, W);
  return cudaGetLastError();
}

}  // namespace bf

// ---------------------------------------------------------------------------
// bf16 band route: the whole bf16 chain of one column strip and row band in
// one launch, every intermediate on chip (hr_s2d 2 and 1).
// ---------------------------------------------------------------------------

namespace band {

constexpr int kThreads = 288;          // compute warpgroups 0 and 1, producer warp 8
constexpr int TP = 64;                 // pixels of a tile row: one wgmma's 64 rows
constexpr int kHalo = 4;               // four 3x3 convolutions: 4 pixels each side
constexpr int TWO = TP - 2 * kHalo;    // output columns of a strip
constexpr int RS = 4;                  // rows of a ring: 2 new a step, 2 the 3x3 carries
constexpr int ROWB = (TP + 2) * 16;    // one octet of a ring row: 66 pixels (a pad each side)
constexpr int RPLANE = RS * ROWB + 16; // one octet's plane; 16 bytes off the 128-byte grid
constexpr int XROWB = TP * 16;         // one octet of a raw x row: the tile's own pixels
constexpr int RAW_PLANE = 2 * XROWB + 16;
constexpr int HQ_PLANE = TP * 16;      // one channel quad of a 64-pixel f32 y tile (the head)

// The plan of one instantiation: N = Cm, CH = Ch, CIN = Ca + Cb. Every ring
// holds RS rows of TP + 2 pixels of one operand in bf16, as [octet][row]
// [pixel][8]: the no-swizzle K-major core matrices (LBO = RPLANE, SBO = 128),
// so a tap is a constant offset, as in the other routes.
template <int N_, int CH_, int CIN_>
struct Plan {
  static constexpr int N = N_, CH = CH_, CIN = CIN_;
  static constexpr int HN = (CH + 7) / 8 * 8;
  static constexpr int NACC = N / 2;
  static constexpr int QB = N * 16;
  static constexpr int W_SLAB = 2 * QB;            // one (chunk, tap) slab [octet][N][8]
  static constexpr int W_CHUNK = TAPS * W_SLAB;    // a chunk's nine slabs
  static constexpr int C1 = CIN / CK;              // f1.conv1's chunks, and the projection's
  static constexpr int CM = N / CK;                // every other convolution's
  static constexpr int W1 = C1 * W_CHUNK;                // f1.conv1
  static constexpr int W2 = CM * W_CHUNK + C1 * W_SLAB;  // f1.conv2, then the projection
  static constexpr int W3 = CM * W_CHUNK;                // f2.conv1, and f2.conv2
  // Cm 32: all five matrices (94 KB) stay in shared memory for the block's
  // life; Cm 64 (336 KB): they stream through NS stages of one chunk each.
  static constexpr bool RESIDENT = W1 + W2 + 2 * W3 <= 100 * 1024;
  static constexpr int NS = 2;
  static constexpr int STAGE = W_CHUNK;
  static constexpr int W_BYTES = RESIDENT ? W1 + W2 + 2 * W3 : NS * STAGE;
  static constexpr int HEAD_W_BYTES = 2 * N * HN * 4;
  static constexpr int X_BYTES = CIN / 8 * RPLANE;     // act(x), f1.conv1's operand
  static constexpr int A_BYTES = N / 8 * RPLANE;       // y, act(y1), z: one each
  static constexpr int RAW_BYTES = CIN / 8 * RAW_PLANE;  // bf16(x) of two rows
  // per-channel vectors: f1.bn1 (a, c), then 11 of Cm (VEC_* below)
  static constexpr int NVEC = 2 * CIN + 11 * N;
  static constexpr int NPREF = 2 * TP * (CIN / 4) / 256;  // float4 of x a thread, a step
  static constexpr int OFF_Y = X_BYTES;
  static constexpr int OFF_Y1 = OFF_Y + A_BYTES;
  static constexpr int OFF_Z = OFF_Y1 + A_BYTES;
  static constexpr int OFF_RAW = OFF_Z + A_BYTES;
  static constexpr int OFF_W = (OFF_RAW + RAW_BYTES + 127) / 128 * 128;
  static constexpr int OFF_H = OFF_W + W_BYTES;
  static constexpr int OFF_VEC = OFF_H + HEAD_W_BYTES;
  static constexpr int OFF_BAR = OFF_VEC + NVEC * 4;
  static constexpr int SMEM = 128 + OFF_BAR + (2 * NS + 2) * 8;
  static_assert(CIN % CK == 0 && N % CK == 0, "16-channel chunks");
  static_assert(STAGE >= C1 * W_SLAB, "a stage holds the projection's slabs");
  static_assert(NPREF * 256 == 2 * TP * (CIN / 4), "x's float4 split evenly");
  static_assert(CIN / 8 >= 8, "the head's y tiles take eight planes of the x ring");
  static_assert(2 * HQ_PLANE <= 2 * ROWB, "two quads fit in two rows of a plane");
  static_assert(OFF_BAR % 8 == 0 && SMEM <= kSmemMax, "a block's shared memory");
};

// The per-channel vectors after f1.bn1's two, in shared memory.
enum { VEC_B1, VEC_A2, VEC_C2, VEC_B2, VEC_PB, VEC_F2A1, VEC_F2C1, VEC_F2B1, VEC_F2A2, VEC_F2C2,
       VEC_F2B2, N_VEC };

struct Args {
  const float* sr;
  const float* dem;
  int ca, cb;
  const float* vec[2 + N_VEC];  // f1.bn1's a and c, then VEC_* order
  const void* w[4];             // the bf16 slabs: f1.conv1, f1.conv2 + proj, f2.conv1, f2.conv2
  const float* head_w;          // hi/lo TF32 slabs, padded to HN columns
  const float* head_b;
  float* out;
  int H, W, rows, strips, bands;
};

template <int NACC>
__device__ __forceinline__ void fence_acc1(float (&acc)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// The compute warpgroups' barrier after generic writes that wgmma reads.
__device__ __forceinline__ void sync_compute() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(1, 256);
}

// Where the weight slabs come from: the resident copy, or the ring (stage
// g % NS, released by each compute warp's lane 0 once read).
struct Feed {
  uint32_t w, full, empty;
  int g;
};

template <class P>
__device__ __forceinline__ uint32_t take(const Feed& f, int resident_off) {
  if (P::RESIDENT) {
    mbar_wait_ptx(f.full, 0);
    return f.w + resident_off;
  }
  const int st = f.g % P::NS;
  mbar_wait_ptx(f.full + 8 * st, (f.g / P::NS) & 1);
  return f.w + st * P::STAGE;
}

// Release the stage taken before the current one.
template <class P>
__device__ __forceinline__ void give(const Feed& f, int lane) {
  if (!P::RESIDENT) mbar_arrive_lane0(f.empty + 8 * ((f.g - 1) % P::NS), lane);
}

// One convolution's sums for the tile row y (a band row) onto acc: nch
// 16-channel chunks of in_ring, 9 taps each (ring rows y-1, y, y+1; a column
// tap is one pixel), then with PROJ the C1 projection chunks of the raw x row
// at raw_row. The order of the sums is the bf16 route's (residual first,
// chunk outer, tap inner, the projection after): the same bits. woff: the
// convolution's weights in the resident copy.
template <class P, bool PROJ>
__device__ __forceinline__ void conv_rows(float (&acc)[P::NACC], bool from_acc, uint32_t in_ring,
                                          int y, int nch, int woff, uint32_t raw_row, Feed& f,
                                          int lane) {
  const uint32_t r0 = ((y - 1) & (RS - 1)) * ROWB;
  const uint32_t r1 = (y & (RS - 1)) * ROWB;
  const uint32_t r2 = ((y + 1) & (RS - 1)) * ROWB;
  const uint64_t da = smem_desc(in_ring, RPLANE, 128);
  for (int c = 0; c < nch; ++c) {
    const uint64_t db = smem_desc(take<P>(f, woff + c * P::W_CHUNK), P::QB, 128);
    const uint64_t dc = da + ((uint32_t)(2 * c * RPLANE) >> 4);
    fence_acc1(acc);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - 3 * ky;
      const uint32_t row = ky == 0 ? r0 : ky == 1 ? r1 : r2;
      wgmma_bf16(acc, dc + ((row + kx * 16) >> 4), db + tap * (P::W_SLAB / 16),
                 tap > 0 || c > 0 || from_acc);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc1(acc);
    if (c > 0) give<P>(f, lane);
    ++f.g;
  }
  if (PROJ) {
    const uint64_t db = smem_desc(take<P>(f, woff + nch * P::W_CHUNK), P::QB, 128);
    const uint64_t dr = smem_desc(raw_row, RAW_PLANE, 128);
    fence_acc1(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < P::C1; ++c)
      wgmma_bf16(acc, dr + (2 * c * RAW_PLANE) / 16, db + c * (P::W_SLAB / 16));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc1(acc);
    give<P>(f, lane);
    ++f.g;
  }
  wgmma_wait<0>();
  fence_acc1(acc);
  give<P>(f, lane);
}

// The epilogue of f1.conv1, f1.conv2 + proj (Y1) and f2.conv1: v = sums +
// bias (+ the projection's bias), the next convolution's affine and ReLU,
// bf16, zero outside the image (SAME padding after the activation, at this
// tensor's own rows and columns), into ring row y. With Y1, v (f32) is kept
// in res as the last residual. The m64nN fragment: thread (warp wq, lane l)
// holds pixels 16 wq + l/4 and + 8, channels 8j + 2(l%4) and + 1.
template <class P, bool Y1>
__device__ __forceinline__ void act_rows(const float (&acc)[P::NACC], const float* vec, int vb,
                                         int va, int vc, unsigned char* ring, int y, int gy,
                                         int gx0, int H, int W, int wq, int lane,
                                         float (&res)[P::NACC]) {
  constexpr int N = P::N;
  const float* bias = vec + vb * N;
  const float* pb = vec + VEC_PB * N;
  const float* na = vec + va * N;
  const float* nc = vec + vc * N;
  const bool row_in = gy >= 0 && gy < H;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = wq * 16 + (lane >> 2) + 8 * half;
    const int gx = gx0 + p;
    const bool in = row_in && gx >= 0 && gx < W;
    unsigned char* dst = ring + (y & (RS - 1)) * ROWB + (p + 1) * 16 + (lane & 3) * 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      float v0 = acc[4 * j + 2 * half] + bias[col];
      float v1 = acc[4 * j + 2 * half + 1] + bias[col + 1];
      if (Y1) {
        v0 = v0 + pb[col];
        v1 = v1 + pb[col + 1];
        res[4 * j + 2 * half] = v0;
        res[4 * j + 2 * half + 1] = v1;
      }
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(act(v0, na[col], nc[col]), act(v1, na[col + 1], nc[col + 1]));
      *reinterpret_cast<uint32_t*>(dst + j * RPLANE) =
          in ? *reinterpret_cast<const uint32_t*>(&h) : 0u;
    }
  }
}

// x's f32 values of two rows (image rows gy0, gy0 + 1; columns gx0 ..
// gx0 + 63) into registers, zeros outside the image: thread t takes float4 i
// = t + 256 k, channels 4q .. 4q + 3 of pixel p of row r.
template <class P>
__device__ __forceinline__ void load_x(float4 (&px)[P::NPREF], const Args& a, int b, int gy0,
                                       int gx0, int t) {
  constexpr int NQ = P::CIN / 4;
#pragma unroll
  for (int k = 0; k < P::NPREF; ++k) {
    const int i = t + 256 * k;
    const int q = i % NQ, p = (i / NQ) % TP, r = i / (NQ * TP);
    const int gy = gy0 + r, gx = gx0 + p, ch = 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
      const size_t pix = ((size_t)b * a.H + gy) * a.W + gx;
      v = ch < a.ca ? __ldg(reinterpret_cast<const float4*>(a.sr + pix * a.ca + ch))
                    : __ldg(reinterpret_cast<const float4*>(a.dem + pix * a.cb + (ch - a.ca)));
    }
    px[k] = v;
  }
}

// The two rows of x in registers into shared memory: with ACT as f1.conv1's
// operand bf16(relu(a1 x + c1)), zero outside the image, at ring rows yr and
// yr + 1; else as bf16(x), the projection's operand, at raw rows 0 and 1.
template <class P, bool ACT>
__device__ __forceinline__ void store_x(const float4 (&px)[P::NPREF], unsigned char* dst,
                                        const float* vec, int yr, int gy0, int gx0, int H, int W,
                                        int t) {
  constexpr int NQ = P::CIN / 4;
#pragma unroll
  for (int k = 0; k < P::NPREF; ++k) {
    const int i = t + 256 * k;
    const int q = i % NQ, p = (i / NQ) % TP, r = i / (NQ * TP);
    const float4 v = px[k];
    __nv_bfloat162 h[2];
    unsigned char* at;
    if (ACT) {
      const int gy = gy0 + r, gx = gx0 + p;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float4 fa = *reinterpret_cast<const float4*>(vec + 4 * q);
      const float4 fc = *reinterpret_cast<const float4*>(vec + P::CIN + 4 * q);
      h[0] = __floats2bfloat162_rn(act(v.x, fa.x, fc.x), act(v.y, fa.y, fc.y));
      h[1] = __floats2bfloat162_rn(act(v.z, fa.z, fc.z), act(v.w, fa.w, fc.w));
      if (!in) h[0] = h[1] = __floats2bfloat162_rn(0.f, 0.f);
      at = dst + (q >> 1) * RPLANE + ((yr + r) & (RS - 1)) * ROWB + (p + 1) * 16 + (q & 1) * 8;
    } else {
      h[0] = __floats2bfloat162_rn(v.x, v.y);
      h[1] = __floats2bfloat162_rn(v.z, v.w);
      at = dst + (q >> 1) * RAW_PLANE + r * XROWB + p * 16 + (q & 1) * 8;
    }
    *reinterpret_cast<uint2*>(at) = *reinterpret_cast<const uint2*>(h);
  }
}

// f2.conv2's epilogue and the head, for the tile row o (a band row) of this
// warpgroup: y2 = sums + bias, split into TF32 hi and lo a quarter of the
// channels (16) at a time over the scratch (eight octet planes of the x ring
// whose two rows are free: [quad][64 pixels][4] f32, hi and lo of each k8
// step, warpgroup wg's own four), then the 3xTF32 head as the bf16 route's
// (lo*Whi, hi*Wlo, hi*Whi per k8 step, in order); the strip's own columns
// and the band's own rows are stored.
template <class P>
__device__ __forceinline__ void head_rows(const float (&acc)[P::NACC], const float* bias,
                                          unsigned char* scratch, uint32_t scratch_s, uint32_t h_s,
                                          const Args& a, int b, int o, int rows, int gy, int gx0,
                                          int wg, int wq, int lane) {
  constexpr int N = P::N, HN = P::HN, HQ = HN * 16;
  float hacc[HN / 2];
#pragma unroll
  for (int i = 0; i < HN / 2; ++i) hacc[i] = 0.f;
#pragma unroll
  for (int qq = 0; qq < N / 16; ++qq) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = wq * 16 + (lane >> 2) + 8 * half;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * qq + jj;
        const int col = 8 * j + 2 * (lane & 3);
        float2 v;
        v.x = acc[4 * j + 2 * half] + bias[col];
        v.y = acc[4 * j + 2 * half + 1] + bias[col + 1];
        float2 hi, lo;
        hi.x = tf32_rna(v.x); lo.x = tf32_rna(v.x - hi.x);
        hi.y = tf32_rna(v.y); lo.y = tf32_rna(v.y - hi.y);
        const int lc = col - 16 * qq;
        const int off = ((lc >> 2) & 1) * HQ_PLANE + px * 16 + (lc & 3) * 4;
        *reinterpret_cast<float2*>(scratch + (wg * 4 + jj) * RPLANE + off) = hi;
        *reinterpret_cast<float2*>(scratch + (wg * 4 + 2 + jj) * RPLANE + off) = lo;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(2 + wg, 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int ks = 2 * qq + kk;  // the k8 step over all N channels
      const uint32_t hw = h_s + (ks >> 1) * (2 * CK * HN * 4) + (ks & 1) * 2 * HQ;
      const uint64_t dbh = smem_desc(hw, HQ, 128);
      const uint64_t dbl = smem_desc(hw + CK * HN * 4, HQ, 128);
      const uint64_t dah = smem_desc(scratch_s + (wg * 4 + kk) * RPLANE, HQ_PLANE, 128);
      const uint64_t dal = smem_desc(scratch_s + (wg * 4 + 2 + kk) * RPLANE, HQ_PLANE, 128);
      wgmma_tf32(hacc, dal, dbh);
      wgmma_tf32(hacc, dah, dbl);
      wgmma_tf32(hacc, dah, dbh);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < HN / 2; ++i) asm volatile("" : "+f"(hacc[i])::"memory");
    // this quarter's tiles are read; the next may overwrite them
    named_barrier(2 + wg, 128);
  }
  if (o < 0 || o >= rows || gy >= a.H) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int px = wq * 16 + (lane >> 2) + 8 * half;
    const int gx = gx0 + px;
    if (px < kHalo || px >= kHalo + TWO || gx >= a.W) continue;
    store_head<P::CH>(a.out + (((size_t)b * a.H + gy) * a.W + gx) * P::CH, hacc, half, lane,
                      a.head_b);
  }
}

// out[b, y0 .. y0 + rows, x0 .. x0 + 56, :CH] of one unit (image b, column
// strip x0 = 56 s, row band y0 = rows * band): the chain of the bf16 route in
// one block, by steps of two rows down the band. Every operand a tile row
// reads has 64 pixels, image columns x0 - 4 .. x0 + 59; each 3x3 leaves its
// edge pixels unused, so the strip's 56 are exact after four. Step t brings
// x rows 2t-4, 2t-3 (band rows; the f32 values loaded in the step before),
// then warpgroup wg computes row 2t-5+wg of y (f1.conv1), 2t-6+wg of y1
// (f1.conv2 + proj), 2t-7+wg of z (f2.conv1) and 2t-8+wg of the output
// (f2.conv2 + y1, head): each reads rows its predecessor wrote in this step or
// the one before, which a ring of four rows holds; y1's f32 value stays in
// the registers of the warpgroup that stores its output row one step later.
// Stage k runs from step k on; the last step is the one that writes the last
// row. Only the output reaches device memory.
template <int N, int CH, int CIN>
__global__ void __launch_bounds__(kThreads, 1) bf16_band_kernel(const Args a) {
  using P = Plan<N, CH, CIN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  const uint32_t base = (raw_u + 127u) & ~127u;
  unsigned char* bp = smem_raw + (base - raw_u);
  float* vec = reinterpret_cast<float*>(bp + P::OFF_VEC);
  const uint32_t bars = base + P::OFF_BAR;
  const uint32_t full = bars, empty = bars + 8 * P::NS, full_h = bars + 16 * P::NS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int u = blockIdx.x;
  const int b = u / (a.strips * a.bands);
  const int x0 = (u % a.strips) * TWO;
  const int y0 = ((u / a.strips) % a.bands) * a.rows;
  const int rows = min(a.rows, a.H - y0);
  const int last = (rows + 1) / 2 + 3;

  if (tid == 0) {
    for (int s = 0; s < P::NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(full_h, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < P::NVEC; i += kThreads) {
    const int k = i < 2 * CIN ? i / CIN : 2 + (i - 2 * CIN) / N;
    vec[i] = a.vec[k][i < 2 * CIN ? i % CIN : (i - 2 * CIN) % N];
  }
  // zeros over the rings: their pad pixels feed only pixels no output reads
  for (int i = tid; i < P::OFF_RAW / 16; i += kThreads)
    reinterpret_cast<uint4*>(bp)[i] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == 8) {
    // ---- producer: one thread issues every copy of the weights ----
    if (lane != 0) return;
    mbar_arrive_expect_tx(full_h, P::HEAD_W_BYTES);
    bulk_load(base + P::OFF_H, a.head_w, P::HEAD_W_BYTES, full_h);
    const unsigned char* w[4];
    for (int k = 0; k < 4; ++k) w[k] = reinterpret_cast<const unsigned char*>(a.w[k]);
    if (P::RESIDENT) {
      mbar_arrive_expect_tx(full, P::W_BYTES);
      bulk_load(base + P::OFF_W, w[0], P::W1, full);
      bulk_load(base + P::OFF_W + P::W1, w[1], P::W2, full);
      bulk_load(base + P::OFF_W + P::W1 + P::W2, w[2], P::W3, full);
      bulk_load(base + P::OFF_W + P::W1 + P::W2 + P::W3, w[3], P::W3, full);
      return;
    }
    // the compute warpgroups' order: stage k from step k on, its chunks,
    // f1.conv2's projection slabs as one more
    int g = 0;
    for (int t = 0; t <= last; ++t)
      for (int k = 1; k <= 4 && k <= t; ++k) {
        const int nch = k == 1 ? P::C1 : P::CM;
        for (int c = 0; c < nch + (k == 2); ++c) {
          const int st = g % P::NS;
          const int bytes = c < nch ? P::W_CHUNK : P::C1 * P::W_SLAB;
          mbar_wait_ptx(empty + 8 * st, ((g / P::NS) & 1) ^ 1);
          mbar_arrive_expect_tx(full + 8 * st, bytes);
          bulk_load(base + P::OFF_W + st * P::STAGE, w[k - 1] + (size_t)c * P::W_CHUNK, bytes,
                    full + 8 * st);
          ++g;
        }
      }
    return;
  }

  // ---- compute warpgroups ----
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int gx0 = x0 - kHalo;
  unsigned char* x_ring = bp;
  unsigned char* raw = bp + P::OFF_RAW;
  const uint32_t x_s = base, y_s = base + P::OFF_Y, y1_s = base + P::OFF_Y1, z_s = base + P::OFF_Z;
  const uint32_t raw_s = base + P::OFF_RAW;
  const float* nvec = vec + 2 * CIN;
  Feed f = {base + P::OFF_W, full, empty, 0};
  float4 px[P::NPREF];
  float acc[P::NACC], res[P::NACC], res_next[P::NACC];
  load_x<P>(px, a, b, y0 - kHalo, gx0, tid);
  for (int t = 0; t <= last; ++t) {
    const int yr = 2 * t - kHalo;  // band row of the step's first x row
    store_x<P, true>(px, x_ring, vec, yr, y0 + yr, gx0, a.H, a.W, tid);
    sync_compute();
    if (t >= 1) {
      const int y = 2 * t - 5 + wg;
      conv_rows<P, false>(acc, false, x_s, y, P::C1, 0, 0, f, lane);
      act_rows<P, false>(acc, nvec, VEC_B1, VEC_A2, VEC_C2, bp + P::OFF_Y, y, y0 + y, gx0, a.H,
                         a.W, wq, lane, res_next);
    }
    sync_compute();
    if (t >= 2) {
      const int y = 2 * t - 6 + wg;  // its raw x row: row wg of the step before's
      conv_rows<P, true>(acc, false, y_s, y, P::CM, P::W1, raw_s + wg * XROWB, f, lane);
      act_rows<P, true>(acc, nvec, VEC_B2, VEC_F2A1, VEC_F2C1, bp + P::OFF_Y1, y, y0 + y, gx0,
                        a.H, a.W, wq, lane, res_next);
    }
    // every read of the raw rows is done: this step's go there, and the next
    // step's x comes in
    named_barrier(1, 256);
    store_x<P, false>(px, raw, vec, yr, y0 + yr, gx0, a.H, a.W, tid);
    if (t < last) load_x<P>(px, a, b, y0 + yr + 2, gx0, tid);
    sync_compute();
    if (t >= 3) {
      const int y = 2 * t - 7 + wg;
      conv_rows<P, false>(acc, false, y1_s, y, P::CM, P::W1 + P::W2, 0, f, lane);
      act_rows<P, false>(acc, nvec, VEC_F2B1, VEC_F2A2, VEC_F2C2, bp + P::OFF_Z, y, y0 + y, gx0,
                         a.H, a.W, wq, lane, res_next);
    }
    sync_compute();
    if (t >= 4) {
      const int o = 2 * t - 8 + wg;
#pragma unroll
      for (int i = 0; i < P::NACC; ++i) acc[i] = res[i];
      conv_rows<P, false>(acc, true, z_s, o, P::CM, P::W1 + P::W2 + P::W3, 0, f, lane);
      mbar_wait_ptx(full_h, 0);
      // the x ring's rows 2t-6 and 2t-5: read by f1.conv1 of this step for the last time
      const int free_row = ((2 * t - 6) & (RS - 1)) * ROWB;
      head_rows<P>(acc, nvec + VEC_F2B2 * N, x_ring + free_row, x_s + free_row,
                   base + P::OFF_H, a, b, o, rows, y0 + o, gx0, wg, wq, lane);
    }
#pragma unroll
    for (int i = 0; i < P::NACC; ++i) res[i] = res_next[i];
    // the head's tiles are read before the next step's x goes over them
    named_barrier(1, 256);
  }
}

template <int N, int CH, int CIN>
cudaError_t launch(const Args& args, int units, cudaStream_t stream) {
  using P = Plan<N, CH, CIN>;
  static bool done[64] = {};
  cudaError_t err = bf::opt_in(bf16_band_kernel<N, CH, CIN>, P::SMEM, done);
  if (err != cudaSuccess) return err;
  bf16_band_kernel<N, CH, CIN><<<units, kThreads, P::SMEM, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace band

// Positions in the packed tensor-core weight list (TC_PACK_KEYS in hr_tail.py).
enum { P_F1_W1, P_F1_W2_PW, P_F2_W1, P_F2_W2, P_HEAD_W, N_PACKS };

}  // namespace tc

}  // namespace

// Direct route. sr [B,H,W,ca], dem [B,H,W,cb]; weights: N_WEIGHTS device pointers in
// WEIGHT_KEYS order; buf_p and buf_y are [B,H,W,cm] scratch; out [B,H,W,ch].
// With bf16 the four 3x3 convolutions and the projection round their operands
// to bf16; the head does not.
static int direct_chain(const float* sr, const float* dem, int B, int H, int W,
                        int ca, int cb, int cm, int ch,
                        const void* const* weights, float* buf_p, float* buf_y,
                        float* out, bool bf16, void* stream_ptr) {
  const float* const* wt = reinterpret_cast<const float* const*>(weights);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long npix = (long long)B * H * W;
  cudaError_t err;
  // p = proj(x)
  err = launch_conv1x1(sr, ca, dem, cb, wt[F1_PW], wt[F1_PB], buf_p, npix, cm,
                       bf16, stream);
  if (err != cudaSuccess) return (int)err;
  // y = conv1(relu(bn1 x))
  err = launch_conv3x3(sr, ca, dem, cb, wt[F1_A1], wt[F1_C1], wt[F1_W1],
                       wt[F1_B1], nullptr, buf_y, B, H, W, cm, bf16, stream);
  if (err != cudaSuccess) return (int)err;
  // y1 = conv2(relu(bn2 y)) + p, in place over p
  err = launch_conv3x3(buf_y, cm, nullptr, 0, wt[F1_A2], wt[F1_C2], wt[F1_W2],
                       wt[F1_B2], buf_p, buf_p, B, H, W, cm, bf16, stream);
  if (err != cudaSuccess) return (int)err;
  // z = conv1(relu(bn1 y1))
  err = launch_conv3x3(buf_p, cm, nullptr, 0, wt[F2_A1], wt[F2_C1], wt[F2_W1],
                       wt[F2_B1], nullptr, buf_y, B, H, W, cm, bf16, stream);
  if (err != cudaSuccess) return (int)err;
  // y2 = conv2(relu(bn2 z)) + y1, in place over y1
  err = launch_conv3x3(buf_y, cm, nullptr, 0, wt[F2_A2], wt[F2_C2], wt[F2_W2],
                       wt[F2_B2], buf_p, buf_p, B, H, W, cm, bf16, stream);
  if (err != cudaSuccess) return (int)err;
  // out = head(y2), f32 on either route
  err = launch_conv1x1(buf_p, cm, nullptr, 0, wt[HEAD_W], wt[HEAD_B], out, npix,
                       ch, false, stream);
  return (int)err;
}

extern "C" int hr_tail_launch(const float* sr, const float* dem, int B, int H,
                              int W, int ca, int cb, int cm, int ch,
                              const void* const* weights, float* buf_p,
                              float* buf_y, float* out, void* stream_ptr) {
  return direct_chain(sr, dem, B, H, W, ca, cb, cm, ch, weights, buf_p, buf_y, out,
                      false, stream_ptr);
}

extern "C" int hr_tail_bf16_direct_launch(const float* sr, const float* dem, int B,
                                          int H, int W, int ca, int cb, int cm,
                                          int ch, const void* const* weights,
                                          float* buf_p, float* buf_y, float* out,
                                          void* stream_ptr) {
  return direct_chain(sr, dem, B, H, W, ca, cb, cm, ch, weights, buf_p, buf_y, out,
                      true, stream_ptr);
}

// The current device's SM count, queried once per device: the bf16 body
// kernel's persistent grid, and the 3xTF32 route's rows a block at Cm 64.
static cudaError_t sm_count(int* sms) {
  static int known[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev] > 0) {
    *sms = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) known[dev] = *sms;
  return err;
}

// Returned by the tensor-core launchers for a (cm, ch) they were not
// instantiated for: they never take another route instead.
constexpr int kNotInstantiated = 200000;

// Tensor-core route: the same chain, every convolution through
// tc::conv_tc_kernel<N, CH, MT>, or tc::conv_tc_rs_kernel<N, CH, MT> where
// N < 128 (tc::kAFromRegisters).
template <int N, int CH, int MT>
static int tc_chain(const float* sr, const float* dem, int B, int H, int W, int ca, int cb,
                    const float* const* wt, const float* const* pk, float* buf_p, float* buf_y,
                    float* out, cudaStream_t stream) {
  const float* none = nullptr;
  cudaError_t err;
  // y = conv1(relu(bn1 x))
  err = tc::launch<N, CH, MT, false>(sr, ca, dem, cb, wt[F1_A1], wt[F1_C1], none, 0, none, 0,
                                     pk[tc::P_F1_W1], wt[F1_B1], none, none, none, none, buf_y,
                                     B, H, W, stream);
  if (err != cudaSuccess) return (int)err;
  // y1 = conv2(relu(bn2 y)) + proj(x): the projection is (ca + cb) / 16 more chunks of K
  err = tc::launch<N, CH, MT, false>(buf_y, N, none, 0, wt[F1_A2], wt[F1_C2], sr, ca, dem, cb,
                                     pk[tc::P_F1_W2_PW], wt[F1_B2], wt[F1_PB], none, none, none,
                                     buf_p, B, H, W, stream);
  if (err != cudaSuccess) return (int)err;
  // z = conv1(relu(bn1 y1))
  err = tc::launch<N, CH, MT, false>(buf_p, N, none, 0, wt[F2_A1], wt[F2_C1], none, 0, none, 0,
                                     pk[tc::P_F2_W1], wt[F2_B1], none, none, none, none, buf_y,
                                     B, H, W, stream);
  if (err != cudaSuccess) return (int)err;
  // out = head(conv2(relu(bn2 z)) + y1): y2 never reaches device memory
  err = tc::launch<N, CH, MT, true>(buf_y, N, none, 0, wt[F2_A2], wt[F2_C2], none, 0, none, 0,
                                    pk[tc::P_F2_W2], wt[F2_B2], none, buf_p, pk[tc::P_HEAD_W],
                                    wt[HEAD_B], out, B, H, W, stream);
  return (int)err;
}

// Tensor-core route. Needs (cm, ch) among the instantiated widths (TC_WIDTHS
// in hr_tail.py), ca % 4 == 0, cb % 4 == 0 and (ca + cb) % 16 == 0 (the
// wrapper checks). weights as above (the affines and biases are read from
// it); packs: tc::N_PACKS device pointers in TC_PACK_KEYS order, the hi/lo
// TF32 weight slabs, the head's padded to HN columns.
extern "C" int hr_tail_tc_launch(const float* sr, const float* dem, int B, int H, int W, int ca,
                                 int cb, int cm, int ch, const void* const* weights,
                                 const void* const* packs, float* buf_p, float* buf_y, float* out,
                                 void* stream_ptr) {
  const float* const* wt = reinterpret_cast<const float* const*>(weights);
  const float* const* pk = reinterpret_cast<const float* const*>(packs);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (cm == 128 && ch == 16)
    return tc_chain<128, 16, 2>(sr, dem, B, H, W, ca, cb, wt, pk, buf_p, buf_y, out, stream);
  if (cm == 64 && ch == 4) {
    // Six rows a block (MT 3) keep a warpgroup's accumulators and fragments in
    // registers; a grid that one wave of eight-row blocks covers takes those
    // (MT 4, a few spilled registers): one 256x256 tile is 128 such blocks,
    // but 172 of six rows, and their second wave leaves the card 70% idle.
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    if ((long long)B * ((H + 7) / 8) * ((W + tc::TWX - 1) / tc::TWX) <= sms)
      return tc_chain<64, 4, 4>(sr, dem, B, H, W, ca, cb, wt, pk, buf_p, buf_y, out, stream);
    return tc_chain<64, 4, 3>(sr, dem, B, H, W, ca, cb, wt, pk, buf_p, buf_y, out, stream);
  }
  if (cm == 32 && ch == 1)
    return tc_chain<32, 1, 4>(sr, dem, B, H, W, ca, cb, wt, pk, buf_p, buf_y, out, stream);
  return kNotInstantiated;
}

// Whether the tensor-core route at (cm, ch) takes its A operand from
// registers (conv_tc_rs_kernel), so that its pack holds each chunk's channels
// transposed: 1 or 0, or kNotInstantiated. The wrapper holds its pack's
// order (hr_tail.py: a_from_registers) against this when it loads the
// library.
extern "C" int hr_tail_tc_a_from_registers(int cm, int ch) {
  if (cm == 128 && ch == 16) return tc::kAFromRegisters<128>;
  if (cm == 64 && ch == 4) return tc::kAFromRegisters<64>;
  if (cm == 32 && ch == 1) return tc::kAFromRegisters<32>;
  return kNotInstantiated;
}

// ---- bf16 route: tensor maps and the chain ----

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime, so
// the library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Returned for a tensor map that cuTensorMapEncodeTiled refuses: kEncodeFailed
// + its CUresult.
constexpr int kEncodeFailed = 100000;

static int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return (int)cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return 0;
}

// A 4-D map (channels, W, H, B) over a contiguous NHWC bf16 tensor, with a
// box of 8 channels x box_w x box_h x 1: one channel octet lands as
// [row][column][8], the K-major core-matrix layout. No swizzle; elements
// outside the tensor load as zeros.
static int tensor_map(CUtensorMap* map, const void* ptr, int C, int B, int H, int W, int box_w,
                      int box_h) {
  EncodeTiled fn = nullptr;
  const int rc = encode_tiled(&fn);
  if (rc != 0) return rc;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// The bf16 route's chain: the pre-pass, then the three body launches, each
// storing the next one's operand, then the head's.
template <int N, int CH, int MT>
static int bf16_chain(const float* sr, const float* dem, int B, int H, int W, int ca, int cb,
                      const float* const* wt, const void* const* pk, void* x_act, void* x_raw,
                      void* act_a, void* act_b, float* y1, float* out, cudaStream_t stream) {
  namespace bf = tc::bf;
  using P = bf::Plan<N, CH, MT>;
  const int cin = ca + cb;
  const float* none = nullptr;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long nquads = (long long)B * H * W * (cin / 4);
  bf::bf16_prepass_kernel<<<(unsigned)((nquads + 255) / 256), 256, 0, stream>>>(
      sr, ca, dem, cb, wt[F1_A1], wt[F1_C1], reinterpret_cast<__nv_bfloat16*>(x_act),
      reinterpret_cast<__nv_bfloat16*>(x_raw), nquads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap x_act_map, x_raw_map, a_map, b_map;
  int rc;
  if ((rc = tensor_map(&x_act_map, x_act, cin, B, H, W, tc::PW, P::PH)) != 0) return rc;
  if ((rc = tensor_map(&x_raw_map, x_raw, cin, B, H, W, tc::TWX, P::TR)) != 0) return rc;
  if ((rc = tensor_map(&a_map, act_a, N, B, H, W, tc::PW, P::PH)) != 0) return rc;
  if ((rc = tensor_map(&b_map, act_b, N, B, H, W, tc::PW, P::PH)) != 0) return rc;
  // act_a = bf16(relu(f1.bn2(conv1(x_act))))
  err = bf::launch_body<N, CH, MT>(x_act_map, x_act_map, cin / tc::CK, 0, pk[tc::P_F1_W1],
                                   wt[F1_B1], none, nullptr, act_a, wt[F1_A2], wt[F1_C2], B, H,
                                   W, sms, stream);
  if (err != cudaSuccess) return (int)err;
  // y1 = conv2(act_a) + proj(x_raw), f32 for the last residual;
  // act_b = bf16(relu(f2.bn1(y1)))
  err = bf::launch_body<N, CH, MT>(a_map, x_raw_map, N / tc::CK, cin / tc::CK,
                                   pk[tc::P_F1_W2_PW], wt[F1_B2], wt[F1_PB], y1, act_b,
                                   wt[F2_A1], wt[F2_C1], B, H, W, sms, stream);
  if (err != cudaSuccess) return (int)err;
  // act_a = bf16(relu(f2.bn2(conv1(act_b))))
  err = bf::launch_body<N, CH, MT>(b_map, b_map, N / tc::CK, 0, pk[tc::P_F2_W1], wt[F2_B1],
                                   none, nullptr, act_a, wt[F2_A2], wt[F2_C2], B, H, W, sms,
                                   stream);
  if (err != cudaSuccess) return (int)err;
  // out = head(conv2(act_a) + y1): y2 never reaches device memory
  err = bf::launch_head<N, CH, MT>(a_map, N / tc::CK, pk[tc::P_F2_W2], wt[F2_B2], y1,
                                   reinterpret_cast<const float*>(pk[tc::P_HEAD_W]), wt[HEAD_B],
                                   out, B, H, W, stream);
  return (int)err;
}

// bf16 route (the TPU kernel's mode="bf16") at the flagship's widths; the
// other two layouts take hr_tail_bf16_band_launch. packs: tc::N_PACKS device
// pointers in TC_PACK_KEYS order, bf16 slabs for the four convolutions and
// hi/lo TF32 slabs for the head. Scratch: x_act and
// x_raw [B,H,W,ca+cb] bf16, act_a and act_b [B,H,W,cm] bf16, y1 [B,H,W,cm]
// f32; every buffer 16-byte aligned. A tensor map that cannot be encoded
// returns kEncodeFailed + its CUresult; widths not instantiated,
// kNotInstantiated.
// The layout of the tensor-core launchers' arguments: 3 from the signatures
// below on (cm and ch after cb, in hr_tail_tc_launch too); 2 before them;
// the route before that took 13 arguments and exported no number.
extern "C" int hr_tail_bf16_abi() { return 3; }

extern "C" int hr_tail_bf16_launch(const float* sr, const float* dem, int B, int H, int W,
                                   int ca, int cb, int cm, int ch, const void* const* weights,
                                   const void* const* packs, void* x_act, void* x_raw,
                                   void* act_a, void* act_b, float* y1, float* out,
                                   void* stream_ptr) {
  if (ca <= 0 || ca % 4 || cb % 4 || (ca + cb) % tc::CK) return (int)cudaErrorInvalidValue;
  const void* aligned[] = {sr, dem, x_act, x_raw, act_a, act_b, y1, out};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < tc::N_PACKS; ++i)
    if (reinterpret_cast<uintptr_t>(packs[i]) % 16) return (int)cudaErrorInvalidValue;
  const float* const* wt = reinterpret_cast<const float* const*>(weights);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (cm == 128 && ch == 16)
    return bf16_chain<128, 16, 1>(sr, dem, B, H, W, ca, cb, wt, packs, x_act, x_raw, act_a,
                                  act_b, y1, out, stream);
  return kNotInstantiated;
}

// ---- bf16 band route ----

// Rows a band: the fewest waves of blocks (one an SM) times a block's steps
// (two rows each, its own rows and the 8 of the halo), so that one tile
// still fills the card (130 blocks at hr_s2d 2 and 1).
static void band_rows(int B, int H, int strips, int sms, int* rows, int* bands) {
  long long best = -1;
  for (int n = 1; n <= H; ++n) {
    const int r = (H + n - 1) / n;
    if ((H + r - 1) / r != n) continue;  // the same rows as a smaller n
    const long long units = (long long)B * strips * n;
    const long long cost = (units + sms - 1) / sms * ((r + 1) / 2 + 4);
    if (best < 0 || cost < best) {
      best = cost;
      *rows = r;
      *bands = n;
    }
  }
}

template <int N, int CH, int CIN>
static int bf16_band_chain(const float* sr, const float* dem, int B, int H, int W, int ca, int cb,
                           const float* const* wt, const void* const* pk, float* out,
                           cudaStream_t stream) {
  namespace band = tc::band;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  band::Args a;
  a.sr = sr;
  a.dem = dem;
  a.ca = ca;
  a.cb = cb;
  const int vecs[2 + band::N_VEC] = {F1_A1, F1_C1, F1_B1, F1_A2, F1_C2, F1_B2, F1_PB,
                                     F2_A1, F2_C1, F2_B1, F2_A2, F2_C2, F2_B2};
  for (int i = 0; i < 2 + band::N_VEC; ++i) a.vec[i] = wt[vecs[i]];
  const int convs[4] = {tc::P_F1_W1, tc::P_F1_W2_PW, tc::P_F2_W1, tc::P_F2_W2};
  for (int k = 0; k < 4; ++k) a.w[k] = pk[convs[k]];
  a.head_w = reinterpret_cast<const float*>(pk[tc::P_HEAD_W]);
  a.head_b = wt[HEAD_B];
  a.out = out;
  a.H = H;
  a.W = W;
  a.strips = (W + band::TWO - 1) / band::TWO;
  band_rows(B, H, a.strips, sms, &a.rows, &a.bands);
  const long long units = (long long)B * a.strips * a.bands;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)band::launch<N, CH, CIN>(a, (int)units, stream);
}

// bf16 band route (the TPU kernel's mode="bf16" in one launch, every
// intermediate on chip): (cm, ch, ca + cb) = (64, 4, 96) and (32, 1, 64), the
// JAX package's hr_s2d 2 and 1; ca and cb multiples of 4. packs as for
// hr_tail_bf16_launch. No scratch. Other widths: kNotInstantiated.
extern "C" int hr_tail_bf16_band_launch(const float* sr, const float* dem, int B, int H, int W,
                                        int ca, int cb, int cm, int ch,
                                        const void* const* weights, const void* const* packs,
                                        float* out, void* stream_ptr) {
  if (ca <= 0 || ca % 4 || cb % 4) return (int)cudaErrorInvalidValue;
  const void* aligned[] = {sr, dem, out};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < tc::N_PACKS; ++i)
    if (reinterpret_cast<uintptr_t>(packs[i]) % 16) return (int)cudaErrorInvalidValue;
  const float* const* wt = reinterpret_cast<const float* const*>(weights);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (cm == 64 && ch == 4 && ca + cb == 96)
    return bf16_band_chain<64, 4, 96>(sr, dem, B, H, W, ca, cb, wt, packs, out, stream);
  if (cm == 32 && ch == 1 && ca + cb == 64)
    return bf16_band_chain<32, 1, 64>(sr, dem, B, H, W, ca, cb, wt, packs, out, stream);
  return kNotInstantiated;
}
