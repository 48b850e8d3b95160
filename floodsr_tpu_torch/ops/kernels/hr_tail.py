"""The ResUNet HR tail: the ``hr_tail`` CUDA kernels (K1).

Replaces the TPU kernel ``floodsr_tpu/ops/pallas/hr_tail.py::hr_tail_pallas``
(pallas_call at :594, kernel ``_hr_tail_kernel`` :385-447): concat(SR
features, DEM features) → residual block with a 1×1 projection shortcut →
residual block with an identity shortcut → 1×1 head, NHWC f32, BN folded to
per-channel affines (:func:`pack_hr_tail_weights`, after the JAX package's
:450-478).

Source: ``floodsr_tpu_torch/csrc/hr_tail.cu`` (its header says what bounds it
on the card and what its design does about that). :func:`hr_tail` dispatches
a CPU tensor to :func:`hr_tail_reference`, the unfused chain with
``F.conv2d``; a CUDA tensor launches the hand-written kernels or raises.

Two routes on the card, chosen from the channel counts alone
(:func:`tc_eligible`): the tensor-core route (``wgmma`` implicit GEMM in
3xTF32 with f32 accumulation; the (Cm, Ch) pairs of :data:`TC_WIDTHS`, which
are the three HR layouts of the JAX package's ``ResUNetConfig.hr_s2d`` at the
flagship's base widths) and the direct route (f32 FMA on the CUDA cores; any
other widths). Each counts its calls in
:data:`route_launches`. The tensor-core route reads its weights from a
kernel-side pack (:func:`pack_hr_tail_tc`: hi/lo TF32 halves in the layout of
the ``wgmma`` B operand), which the caller builds once per set of weights
and hands in; the wrapper never builds it.
:func:`split_tf32` and :func:`hr_tail_reference_3xtf32` state that route's
arithmetic in plain torch, for the tests; nothing on the main path calls them.

``mode="bf16"`` is the TPU kernel's second arithmetic (its ``mode="bf16"``,
run under the ``bf16`` precision policy): inputs, intermediates, affines,
biases and residual adds stay f32; at the four 3×3 convolutions and at the
projection the activated operand and the weight are rounded to bf16 and
multiplied in one pass with f32 accumulation; the head stays at three-pass
precision. Three more routes carry it on the card, counted like the others
(:func:`bf16_route` picks one from the channel counts), the first two with
weights from :func:`pack_hr_tail_bf16`:

- ``"bf16"`` at the flagship's widths (:data:`BF16_WIDTHS`): ``wgmma``
  m64nNk16, N = Cm, a pre-pass and four launches; each launch stores the next
  convolution's operand already activated and rounded, as bf16, and the next
  reads it by TMA; scratch :func:`bf16_scratch`.
- ``"bf16_band"`` at the JAX package's other two HR layouts
  (:data:`BAND_LAYOUTS`, ``hr_s2d`` 2 and 1): the whole chain in ONE launch, as
  the TPU kernel's row bands do it. A block walks a strip of 56 output columns
  down a band of rows, two rows a step, and keeps every operand in shared
  memory (rings of four rows, x read once) and the last residual in
  registers: only the output reaches device memory, and there is no scratch.
  The same sums in the same order as ``"bf16"``: the same bits.
- ``"bf16_direct"`` (the direct kernels with the operands rounded to bf16 in
  registers, any widths).

The head is a 3xTF32 product on the first two and an f32 FMA product on the
last, each at least as exact as the TPU kernel's three-pass bf16 split.
:func:`hr_tail_reference_bf16` is the plain version: what a CPU tensor runs
in this mode and what the kernels are held against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Packed weight order (the CUDA launcher indexes the same list).
WEIGHT_KEYS = (
    "f1_a1", "f1_c1", "f1_w1", "f1_b1", "f1_a2", "f1_c2", "f1_w2", "f1_b2",
    "f1_pw", "f1_pb",
    "f2_a1", "f2_c1", "f2_w1", "f2_b1", "f2_a2", "f2_c2", "f2_w2", "f2_b2",
    "head_w", "head_b",
)

#: The tensor-core route's pack, in the order the CUDA launcher indexes it:
#: each entry names the weight matrices whose slabs one launch streams. The
#: projection shortcut rides in f1.conv2's launch as (Ca+Cb)/16 more chunks of K.
TC_PACK_KEYS = (("f1_w1",), ("f1_w2", "f1_pw"), ("f2_w1",), ("f2_w2",), ("head_w",))

#: (Cm, Ch) pairs the tensor-core kernels are instantiated for (the CUDA
#: launchers' own list): hr_s2d = 4 (the flagship, 128 + 32 -> 128 -> 16), 2
#: (64 + 32 -> 64 -> 4) and 1 (32 + 32 -> 32 -> 1) at base and fuse width 32.
TC_WIDTHS = ((128, 16), (64, 4), (32, 1))
#: The input-channel chunk of one staged patch, and the head's wgmma width
#: unit: the packed head is ``Ch`` rounded up to 8 columns, zeros beyond Ch.
TC_CK, TC_HEAD_N = 16, 8
#: What a tensor-core launcher returns for a (Cm, Ch) it was not built for.
NOT_INSTANTIATED = 200000
#: (Cm, Ch) pairs the ``"bf16"`` route's kernels are instantiated for.
BF16_WIDTHS = ((128, 16),)
#: (Ca+Cb, Cm, Ch) of the ``"bf16_band"`` route: ``hr_s2d`` 2 (64 + 32 -> 64 ->
#: 4) and 1 (32 + 32 -> 32 -> 1) at base and fuse width 32.
BAND_LAYOUTS = ((96, 64, 4), (64, 32, 1))

#: hr_tail calls that launched the kernels since the last reset
#: (ops.kernels.reset_launch_counts); each call is four kernel launches on
#: the tensor-core route, five on the bf16 one (a pre-pass first), one on the
#: bf16 band route and six on the direct ones
launches = 0
#: the same calls by route
route_launches = {"tensor": 0, "direct": 0, "bf16": 0, "bf16_band": 0, "bf16_direct": 0}


def pack_hr_tail_weights(f1, f2, head, *, bn_eps: float) -> list[torch.Tensor]:
    """Fold BN stats and order the fuse/head parameters for the kernel.

    ``f1``/``f2`` are :class:`floodsr_tpu_torch.nn.resunet.ResBlock` modules
    (``f1`` with a ``proj``), ``head`` the 1×1 :class:`Conv`. Returns float32
    contiguous tensors in :data:`WEIGHT_KEYS` order, in the JAX package's
    layouts: 3×3 kernels HWIO ``[3, 3, Cin, Cout]``, 1×1 kernels ``[Cin, Cout]``.
    """

    def hwio(w):
        return w.permute(2, 3, 1, 0).contiguous()

    def block(blk, with_proj):
        a1, c1 = blk.bn1.folded(bn_eps)
        a2, c2 = blk.bn2.folded(bn_eps)
        out = [
            a1, c1, hwio(blk.conv1.w), blk.conv1.b,
            a2, c2, hwio(blk.conv2.w), blk.conv2.b,
        ]
        if with_proj:
            out += [hwio(blk.proj.w)[0, 0], blk.proj.b]
        return out

    ws = block(f1, True) + block(f2, False) + [hwio(head.w)[0, 0], head.b]
    # detached: the kernels have no backward (:func:`hr_tail` refuses a
    # tensor that requires grad), and a pack outlives the call that built it
    return [w.detach().to(torch.float32).contiguous() for w in ws]


def _affine_relu(x: torch.Tensor, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.relu(x * a[None, :, None, None] + c[None, :, None, None])


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NCHW conv with an HWIO kernel (3×3 pads 1 each side, as SAME does)."""
    if w.ndim == 2:
        w = w[None, None]
    pad = (w.shape[0] - 1) // 2
    return F.conv2d(x, w.permute(3, 2, 0, 1), None, 1, pad) + b[None, :, None, None]


def hr_tail_reference(sr: torch.Tensor, dem: torch.Tensor, *weights) -> torch.Tensor:
    """Plain torch version: the unfused chain. NHWC in, ``[B, H, W, Ch]`` out."""
    w = dict(zip(WEIGHT_KEYS, weights))
    x = torch.cat([sr, dem], dim=-1).permute(0, 3, 1, 2).to(torch.float32)
    y = _conv(_affine_relu(x, w["f1_a1"], w["f1_c1"]), w["f1_w1"], w["f1_b1"])
    y = _conv(_affine_relu(y, w["f1_a2"], w["f1_c2"]), w["f1_w2"], w["f1_b2"])
    y1 = y + _conv(x, w["f1_pw"], w["f1_pb"])
    y = _conv(_affine_relu(y1, w["f2_a1"], w["f2_c1"]), w["f2_w1"], w["f2_b1"])
    y = _conv(_affine_relu(y, w["f2_a2"], w["f2_c2"]), w["f2_w2"], w["f2_b2"])
    y2 = y + y1
    return _conv(y2, w["head_w"], w["head_b"]).permute(0, 2, 3, 1)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """The nearest bf16 value (ties to even) of each element, as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, both f32."""
    x = x.to(torch.float32)
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def hr_tail_reference_bf16(sr: torch.Tensor, dem: torch.Tensor, *weights) -> torch.Tensor:
    """Plain torch version of ``mode="bf16"``. NHWC in, ``[B, H, W, Ch]`` out.

    The chain of :func:`hr_tail_reference` with each convolution's operand and
    weight (the four 3×3 and the projection) rounded to bf16 first; a product
    of two bf16 values is exact in f32, so the f32 convolution of the rounded
    operands is the single-pass product with f32 accumulation. Biases,
    affines, residual adds and every intermediate stay f32. The head is the
    three-pass product of a bf16 split, ``hi·Whi + hi·Wlo + lo·Whi``.
    """
    w = dict(zip(WEIGHT_KEYS, weights))

    def conv(x, wk, bk):
        return _conv(round_bf16(x), round_bf16(w[wk]), w[bk])

    x = torch.cat([sr, dem], dim=-1).permute(0, 3, 1, 2).to(torch.float32)
    y = conv(_affine_relu(x, w["f1_a1"], w["f1_c1"]), "f1_w1", "f1_b1")
    y = conv(_affine_relu(y, w["f1_a2"], w["f1_c2"]), "f1_w2", "f1_b2")
    y1 = y + conv(x, "f1_pw", "f1_pb")
    y = conv(_affine_relu(y1, w["f2_a1"], w["f2_c1"]), "f2_w1", "f2_b1")
    y = conv(_affine_relu(y, w["f2_a2"], w["f2_c2"]), "f2_w2", "f2_b2")
    y2 = y + y1
    y_hi, y_lo = split_bf16(y2)
    w_hi, w_lo = split_bf16(w["head_w"])
    zero = torch.zeros_like(w["head_b"])
    out = (_conv(y_hi, w_hi, zero) + _conv(y_hi, w_lo, zero)) + _conv(y_lo, w_hi, zero)
    return (out + w["head_b"][None, :, None, None]).permute(0, 2, 3, 1)


def tc_eligible(ca: int, cb: int, cm: int, ch: int) -> bool:
    """Whether the tensor-core kernels take these channel counts."""
    return (
        (cm, ch) in TC_WIDTHS and ca > 0 and ca % 4 == 0 and cb % 4 == 0
        and (ca + cb) % TC_CK == 0
    )


def bf16_route(ca: int, cb: int, cm: int, ch: int) -> str:
    """The route of ``mode="bf16"`` for these channel counts."""
    if tc_eligible(ca, cb, cm, ch):
        if (ca + cb, cm, ch) in BAND_LAYOUTS:
            return "bf16_band"
        if (cm, ch) in BF16_WIDTHS:
            return "bf16"
    return "bf16_direct"


#: The ``"bf16_band"`` route's unit: a strip of ``BAND_COLS`` output columns
#: (a 64-pixel tile row less ``BAND_HALO`` pixels each side: four 3×3
#: convolutions) down a band of rows, two rows a step.
BAND_COLS, BAND_HALO = 56, 4


def band_plan(b: int, h: int, w: int, sms: int = 132) -> tuple[int, int, int]:
    """The ``"bf16_band"`` launch's units as its launcher plans them:
    ``(rows a band, bands, strips)``, one block each.

    The rows minimize the waves of blocks (one an SM) times a block's steps
    (two rows each, its own rows and the 2 x ``BAND_HALO`` of the halo), the
    fewest bands among equals; so one tile still fills the card.
    """
    strips = -(-w // BAND_COLS)
    best = None
    for n in range(1, h + 1):
        rows = -(-h // n)
        if -(-h // rows) != n:
            continue  # the same rows as a smaller n
        cost = -(-(b * strips * n) // sms) * ((rows + 1) // 2 + BAND_HALO)
        if best is None or cost < best[0]:
            best = (cost, rows, n)
    return best[1], best[2], strips


def head_columns(ch: int) -> int:
    """The packed head's columns: ``ch`` rounded up to the wgmma's 8."""
    return -(-ch // TC_HEAD_N) * TC_HEAD_N


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, both f32.

    ``tf32`` rounds onto a 10-bit mantissa, nearest with ties away from zero,
    as the kernel's ``cvt.rna.tf32.f32`` does: half an ulp is added to the
    magnitude's bits and the low 13 bits are cleared. ``x - hi`` is exact in
    f32, so ``hi + lo`` carries 21-22 mantissa bits of ``x``.
    """

    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
        rounded = (mag | (bits & -0x80000000)).view(torch.float32)
        return torch.where(torch.isfinite(v), rounded, v)

    x = x.to(torch.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def _padded_head(w: torch.Tensor) -> torch.Tensor:
    """The head's ``[Cm, Ch]`` with zero columns up to :func:`head_columns`."""
    return F.pad(w, (0, head_columns(int(w.shape[-1])) - int(w.shape[-1])))


def a_from_registers(cm: int) -> bool:
    """Whether the tensor-core route at this Cm takes its A operand from
    registers (the small widths' kernel, ``conv_tc_rs_kernel``), so that its
    3×3 and projection slabs hold each chunk's channels transposed
    (:func:`_tc_slabs`)."""
    return cm < 128


def _tc_slabs(m: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """``[taps..., Cin, Cout]`` → ``[Cin/16 * taps, 2, 4, Cout, 4]`` hi/lo slabs.

    A slab's ``[quad q][cout][i]`` holds channel ``4q + i`` of its 16-channel
    chunk, or with ``transposed`` channel ``4i + q``: the k column that
    ``wgmma`` reads there is then the one the A-from-registers kernel puts
    that channel at (a thread's one 16-byte load of a pixel, channels ``4t ..
    4t + 3``, is its fragment at k columns ``t`` and ``t + 4`` of the chunk's
    two k8 steps).
    """
    cin, cout = int(m.shape[-2]), int(m.shape[-1])
    if cin % TC_CK:
        raise ValueError(f"{cin} input channels are not a multiple of {TC_CK}")
    halves = torch.stack(split_tf32(m.reshape(-1, cin, cout)))  # [2, taps, cin, cout]
    taps = halves.shape[1]
    slabs = halves.reshape(2, taps, cin // TC_CK, TC_CK // 4, 4, cout)
    order = (2, 1, 0, 4, 5, 3) if transposed else (2, 1, 0, 3, 5, 4)
    return slabs.permute(*order).reshape(-1, 2, TC_CK // 4, cout, 4)


def pack_hr_tail_tc(weights) -> list[torch.Tensor]:
    """The tensor-core route's weight pack, from the :data:`WEIGHT_KEYS` list.

    One tensor per :data:`TC_PACK_KEYS` entry, ``[slabs, 2, 4, Cout, 4]`` f32:
    per 16-channel chunk and tap of a weight matrix one contiguous slab
    (chunk-major), the hi halves then the lo halves (:func:`split_tf32`), each
    as ``[channel quad][Cout][4 channels]``, which is the no-swizzle K-major
    layout ``wgmma`` reads its B operand in. An entry of two matrices holds the
    first one's slabs, then the second's. Where :func:`a_from_registers` (Cm
    64 and 32), the four convolution entries hold each chunk's channels
    transposed (:func:`_tc_slabs`); the head never. The head's Cout is padded
    to :func:`head_columns` with zeros (``wgmma`` is at least 8 wide); the
    kernels store only its first Ch columns. Build it once per set of weights,
    not per call.
    """
    w = dict(zip(WEIGHT_KEYS, weights))
    transposed = a_from_registers(int(w["f1_b1"].shape[0]))
    w["head_w"] = _padded_head(w["head_w"])
    return [
        torch.cat([
            _tc_slabs(w[key], transposed and keys != ("head_w",)) for key in keys
        ]).contiguous()
        for keys in TC_PACK_KEYS
    ]


def _bf16_slabs(m: torch.Tensor) -> torch.Tensor:
    """``[taps..., Cin, Cout]`` → ``[Cin/16 * taps, 2, Cout, 8]`` bf16 slabs."""
    cin, cout = int(m.shape[-2]), int(m.shape[-1])
    if cin % TC_CK:
        raise ValueError(f"{cin} input channels are not a multiple of {TC_CK}")
    rounded = m.reshape(-1, cin, cout).to(torch.bfloat16)  # [taps, cin, cout]
    taps = rounded.shape[0]
    slabs = rounded.reshape(taps, cin // TC_CK, TC_CK // 8, 8, cout)
    return slabs.permute(1, 0, 2, 4, 3).reshape(-1, TC_CK // 8, cout, 8)


def pack_hr_tail_bf16(weights) -> list[torch.Tensor]:
    """The bf16 route's weight pack, from the :data:`WEIGHT_KEYS` list.

    One tensor per :data:`TC_PACK_KEYS` entry. The four convolution entries
    are ``[slabs, 2, Cout, 8]`` bf16: per 16-channel chunk and tap one
    contiguous slab (chunk-major) of the bf16-rounded weights, as ``[channel
    octet][Cout][8 channels]``: the no-swizzle K-major layout of ``wgmma``'s
    B operand for a 2-byte type, one k16 step a slab. The head entry is the
    tensor-core route's hi/lo TF32 slabs (:func:`pack_hr_tail_tc`, padded as
    there): the head keeps its three-pass product. The ``"bf16_band"`` route
    reads the same pack. Build it once per set of weights.
    """
    w = dict(zip(WEIGHT_KEYS, weights))
    packs = [
        torch.cat([_bf16_slabs(w[key]) for key in keys]).contiguous()
        for keys in TC_PACK_KEYS[:-1]
    ]
    return packs + [_tc_slabs(_padded_head(w["head_w"])).contiguous()]


def hr_tail_reference_3xtf32(
    sr: torch.Tensor, dem: torch.Tensor, *weights, products: int = 3,
    accumulate: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The chain with every product formed from TF32 halves, as the kernel does.

    ``products=3``: ``lo*Whi + hi*Wlo + hi*Whi`` (3xTF32); ``products=1``:
    ``hi*Whi`` alone (plain TF32). A product of two halves is exact in f32;
    the sums run in ``accumulate`` (f64 isolates the split's error from the
    summation's). For the tests: nothing on the main path calls this.
    """
    if products not in (1, 3):
        raise ValueError(f"products must be 1 or 3; got {products}")
    w = dict(zip(WEIGHT_KEYS, weights))

    def conv(x, wk, bk):
        x_hi, x_lo = (t.to(accumulate) for t in split_tf32(x))
        w_hi, w_lo = (t.to(accumulate) for t in split_tf32(w[wk]))
        zero = torch.zeros_like(w[bk], dtype=accumulate)
        y = _conv(x_hi, w_hi, zero)
        if products == 3:
            y = (_conv(x_lo, w_hi, zero) + _conv(x_hi, w_lo, zero)) + y
        return y.to(torch.float32) + w[bk][None, :, None, None]

    x = torch.cat([sr, dem], dim=-1).permute(0, 3, 1, 2).to(torch.float32)
    y = conv(_affine_relu(x, w["f1_a1"], w["f1_c1"]), "f1_w1", "f1_b1")
    y = conv(_affine_relu(y, w["f1_a2"], w["f1_c2"]), "f1_w2", "f1_b2")
    y1 = y + conv(x, "f1_pw", "f1_pb")
    y = conv(_affine_relu(y1, w["f2_a1"], w["f2_c1"]), "f2_w1", "f2_b1")
    y = conv(_affine_relu(y, w["f2_a2"], w["f2_c2"]), "f2_w2", "f2_b2")
    y2 = y + y1
    return conv(y2, "head_w", "head_b").permute(0, 2, 3, 1)


def bf16_scratch(b: int, h: int, w: int, ca: int, cb: int, cm: int) -> dict:
    """The ``"bf16"`` route's scratch, ``{name: (shape, dtype)}`` in launch order.

    ``x_act`` = bf16(relu(f1.bn1(x))) and ``x_raw`` = bf16(x) of x = concat(sr,
    dem), from the pre-pass; ``act_a`` holds f1.conv2's operand, then
    f2.conv2's; ``act_b`` f2.conv1's; each written already activated by the
    launch that computes it. ``y1`` (f32) is the last residual. The wrapper
    takes them from one allocation (:func:`bf16_workspace`).
    """
    cin = ca + cb
    return {
        "x_act": ((b, h, w, cin), torch.bfloat16),
        "x_raw": ((b, h, w, cin), torch.bfloat16),
        "act_a": ((b, h, w, cm), torch.bfloat16),
        "act_b": ((b, h, w, cm), torch.bfloat16),
        "y1": ((b, h, w, cm), torch.float32),
    }


def bf16_workspace(scratch: dict) -> tuple[list[int], int]:
    """Byte offsets of the :func:`bf16_scratch` buffers in one allocation, and its size.

    Each buffer starts on a 256-byte boundary (TMA and the float4 loads need 16).
    """
    offsets, total = [], 0
    for shape, dtype in scratch.values():
        offsets.append(total)
        nbytes = dtype.itemsize
        for n in shape:
            nbytes *= n
        total += -(-nbytes // 256) * 256
    return offsets, total


def _check_weights(weights, cin: int, cm: int, ch: int, device) -> None:
    if len(weights) != len(WEIGHT_KEYS):
        raise ValueError(f"expected {len(WEIGHT_KEYS)} weights; got {len(weights)}")
    want = {
        "f1_a1": (cin,), "f1_c1": (cin,), "f1_w1": (3, 3, cin, cm), "f1_b1": (cm,),
        "f1_a2": (cm,), "f1_c2": (cm,), "f1_w2": (3, 3, cm, cm), "f1_b2": (cm,),
        "f1_pw": (cin, cm), "f1_pb": (cm,),
        "f2_a1": (cm,), "f2_c1": (cm,), "f2_w1": (3, 3, cm, cm), "f2_b1": (cm,),
        "f2_a2": (cm,), "f2_c2": (cm,), "f2_w2": (3, 3, cm, cm), "f2_b2": (cm,),
        "head_w": (cm, ch), "head_b": (ch,),
    }
    for key, t in zip(WEIGHT_KEYS, weights):
        if tuple(t.shape) != want[key]:
            raise ValueError(f"weight {key}: shape {tuple(t.shape)} != {want[key]}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError(
                f"weight {key} must be float32, contiguous and on {device}; "
                f"got {t.dtype} on {t.device}"
            )


def _lib():
    from floodsr_tpu_torch.ops.kernels import _build

    lib = _build.load("hr_tail")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (
        ("hr_tail_launch", [ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]),
        ("hr_tail_tc_launch",
         [ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr]),
        ("hr_tail_bf16_direct_launch",
         [ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]),
        ("hr_tail_bf16_launch",
         [ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
          ptr]),
        ("hr_tail_bf16_band_launch",
         [ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr]),
    ):
        fn = getattr(lib, name)
        if fn.restype is not ctypes.c_int or not fn.argtypes:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    query = lib.hr_tail_tc_a_from_registers
    if query.restype is not ctypes.c_int or not query.argtypes:
        query.restype, query.argtypes = ctypes.c_int, [i32, i32]
        # The kernels' own choice against the pack's channel order: a pack in
        # the other order would give a wrong convolution, silently.
        for cm, ch in TC_WIDTHS:
            built = query(cm, ch)
            if built != int(a_from_registers(cm)):
                raise RuntimeError(
                    f"hr_tail library: A from registers at Cm={cm} is {built} in the "
                    f"kernels but {a_from_registers(cm)} in pack_hr_tail_tc's order"
                )
    return lib


def _check_inputs(sr, dem, weights) -> tuple[int, int, int, int, int, int, int]:
    """Raise on what the kernels do not take; ``(b, h, w, ca, cb, cm, ch)``."""
    for name, t in (("sr", sr), ("dem", dem)):
        if t.device.type != "cuda":
            raise ValueError(f"hr_tail_cuda needs CUDA tensors; {name} is on {t.device}")
        if t.ndim != 4 or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 [B, H, W, C] tensor; got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if sr.shape[:3] != dem.shape[:3] or sr.device != dem.device:
        raise ValueError(
            f"sr {tuple(sr.shape)} and dem {tuple(dem.shape)} must share "
            "batch, height, width and device"
        )
    b, h, w, ca = (int(v) for v in sr.shape)
    cb = int(dem.shape[3])
    if len(weights) != len(WEIGHT_KEYS):
        raise ValueError(f"expected {len(WEIGHT_KEYS)} weights; got {len(weights)}")
    cm = int(weights[WEIGHT_KEYS.index("f1_b1")].shape[0])
    ch = int(weights[WEIGHT_KEYS.index("head_b")].shape[0])
    _check_weights(weights, ca + cb, cm, ch, sr.device)
    if b * h * w * max(ca + cb, cm) >= 2**31 or b * ((cm + 31) // 32) > 65535:
        raise ValueError(f"batch {tuple(sr.shape)} exceeds the kernel's index range")
    if (h + 3) // 4 > 65535:
        raise ValueError(f"height {h} exceeds the kernel's grid")
    return b, h, w, ca, cb, cm, ch


def _refuse_grad(sr, dem, weights, tc_pack) -> None:
    """Raise on a tensor that requires grad: the kernels have no backward, so
    their output would silently cut the graph (and freeze the weights)."""
    named = [("sr", sr), ("dem", dem)]
    named += [(f"weight {k}", t) for k, t in zip(WEIGHT_KEYS, weights)]
    named += [(f"packed weight {i}", t) for i, t in enumerate(tc_pack or ())]
    for name, t in named:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise ValueError(
                f"hr_tail has no backward, but {name} requires grad: train through "
                "the unfused tail (ResUNet.forward_train), or detach the tensor"
            )


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _pack_shapes(route: str, want: dict) -> list[tuple[tuple[int, ...], torch.dtype]]:
    """Shape and dtype of each :data:`TC_PACK_KEYS` entry for a tensor-core route."""
    out = []
    for keys in TC_PACK_KEYS:
        cout = int(want[keys[0]].shape[-1])
        slabs = sum(want[key].numel() // (TC_CK * cout) for key in keys)
        if keys == ("head_w",):
            cout = head_columns(cout)
        if route in ("bf16", "bf16_band") and keys != ("head_w",):
            out.append(((slabs, TC_CK // 8, cout, 8), torch.bfloat16))
        else:
            out.append(((slabs, 2, TC_CK // 4, cout, 4), torch.float32))
    return out


def hr_tail_cuda(
    sr: torch.Tensor, dem: torch.Tensor, *weights, tc_pack=None, route: "str | None" = None,
    mode: str = "f32",
) -> torch.Tensor:
    """Launch the hand-written kernels: NHWC f32 contiguous CUDA tensors.

    ``mode`` ("f32" or "bf16") names the arithmetic; within it the widths
    alone choose the route: in f32 tensor cores where :func:`tc_eligible`
    ("tensor", 3xTF32), else the direct kernels ("direct"); in bf16
    :func:`bf16_route` ("bf16", "bf16_band" or "bf16_direct"). A tensor-core
    route needs ``tc_pack`` of the same weights, built once per set of
    weights: :func:`pack_hr_tail_tc` for "tensor", :func:`pack_hr_tail_bf16`
    for "bf16" and "bf16_band". ``route`` forces one (and with it the
    arithmetic), for the tests and for timing routes side by side; the
    tensor-core routes raise on widths they do not take.
    """
    global launches
    from floodsr_tpu_torch.ops.kernels import _build

    _refuse_grad(sr, dem, weights, tc_pack)
    b, h, w, ca, cb, cm, ch = _check_inputs(sr, dem, weights)
    eligible = tc_eligible(ca, cb, cm, ch)
    if route is None:
        if mode not in ("f32", "bf16"):
            raise ValueError(f"mode must be 'f32' or 'bf16'; got {mode!r}")
        if mode == "bf16":
            route = bf16_route(ca, cb, cm, ch)
        else:
            route = "tensor" if eligible else "direct"
    if route not in route_launches:
        raise ValueError(f"route must be one of {sorted(route_launches)}; got {route!r}")
    on_tensor_cores = route in ("tensor", "bf16", "bf16_band")
    label = "tensor-core" if route == "tensor" else route
    if on_tensor_cores:
        if not eligible:
            raise ValueError(
                f"the {label} route takes (Cm, Ch) in {TC_WIDTHS}, Ca and Cb multiples "
                f"of 4 and Ca+Cb a multiple of {TC_CK}; got Ca={ca} Cb={cb} Cm={cm} Ch={ch}"
            )
        if route == "bf16_band" and (ca + cb, cm, ch) not in BAND_LAYOUTS:
            raise ValueError(
                f"the bf16_band route takes (Ca+Cb, Cm, Ch) in {BAND_LAYOUTS}; "
                f"got Ca={ca} Cb={cb} Cm={cm} Ch={ch}"
            )
        packer = "pack_hr_tail_tc" if route == "tensor" else "pack_hr_tail_bf16"
        if tc_pack is None:
            raise ValueError(
                f"the {label} route needs tc_pack={packer}(weights), "
                "built once per set of weights"
            )
        want = dict(zip(WEIGHT_KEYS, weights))
        if len(tc_pack) != len(TC_PACK_KEYS):
            raise ValueError(f"expected {len(TC_PACK_KEYS)} packed weights; got {len(tc_pack)}")
        for keys, t, (shape, dtype) in zip(TC_PACK_KEYS, tc_pack, _pack_shapes(route, want)):
            name = "+".join(keys)
            if (
                tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != sr.device
            ):
                raise ValueError(
                    f"packed weight {name} must be {dtype} {shape}, contiguous, on "
                    f"{sr.device} ({packer}); got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
        # 16-byte bulk copies of the slabs; float4 loads of the inputs and the
        # affines, float2 loads of the biases (the bf16 route's entry point
        # checks its scratch, which TMA reads, again)
        aligned = [("sr", sr), ("dem", dem)]
        aligned += [("packed weight " + "+".join(k), t) for k, t in zip(TC_PACK_KEYS, tc_pack)]
        aligned += [(f"weight {k}", t) for k, t in zip(WEIGHT_KEYS, weights) if t.ndim == 1]
        for name, t in aligned:
            if t.data_ptr() % 16:
                raise ValueError(
                    f"{name} must start on a 16-byte boundary for the {label} route"
                )

    out = torch.empty((b, h, w, ch), dtype=torch.float32, device=sr.device)
    lib = _lib()
    wptrs = ctypes.cast(_pointers(weights), ctypes.c_void_p)
    stream = _build.current_stream_ptr(sr.device)
    with torch.cuda.device(sr.device):
        if route == "bf16_band":
            rc = lib.hr_tail_bf16_band_launch(
                sr.data_ptr(), dem.data_ptr(), b, h, w, ca, cb, cm, ch, wptrs,
                ctypes.cast(_pointers(tc_pack), ctypes.c_void_p), out.data_ptr(), stream,
            )
        elif route == "bf16":
            offsets, nbytes = bf16_workspace(bf16_scratch(b, h, w, ca, cb, cm))
            workspace = torch.empty(nbytes, dtype=torch.uint8, device=sr.device)
            rc = lib.hr_tail_bf16_launch(
                sr.data_ptr(), dem.data_ptr(), b, h, w, ca, cb, cm, ch, wptrs,
                ctypes.cast(_pointers(tc_pack), ctypes.c_void_p),
                *[workspace.data_ptr() + off for off in offsets], out.data_ptr(), stream,
            )
        else:
            buf_p = torch.empty((b, h, w, cm), dtype=torch.float32, device=sr.device)
            buf_y = torch.empty_like(buf_p)
            if route == "tensor":
                rc = lib.hr_tail_tc_launch(
                    sr.data_ptr(), dem.data_ptr(), b, h, w, ca, cb, cm, ch, wptrs,
                    ctypes.cast(_pointers(tc_pack), ctypes.c_void_p),
                    buf_p.data_ptr(), buf_y.data_ptr(), out.data_ptr(), stream,
                )
            else:
                fn = lib.hr_tail_launch if route == "direct" else lib.hr_tail_bf16_direct_launch
                rc = fn(
                    sr.data_ptr(), dem.data_ptr(), b, h, w, ca, cb, cm, ch, wptrs,
                    buf_p.data_ptr(), buf_y.data_ptr(), out.data_ptr(), stream,
                )
    if rc == NOT_INSTANTIATED:
        raise ValueError(f"the {label} kernels were not built for Cm={cm}, Ch={ch}")
    _build.check(rc, f"hr_tail ({route} route)")
    launches += 1
    route_launches[route] += 1
    return out


def hr_tail(
    sr: torch.Tensor, dem: torch.Tensor, *weights, tc_pack=None, mode: str = "f32"
) -> torch.Tensor:
    """Fused tail ``[B,H,W,Ca] + [B,H,W,Cb] → [B,H,W,Ch]``: kernel on CUDA, plain on CPU.

    ``mode`` "f32" or "bf16" (the module docstring says what each computes).
    Raises on a tensor that requires grad, on either device: neither the
    kernels nor this dispatch have a backward.
    ``tc_pack`` (:func:`pack_hr_tail_tc` for "f32", :func:`pack_hr_tail_bf16`
    for "bf16") is read only by the tensor-core routes on the card, which
    need it.
    """
    if mode not in ("f32", "bf16"):
        raise ValueError(f"mode must be 'f32' or 'bf16'; got {mode!r}")
    _refuse_grad(sr, dem, weights, tc_pack)
    if sr.device.type == "cuda":
        return hr_tail_cuda(sr, dem, *weights, tc_pack=tc_pack, mode=mode)
    if sr.device.type != "cpu":
        raise ValueError(f"unsupported device {sr.device}")
    if mode == "bf16":
        return hr_tail_reference_bf16(sr, dem, *weights)
    return hr_tail_reference(sr, dem, *weights)
