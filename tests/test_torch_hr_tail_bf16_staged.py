"""The dataflow of K1's bf16 route (``hr_tail(mode="bf16")`` on the card), on the CPU.

The route moves where the bf16 rounding happens, not what is computed: each
launch applies the NEXT convolution's affine and ReLU in its epilogue and
stores that operand as bf16; the next launch reads it by TMA, which fills the
pixels outside the image with zeros; the projection reads ``bf16(x)`` that a
pre-pass stored, at the block's own pixels only. :func:`staged_bf16` renders
that dataflow in plain PyTorch, block by block, with the weights taken from
the route's own pack, and must equal ``hr_tail_reference_bf16`` bit for bit:
the stored values are the ones the reference rounds at each convolution, and
the zero fill is the SAME padding after the activation. Through it the route's
dataflow is held against the Pallas kernel in interpret mode, ``mode="bf16"``.
The kernel itself runs only on the card (``tests/test_torch_cuda_bf16.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from floodsr_tpu.ops.pallas.hr_tail import hr_tail_pallas
from floodsr_tpu_torch.ops.kernels import hr_tail as ht

pytestmark = pytest.mark.unit

#: The blocks the dataflow is rendered in: image rows x columns, the route's
#: unit on the card. The result must not depend on it.
BLOCK = (2, 64)


def _weights(ca, cb, cm, ch, seed, offsets=False):
    rng = np.random.default_rng(seed)
    cin = ca + cb
    shapes = {
        "f1_a1": (cin,), "f1_c1": (cin,), "f1_w1": (3, 3, cin, cm), "f1_b1": (cm,),
        "f1_a2": (cm,), "f1_c2": (cm,), "f1_w2": (3, 3, cm, cm), "f1_b2": (cm,),
        "f1_pw": (cin, cm), "f1_pb": (cm,),
        "f2_a1": (cm,), "f2_c1": (cm,), "f2_w1": (3, 3, cm, cm), "f2_b1": (cm,),
        "f2_a2": (cm,), "f2_c2": (cm,), "f2_w2": (3, 3, cm, cm), "f2_b2": (cm,),
        "head_w": (cm, ch), "head_b": (ch,),
    }
    out = []
    for key in ht.WEIGHT_KEYS:
        shape = shapes[key]
        if key.endswith(("_a1", "_a2")):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) > 1:
            v = rng.normal(0.0, 1.0 / np.sqrt(int(np.prod(shape[:-1]))), shape)
        elif offsets and key.endswith(("_c1", "_c2")):
            v = np.full(shape, 2.0)  # relu(c) != 0: padding before the affine would show
        else:
            v = rng.normal(0.0, 0.1, shape)
        out.append(v.astype(np.float32))
    return out


def _inputs(b, h, w, ca, cb, seed):
    rng = np.random.default_rng(seed)
    sr = np.abs(rng.normal(0, 1, (b, h, w, ca))).astype(np.float32)
    dem = np.abs(rng.normal(0, 1, (b, h, w, cb))).astype(np.float32)
    return sr, dem


def _unpack(slabs, taps):
    """The route's bf16 slabs ``[chunks * taps, 2, cout, 8]`` back to ``[taps, cin, cout]`` f32."""
    n, _, cout, _ = slabs.shape
    chunks = n // taps
    m = slabs.reshape(chunks, taps, 2, cout, 8).permute(1, 0, 2, 4, 3)
    return m.reshape(taps, chunks * ht.TC_CK, cout).float()


def tma_box(t, b, y, x, h, w):
    """``t[b, y:y+h, x:x+w]`` of an NHWC tensor, zeros where the box leaves it.

    What a TMA load of a box at (x, y) writes to shared memory: the start may
    be negative and the box may run past the tensor; those elements are 0.
    """
    _, H, W, C = t.shape
    box = torch.zeros((h, w, C), dtype=t.dtype)
    y0, y1, x0, x1 = max(y, 0), min(y + h, H), max(x, 0), min(x + w, W)
    if y1 > y0 and x1 > x0:
        box[y0 - y : y1 - y, x0 - x : x1 - x] = t[b, y0:y1, x0:x1]
    return box


def _blocks(t, block):
    _, H, W, _ = t.shape
    rows, cols = block
    for b in range(t.shape[0]):
        for y0 in range(0, H, rows):
            for x0 in range(0, W, cols):
                yield b, y0, x0, min(rows, H - y0), min(cols, W - x0)


def _conv_blocks(operand, w, block, halo):
    """The convolution's sums from what the blocks read, NCHW f32 ``[B, Cout, H, W]``.

    Each block's box of the stored operand (``block`` pixels and a halo,
    zeros outside the image) is put back where it came from on a canvas with a
    border of ``halo``; every pixel the convolution reads must have come in
    that way. The canvas is then convolved without padding.
    """
    B, H, W, C = operand.shape
    canvas = torch.full((B, H + 2 * halo, W + 2 * halo, C), float("nan"), dtype=operand.dtype)
    rows, cols = block
    for b, y0, x0, hh, ww in _blocks(operand, block):
        box = tma_box(operand, b, y0 - halo, x0 - halo, rows + 2 * halo, cols + 2 * halo)
        canvas[b, y0 : y0 + hh + 2 * halo, x0 : x0 + ww + 2 * halo] = box[: hh + 2 * halo, : ww + 2 * halo]
    assert not canvas.isnan().any()
    kernel = w.reshape(2 * halo + 1, 2 * halo + 1, *w.shape[-2:]).permute(3, 2, 0, 1)
    return F.conv2d(canvas.float().permute(0, 3, 1, 2), kernel)


def staged_bf16(sr, dem, *weights, block=BLOCK):
    """The bf16 route's dataflow in plain torch: ``(out, {scratch name: stored tensor})``.

    NHWC f32 in, ``[B, H, W, Ch]`` out. Every operand a convolution reads is a
    bf16 tensor that the launch before it stored (or the pre-pass), read in
    boxes of ``block`` (rows, columns) pixels with a halo of 1; the weights come from
    ``pack_hr_tail_bf16``.
    """
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    pack = ht.pack_hr_tail_bf16(weights)
    cm = w["f1_b1"].shape[0]
    w1 = _unpack(pack[0], 9)
    w2_pw = pack[1]
    n_w2 = 9 * cm // ht.TC_CK
    w2, pw = _unpack(w2_pw[:n_w2], 9), _unpack(w2_pw[n_w2:], 1)
    f2w1, f2w2 = _unpack(pack[2], 9), _unpack(pack[3], 9)

    def nhwc(v):
        return v.permute(0, 2, 3, 1)

    def epilogue_act(v, a, c):
        """The next convolution's operand, stored as bf16 (NCHW f32 in, NHWC bf16 out)."""
        return nhwc(torch.relu(v * a[None, :, None, None] + c[None, :, None, None])).to(
            torch.bfloat16
        ).contiguous()

    def bias(k):
        return w[k][None, :, None, None]

    x = torch.cat([sr, dem], dim=-1)
    stored = {
        # the pre-pass
        "x_act": nhwc(torch.relu(x.permute(0, 3, 1, 2) * w["f1_a1"][None, :, None, None]
                                 + w["f1_c1"][None, :, None, None])).to(torch.bfloat16).contiguous(),
        "x_raw": x.to(torch.bfloat16).contiguous(),
    }
    # launch 1: f1.conv1; its epilogue stores f1.conv2's operand
    y = _conv_blocks(stored["x_act"], w1, block, 1) + bias("f1_b1")
    stored["act_a"] = epilogue_act(y, w["f1_a2"], w["f1_c2"])
    # launch 2: f1.conv2 + the projection of bf16(x) at the block's own pixels
    y = _conv_blocks(stored["act_a"], w2, block, 1) + bias("f1_b2")
    y1 = y + (_conv_blocks(stored["x_raw"], pw, block, 0) + bias("f1_pb"))
    stored["y1"] = nhwc(y1).contiguous()
    stored["act_b"] = epilogue_act(y1, w["f2_a1"], w["f2_c1"])
    # launch 3: f2.conv1; its epilogue stores f2.conv2's operand over act_a
    z = _conv_blocks(stored["act_b"], f2w1, block, 1) + bias("f2_b1")
    act_a2 = epilogue_act(z, w["f2_a2"], w["f2_c2"])
    # launch 4: f2.conv2 + y1, then the head (three-pass, as the reference)
    y2 = (_conv_blocks(act_a2, f2w2, block, 1) + bias("f2_b2")) + stored["y1"].permute(0, 3, 1, 2)
    y_hi, y_lo = ht.split_bf16(y2)
    w_hi, w_lo = ht.split_bf16(w["head_w"])
    zero = torch.zeros_like(w["head_b"])
    out = (ht._conv(y_hi, w_hi, zero) + ht._conv(y_hi, w_lo, zero)) + ht._conv(y_lo, w_hi, zero)
    return nhwc(out + bias("head_b")), stored


@pytest.mark.parametrize("offsets", [False, True], ids=["plain", "relu_c_nonzero"])
@pytest.mark.parametrize(
    "b,h,w",
    # 2 x 2 blocks: the right ones ragged, the bottom ones ragged or whole
    [(2, 3, 123), (1, 4, 100)],
)
def test_staged_dataflow_equals_the_plain_bf16_version_bit_for_bit(b, h, w, offsets):
    ca, cb, cm, ch = 16, 16, 16, 4
    weights = [torch.from_numpy(v) for v in _weights(ca, cb, cm, ch, seed=11, offsets=offsets)]
    sr, dem = (torch.from_numpy(v) for v in _inputs(b, h, w, ca, cb, seed=12))
    got, _ = staged_bf16(sr, dem, *weights)
    want = ht.hr_tail_reference_bf16(sr, dem, *weights)
    assert got.shape == want.shape == (b, h, w, ch)
    assert torch.equal(got, want)
    # and the rounding is real: the f32 chain differs
    assert not torch.equal(want, ht.hr_tail_reference(sr, dem, *weights))


def test_tma_box_fills_zeros_outside_the_image():
    t = torch.arange(2 * 3 * 4 * 8, dtype=torch.float32).reshape(2, 3, 4, 8).to(torch.bfloat16)
    box = tma_box(t, 1, -1, -1, 6, 66)
    assert box.shape == (6, 66, 8) and box.dtype == torch.bfloat16
    assert torch.equal(box[1:4, 1:5], t[1])
    inside = torch.zeros(6, 66, dtype=torch.bool)
    inside[1:4, 1:5] = True
    assert not box[~inside].any()


def test_staged_dataflow_agrees_with_the_pallas_kernel_in_bf16_mode():
    b, h, w, ca, cb, cm, ch = 2, 16, 24, 16, 16, 16, 4
    weights = _weights(ca, cb, cm, ch, seed=13)
    sr, dem = _inputs(b, h, w, ca, cb, seed=14)
    want = np.asarray(hr_tail_pallas(
        jnp.asarray(sr), jnp.asarray(dem), *[jnp.asarray(v) for v in weights],
        band=8, interpret=True, mode="bf16",
    ))
    tw = [torch.from_numpy(v) for v in weights]
    got = staged_bf16(torch.from_numpy(sr), torch.from_numpy(dem), *tw)[0].numpy()
    f32 = ht.hr_tail_reference(torch.from_numpy(sr), torch.from_numpy(dem), *tw).numpy()
    # Products of bf16 values are exact in f32 on both sides; the f32 sums run
    # in another order, so an operand within an f32 rounding of a bf16 tie
    # may round the other way (2^-9 of it, one term among hundreds): at most
    # 4e-3 of the output's range, and rare, so the root mean square of the
    # difference stays under a quarter of the bf16 result's distance to f32.
    scale = float(np.abs(want).max())
    err, gap = float(np.abs(got - want).max()), float(np.abs(want - f32).max())
    assert gap > 1e-3 * scale
    assert err <= 4e-3 * scale, (err, scale)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))  # noqa: E731
    assert rms(got - want) < 0.25 * rms(want - f32)


def test_the_wrapper_scratch_is_what_the_dataflow_stores():
    b, h, w, ca, cb, cm, ch = 1, 5, 70, 16, 16, 16, 4
    weights = [torch.from_numpy(v) for v in _weights(ca, cb, cm, ch, seed=15)]
    sr, dem = (torch.from_numpy(v) for v in _inputs(b, h, w, ca, cb, seed=16))
    _, stored = staged_bf16(sr, dem, *weights)
    scratch = ht.bf16_scratch(b, h, w, ca, cb, cm)
    assert list(scratch) == ["x_act", "x_raw", "act_a", "act_b", "y1"]
    assert {k: (tuple(t.shape), t.dtype) for k, t in stored.items()} == scratch
    # at the flagship's widths, 8 tiles: 4 bf16 operands and one f32 residual
    flagship = ht.bf16_scratch(8, 128, 128, 128, 32, 128)
    nbytes = {k: int(np.prod(s)) * (2 if d == torch.bfloat16 else 4) for k, (s, d) in flagship.items()}
    assert nbytes == {
        "x_act": 41943040, "x_raw": 41943040, "act_a": 33554432, "act_b": 33554432, "y1": 67108864,
    }
    # one allocation, each buffer on a 256-byte boundary (TMA and float4 need 16)
    offsets, total = ht.bf16_workspace(flagship)
    assert offsets == [0, 41943040, 83886080, 117440512, 150994944] and total == 218103808
    offsets, total = ht.bf16_workspace(scratch)
    assert all(o % 256 == 0 for o in offsets) and offsets == sorted(offsets)
    assert total >= sum(int(np.prod(s)) * d.itemsize for s, d in scratch.values())


@pytest.mark.parametrize("block", [(1, 16), (3, 40), (5, 7)], ids=["1x16", "3x40", "5x7"])
def test_staged_dataflow_does_not_depend_on_the_block_shape(block):
    # the boxes are put back where they came from: any block shape, ragged at
    # the right and bottom edges, reads the same operand and gives the same bits
    b, h, w, ca, cb, cm, ch = 2, 7, 45, 16, 16, 16, 4
    weights = [torch.from_numpy(v) for v in _weights(ca, cb, cm, ch, seed=17, offsets=True)]
    sr, dem = (torch.from_numpy(v) for v in _inputs(b, h, w, ca, cb, seed=18))
    got, stored = staged_bf16(sr, dem, *weights, block=block)
    want, want_stored = staged_bf16(sr, dem, *weights)
    assert torch.equal(got, want)
    assert torch.equal(got, ht.hr_tail_reference_bf16(sr, dem, *weights))
    assert all(torch.equal(stored[k], want_stored[k]) for k in want_stored)
