"""The dataflow of K1's bf16 band route (``hr_tail(mode="bf16")`` at ``hr_s2d`` 2 and 1), on the CPU.

The band route computes the whole bf16 chain of one unit in one block: a
strip of ``BAND_COLS`` output columns down a band of rows (``band_plan``),
every operand on chip. It reads x in f32 once, over the unit's pixels and a
halo of ``BAND_HALO`` = 4 each side (four 3×3 convolutions), forms
``bf16(relu(f1.bn1 x))`` and ``bf16(x)`` itself, and each convolution then
shrinks the window by one pixel a side; after each activation the pixels
outside the image are zeroed, at that tensor's own rows and columns (SAME
padding after the activation, ``relu(c) != 0``). :func:`band_bf16` renders
that dataflow in plain PyTorch, unit by unit, with the weights taken from the
route's own pack, and must equal ``hr_tail_reference_bf16`` bit for bit. The
kernel itself runs only on the card (``tests/test_torch_cuda_kernels.py``).
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from floodsr_tpu.ops.pallas.hr_tail import hr_tail_pallas
from floodsr_tpu_torch.ops.kernels import hr_tail as ht

pytestmark = pytest.mark.unit

#: (Ca, Cb, Cm, Ch) of the JAX package's HR layouts hr_s2d 2 and 1.
LAYOUTS = {2: (64, 32, 64, 4), 1: (32, 32, 32, 1)}


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
            v = np.full(shape, 2.0)  # relu(c) != 0: a missed edge zeroing would show
        else:
            v = rng.normal(0.0, 0.1, shape)
        out.append(v.astype(np.float32))
    return out


def _inputs(b, h, w, ca, cb, seed):
    rng = np.random.default_rng(seed)
    sr = np.abs(rng.normal(0, 1, (b, h, w, ca))).astype(np.float32)
    dem = np.abs(rng.normal(0, 1, (b, h, w, cb))).astype(np.float32)
    return sr, dem


def _case(s2d, b, h, w, seed, offsets=False):
    ca, cb, cm, ch = LAYOUTS[s2d]
    weights = [torch.from_numpy(v) for v in _weights(ca, cb, cm, ch, seed, offsets)]
    sr, dem = (torch.from_numpy(v) for v in _inputs(b, h, w, ca, cb, seed + 1))
    return sr, dem, weights


def _unpack(slabs, taps):
    """The route's bf16 slabs ``[chunks * taps, 2, cout, 8]`` back to ``[taps, cin, cout]`` f32."""
    n, _, cout, _ = slabs.shape
    chunks = n // taps
    m = slabs.reshape(chunks, taps, 2, cout, 8).permute(1, 0, 2, 4, 3)
    return m.reshape(taps, chunks * ht.TC_CK, cout).float()


def _window(t, b, y, x, h, w):
    """``t[b, y:y+h, x:x+w]`` of an NHWC tensor, zeros where the window leaves it."""
    _, H, W, C = t.shape
    box = torch.zeros((h, w, C), dtype=t.dtype)
    y0, y1, x0, x1 = max(y, 0), min(y + h, H), max(x, 0), min(x + w, W)
    if y1 > y0 and x1 > x0:
        box[y0 - y : y1 - y, x0 - x : x1 - x] = t[b, y0:y1, x0:x1]
    return box


def _on_image(fn, v, y, x, H, W, k):
    """``fn`` (an unpadded k×k convolution) of the window ``v`` (CHW, its first
    pixel at image row ``y``, column ``x``) as the whole image's convolution
    sums it: ``v`` goes onto a canvas of the image and a border of ``k // 2``
    (NaN where ``v`` does not reach), the canvas is convolved whole, and the
    window's own outputs are read back where they lie in the image (zeros
    outside it: no output reads those). A NaN read back is a pixel the window
    did not hold."""
    p = k // 2
    c, h, w = v.shape
    # NHWC storage seen as NCHW, as the reference's tensors are: the CPU
    # convolution picks its order of summation by memory format and shape
    canvas = torch.full((1, H + 2 * p, W + 2 * p, c), float("nan")).permute(0, 3, 1, 2)
    r0, r1 = max(y + p, 0), min(y + p + h, H + 2 * p)
    c0, c1 = max(x + p, 0), min(x + p + w, W + 2 * p)
    canvas[0, :, r0:r1, c0:c1] = v[:, r0 - y - p : r1 - y - p, c0 - x - p : c1 - x - p]
    full = fn(canvas)[0]
    out = torch.zeros((full.shape[0], h - 2 * p, w - 2 * p))
    ys, xs = y + p, x + p  # the window's first output pixel
    r0, r1, c0, c1 = max(ys, 0), min(ys + h - 2 * p, H), max(xs, 0), min(xs + w - 2 * p, W)
    if r1 > r0 and c1 > c0:
        out[:, r0 - ys : r1 - ys, c0 - xs : c1 - xs] = full[:, r0:r1, c0:c1]
    assert not out.isnan().any(), "the window did not hold a pixel its convolution reads"
    return out


def band_bf16(sr, dem, *weights, rows=None, cols=ht.BAND_COLS):
    """The band route's dataflow in plain torch: ``(out, units)``.

    Every unit (image, strip of ``cols`` output columns, band of ``rows``
    output rows; ``rows`` from :func:`ht.band_plan` unless given) reads x on
    its pixels and a halo of 4 (zeros outside the image), then runs the chain
    on the shrinking window (:func:`_on_image`), zeroing each activation
    outside the image; its own rows and columns of the output are written,
    and every output pixel must be written exactly once.
    """
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    pack = ht.pack_hr_tail_bf16(weights)
    cm = w["f1_b1"].shape[0]
    n_w2 = 9 * cm // ht.TC_CK
    w1, w2, pw = _unpack(pack[0], 9), _unpack(pack[1][:n_w2], 9), _unpack(pack[1][n_w2:], 1)
    f2w1, f2w2 = _unpack(pack[2], 9), _unpack(pack[3], 9)
    B, H, W, _ = sr.shape
    if rows is None:
        rows = ht.band_plan(B, H, W)[0]
    halo = ht.BAND_HALO
    x = torch.cat([sr, dem], dim=-1)
    w_hi, w_lo = ht.split_bf16(w["head_w"])
    zero = torch.zeros_like(w["head_b"])
    out = torch.full((B, H, W, w["head_b"].shape[0]), float("nan"))
    written = torch.zeros((B, H, W), dtype=torch.int32)

    def conv(v, y, x0, m, bias):
        """The k×k convolution (m: [taps, cin, cout]) of the window v at (y, x0), + bias."""
        k = int(round(m.shape[0] ** 0.5))
        kernel = m.reshape(k, k, *m.shape[-2:]).permute(3, 2, 0, 1)
        return _on_image(
            lambda c: F.conv2d(c, kernel) + bias[None, :, None, None], v, y, x0, H, W, k
        )

    def head(v, y, x0, m):
        return _on_image(lambda c: ht._conv(c, m, zero), v, y, x0, H, W, 1)

    def act(v, a, c, y, x0):
        """The next convolution's operand: affine, ReLU, zero outside the
        image (v's first pixel is image row y, column x0), bf16."""
        r = torch.arange(v.shape[1])[:, None] + y
        q = torch.arange(v.shape[2])[None, :] + x0
        inside = (r >= 0) & (r < H) & (q >= 0) & (q < W)
        t = torch.relu(v * a[:, None, None] + c[:, None, None])
        return ht.round_bf16(torch.where(inside, t, torch.zeros(())))

    units = 0
    for b in range(B):
        for y0 in range(0, H, rows):
            for x0 in range(0, W, cols):
                units += 1
                rb, cb_ = min(rows, H - y0), min(cols, W - x0)
                ys, xs = y0 - halo, x0 - halo
                xw = _window(x, b, ys, xs, rb + 2 * halo, cols + 2 * halo).permute(2, 0, 1)
                y = conv(act(xw, w["f1_a1"], w["f1_c1"], ys, xs), ys, xs, w1, w["f1_b1"])
                y = conv(act(y, w["f1_a2"], w["f1_c2"], ys + 1, xs + 1), ys + 1, xs + 1, w2,
                         w["f1_b2"])
                proj = conv(ht.round_bf16(xw[:, 2:-2, 2:-2]), ys + 2, xs + 2, pw, w["f1_pb"])
                y1 = y + proj
                z = conv(act(y1, w["f2_a1"], w["f2_c1"], ys + 2, xs + 2), ys + 2, xs + 2, f2w1,
                         w["f2_b1"])
                y2 = conv(act(z, w["f2_a2"], w["f2_c2"], ys + 3, xs + 3), ys + 3, xs + 3, f2w2,
                          w["f2_b2"])
                y2 = y2 + y1[:, 2:-2, 2:-2]
                y_hi, y_lo = ht.split_bf16(y2)
                o = (head(y_hi, y0, x0, w_hi) + head(y_hi, y0, x0, w_lo)) + head(
                    y_lo, y0, x0, w_hi
                )
                o = (o + w["head_b"][:, None, None]).permute(1, 2, 0)
                out[b, y0 : y0 + rb, x0 : x0 + cb_] = o[:rb, :cb_]
                written[b, y0 : y0 + rb, x0 : x0 + cb_] += 1
    assert torch.equal(written, torch.ones_like(written)), "a pixel written other than once"
    return out, units


# Heights that are not a multiple of the band, widths that are not a multiple
# of the strip (the last strip ragged); plain weights and relu(c) != 0.
@pytest.mark.parametrize("offsets", [False, True], ids=["plain", "relu_c_nonzero"])
@pytest.mark.parametrize("s2d,b,h,w", [(2, 2, 11, 61), (1, 1, 13, 120)], ids=["s2d2", "s2d1"])
def test_band_dataflow_equals_the_plain_bf16_version_bit_for_bit(s2d, b, h, w, offsets):
    sr, dem, weights = _case(s2d, b, h, w, seed=20 + s2d, offsets=offsets)
    got, units = band_bf16(sr, dem, *weights, rows=5)
    want = ht.hr_tail_reference_bf16(sr, dem, *weights)
    assert units == b * -(-h // 5) * -(-w // ht.BAND_COLS) > b
    assert torch.equal(got, want)
    # and the rounding is real: the f32 chain differs
    assert not torch.equal(want, ht.hr_tail_reference(sr, dem, *weights))


# More than one band height and column span, the launcher's own plan among
# them: the windows are cut differently, the bits are the same.
@pytest.mark.parametrize("rows,cols", [(None, ht.BAND_COLS), (2, 24), (9, 7)],
                         ids=["planned", "rows2_cols24", "rows9_cols7"])
def test_band_dataflow_does_not_depend_on_the_unit(rows, cols):
    sr, dem, weights = _case(1, 1, 17, 70, seed=30, offsets=True)
    got, _ = band_bf16(sr, dem, *weights, rows=rows, cols=cols)
    assert torch.equal(got, ht.hr_tail_reference_bf16(sr, dem, *weights))


@pytest.mark.parametrize("s2d", [2, 1])
def test_band_dataflow_agrees_with_the_pallas_kernel_in_bf16_mode(s2d):
    b, h, w = 1, 32, 40
    ca, cb, cm, ch = LAYOUTS[s2d]
    weights = _weights(ca, cb, cm, ch, seed=40 + s2d)
    sr, dem = _inputs(b, h, w, ca, cb, seed=41 + s2d)
    want = np.asarray(hr_tail_pallas(
        jnp.asarray(sr), jnp.asarray(dem), *[jnp.asarray(v) for v in weights],
        band=16, interpret=True, mode="bf16",
    ))
    tw = [torch.from_numpy(v) for v in weights]
    got = band_bf16(torch.from_numpy(sr), torch.from_numpy(dem), *tw, rows=7)[0].numpy()
    f32 = ht.hr_tail_reference(torch.from_numpy(sr), torch.from_numpy(dem), *tw).numpy()
    # Products of bf16 values are exact in f32 on both sides; the f32 sums run
    # in another order, so an operand within an f32 rounding of a bf16 tie may
    # round the other way: rare, so the root mean square of the difference
    # stays under a quarter of the bf16 result's distance to f32, and no pixel
    # departs by more than chip_smoke.py's BF16_GATE of the output's range.
    scale = float(np.abs(want).max())
    err, gap = float(np.abs(got - want).max()), float(np.abs(want - f32).max())
    assert gap > 1e-3 * scale
    assert err <= 1e-2 * scale, (err, scale)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))  # noqa: E731
    assert rms(got - want) < 0.25 * rms(want - f32)


def test_band_plan_fills_the_card_at_one_tile():
    # the layouts' tiles (256² at hr_s2d 2, 512² at 1): one tile is 130 blocks,
    # over the H100's 132 SMs less 4; 8 tiles one or two waves
    assert ht.band_plan(1, 256, 256) == (10, 26, 5)
    assert ht.band_plan(1, 512, 512) == (40, 13, 10)
    assert ht.band_plan(8, 256, 256) == (86, 3, 5)
    assert ht.band_plan(8, 512, 512) == (171, 3, 10)
    for b, side in ((1, 256), (1, 512)):
        rows, bands, strips = ht.band_plan(b, side, side)
        assert 128 <= b * bands * strips <= 132 and bands * rows >= side > (bands - 1) * rows


class _FakeLibrary:
    """Stands for the built ``libhr_tail.so``: every launcher returns 0 and
    records its name; ``hr_tail_tc_a_from_registers`` answers as the pack."""

    def __init__(self):
        self.called = []
        owner = self

        class _Fn:
            def __init__(self, name):
                self.restype, self.argtypes, self.name = ctypes.c_int, None, name

            def __call__(self, *args):
                if self.name == "hr_tail_tc_a_from_registers":
                    return int(ht.a_from_registers(args[0]))
                owner.called.append(self.name)
                return 0

        self._fn = _Fn

    def __getattr__(self, name):
        fn = self._fn(name)
        setattr(self, name, fn)
        return fn


@contextlib.contextmanager
def _stubbed_card(monkeypatch):
    """``hr_tail_cuda`` on CPU tensors with the library stubbed: no device
    check, no stream, and every ``torch.empty`` the wrapper asks for recorded."""
    from floodsr_tpu_torch.ops.kernels import _build

    lib = _FakeLibrary()
    allocs = []
    empty = torch.empty

    def recording_empty(*args, **kw):
        t = empty(*args, **kw)
        allocs.append((tuple(t.shape), t.dtype))
        return t

    def inputs_as_on_card(sr, dem, weights):
        b, h, w, ca = (int(v) for v in sr.shape)
        cm = int(weights[ht.WEIGHT_KEYS.index("f1_b1")].shape[0])
        ch = int(weights[ht.WEIGHT_KEYS.index("head_b")].shape[0])
        return b, h, w, ca, int(dem.shape[3]), cm, ch

    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "current_stream_ptr", lambda device: 0)
    monkeypatch.setattr(ht, "_check_inputs", inputs_as_on_card)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", recording_empty)
    yield lib, allocs


@pytest.mark.parametrize("s2d", [2, 1, 4])
def test_the_wrapper_takes_the_band_route_and_allocates_no_scratch(monkeypatch, s2d):
    ca, cb, cm, ch = {**LAYOUTS, 4: (128, 32, 128, 16)}[s2d]
    b, h, w = 2, 8, 16
    weights = [torch.from_numpy(v) for v in _weights(ca, cb, cm, ch, seed=50)]
    sr, dem = (torch.from_numpy(v) for v in _inputs(b, h, w, ca, cb, seed=51))
    pack = ht.pack_hr_tail_bf16(weights)
    route = "bf16" if s2d == 4 else "bf16_band"
    assert ht.bf16_route(ca, cb, cm, ch) == route
    counts, launches = dict(ht.route_launches), ht.launches
    try:
        with _stubbed_card(monkeypatch) as (lib, allocs):
            out = ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, mode="bf16")
            assert lib.called == [{"bf16": "hr_tail_bf16_launch",
                                   "bf16_band": "hr_tail_bf16_band_launch"}[route]]
            assert tuple(out.shape) == (b, h, w, ch)
            assert ht.route_launches[route] == counts[route] + 1
            # the band route allocates its output alone; the bf16 route one workspace more
            scratch = [] if route == "bf16_band" else [
                ((ht.bf16_workspace(ht.bf16_scratch(b, h, w, ca, cb, cm))[1],), torch.uint8)
            ]
            assert allocs == [((b, h, w, ch), torch.float32), *scratch]
            if route == "bf16_band":
                # a forced "bf16" at these widths goes to the launcher, which
                # was not built for them (NOT_INSTANTIATED on the card)
                ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16")
                assert lib.called[-1] == "hr_tail_bf16_launch"
            else:
                with pytest.raises(ValueError, match="bf16_band route takes"):
                    ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16_band")
    finally:
        ht.route_launches.update(counts)
        ht.launches = launches


def test_bf16_routes_by_channel_counts():
    assert ht.bf16_route(64, 32, 64, 4) == "bf16_band"
    assert ht.bf16_route(32, 32, 32, 1) == "bf16_band"
    assert ht.bf16_route(128, 32, 128, 16) == "bf16"
    # the tensor-core widths with another input width, and widths off them
    assert ht.bf16_route(48, 16, 64, 4) == "bf16_direct"
    assert ht.bf16_route(16, 16, 16, 4) == "bf16_direct"
