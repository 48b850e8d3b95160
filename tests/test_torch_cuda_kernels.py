"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode. The file imports no JAX, so it also runs on a machine
without it: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(``tests/test_torch_cuda_bf16.py`` holds K1's bf16 routes the same way).
"""

import numpy as np
import pytest
import torch

from floodsr_tpu_torch.device import set_strict_f32
from floodsr_tpu_torch.ops import costgrow as cg
from floodsr_tpu_torch.ops.kernels import hr_tail as ht
from floodsr_tpu_torch.ops.kernels import relax_step as rs
from floodsr_tpu_torch.ops.kernels import tile_stats as ts

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The GPU, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel runs only on the card")
    set_strict_f32()
    return torch.device("cuda")


def _tiles(seed, n, h, w):
    """Terrain-like tiles: tile 1 dips below 0, tile 2 has ties, tile 3 is flat."""
    rng = np.random.default_rng(seed)
    t = (200.0 + np.cumsum(rng.normal(0.0, 0.5, (n, h, w)), axis=2)).astype(np.float32)
    t[1] -= np.float32(t[1].mean())
    t[2] = np.round(t[2] * 2.0) / 2.0
    t[3] = np.float32(123.25)
    return t


# 128x128 and 64x96 split into eight aligned slices and take the one-read
# (cluster) route; 33x31 (a count not divisible by 4) streams with scalar
# loads, 30x30 (divisible by 4, not by 32) with float4 loads.
@pytest.mark.parametrize(
    "h,w,route", [(128, 128, "one_read"), (33, 31, "stream"), (64, 96, "one_read"), (30, 30, "stream")]
)
@pytest.mark.parametrize("pct", [95.0, 100.0])
def test_tile_stats_kernel_equals_plain_version(cuda_device, h, w, route, pct):
    dem = torch.from_numpy(_tiles(4, 6, h, w)).to(cuda_device)
    ts.launches = 0
    ts.route_launches.update(one_read=0, stream=0)
    got = ts.tile_stats(dem, pct)
    torch.cuda.synchronize()
    assert ts.launches == 1
    assert ts.route_launches == {"one_read": int(route == "one_read"), "stream": int(route == "stream")}
    # The bisection replayed on the exact order statistics: bit for bit.
    assert torch.equal(got, ts.tile_stats_reference(dem, pct))


@pytest.mark.parametrize("pct", [50.0, 95.0, 99.9, 100.0])
def test_tile_stats_one_read_route_at_the_scene_tile_size(cuda_device, pct):
    # 512x512: an eighth of a tile is 128 KiB of a block's shared memory. A
    # tile with NaNs and one whose values span the whole exponent range
    # (three select passes) ride along.
    t = _tiles(7, 7, 512, 512)
    t[4, ::7, ::5] = np.nan
    t[5] = np.exp(np.random.default_rng(8).uniform(-40.0, 40.0, (512, 512))).astype(np.float32)
    t[6] = np.float32(0.0)
    dem = torch.from_numpy(t).to(cuda_device)
    ts.route_launches.update(one_read=0, stream=0)
    for _ in range(2):  # twice: a race would not repeat
        got = ts.tile_stats(dem, pct)
        torch.cuda.synchronize()
        assert torch.equal(got, ts.tile_stats_reference(dem, pct))
    assert ts.route_launches == {"one_read": 2, "stream": 0}


@pytest.mark.parametrize("n", [32, 25, 40])
def test_tile_stats_one_read_route_at_the_scene_batch_sizes(cuda_device, n):
    # The scene's batches are 32 tiles of 512x512, then 25: 256 and 200 blocks
    # on the card's SMs, one block each, so the clusters run in more than one
    # wave; 40 tiles make a third. Every tile is held against the plain version.
    t = _tiles(11, n, 512, 512)
    t[n - 1] = t[0][::-1]  # the last cluster of the last wave: a tile of its own
    dem = torch.from_numpy(t).to(cuda_device)
    want = ts.tile_stats_reference(dem, 95.0)
    ts.route_launches.update(one_read=0, stream=0)
    for _ in range(2):  # twice: a race would not repeat
        got = ts.tile_stats(dem, 95.0)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert ts.route_launches == {"one_read": 2, "stream": 0}


def test_tile_stats_streaming_route_on_a_tile_too_large_for_one_read(cuda_device):
    # 640x640 f32 is 1.56 MiB: an eighth of it does not fit a block's shared memory.
    dem = torch.from_numpy(_tiles(9, 4, 640, 640)).to(cuda_device)
    assert not ts.one_read_ok(640 * 640, dem.data_ptr())
    ts.route_launches.update(one_read=0, stream=0)
    got = ts.tile_stats(dem, 95.0)
    torch.cuda.synchronize()
    assert ts.route_launches == {"one_read": 0, "stream": 1}
    assert torch.equal(got, ts.tile_stats_reference(dem, 95.0))


def test_tile_stats_kernel_on_a_view_off_16_byte_alignment(cuda_device):
    # A contiguous view one float into its storage: the count is a multiple
    # of 32, but the tiles do not start on a 16-byte boundary, so the kernel
    # must stream with its scalar loads.
    n, h, w = 6, 32, 32
    flat = torch.from_numpy(_tiles(5, n, h, w).reshape(-1)).to(cuda_device)
    store = torch.empty(flat.numel() + 1, device=cuda_device)
    store[1:] = flat
    dem = store[1:].view(n, h, w)
    assert dem.is_contiguous() and dem.data_ptr() % 16 != 0
    ts.route_launches.update(one_read=0, stream=0)
    got = ts.tile_stats(dem, 95.0)
    torch.cuda.synchronize()
    assert ts.route_launches == {"one_read": 0, "stream": 1}
    assert torch.equal(got, ts.tile_stats_reference(dem, 95.0))


def test_tile_stats_kernel_rejects_what_it_does_not_take(cuda_device):
    with pytest.raises(TypeError, match="float32"):
        ts.tile_stats(torch.zeros(2, 8, 8, dtype=torch.float64, device=cuda_device), 95.0)
    with pytest.raises(ValueError, match="contiguous"):
        ts.tile_stats(torch.zeros(2, 8, 16, device=cuda_device)[:, :, ::2], 95.0)


def _tail_weights(ca, cb, cm, ch, device, seed=0, offsets=False):
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
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif offsets and key.endswith(("_c1", "_c2")):
            v = np.full(shape, 0.5)  # relu(c) != 0: the padding must come after the activation
        else:
            v = rng.normal(0.0, 0.1, shape)
        out.append(torch.from_numpy(v.astype(np.float32)).to(device))
    return out


def _reset_routes():
    ht.launches = 0
    for route in ht.route_launches:
        ht.route_launches[route] = 0


def _routes(**counts):
    """The expected ``route_launches``: the named counts, 0 for every other route."""
    return {route: counts.get(route, 0) for route in ht.route_launches}


def _tail_inputs(b, h, w, ca, cb, device, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    sr = np.abs(rng.normal(0, scale, (b, h, w, ca))).astype(np.float32)
    dem = np.abs(rng.normal(0, scale, (b, h, w, cb))).astype(np.float32)
    return torch.from_numpy(sr).to(device), torch.from_numpy(dem).to(device)


# The flagship's channel widths (128 + 32 → 128 → 16) take the tensor-core
# route, the narrow config the direct one; heights and widths that are not
# multiples of either route's tile (4x64 and 8x32), so the ragged edges and
# the image-edge padding are exercised; one full 128x128 tile.
@pytest.mark.parametrize(
    "b,h,w,ca,cb,cm,ch,route",
    [
        (2, 20, 48, 128, 32, 128, 16, "tensor"),
        (1, 13, 70, 16, 8, 16, 4, "direct"),
        (1, 128, 128, 128, 32, 128, 16, "tensor"),
        (3, 33, 131, 128, 32, 128, 16, "tensor"),
        (1, 5, 3, 64, 16, 128, 16, "tensor"),
        # a 16-channel chunk that holds channels of both inputs
        (1, 9, 70, 68, 12, 128, 16, "tensor"),
    ],
)
def test_hr_tail_kernel_matches_plain_version(cuda_device, b, h, w, ca, cb, cm, ch, route):
    sr, dem = _tail_inputs(b, h, w, ca, cb, cuda_device)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device)
    want = ht.hr_tail_reference(sr, dem, *weights)
    pack = ht.pack_hr_tail_tc(weights) if route == "tensor" else None
    _reset_routes()
    for _ in range(2):  # twice: a missing fence gives wrong sums only sometimes
        got = ht.hr_tail(sr, dem, *weights, tc_pack=pack)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (b, h, w, ch)
        # f32 FMAs (direct) or 3xTF32 products summed in f32 (tensor cores), in
        # another order than cuDNN's (TF32 off): f32-rounding level per layer
        # through five convolutions, held at 1e-4 of the output's range.
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max())
    assert ht.launches == 2
    assert ht.route_launches == _routes(**{route: 2})


def test_hr_tail_both_routes_agree_at_the_flagship_widths(cuda_device):
    # The direct route takes any widths; at the flagship's it must agree with
    # the tensor-core route and the plain version alike. A large BN offset
    # makes relu(c) != 0, which would leak into the edge rows if the padding
    # were applied before the affine.
    b, h, w, ca, cb, cm, ch = 2, 24, 72, 128, 32, 128, 16
    sr, dem = _tail_inputs(b, h, w, ca, cb, cuda_device, seed=3)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device, seed=2)
    for key in ("f1_c1", "f1_c2", "f2_c1", "f2_c2"):
        weights[ht.WEIGHT_KEYS.index(key)].fill_(2.0)
    want = ht.hr_tail_reference(sr, dem, *weights)
    pack = ht.pack_hr_tail_tc(weights)
    _reset_routes()
    tensor = ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="tensor")
    direct = ht.hr_tail_cuda(sr, dem, *weights, route="direct")
    assert ht.route_launches == _routes(tensor=1, direct=1)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((tensor - want).abs().max()) <= 1e-4 * scale
    assert float((direct - want).abs().max()) <= 1e-4 * scale
    # the image's edge rows and columns as well as its inside
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert float((tensor[edge] - want[edge]).abs().max()) <= 1e-4 * scale


def test_hr_tail_tensor_route_holds_f32_level_at_large_features(cuda_device):
    # Features of order 1e4, the flagship's magnitude: a single TF32 product
    # would leave about three decimal digits; the three split products stay at
    # f32-rounding level. The tensor core's f32 accumulator chops where cuDNN's
    # FMAs round, over 540 accumulations a convolution: 1.5e-5 of the range
    # was measured on an H100; held at 3e-5, a third of the gate.
    b, h, w, ca, cb, cm, ch = 1, 32, 64, 128, 32, 128, 16
    sr, dem = _tail_inputs(b, h, w, ca, cb, cuda_device, seed=5, scale=1e4)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device, seed=4)
    want = ht.hr_tail_reference(sr, dem, *weights)
    _reset_routes()
    got = ht.hr_tail(sr, dem, *weights, tc_pack=ht.pack_hr_tail_tc(weights))
    assert ht.route_launches == _routes(tensor=1)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert scale > 1e4 and err <= 3e-5 * scale, (err, scale)


def test_hr_tail_kernel_rejects_what_it_does_not_take(cuda_device):
    weights = _tail_weights(16, 8, 16, 4, cuda_device)
    sr = torch.zeros(1, 8, 8, 16, device=cuda_device)
    dem = torch.zeros(1, 8, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        ht.hr_tail(sr.permute(0, 2, 1, 3), dem, *weights)
    with pytest.raises(ValueError, match="weight f1_w1"):
        ht.hr_tail(sr, dem, *weights[:2], weights[2][:, :, :-1], *weights[3:])
    with pytest.raises(ValueError, match="must share"):
        ht.hr_tail(sr, dem[:, :4].contiguous(), *weights)
    # the tensor-core route takes the flagship's widths only, and its pack
    # must be the one for these weights' shapes
    with pytest.raises(ValueError, match="tensor-core route takes"):
        ht.hr_tail_cuda(sr, dem, *weights, route="tensor")
    with pytest.raises(ValueError, match="route must be one of"):
        ht.hr_tail_cuda(sr, dem, *weights, route="cudnn")
    wide = _tail_weights(128, 32, 128, 16, cuda_device)
    sr_w = torch.zeros(1, 8, 8, 128, device=cuda_device)
    dem_w = torch.zeros(1, 8, 8, 32, device=cuda_device)
    pack = ht.pack_hr_tail_tc(wide)
    # the wrapper never builds the pack itself
    with pytest.raises(ValueError, match="needs tc_pack"):
        ht.hr_tail(sr_w, dem_w, *wide)
    with pytest.raises(ValueError, match=r"packed weight f1_w2\+f1_pw"):
        ht.hr_tail(sr_w, dem_w, *wide, tc_pack=[pack[0], pack[1][:-1].contiguous(), *pack[2:]])
    with pytest.raises(ValueError, match="expected 5 packed"):
        ht.hr_tail(sr_w, dem_w, *wide, tc_pack=pack[:4])
    # float4 loads: an input one float into its storage is refused
    store = torch.zeros(sr_w.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ht.hr_tail(store[1:].view(sr_w.shape), dem_w, *wide, tc_pack=pack)
    # the affines too: a per-channel vector one float into its storage
    k = ht.WEIGHT_KEYS.index("f1_a2")
    store = torch.ones(wide[k].numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="weight f1_a2 must start on a 16-byte boundary"):
        ht.hr_tail(sr_w, dem_w, *wide[:k], store[1:], *wide[k + 1:], tc_pack=pack)


# K1's tensor-core routes at the JAX package's other two HR layouts (hr_s2d 2
# and 1 at base and fuse width 32): (Ca, Cb, Cm, Ch) and the tail's tile side.
LAYOUT_WIDTHS = {2: (64, 32, 64, 4, 256), 1: (32, 32, 32, 1, 512)}


# 8 tiles and 1 of the layout's tile, and an odd height with a ragged width
# (neither a multiple of either route's block).
@pytest.mark.parametrize("s2d", [2, 1])
@pytest.mark.parametrize("shape", ["8_tiles", "1_tile", "odd"])
def test_hr_tail_tensor_core_routes_at_the_layout_widths(cuda_device, s2d, shape):
    ca, cb, cm, ch, tile = LAYOUT_WIDTHS[s2d]
    b, h, w = {"8_tiles": (8, tile, tile), "1_tile": (1, tile, tile), "odd": (2, 37, 133)}[shape]
    sr, dem = _tail_inputs(b, h, w, ca, cb, cuda_device, seed=s2d)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device, seed=10 + s2d)
    want = ht.hr_tail_reference(sr, dem, *weights)
    want16 = ht.hr_tail_reference_bf16(sr, dem, *weights)
    packs = ht.pack_hr_tail_tc(weights), ht.pack_hr_tail_bf16(weights)
    scale, scale16 = float(want.abs().max()), float(want16.abs().max())
    rms_gap = float((want16 - want).square().mean().sqrt())
    _reset_routes()
    for _ in range(2):  # twice: a missing fence gives wrong sums only sometimes
        got = ht.hr_tail(sr, dem, *weights, tc_pack=packs[0])
        got16 = ht.hr_tail(sr, dem, *weights, tc_pack=packs[1], mode="bf16")
        torch.cuda.synchronize()
        assert got.shape == got16.shape == (b, h, w, ch)
        # 3xTF32: the flagship route's bar, 1e-4 of the output's range
        assert float((got - want).abs().max()) <= 1e-4 * scale
        # bf16: flipped roundings only (chip_smoke.py's BF16_GATE), and rare:
        # their rms under a quarter of the distance between bf16 and f32
        err16 = float((got16 - want16).abs().max())
        rms16 = float((got16 - want16).square().mean().sqrt())
        assert err16 <= 1e-2 * scale16 and rms16 < 0.25 * rms_gap, (err16, rms16, rms_gap)
    assert ht.route_launches == _routes(tensor=2, bf16_band=2)


# K1's bf16 band route (one launch, every intermediate on chip) at the layout
# widths: 8 tiles and 1 (the launcher's own band plan, 240 and 130 blocks at
# hr_s2d 1), and an odd height that is not a multiple of the band nor the
# width of the strip; twice on the same inputs (bit-equal: the sums' order is
# fixed); against the plain version within chip_smoke.py's BF16_GATE, and its
# flipped roundings rare (rms under a quarter of the bf16 vs f32 distance).
@pytest.mark.parametrize("s2d", [2, 1])
@pytest.mark.parametrize("shape", ["8_tiles", "1_tile", "odd"])
def test_hr_tail_bf16_band_route_matches_the_plain_bf16_version(cuda_device, s2d, shape):
    ca, cb, cm, ch, tile = LAYOUT_WIDTHS[s2d]
    b, h, w = {"8_tiles": (8, tile, tile), "1_tile": (1, tile, tile), "odd": (3, 37, 133)}[shape]
    sr, dem = _tail_inputs(b, h, w, ca, cb, cuda_device, seed=40 + s2d)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device, seed=50 + s2d, offsets=True)
    want = ht.hr_tail_reference_bf16(sr, dem, *weights)
    f32 = ht.hr_tail_reference(sr, dem, *weights)
    pack = ht.pack_hr_tail_bf16(weights)
    _reset_routes()
    got = ht.hr_tail(sr, dem, *weights, tc_pack=pack, mode="bf16")
    again = ht.hr_tail(sr, dem, *weights, tc_pack=pack, mode="bf16")
    torch.cuda.synchronize()
    assert ht.route_launches == _routes(bf16_band=2) and ht.launches == 2
    assert got.shape == (b, h, w, ch) and torch.equal(got, again)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    rms = float((got - want).square().mean().sqrt())
    gap = float((want - f32).square().mean().sqrt())
    assert err <= 1e-2 * scale and rms < 0.25 * gap, (err, rms, gap, scale)


def test_hr_tail_bf16_band_route_refuses_what_it_does_not_take(cuda_device):
    ca, cb, cm, ch, _ = LAYOUT_WIDTHS[1]
    sr, dem = _tail_inputs(1, 8, 8, ca, cb, cuda_device)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device)
    pack = ht.pack_hr_tail_bf16(weights)
    # the bf16 route's kernels are not built at these widths any more
    with pytest.raises(ValueError, match="bf16 kernels were not built for Cm=32, Ch=1"):
        ht.hr_tail_cuda(sr, dem, *weights, tc_pack=pack, route="bf16")
    # the band route takes its two layouts only
    fw = _tail_weights(128, 32, 128, 16, cuda_device)
    fsr, fdem = _tail_inputs(1, 8, 8, 128, 32, cuda_device)
    with pytest.raises(ValueError, match="bf16_band route takes"):
        ht.hr_tail_cuda(fsr, fdem, *fw, tc_pack=ht.pack_hr_tail_bf16(fw), route="bf16_band")
    # the 3xTF32 pack is not the bf16 one
    with pytest.raises(ValueError, match="packed weight f1_w1 must be torch.bfloat16"):
        ht.hr_tail(sr, dem, *weights, tc_pack=ht.pack_hr_tail_tc(weights), mode="bf16")
    # float4 loads: an input one float into its storage is refused
    store = torch.zeros(sr.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte boundary for the bf16_band route"):
        ht.hr_tail(store[1:].view(sr.shape), dem, *weights, tc_pack=pack, mode="bf16")


def test_hr_tail_launchers_refuse_widths_they_were_not_built_for(cuda_device):
    # The wrapper never hands them such widths (tc_eligible); the launchers
    # themselves return an error rather than take another route.
    import ctypes

    lib = ht._lib()
    buf = torch.zeros(64, device=cuda_device)
    ptrs = (ctypes.c_void_p * 20)(*[buf.data_ptr()] * 20)
    common = (buf.data_ptr(), buf.data_ptr(), 1, 8, 8, 16, 16, 16, 4, ptrs, ptrs)
    rc_tc = lib.hr_tail_tc_launch(*common, *[buf.data_ptr()] * 3, 0)
    rc_bf16 = lib.hr_tail_bf16_launch(*common, *[buf.data_ptr()] * 6, 0)
    rc_band = lib.hr_tail_bf16_band_launch(*common, buf.data_ptr(), 0)
    assert rc_tc == rc_bf16 == rc_band == ht.NOT_INSTANTIATED
    # and the band launcher at a layout's (Cm, Ch) with another input width
    layout = (buf.data_ptr(), buf.data_ptr(), 1, 8, 8, 48, 16, 64, 4, ptrs, ptrs)
    assert lib.hr_tail_bf16_band_launch(*layout, buf.data_ptr(), 0) == ht.NOT_INSTANTIATED


# The small widths' kernel (A from registers, conv_tc_rs_kernel): a batch of 3
# at a height and width that are not multiples of its blocks (6x64 at Cm 64,
# a grid over one wave; 8x64 at Cm 32), twice on the same inputs (bit-equal:
# the sums' order is fixed); and features of 1e4 at the bar of the flagship's
# test above, 3e-5 of the output's range.
@pytest.mark.parametrize("s2d", [2, 1])
@pytest.mark.parametrize("case", ["ragged", "large_features"])
def test_hr_tail_small_widths_take_a_from_registers(cuda_device, s2d, case):
    ca, cb, cm, ch, _ = LAYOUT_WIDTHS[s2d]
    b, h, w, size, bar = {
        "ragged": (3, 100, 200, 1.0, 1e-4), "large_features": (1, 40, 64, 1e4, 3e-5)
    }[case]
    sr, dem = _tail_inputs(b, h, w, ca, cb, cuda_device, seed=20 + s2d, scale=size)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device, seed=30 + s2d)
    want = ht.hr_tail_reference(sr, dem, *weights)
    pack = ht.pack_hr_tail_tc(weights)
    _reset_routes()
    got = ht.hr_tail(sr, dem, *weights, tc_pack=pack)
    again = ht.hr_tail(sr, dem, *weights, tc_pack=pack)
    torch.cuda.synchronize()
    assert ht.route_launches == _routes(tensor=2)
    assert torch.equal(got, again)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert scale > 0.1 * size and err <= bar * scale, (err, scale)


def _relax_grid(seed, h, w, device):
    """Terrain-like costs in [1, 5] with ``inf`` walls and one NaN; seeds on the
    grid's corner and edge, and two equidistant from the cells between them."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(1.0, 5.0, (h, w)).astype(np.float32)
    cost[h // 3, : w // 2] = np.inf
    cost[:, 2 * w // 3][rng.random(h) > 0.3] = np.inf
    cost[h // 2, w // 2] = np.nan
    cost[1:4, 1:8] = 1.0  # a flat patch: exact ties between its two seeds
    dist = np.full((h, w), np.inf, np.float32)
    value = np.full((h, w), np.nan, np.float32)
    cells = [(0, 0), (h - 1, w // 2), (min(2, h - 1), min(2, w - 1)), (min(2, h - 1), min(6, w - 1))] + [
        (int(r), int(c)) for r, c in zip(rng.integers(0, h, 12), rng.integers(0, w, 12))
    ]
    for k, (r, c) in enumerate(cells):
        dist[r, c], value[r, c] = 0.0, 100.0 + k
    return tuple(torch.from_numpy(a).to(device) for a in (dist, value, cost))


def _assert_same_state(got, want):
    (gd, gv), (wd, wv) = got, want
    assert torch.equal(gd, wd)  # distances bit for bit, inf included
    assert torch.equal(torch.isnan(gv), torch.isnan(wv))
    assert torch.equal(torch.nan_to_num(gv, nan=0.0), torch.nan_to_num(wv, nan=0.0))


# 64x96 is whole 32x8 thread tiles; 37x45 and 5x3 have ragged edges.
@pytest.mark.parametrize("h,w", [(64, 96), (37, 45), (5, 3)])
def test_relax_step_kernel_equals_plain_version(cuda_device, h, w):
    dist, value, cost = _relax_grid(2, h, w, cuda_device)
    rs.launches = 0
    got, want = (dist, value), (dist, value)
    for step in range(1, 25):
        got = rs.relax_step(*got, cost)[:2]
        want = rs.relax_step_reference(*want, cost)
        torch.cuda.synchronize()
        # No FMA contraction in the kernel: bit for bit after every step.
        _assert_same_state(got, want)
    assert rs.launches == 24
    assert torch.isfinite(got[0]).sum() > min(16, h * w // 2) and not torch.isnan(got[0]).any()


def test_relax_step_kernel_leaves_its_inputs_alone(cuda_device):
    dist, value, cost = _relax_grid(3, 40, 50, cuda_device)
    keep = dist.clone(), value.clone()
    got = rs.relax_step(dist, value, cost)[:2]
    torch.cuda.synchronize()
    # Jacobi: new tensors are written, the inputs are not.
    assert got[0].data_ptr() != dist.data_ptr() and got[1].data_ptr() != value.data_ptr()
    _assert_same_state((dist, value), keep)
    _assert_same_state(got, rs.relax_step_reference(dist, value, cost))


def test_relax_step_kernel_rejects_what_it_does_not_take(cuda_device):
    dist, value, cost = _relax_grid(4, 16, 16, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        rs.relax_step(dist, value, cost.double())
    with pytest.raises(ValueError, match="contiguous"):
        rs.relax_step(dist, value, cost.t())
    with pytest.raises(ValueError, match="shape"):
        rs.relax_step(dist, value, cost[:8].contiguous())
    with pytest.raises(ValueError, match="is on"):
        rs.relax_step(dist, value, cost.cpu())


def test_mcp_fill_on_the_card_equals_the_cpu_and_the_dijkstra_oracle(cuda_device):
    rng = np.random.default_rng(6)
    h, w = 96, 80
    cost = rng.uniform(1.0, 5.0, (h, w)).astype(np.float32)
    domain = rng.random((h, w)) > 0.1
    seeds = rng.random((h, w)) > 0.995
    seed_values = np.where(seeds, rng.uniform(100, 110, (h, w)), np.nan).astype(np.float32)
    args = [torch.from_numpy(a) for a in (seed_values, seeds, cost, domain)]
    rs.launches = 0
    stats = {}
    fill_gpu, dist_gpu = cg.mcp_fill(*(a.to(cuda_device) for a in args), stats=stats)
    fill_cpu, dist_cpu = cg.mcp_fill(*args)
    # one launch of 8 relaxations between two checks
    assert rs.launches == stats["k3_launches"] == stats["relaxations"] // 8 > 0
    assert torch.equal(dist_gpu.cpu(), dist_cpu)
    np.testing.assert_array_equal(fill_gpu.cpu().numpy(), fill_cpu.numpy())
    want_fill, want_dist = cg.mcp_fill_numpy(seed_values, seeds, cost, domain)
    finite = np.isfinite(want_dist)
    np.testing.assert_array_equal(np.isfinite(dist_cpu.numpy()), finite)
    # f32 sums along a path against the oracle's float64.
    np.testing.assert_allclose(dist_cpu.numpy()[finite], want_dist[finite], rtol=1e-4)


def _plain_steps(dist, value, cost, n):
    for _ in range(n):
        dist, value = rs.relax_step_reference(dist, value, cost)
    return dist, value


# 1x1 to 5x5 and 3x7 are smaller than the kernel's halo of 8; 37x1000 and
# 513x777 have ragged tiles; 3840x3840 is the benchmarked scene's grid.
RELAX_SHAPES = [(1, 1), (1, 300), (300, 1), (5, 5), (3, 7), (37, 1000), (513, 777), (3840, 3840)]


@pytest.mark.parametrize("h,w", RELAX_SHAPES)
@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 16])
def test_relax_step_kernel_with_a_count_equals_that_many_plain_steps(cuda_device, h, w, n):
    """One launch per 8 relaxations, bit for bit with ``n`` plain steps, from a
    fresh state and from one 20 steps on; ``fell`` is ``(dist' < dist).any()``."""
    dist, value, cost = _relax_grid(7, h, w, cuda_device)
    for state in ((dist, value), _plain_steps(dist, value, cost, 20)):
        rs.launches = 0
        got_d, got_v, fell = rs.relax_step(*state, cost, n)
        want = _plain_steps(*state, cost, n)
        torch.cuda.synchronize()
        assert rs.launches == -(-n // 8)
        _assert_same_state((got_d, got_v), want)
        assert fell.dtype == torch.bool and bool(fell) == bool((want[0] < state[0]).any())


@pytest.mark.parametrize("h,w", [(5, 5), (37, 1000), (513, 777)])
def test_relax_step_kernel_with_a_count_on_special_grids(cuda_device, h, w):
    """No seeds: nothing falls. All costs infinite but the seeds: nothing
    moves. Exact ties on unit costs keep the first neighbour in the order.
    A settled grid: nothing falls."""
    dist, value, cost = _relax_grid(8, h, w, cuda_device)
    no_seeds = torch.full_like(dist, float("inf")), torch.full_like(value, float("nan"))
    walls = torch.where(dist == 0, cost, float("inf"))
    unit = torch.ones_like(cost)
    settled = _plain_steps(dist, value, unit, h + w)
    for state, c in ((no_seeds, cost), ((dist, value), walls), ((dist, value), unit), (settled, unit)):
        for n in (1, 8, 9):
            got_d, got_v, fell = rs.relax_step(*state, c, n)
            want = _plain_steps(*state, c, n)
            torch.cuda.synchronize()
            _assert_same_state((got_d, got_v), want)
            assert bool(fell) == bool((want[0] < state[0]).any())
    assert not bool(rs.relax_step(*no_seeds, cost, 8)[2])
    assert not bool(rs.relax_step(*settled, unit, 8)[2])
    assert bool(rs.relax_step(dist, value, unit, 8)[2])


def _parent_fill(seed_values, seed_mask, cost_surface, domain_mask, relaxations_per_check=8):
    """The fill loop before one launch a check block: single relaxations, and
    a full-grid ``(dist < prev).any()`` every ``relaxations_per_check``."""
    h, w = seed_values.shape
    cost = torch.where(domain_mask, cost_surface, float("inf")).contiguous()
    valid = seed_mask & domain_mask
    dist = torch.where(valid, 0.0, float("inf")).contiguous()
    value = torch.where(valid, seed_values, float("nan")).contiguous()
    prev = torch.full_like(dist, float("inf"))
    it = checks = 0
    while True:
        checks += 1
        if not (bool((dist < prev).any()) and it < h * w):
            break
        prev = dist
        for _ in range(relaxations_per_check):
            dist, value, _ = rs.relax_step(dist, value, cost)
        it += relaxations_per_check
    filled = torch.where(domain_mask & ~valid & torch.isfinite(dist), value, seed_values)
    return filled, dist, it, checks


@pytest.mark.parametrize("h,w,rpc", [(96, 80, 8), (300, 517, 8), (64, 64, 3), (40, 200, 16)])
def test_mcp_fill_on_the_card_equals_the_single_step_loop(cuda_device, h, w, rpc):
    """Outputs, relaxations and checks as the loop of single relaxations and
    full-grid compares gives them; one launch per 8 relaxations."""
    rng = np.random.default_rng(h * w + rpc)
    cost = rng.uniform(1.0, 5.0, (h, w)).astype(np.float32)
    domain = rng.random((h, w)) > 0.1
    seeds = rng.random((h, w)) > 0.995
    seed_values = np.where(seeds, rng.uniform(100, 110, (h, w)), np.nan).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (seed_values, seeds, cost, domain)]
    want_fill, want_dist, relaxations, checks = _parent_fill(*args, relaxations_per_check=rpc)
    rs.launches = 0
    stats = {}
    fill, dist = cg.mcp_fill(*args, relaxations_per_check=rpc, stats=stats)
    torch.cuda.synchronize()
    assert (stats["relaxations"], stats["checks"]) == (relaxations, checks)
    assert rs.launches == stats["k3_launches"] == (checks - 1) * -(-rpc // 8)
    assert torch.equal(dist, want_dist)
    assert torch.equal(torch.isnan(fill), torch.isnan(want_fill))
    assert torch.equal(torch.nan_to_num(fill), torch.nan_to_num(want_fill))
