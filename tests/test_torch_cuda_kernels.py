"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode. The file imports no JAX, so it also runs on a machine
without it: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from floodsr_tpu_torch.device import set_strict_f32
from floodsr_tpu_torch.ops.kernels import hr_tail as ht
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


# 128x128 takes the float4 path; 33x31 (a count not divisible by 4) the
# scalar one.
@pytest.mark.parametrize("h,w", [(128, 128), (33, 31)])
@pytest.mark.parametrize("pct", [95.0, 100.0])
def test_tile_stats_kernel_equals_plain_version(cuda_device, h, w, pct):
    dem = torch.from_numpy(_tiles(4, 6, h, w)).to(cuda_device)
    ts.launches = 0
    got = ts.tile_stats(dem, pct)
    torch.cuda.synchronize()
    assert ts.launches == 1
    # Same f32 bisection in the same order: bit for bit.
    assert torch.equal(got, ts.tile_stats_reference(dem, pct))


def test_tile_stats_kernel_on_a_view_off_16_byte_alignment(cuda_device):
    # A contiguous view one float into its storage: the count is a multiple
    # of 4, but the tiles do not start on a 16-byte boundary, so the kernel
    # must take its scalar loads.
    n, h, w = 6, 32, 32
    flat = torch.from_numpy(_tiles(5, n, h, w).reshape(-1)).to(cuda_device)
    store = torch.empty(flat.numel() + 1, device=cuda_device)
    store[1:] = flat
    dem = store[1:].view(n, h, w)
    assert dem.is_contiguous() and dem.data_ptr() % 16 != 0
    got = ts.tile_stats(dem, 95.0)
    torch.cuda.synchronize()
    assert torch.equal(got, ts.tile_stats_reference(dem, 95.0))


def test_tile_stats_kernel_rejects_what_it_does_not_take(cuda_device):
    with pytest.raises(TypeError, match="float32"):
        ts.tile_stats(torch.zeros(2, 8, 8, dtype=torch.float64, device=cuda_device), 95.0)
    with pytest.raises(ValueError, match="contiguous"):
        ts.tile_stats(torch.zeros(2, 8, 16, device=cuda_device)[:, :, ::2], 95.0)


def _tail_weights(ca, cb, cm, ch, device, seed=0):
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
        else:
            v = rng.normal(0.0, 0.1, shape)
        out.append(torch.from_numpy(v.astype(np.float32)).to(device))
    return out


# The flagship's channel widths (128 + 32 → 128 → 16) and a narrow config;
# heights and widths that are not multiples of the kernel's 8x32 tile, so
# the ragged edges and the image-edge padding are exercised.
@pytest.mark.parametrize(
    "b,h,w,ca,cb,cm,ch",
    [(2, 20, 48, 128, 32, 128, 16), (1, 13, 70, 16, 8, 16, 4)],
)
def test_hr_tail_kernel_matches_plain_version(cuda_device, b, h, w, ca, cb, cm, ch):
    rng = np.random.default_rng(1)
    sr = torch.from_numpy(np.abs(rng.normal(0, 1, (b, h, w, ca))).astype(np.float32)).to(cuda_device)
    dem = torch.from_numpy(np.abs(rng.normal(0, 1, (b, h, w, cb))).astype(np.float32)).to(cuda_device)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device)
    ht.launches = 0
    got = ht.hr_tail(sr, dem, *weights)
    want = ht.hr_tail_reference(sr, dem, *weights)
    torch.cuda.synchronize()
    assert ht.launches == 1
    assert got.shape == want.shape == (b, h, w, ch)
    # f32 FMAs in another order than cuDNN's (TF32 off): a few ulps per
    # layer through five convolutions, held at 1e-4 of the output's range.
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max())


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
