"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode. The file imports no JAX, so it also runs on a machine
without it: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
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
    cells = [(0, 0), (h - 1, w // 2), (2, min(2, w - 1)), (2, min(6, w - 1))] + [
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
        got = rs.relax_step(*got, cost)
        want = rs.relax_step_reference(*want, cost)
        torch.cuda.synchronize()
        # No FMA contraction in the kernel: bit for bit after every step.
        _assert_same_state(got, want)
    assert rs.launches == 24
    assert torch.isfinite(got[0]).sum() > min(16, h * w // 2) and not torch.isnan(got[0]).any()


def test_relax_step_kernel_leaves_its_inputs_alone(cuda_device):
    dist, value, cost = _relax_grid(3, 40, 50, cuda_device)
    keep = dist.clone(), value.clone()
    got = rs.relax_step(dist, value, cost)
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
    assert rs.launches == stats["relaxations"] > 0
    assert torch.equal(dist_gpu.cpu(), dist_cpu)
    np.testing.assert_array_equal(fill_gpu.cpu().numpy(), fill_cpu.numpy())
    want_fill, want_dist = cg.mcp_fill_numpy(seed_values, seeds, cost, domain)
    finite = np.isfinite(want_dist)
    np.testing.assert_array_equal(np.isfinite(dist_cpu.numpy()), finite)
    # f32 sums along a path against the oracle's float64.
    np.testing.assert_allclose(dist_cpu.numpy()[finite], want_dist[finite], rtol=1e-4)
