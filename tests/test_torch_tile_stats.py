"""K2 (tile_stats): the port's plain version vs the JAX stats, and its wrapper."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from floodsr_tpu.ops.normalize import dem_tile_stats as dem_tile_stats_jax
from floodsr_tpu.ops.normalize import invert_depth_log1p as invert_jax
from floodsr_tpu.ops.normalize import normalize_dem_with_stats as normalize_jax
from floodsr_tpu.ops.normalize import scale_depth_log1p as scale_jax
from floodsr_tpu.ops.pallas.tile_stats import dem_tile_stats_pallas
from floodsr_tpu_torch.ops import normalize as nt
from floodsr_tpu_torch.ops.kernels import tile_stats as ts

pytestmark = pytest.mark.unit


def _tiles(seed=0, n=4, size=32):
    """Terrain-like tiles: tile 1 dips below 0, tile 2 has ties, tile 3 is flat."""
    rng = np.random.default_rng(seed)
    t = 200.0 + np.cumsum(rng.normal(0.0, 0.5, (n, size, size)), axis=2)
    t = t.astype(np.float32)
    t[1] -= np.float32(t[1].mean())
    t[2] = np.round(t[2] * 2.0) / 2.0
    t[3] = np.float32(123.25)
    return t


@pytest.mark.parametrize("pct", [95.0, 50.0, 99.9, 100.0])
def test_plain_version_equals_jax_bisection_and_pallas_interpret(pct):
    # Same f32 bisection (mid, count test, lerp) in the same order: bitwise.
    dem = _tiles()
    got = ts.tile_stats_reference(torch.from_numpy(dem), pct).numpy()
    cpu = np.stack([np.asarray(v) for v in dem_tile_stats_jax(jnp.asarray(dem), pct)], 1)
    pallas = np.stack(
        [np.asarray(v) for v in dem_tile_stats_pallas(jnp.asarray(dem), pct, interpret=True)], 1
    )
    np.testing.assert_array_equal(got, cpu)
    np.testing.assert_array_equal(got, pallas)


def test_stats_close_to_numpy_percentile():
    dem = _tiles(seed=3)
    got = ts.tile_stats_reference(torch.from_numpy(dem), 95.0).numpy()
    clamped = np.clip(dem.reshape(4, -1), 0.0, None)
    p = np.percentile(clamped, 95.0, axis=1)
    span = clamped.max(1) - clamped.min(1)
    # 30 bisection steps: the bracket is range / 2^30 wide.
    assert np.all(np.abs(got[:, 0] - p) <= span / 2**30 + 1e-4)
    assert got[3, 0] == np.float32(123.25) and got[3, 1] == got[3, 2]


def test_wrapper_dispatches_cpu_to_plain_and_counts_no_launch():
    ts.launches = 0
    dem = torch.from_numpy(_tiles(seed=1))
    p, lo, hi = nt.dem_tile_stats(dem, 95.0)
    want = ts.tile_stats_reference(dem, 95.0)
    assert torch.equal(torch.stack([p, lo, hi], 1), want)
    assert ts.launches == 0


def test_wrapper_input_checks():
    with pytest.raises(ValueError, match="N, H, W"):
        ts.tile_stats(torch.zeros(4, 4), 95.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ts.tile_stats_cuda(torch.zeros(1, 4, 4), 95.0)
    with pytest.raises(ValueError, match="unsupported device"):
        ts.tile_stats(torch.zeros(1, 4, 4, device="meta"), 95.0)


def test_percentile_ranks_match_numpy_linear_rule():
    assert ts.percentile_ranks(1024, 95.0) == (971, 972, pytest.approx(0.85))
    assert ts.percentile_ranks(1024, 100.0) == (1023, 1023, 0.0)


def test_normalize_twins_match_jax():
    rng = np.random.default_rng(5)
    dem = _tiles(seed=2)
    p, lo, hi = (np.asarray(v) for v in dem_tile_stats_jax(jnp.asarray(dem), 95.0))
    got = nt.normalize_dem_with_stats(
        torch.from_numpy(dem), torch.from_numpy(p), torch.from_numpy(lo), torch.from_numpy(hi)
    ).numpy()
    want = np.asarray(normalize_jax(jnp.asarray(dem), jnp.asarray(p), jnp.asarray(lo), jnp.asarray(hi)))
    # Same f32 ops in the same order; the flat tile maps to zeros in both.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert not got[3].any()

    depth = rng.uniform(-0.5, 7.0, (3, 8, 8)).astype(np.float32)
    scaled = nt.scale_depth_log1p(torch.from_numpy(depth), 5.0).numpy()
    # log1p/expm1 implementations differ by an ulp between XLA and torch.
    np.testing.assert_allclose(scaled, np.asarray(scale_jax(jnp.asarray(depth), 5.0)), atol=2e-7)
    back = nt.invert_depth_log1p(torch.from_numpy(scaled), 5.0).numpy()
    np.testing.assert_allclose(back, np.asarray(invert_jax(jnp.asarray(scaled), 5.0)), atol=2e-6)



def _mixed_tiles(h, w, seed=7):
    """Terrain-like, negatives, many ties, constant, NaNs, all zero, and a
    tile whose values span the exponent range (three select passes on the card)."""
    rng = np.random.default_rng(seed)
    t = (200.0 + np.cumsum(rng.normal(0.0, 0.5, (7, h, w)), axis=2)).astype(np.float32)
    t[1] -= np.float32(t[1].mean())
    t[2] = np.round(t[2] * 2.0) / 2.0
    t[3] = np.float32(123.25)
    t[4].reshape(-1)[::5] = np.nan
    t[5] = np.float32(-3.0)
    t[6] = np.exp(rng.uniform(-40.0, 40.0, (h, w))).astype(np.float32)
    return t


@pytest.mark.parametrize("h,w", [(8, 8), (33, 31), (128, 128)])
@pytest.mark.parametrize("pct", [50.0, 95.0, 99.9, 100.0])
def test_selection_equals_the_bisection_bit_for_bit(h, w, pct):
    # The bisection reads the data only through count(x <= mid) >= rank + 1,
    # which holds exactly when the rank-th smallest value is <= mid: the
    # replay on the two order statistics is the same f32 arithmetic.
    dem = torch.from_numpy(_mixed_tiles(h, w))
    got = ts.tile_stats_by_selection(dem, pct)
    want = ts.tile_stats_reference(dem, pct)
    assert got.dtype == want.dtype == torch.float32 and got.shape == (7, 3)
    assert torch.equal(got, want)
    assert not torch.isnan(got).any()


@pytest.mark.parametrize("pct", [95.0, 50.0, 99.9, 100.0])
def test_selection_equals_jax_bisection(pct):
    dem = _tiles()
    got = ts.tile_stats_by_selection(torch.from_numpy(dem), pct).numpy()
    cpu = np.stack([np.asarray(v) for v in dem_tile_stats_jax(jnp.asarray(dem), pct)], 1)
    np.testing.assert_array_equal(got, cpu)


def test_selection_with_the_rank_on_a_run_of_ties():
    # Rank k falls on the last of a run of equal values, on its first, and
    # inside it: s_k1 is the next value above in the first case only.
    base = np.arange(64, dtype=np.float32)
    for run_start in (60, 61, 59):  # k = floor(0.95 * 63) = 59, k1 = 60
        tile = base.copy()
        tile[run_start - 3 : run_start + 1] = tile[run_start]
        dem = torch.from_numpy(np.stack([tile, tile[::-1].copy()]).reshape(2, 8, 8))
        assert torch.equal(ts.tile_stats_by_selection(dem, 95.0), ts.tile_stats_reference(dem, 95.0))


def test_one_read_route_rule_and_route_counts():
    from floodsr_tpu_torch.ops import kernels

    # 512x512: eight 128 KiB slices. Not a multiple of 32 elements, a slice
    # beyond a block's shared memory, or a start off 16 bytes: the stream.
    assert ts.one_read_ok(512 * 512, 0x7F0000000000)
    assert ts.one_read_ok(64 * 96, 1 << 20)
    assert not ts.one_read_ok(33 * 31, 1 << 20)
    assert not ts.one_read_ok(30 * 30, 1 << 20)
    assert not ts.one_read_ok(640 * 640, 1 << 20)
    assert not ts.one_read_ok(512 * 512, (1 << 20) + 4)
    assert (512 * 512 // ts.CLUSTER_BLOCKS) * 4 <= ts.MAX_SLICE_BYTES
    ts.route_launches["one_read"] = 3
    ts.launches = 3
    kernels.reset_launch_counts()
    assert ts.launches == 0 and ts.route_launches == {"one_read": 0, "stream": 0}
    assert kernels.route_counts()["tile_stats"] == {"one_read": 0, "stream": 0}
    # the plain version is no launch on either route
    ts.tile_stats(torch.from_numpy(_tiles(seed=1)), 95.0)
    assert kernels.launch_counts()["tile_stats"] == 0
    assert kernels.route_counts()["tile_stats"] == {"one_read": 0, "stream": 0}
