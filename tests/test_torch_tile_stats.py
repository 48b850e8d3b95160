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

