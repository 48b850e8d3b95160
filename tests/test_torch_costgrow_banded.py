"""The port's row-band-sharded CostGrow fill (``floodsr_tpu_torch/ops/
costgrow_banded.py``): equal to the port's own ``mcp_fill`` bit for bit, and
held against the JAX package's ``mcp_fill_sharded``.

The port's bands run on ``make_mesh(devices=[cpu] * 8)`` with the plain
version of the ``relax_step`` kernel; the JAX half on the suite's 8-device
virtual CPU mesh. Tolerances: against the port's ``mcp_fill`` the distances
and fills are the same bits (both are Jacobi steps with the same arithmetic,
run to the same fixpoint). Against JAX: finite masks equal, distances to rtol
1e-5, fills equal on more than 99% of cells, the JAX test's own bound
(``tests/test_costgrow_banded.py``): XLA fuses the candidate into an FMA on
the CPU and its jnp relaxation breaks exact ties in another neighbour order
(ROADMAP.md §3).
"""

import numpy as np
import pytest
import torch

import jax

from floodsr_tpu.ops.costgrow_banded import mcp_fill_sharded as mcp_fill_sharded_jax
from floodsr_tpu.parallel.mesh import make_mesh as make_mesh_jax
from floodsr_tpu_torch.ops import costgrow_banded as cb
from floodsr_tpu_torch.ops.costgrow import mcp_fill, mcp_fill_numpy
from floodsr_tpu_torch.parallel.mesh import make_mesh

pytestmark = [pytest.mark.unit, pytest.mark.multidev]

MESH = make_mesh(devices=[torch.device("cpu")] * 8)


def _random_problem(rng, h, w, n_seeds=5):
    domain = rng.random((h, w)) > 0.05
    cost = rng.uniform(1.0, 5.0, (h, w)).astype(np.float32)
    seeds = np.zeros((h, w), bool)
    seeds[rng.integers(0, h, n_seeds), rng.integers(0, w, n_seeds)] = True
    seeds &= domain
    if not seeds.any():
        seeds[h // 2, w // 2] = True
        domain[h // 2, w // 2] = True
    seed_values = np.full((h, w), np.nan, np.float32)
    seed_values[seeds] = rng.normal(size=int(seeds.sum())).astype(np.float32) * 10
    return seed_values, seeds, cost, domain


def _port_unsharded(seed_values, seeds, cost, domain):
    filled, dist = mcp_fill(*(torch.from_numpy(a) for a in (seed_values, seeds, cost, domain)))
    return filled.numpy(), dist.numpy()


@pytest.mark.parametrize("h,w,seed", [(64, 48, 1), (40, 40, 2), (42, 24, 3), (16, 30, 4)])
def test_equals_the_ports_mcp_fill_bit_for_bit(h, w, seed):
    """(42, 24) pads 6 impassable rows; (16, 30) has bands of 2 rows, so a
    block is clamped to 2 relaxations (``k <= h // n_bands``)."""
    problem = _random_problem(np.random.default_rng(seed), h, w)
    stats = {}
    got_fill, got_dist = cb.mcp_fill_sharded(*problem, MESH, stats=stats)
    want_fill, want_dist = _port_unsharded(*problem)
    assert got_dist.shape == (h, w)
    np.testing.assert_array_equal(got_dist, want_dist)
    np.testing.assert_array_equal(got_fill, want_fill)  # NaN where NaN
    assert stats["relaxations"] % min(8, -(-h // 8)) == 0 and stats["checks"] >= 1


@pytest.fixture(scope="module")
def jax_fills():
    """The JAX package's banded fill at dp=8 on three problems, computed once."""
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"
    mesh = make_mesh_jax(dp=8, tp=1)
    out = {}
    for h, w, seed in ((64, 48, 11), (40, 40, 12), (42, 24, 13)):
        problem = _random_problem(np.random.default_rng(seed), h, w)
        out[(h, w)] = (problem, mcp_fill_sharded_jax(*problem, mesh))
    return out


def test_matches_jax_mcp_fill_sharded(jax_fills):
    for (h, w), (problem, (want_fill, want_dist)) in jax_fills.items():
        got_fill, got_dist = cb.mcp_fill_sharded(*problem, MESH)
        finite = np.isfinite(want_dist)
        np.testing.assert_array_equal(np.isfinite(got_dist), finite)
        np.testing.assert_allclose(got_dist[finite], want_dist[finite], rtol=1e-5)
        agree = (got_fill == want_fill) | (np.isnan(got_fill) & np.isnan(want_fill))
        assert agree.mean() > 0.99, (h, w, agree.mean())


def test_propagation_crosses_band_seams():
    """One seed in the top band fills the whole domain (exact Dijkstra
    distances), crossing all 7 seams."""
    h, w = 64, 16
    domain = np.ones((h, w), bool)
    cost = np.ones((h, w), np.float32)
    seeds = np.zeros((h, w), bool)
    seeds[0, 0] = True
    seed_values = np.where(seeds, 7.0, np.nan).astype(np.float32)
    got_fill, got_dist = cb.mcp_fill_sharded(seed_values, seeds, cost, domain, MESH)
    _, want_dist = mcp_fill_numpy(seed_values, seeds, cost, domain)
    np.testing.assert_allclose(got_dist, want_dist, rtol=1e-5)
    assert np.isfinite(got_fill).all()
    np.testing.assert_allclose(got_fill, 7.0)


def test_serpentine_across_bands():
    """A least-cost path that snakes through every band several times:
    convergence needs many more blocks than bands."""
    h, w = 16, 16
    domain = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        domain[r, :] = True
    for j, r in enumerate(range(1, h, 2)):
        domain[r, w - 1 if j % 2 == 0 else 0] = True
    seeds = np.zeros((h, w), bool)
    seeds[0, 0] = True
    seed_values = np.where(seeds, 3.0, np.nan).astype(np.float32)
    cost = np.ones((h, w), np.float32)
    _, want_dist = mcp_fill_numpy(seed_values, seeds, cost, domain)
    stats = {}
    got_fill, got_dist = cb.mcp_fill_sharded(seed_values, seeds, cost, domain, MESH, stats=stats)
    finite = np.isfinite(want_dist)
    np.testing.assert_allclose(got_dist[finite], want_dist[finite], rtol=1e-5)
    np.testing.assert_allclose(got_fill[domain], 3.0)
    assert stats["checks"] > 8


def test_unreachable_cells_stay_untouched():
    h, w = 32, 8
    domain = np.ones((h, w), bool)
    domain[16, :] = False  # full wall between bands
    seeds = np.zeros((h, w), bool)
    seeds[0, 0] = True
    seed_values = np.where(seeds, 1.0, np.nan).astype(np.float32)
    got_fill, got_dist = cb.mcp_fill_sharded(
        seed_values, seeds, np.ones((h, w), np.float32), domain, MESH
    )
    assert np.isfinite(got_dist[:16]).all()
    assert not np.isfinite(got_dist[17:]).any()
    assert np.isnan(got_fill[17:]).all()


def test_outer_halos_are_impassable_not_zero(monkeypatch):
    """The first band's top halo and the last band's bottom halo are inf
    (distance, cost) and NaN (value), never the zeros ``ppermute`` leaves."""
    seen = []
    real = cb._exchange_halos

    def spy(cores, k, fill):
        out = real(cores, k, fill)
        seen.append((k, fill, out[0][:k].clone(), out[-1][-k:].clone()))
        return out

    monkeypatch.setattr(cb, "_exchange_halos", spy)
    problem = _random_problem(np.random.default_rng(21), 32, 12)
    cb.mcp_fill_sharded(*problem, make_mesh(devices=[torch.device("cpu")] * 4), max_iters=8)
    # the cost halo once, then a distance and a value halo in the one block
    assert ["nan" if np.isnan(f) else f for _, f, _, _ in seen] == [np.inf, np.inf, "nan"]
    for k, fill, top, bottom in seen:
        assert k == 8 and top.shape[0] == bottom.shape[0] == 8
        for halo in (top, bottom):
            assert (torch.isnan(halo).all() if np.isnan(fill) else (halo == fill).all())


def test_repeat_builds_reuse_the_built_fill():
    a = cb.build_banded_mcp_fill(MESH, (64, 32))
    b = cb.build_banded_mcp_fill(MESH, (64, 32))
    assert a is b
    c = cb.build_banded_mcp_fill(MESH, (64, 32), relaxations_per_check=4)
    assert c is not a
    assert cb.build_banded_mcp_fill(make_mesh(devices=[torch.device("cpu")] * 8), (64, 32)) is a
    with pytest.raises(ValueError, match="not divisible by 8 bands"):
        cb.build_banded_mcp_fill(MESH, (60, 32))
