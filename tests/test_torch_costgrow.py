"""The port's CostGrow path vs the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function and its torch
counterpart: the relaxation step (K3's plain version vs the Pallas kernel in
interpret mode), the least-cost solves, the phases of both CostGrow variants,
and both workers end to end through ``tohr``.

Why distances are not compared bit for bit: XLA on the CPU contracts the
candidate ``nd + k * (nc + cc)`` into one fused multiply-add (one rounding),
in the Pallas kernel's interpret mode and in the jnp version alike. The port
rounds the product and then the sum, in its plain version and (with
round-to-nearest intrinsics) in its CUDA kernel. The two differ by at most one
ulp per relaxation along a path; where every product is exact (one
power-of-two cost, so that ``nc + cc`` is a power of two) they are equal, and
the tests use such costs where they need exactness.
"""

import inspect
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from floodsr_tpu.io import from_origin, read_raster, write_raster
from floodsr_tpu.models.CostGrow import _costgrow_phases as phases_jax
from floodsr_tpu.models.CostGrow_pcraster import (
    _costgrow_pcraster_phases as pcraster_phases_jax,
)
from floodsr_tpu.ops import costgrow as cg_jax
from floodsr_tpu.ops.pallas.costgrow_stencil import relax_step_pallas
from floodsr_tpu.tohr import tohr as tohr_jax
from floodsr_tpu_torch import model_registry as registry_torch
from floodsr_tpu_torch.models.CostGrow import _costgrow_phases as phases_torch
from floodsr_tpu_torch.models.CostGrow_pcraster import (
    _costgrow_pcraster_phases as pcraster_phases_torch,
)
from floodsr_tpu_torch.ops import costgrow as cg_torch
from floodsr_tpu_torch.ops.kernels import relax_step as rs
from floodsr_tpu_torch.tohr import tohr as tohr_torch

pytestmark = pytest.mark.unit

NODATA = -9999.0
CRS = "EPSG:32633"


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


def _ulp(x):
    return np.spacing(np.float32(x))


# ---------------------------------------------------------------------------
# (a) the relaxation step: plain version vs the Pallas kernel, interpret mode
# ---------------------------------------------------------------------------


def _step_inputs(seed, h, w, exact_costs):
    """Seeds at a corner, on an edge and inside; an ``inf`` wall; one NaN cost."""
    rng = np.random.default_rng(seed)
    dist = np.full((h, w), np.inf, np.float32)
    value = np.full((h, w), np.nan, np.float32)
    for k, (r, c) in enumerate([(0, 0), (3, 5), (h - 4, w - 4), (h - 1, w // 2)]):
        dist[r, c] = 0.0
        value[r, c] = 10.0 * (k + 1)
    if exact_costs:
        cost = np.full((h, w), 2.0, np.float32)
        cost[rng.random((h, w)) > 0.85] = np.inf  # scattered obstacles
    else:
        cost = rng.uniform(1.0, 4.0, (h, w)).astype(np.float32)
    cost[h // 2, 2 : w - 3] = np.inf
    return dist, value, cost


def _run_steps(dist, value, cost, steps):
    dj, vj, cj = jnp.asarray(dist), jnp.asarray(value), jnp.asarray(cost)
    dt, vt, ct = _t(dist), _t(value), _t(cost)
    for _ in range(steps):
        dj, vj = relax_step_pallas(dj, vj, cj, block_rows=8, interpret=True)
        dt, vt, _ = rs.relax_step(dt, vt, ct)
    return np.asarray(dj), np.asarray(vj), dt.numpy(), vt.numpy()


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("h,w", [(16, 24), (24, 16)])
def test_relax_step_equals_pallas_kernel_exactly_on_exact_costs(h, w, steps):
    # One power-of-two cost: every product k * (nc + cc) is exact, so one
    # rounding or two give the same candidate and everything is equal bit for
    # bit, across the block_rows=8 band boundaries and around obstacles.
    dj, vj, dt, vt = _run_steps(*_step_inputs(3, h, w, exact_costs=True), steps)
    finite = np.isfinite(dt)
    assert finite.sum() > 4
    np.testing.assert_array_equal((dj > 1e37), ~finite)  # sentinel <=> inf
    np.testing.assert_array_equal(dj[finite], dt[finite])
    np.testing.assert_array_equal(np.isnan(vj), np.isnan(vt))
    np.testing.assert_array_equal(vj[finite], vt[finite])


@pytest.mark.parametrize("steps", [1, 10])
def test_relax_step_matches_pallas_kernel_on_random_costs(steps):
    dj, vj, dt, vt = _run_steps(*_step_inputs(5, 24, 16, exact_costs=False), steps)
    finite = np.isfinite(dt)
    np.testing.assert_array_equal((dj > 1e37), ~finite)
    # One ulp of the candidate per relaxation (fused vs separate rounding).
    bound = steps * _ulp(dt[finite].max())
    assert np.abs(dj[finite] - dt[finite]).max() <= bound
    if steps == 1:
        np.testing.assert_array_equal(dj[finite], dt[finite])  # nd = 0: exact
    # The values and the NaN pattern are equal exactly.
    np.testing.assert_array_equal(np.isnan(vj), np.isnan(vt))
    np.testing.assert_array_equal(vj[finite], vt[finite])


def test_relax_step_tie_keeps_the_first_neighbour_in_the_kernels_order():
    # Unit costs; seeds west (7) and east (9) of the centre cell, and north
    # (5) and south (6): all four at the same distance 1.0. The order W, E,
    # N, ..., S with a strict ``<`` keeps the west seed's value. The jnp
    # version that the JAX package runs off the TPU tries its shifts in another
    # order (its first orthogonal shift brings the south neighbour) and keeps
    # the south seed's: values at exact ties depend on the order, and the
    # port takes the kernel's.
    h, w = 8, 8
    dist = np.full((h, w), np.inf, np.float32)
    value = np.full((h, w), np.nan, np.float32)
    for (r, c), v in {(4, 3): 7.0, (4, 5): 9.0, (3, 4): 5.0, (5, 4): 6.0}.items():
        dist[r, c], value[r, c] = 0.0, v
    cost = np.ones((h, w), np.float32)
    dj, vj, dt, vt = _run_steps(dist, value, cost, 1)
    assert dt[4, 4] == 1.0 and vt[4, 4] == 7.0
    np.testing.assert_array_equal(dj[np.isfinite(dt)], dt[np.isfinite(dt)])
    np.testing.assert_array_equal(vj[np.isfinite(dt)], vt[np.isfinite(dt)])
    _, v_jnp = cg_jax._relax_distance_value(
        jnp.asarray(dist), jnp.asarray(value), jnp.asarray(cost)
    )
    assert float(v_jnp[4, 4]) == 6.0
    # Diagonal tie: NW before NE before SW before SE.
    dist[:], value[:] = np.inf, np.nan
    for (r, c), v in {(1, 1): 1.0, (1, 3): 2.0, (3, 1): 3.0, (3, 3): 4.0}.items():
        dist[r, c], value[r, c] = 0.0, v
    dj, vj, dt, vt = _run_steps(dist, value, cost, 1)
    assert vt[2, 2] == 1.0 and vj[2, 2] == 1.0
    assert dt[2, 2] == np.float32(rs.K_DIAG) * np.float32(2.0)


def test_relax_step_is_jacobi_and_leaves_its_inputs_alone():
    dist, value, cost = _step_inputs(7, 16, 24, exact_costs=False)
    dt, vt, ct = _t(dist.copy()), _t(value.copy()), _t(cost)
    new_d, new_v, _ = rs.relax_step(dt, vt, ct)
    np.testing.assert_array_equal(dt.numpy(), dist)
    np.testing.assert_array_equal(vt.numpy(), value)
    # One step reaches exactly the 8 neighbours of each seed (wall aside).
    reached = np.isfinite(new_d.numpy())
    assert reached.sum() <= 4 * 9 and reached.sum() > 4
    assert not torch.isnan(new_d).any()


def test_relax_step_nan_cost_is_never_taken():
    dist = np.full((5, 5), np.inf, np.float32)
    value = np.full((5, 5), np.nan, np.float32)
    dist[2, 2], value[2, 2] = 0.0, 3.0
    cost = np.ones((5, 5), np.float32)
    cost[2, 3] = np.nan
    d, v, _ = rs.relax_step(_t(dist), _t(value), _t(cost))
    assert torch.isinf(d[2, 3]) and torch.isnan(v[2, 3])
    assert not torch.isnan(d).any()
    assert d[2, 1] == 1.0 and v[2, 1] == 3.0


@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 16])
def test_relax_step_with_a_count_equals_that_many_steps(n):
    """``relax_step(..., n)`` on the CPU: ``n`` plain steps, and ``fell`` is
    ``(dist' < dist).any()``, false once the grid is settled."""
    dist, value, cost = (_t(a) for a in _step_inputs(11, 20, 28, exact_costs=False))
    want_d, want_v = dist, value
    for _ in range(n):
        want_d, want_v = rs.relax_step_reference(want_d, want_v, cost)
    got_d, got_v, fell = rs.relax_step(dist, value, cost, n)
    assert torch.equal(got_d, want_d)
    assert torch.equal(torch.isnan(got_v), torch.isnan(want_v))
    assert torch.equal(torch.nan_to_num(got_v), torch.nan_to_num(want_v))
    assert fell.dtype == torch.bool and fell.ndim == 0
    assert bool(fell) == bool((want_d < dist).any()) is True
    settled = rs.relax_step(dist, value, cost, 20 * 28)
    again = rs.relax_step(*settled[:2], cost, n)
    assert torch.equal(again[0], settled[0]) and not bool(again[2])


@pytest.mark.parametrize("n", [0, -1])
def test_relax_step_raises_on_a_count_below_one(n):
    dist, value, cost = (_t(a) for a in _step_inputs(1, 8, 8, exact_costs=True))
    with pytest.raises(ValueError, match="must be >= 1"):
        rs.relax_step(dist, value, cost, n)


def test_relax_step_wrapper_raises_on_cuda_request_without_cuda():
    dist, value, cost = (_t(a) for a in _step_inputs(1, 8, 8, exact_costs=True))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rs.relax_step_cuda(dist, value, cost)
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        rs.relax_step(dist[None], value[None], cost[None])


# ---------------------------------------------------------------------------
# (b) the solves vs their _jax counterparts and the Dijkstra oracle
# ---------------------------------------------------------------------------


def _fill_both(seed_values, seeds, cost, domain, target=None):
    fj, dj = cg_jax.mcp_fill_jax(
        jnp.asarray(seed_values), jnp.asarray(seeds),
        jnp.asarray(cost, dtype=jnp.float32), jnp.asarray(domain),
        target_mask=None if target is None else jnp.asarray(target),
        use_pallas=False,
    )
    stats = {}
    ft, dt = cg_torch.mcp_fill(
        _t(seed_values), _t(seeds), _t(np.asarray(cost, np.float32)), _t(domain),
        target_mask=None if target is None else _t(target), stats=stats,
    )
    return np.asarray(fj), np.asarray(dj), ft.numpy(), dt.numpy(), stats


def test_mcp_distance_matches_jax_and_dijkstra_around_a_wall():
    h = w = 24
    domain = np.ones((h, w), bool)
    domain[10:14, 2:20] = False  # a wall with a gap
    seeds = np.zeros((h, w), bool)
    seeds[2, 2] = True
    _, want = cg_jax.mcp_fill_numpy(
        np.zeros((h, w), np.float32), seeds, np.ones((h, w)), domain
    )
    got_j = np.asarray(cg_jax.mcp_distance_jax(jnp.asarray(seeds), jnp.asarray(domain)))
    got_t = cg_torch.mcp_distance(_t(seeds), _t(domain)).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got_t), finite)
    np.testing.assert_allclose(got_t[finite], want[finite], atol=1e-4)
    # Unit costs: k * 2 is exact, so fused and separate rounding agree.
    np.testing.assert_array_equal(got_t, got_j)


def test_mcp_fill_matches_jax_and_dijkstra_on_weighted_costs():
    rng = np.random.default_rng(11)
    h = w = 20
    domain = np.ones((h, w), bool)
    cost = rng.uniform(1.0, 5.0, (h, w))
    seeds = np.zeros((h, w), bool)
    seeds[0, 0] = seeds[h - 1, w - 1] = True
    seed_values = np.full((h, w), np.nan, np.float32)
    seed_values[0, 0], seed_values[h - 1, w - 1] = 100.0, 200.0
    fj, dj, ft, dt, stats = _fill_both(seed_values, seeds, cost, domain)
    want_fill, want_dist = cg_jax.mcp_fill_numpy(seed_values, seeds, cost, domain)
    np.testing.assert_allclose(dt, want_dist, rtol=1e-4)
    # vs JAX: a few ulp along a path of at most h + w steps.
    np.testing.assert_allclose(dt, dj, rtol=0, atol=(h + w) * _ulp(dt.max()))
    # Every cell takes the value of one of the seeds; they may differ only
    # where the two seeds are equidistant to rounding.
    differs = ft != fj
    assert differs.mean() <= 0.01
    assert (ft != want_fill).mean() <= 0.05  # the JAX test's own allowance
    assert stats["relaxations"] % 8 == 0 and stats["checks"] == stats["relaxations"] // 8 + 1


def test_mcp_fill_target_mask_restricts_fill():
    h = w = 12
    domain = np.ones((h, w), bool)
    seeds = np.zeros((h, w), bool)
    seeds[0, 0] = True
    seed_values = np.where(seeds, 7.0, np.nan).astype(np.float32)
    target = np.zeros((h, w), bool)
    target[:4, :4] = True
    fj, dj, ft, dt, _ = _fill_both(seed_values, seeds, np.ones((h, w)), domain, target)
    assert np.isfinite(ft[:4, :4]).all() and np.isnan(ft[6:, 6:]).all()
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(dt, dj)


def test_mcp_fill_converges_on_a_serpentine_longer_than_h_plus_w():
    h, w = 12, 12
    domain = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        domain[r, :] = True
    for k, r in enumerate(range(1, h, 2)):
        domain[r, w - 1 if k % 2 == 0 else 0] = True
    seeds = np.zeros((h, w), bool)
    seeds[0, 0] = True
    seed_values = np.where(seeds, 42.0, np.nan).astype(np.float32)
    cost = np.ones((h, w), np.float32)
    want_fill, want_dist = cg_jax.mcp_fill_numpy(seed_values, seeds, cost, domain)
    fj, dj, ft, dt, stats = _fill_both(seed_values, seeds, cost, domain)
    finite = np.isfinite(want_dist)
    assert want_dist[finite].max() > h + w
    np.testing.assert_allclose(dt[finite], want_dist[finite], rtol=1e-4)
    np.testing.assert_allclose(ft[domain], want_fill[domain], atol=1e-5)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(ft, fj)
    assert stats["relaxations"] > h + w


def test_mcp_fill_results_do_not_depend_on_relaxations_per_check():
    dist, value, cost = _step_inputs(9, 20, 20, exact_costs=False)
    seeds = np.isfinite(value)
    domain = np.isfinite(cost)
    outs = [
        cg_torch.mcp_fill(
            _t(value), _t(seeds), _t(cost), _t(domain), relaxations_per_check=k
        )
        for k in (1, 3, 8)
    ]
    for f, d in outs[1:]:
        assert torch.equal(d, outs[0][1])
        np.testing.assert_array_equal(f.numpy(), outs[0][0].numpy())


@pytest.mark.parametrize("metric", ["chessboard", "taxicab"])
@pytest.mark.parametrize("max_iters", [None, 8])
def test_grid_distance_equals_jax(metric, max_iters):
    rng = np.random.default_rng(2)
    seeds = rng.random((20, 28)) > 0.985
    seeds[0, 0] = True
    want = np.asarray(
        cg_jax.grid_distance_jax(jnp.asarray(seeds), metric=metric, max_iters=max_iters)
    )
    got = cg_torch.grid_distance(_t(seeds), metric=metric, max_iters=max_iters).numpy()
    np.testing.assert_array_equal(got, want)  # whole numbers: exact
    with pytest.raises(ValueError, match="metric"):
        cg_torch.grid_distance(_t(seeds), metric="euclid")


@pytest.mark.parametrize("connectivity", [1, 2])
def test_keep_components_connected_to_anchor_equals_jax(connectivity):
    rng = np.random.default_rng(4)
    wet = rng.random((24, 24)) > 0.45
    wet[0, 0] = wet[1, 1] = wet[2, 2] = True
    anchors = np.zeros_like(wet)
    anchors[0, 0] = anchors[12, 12] = anchors[20, 5] = True
    want = np.asarray(
        cg_jax.keep_components_connected_to_anchor_jax(
            jnp.asarray(wet), jnp.asarray(anchors), connectivity=connectivity
        )
    )
    got = cg_torch.keep_components_connected_to_anchor(
        _t(wet), _t(anchors), connectivity=connectivity
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] and (got <= wet).all()
    with pytest.raises(ValueError, match="connectivity"):
        cg_torch.keep_components_connected_to_anchor(_t(wet), _t(anchors), connectivity=3)


def test_numpy_oracles_are_copies_of_the_jax_packages():
    for name in ("nearest_fill_numpy", "mcp_fill_numpy"):
        a = inspect.getsource(getattr(cg_jax, name))
        b = inspect.getsource(getattr(cg_torch, name))
        assert a.replace("mcp_fill_jax", "mcp_fill") == b
    rng = np.random.default_rng(8)
    vals = np.where(rng.random((9, 11)) > 0.7, rng.normal(size=(9, 11)), np.nan)
    np.testing.assert_array_equal(
        cg_torch.nearest_fill_numpy(vals, "taxicab"), cg_jax.nearest_fill_numpy(vals, "taxicab")
    )


# ---------------------------------------------------------------------------
# (c) the phases of both variants vs the JAX functions on the same arrays
# ---------------------------------------------------------------------------


def _valley(h=48, w=48, hole=True):
    """A valley DEM with a side channel and a nodata hole; WSE over the channel."""
    yy = np.abs(np.arange(h) - h / 2)[:, None]
    dem = (100.0 + yy * 0.5 + np.linspace(0, 3, w)[None, :]).astype(np.float32)
    dem[: h // 2, w // 3] -= 2.0  # a side channel up the slope
    dem_valid = np.ones((h, w), bool)
    if hole:
        dem_valid[h // 2 - 2 : h // 2 + 2, w - 10 : w - 6] = False
    wse = np.full((h, w), np.nan, np.float32)
    wse[h // 2 - 4 : h // 2 + 4, : w - 12] = 102.5
    wse = np.where(dem_valid, wse, np.nan).astype(np.float32)
    return wse, np.where(dem_valid, dem, np.inf).astype(np.float32), dem_valid


def _assert_wse_close(got, want, what):
    """Equal wet masks, WSE within 1e-5 m apart from tie cells (counted)."""
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    wet = np.isfinite(want)
    assert wet.any()
    # 1e-5 m: one f32 ulp at ~100 m is 7.6e-6 (fused vs separate rounding
    # in the cost surface and the decay). A tie cell takes another anchor's
    # WSE; the scenes carry one WSE level, so none is expected.
    ties = np.abs(got[wet] - want[wet]) > 1e-5
    assert ties.sum() == 0, f"{what}: {int(ties.sum())} tie cells"


@pytest.mark.parametrize("decay_per_pixel", [0.0, 0.01])
def test_costgrow_phases_match_jax(decay_per_pixel):
    wse, dem, dem_valid = _valley()
    kw = dict(
        max_grow_fine_pixels=10.0, terrain_penalty_scale=1.5,
        decay_per_pixel=decay_per_pixel,
    )
    want = np.asarray(phases_jax(jnp.asarray(wse), jnp.asarray(dem), jnp.asarray(dem_valid), **kw))
    solves = {}
    got = phases_torch(_t(wse), _t(dem), _t(dem_valid), solves=solves, **kw).numpy()
    _assert_wse_close(got, want, "CostGrow phases")
    assert np.isfinite(got).sum() > np.isfinite(wse).sum() * 0.5
    assert not np.isfinite(got[~dem_valid]).any()
    assert set(solves) == {"neutral_fill", "anchor_distance", "penalized_fill"}
    assert all(s["relaxations"] > 0 and s["checks"] > 1 for s in solves.values())


@pytest.mark.parametrize("metric", ["chessboard", "taxicab"])
@pytest.mark.parametrize("dp_max", [12.0, None])
def test_costgrow_pcraster_phases_match_jax(metric, dp_max):
    wse, dem, dem_valid = _valley()
    rng = np.random.default_rng(6)
    cost = (1.0 + rng.uniform(0.0, 2.0, dem.shape)).astype(np.float32)
    cost[~dem_valid] = np.nan
    cost[5, 5] = np.nan
    kw = dict(dp_fine_pixel_max=dp_max, decay_per_pixel=0.008, metric=metric)
    want = np.asarray(
        pcraster_phases_jax(
            jnp.asarray(wse), jnp.asarray(dem), jnp.asarray(dem_valid), jnp.asarray(cost), **kw
        )
    )
    solves = {}
    got = pcraster_phases_torch(
        _t(wse), _t(dem), _t(dem_valid), _t(cost), solves=solves, **kw
    ).numpy()
    _assert_wse_close(got, want, "CostGrow_pcraster phases")
    assert set(solves) == {"spreadzone_fill"} and solves["spreadzone_fill"]["relaxations"] > 0


# ---------------------------------------------------------------------------
# (d) both workers end to end through tohr vs the JAX package's tohr
# ---------------------------------------------------------------------------


def _profile(arr, transform):
    return {
        "height": int(arr.shape[0]), "width": int(arr.shape[1]), "count": 1,
        "dtype": "float32", "crs": CRS, "transform": transform,
        "nodata": NODATA, "compress": "LZW",
    }


@pytest.fixture(scope="module")
def valley_scene(tmp_path_factory):
    """The JAX tests' 64x64 valley with an 8x coarser WSE over the channel,
    plus a DEM nodata hole, a depth twin of the WSE and a building wall."""
    root = tmp_path_factory.mktemp("torch_costgrow")
    h = w = 64
    yy = np.abs(np.arange(h) - h / 2)[:, None]
    dem = (100.0 + yy * 0.5 + np.linspace(0, 3, w)[None, :]).astype(np.float32)
    dem[4:8, 50:54] = NODATA
    wse_lr = np.full((8, 8), NODATA, np.float32)
    wse_lr[3:5, :] = 102.5
    depth_lr = np.full((8, 8), NODATA, np.float32)
    depth_lr[3:5, :] = 1.25
    lr_t, hr_t = from_origin(0, 512, 64.0, 64.0), from_origin(0, 512, 8.0, 8.0)
    fps = {k: root / f"{k}.tif" for k in ("wse", "depth", "dem")}
    write_raster(fps["wse"], wse_lr, _profile(wse_lr, lr_t))
    write_raster(fps["depth"], depth_lr, _profile(depth_lr, lr_t))
    write_raster(fps["dem"], dem, _profile(dem, hr_t))
    # A building across the channel at world x in [240, 264) (HR cols 30-32).
    fps["buildings"] = root / "buildings.geojson"
    fps["buildings"].write_text(json.dumps({
        "type": "Polygon",
        "crs": {"type": "name", "properties": {"name": CRS}},
        "coordinates": [[[240.0, 200.0], [264.0, 200.0], [264.0, 320.0],
                         [240.0, 320.0], [240.0, 200.0]]],
    }))
    fps["params"] = {
        "CostGrow": root / "costgrow.json",
        "CostGrow_depth_out": root / "costgrow_depth.json",
        "CostGrow_pcraster": root / "pcraster.json",
    }
    fps["params"]["CostGrow"].write_text(
        json.dumps({"model_version": "CostGrow", "max_grow_coarse_pixels": 2,
                    "decay_per_meter": 0.001})
    )
    fps["params"]["CostGrow_depth_out"].write_text(
        json.dumps({"max_grow_coarse_pixels": 2, "output_kind": "depth"})
    )
    fps["params"]["CostGrow_pcraster"].write_text(
        json.dumps({"model_version": "CostGrow_pcraster", "dp_coarse_pixel_max": 3})
    )
    fps["dem_arr"] = dem
    return fps


def _tohr_both(scene, tmp_path, version, params_key=None, lr="wse", **kw):
    outs, diags = {}, {}
    for name, fn, extra in (("jax", tohr_jax, {}), ("torch", tohr_torch, {"device": "cpu"})):
        out_fp = tmp_path / f"{name}.tif"
        diags[name] = fn(
            model_version=version, model_fp=scene["params"][params_key or version],
            depth_lr_fp=scene[lr], dem_hr_fp=scene["dem"], output_fp=out_fp,
            **kw, **extra,
        )
        arr, nodata, _ = read_raster(out_fp)
        outs[name] = np.where(np.isclose(arr, nodata), np.nan, arr)
    return outs, diags


@pytest.mark.parametrize(
    "version,kw",
    [
        ("CostGrow", {}),
        ("CostGrow", {"buildings": True}),
        ("CostGrow", {"lr": "depth", "input_kind": "depth"}),
        ("CostGrow", {"params_key": "CostGrow_depth_out", "max_depth": 2.0}),
        ("CostGrow_pcraster", {}),
        ("CostGrow_pcraster", {"buildings": True}),
        ("CostGrow_pcraster", {"lr": "depth", "input_kind": "depth"}),
    ],
)
def test_costgrow_tohr_matches_jax_tohr(valley_scene, tmp_path, version, kw):
    kw = dict(kw)
    if kw.pop("buildings", False):
        kw["buildings_fp"] = valley_scene["buildings"]
    outs, diags = _tohr_both(valley_scene, tmp_path, version, **kw)
    _assert_wse_close(outs["torch"], outs["jax"], f"{version} {kw}")
    assert diags["torch"]["preprocess"] == diags["jax"]["preprocess"]
    assert diags["torch"]["model_version"] == version
    assert set(diags["jax"]) <= set(diags["torch"])
    pre = diags["torch"]["preprocess"]
    assert pre["downscale"] == 8 and pre["wet_pixel_count"] == int(np.isfinite(outs["torch"]).sum())
    wet = np.isfinite(outs["torch"])
    assert not wet[4:8, 50:54].any()  # the DEM's nodata hole stays dry
    if pre["output_kind"] == "wse":
        assert (outs["torch"][wet] > valley_scene["dem_arr"][wet]).all()
    else:
        assert (outs["torch"][wet] >= 0).all() and (outs["torch"][wet] <= 2.0).all()
    if "buildings_fp" in kw:
        assert pre["building_blocked_cells"] == 3 * 15
        assert not wet[24:39, 30:33].any()
    solves = diags["torch"]["solves"]
    assert solves and all(s["relaxations"] > 0 for s in solves.values())


def test_costgrow_workers_resolve_fetch_and_default_to_cuda(tmp_path, monkeypatch):
    for version in ("CostGrow", "CostGrow_pcraster"):
        fp = registry_torch.fetch_model(version, cache_dir=tmp_path / "cache")
        assert json.loads(fp.read_text())["model_version"] == version
        worker_cls = registry_torch.resolve_model_worker_class(version)
        assert worker_cls.model_version == version
        assert inspect.signature(worker_cls.__init__).parameters["device"].default == "cuda"
        assert worker_cls(fp, device="cpu").device.type == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            worker_cls(fp)
    assert {"CostGrow", "CostGrow_pcraster", "ResUNet_16x_DEM"} <= set(
        registry_torch.list_runnable_model_versions()
    )


def test_large_warp_keeps_a_live_nodata_sentinel_out_of_its_neighbours(monkeypatch):
    # CostGrow warps its WSE with the -9999 sentinel in the data. Above the
    # device-warp threshold the JAX package sends any nonzero sentinel through
    # two matmuls, which blend it into the neighbouring cells; the port looks
    # at the data and takes the nodata-aware gather. The threshold is lowered
    # here so that a small grid takes the large-grid path.
    from floodsr_tpu.ops import resample as resample_jax
    from floodsr_tpu_torch.ops import resample as resample_torch

    monkeypatch.setattr(resample_jax, "_DEVICE_WARP_THRESHOLD", 0)
    monkeypatch.setattr(resample_torch, "_DEVICE_WARP_THRESHOLD", 0)
    src = np.full((8, 8), NODATA, np.float32)
    src[3:5, :] = 102.5
    src_t, dst_t = from_origin(0, 512, 64.0, 64.0), from_origin(0, 512, 8.0, 8.0)
    args = (src, src_t, (64, 64), dst_t)
    want = resample_torch.reproject_bilinear(*args, src_nodata=NODATA, dst_nodata=np.nan)
    got = resample_torch.reproject_bilinear_auto(
        *args, src_nodata=NODATA, dst_nodata=np.nan, device="cpu"
    )
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    # f32 coordinates and weights against the host's float64.
    np.testing.assert_allclose(got[finite], want[finite], atol=1e-4)
    assert (got[finite] == 102.5).all()
    blended = resample_jax.reproject_bilinear_auto(
        *args, src_nodata=NODATA, dst_nodata=np.nan
    )
    assert np.isfinite(blended).all() and (blended[finite] < 102.0).any()
    # Without a live sentinel the two matmuls run, and agree with the host.
    src_full = np.where(src == NODATA, 99.0, src).astype(np.float32)
    got_full = resample_torch.reproject_bilinear_auto(
        src_full, src_t, (64, 64), dst_t, src_nodata=NODATA, dst_nodata=np.nan, device="cpu"
    )
    want_full = resample_torch.reproject_bilinear(
        src_full, src_t, (64, 64), dst_t, src_nodata=NODATA, dst_nodata=np.nan
    )
    np.testing.assert_allclose(got_full, want_full, atol=1e-4)
