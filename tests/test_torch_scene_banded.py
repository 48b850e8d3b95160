"""The port's banded scene executor (``floodsr_tpu_torch/engine/scene_banded.py``)
against the JAX package's ``engine/scene_banded.py``.

The JAX halves run on the suite's 8-device virtual CPU mesh, each result
computed once per module (``shard_map`` compiles are slow here); the port's
run on ``make_mesh(devices=[cpu] * 8)`` (and ``[cpu]``) with the plain
versions of the kernels. Tolerances: the packed bands and indices equal the
JAX package's array for array; the banded scene agrees with the port's own
unsharded executor to 1e-4 m (the reference's bound between its banded and
unsharded executors, ``tests/test_scene_banded.py``: batch composition
changes the convolutions' reduction order), and with JAX's banded executor at
the same dp to the port's bar against JAX, 1e-4 m RMSE
(``tests/test_torch_scene_tohr.py``), and 2e-4 m at any pixel: the port's
UNsharded executor already differs from JAX's by up to 1.25e-4 m on this
scene (2 of 65536 pixels, near the ``max_depth`` clip, where the inverse
multiplies a difference of the normalized prediction by ~11). Per-tile stats:
rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

from floodsr_tpu.engine import scene_banded as sb_jax
from floodsr_tpu.nn import ResUNetConfig as ConfigJAX
from floodsr_tpu.nn import init_resunet
from floodsr_tpu.parallel import make_mesh as make_mesh_jax
from floodsr_tpu.tiling import build_window_grid
from floodsr_tpu_torch.engine import scene_banded as sb
from floodsr_tpu_torch.engine.scene import SceneExecutor, scene_indices
from floodsr_tpu_torch.nn.checkpoint import params_from_jax
from floodsr_tpu_torch.nn.resunet import ResUNet, ResUNetConfig
from floodsr_tpu_torch.parallel.mesh import make_mesh

pytestmark = [pytest.mark.unit, pytest.mark.multidev]

CFG_KW = dict(
    base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
    fuse_filters=8, fuse_blocks=1, scale=4, lr_tile=8,
)
CFG = ResUNetConfig(**CFG_KW)
BUCKET = (256, 256)
OVERLAP = 8
STRIDE = CFG.hr_tile - OVERLAP  # 24
CHUNK = 4
MAX_DEPTH = 5.0
PCT = 95.0
CPU = torch.device("cpu")
ATOL_M = 1e-4
RMSE_VS_JAX_M = 1e-4
ATOL_VS_JAX_M = 2e-4


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    dem = rng.uniform(300, 800, BUCKET).astype(np.float32)
    depth = rng.uniform(0, 3, (BUCKET[0] // CFG.scale, BUCKET[1] // CFG.scale)).astype(np.float32)
    params, state = init_resunet(77, ConfigJAX(**CFG_KW))
    model = ResUNet(CFG)
    model.load_state_dict(params_from_jax(params, state))
    model.eval()
    grid = build_window_grid(BUCKET[0], BUCKET[1], CFG.hr_tile, STRIDE)
    return {"dem": dem, "depth": depth, "params": params, "state": state,
            "model": model, "grid": grid}


@pytest.fixture(scope="module")
def jax_banded(scene):
    """The JAX package's banded executor at dp=8 and dp=1: ``{dp: (out, stats)}``."""
    outs = {}
    for dp in (8, 1):
        mesh = make_mesh_jax(dp, tp=1)
        packed = sb_jax.pack_banded_scene(
            scene["depth"], scene["dem"], scene["grid"], n_bands=dp, tile=CFG.hr_tile,
            scale=CFG.scale, chunk=CHUNK,
        )
        shardings = sb_jax.banded_in_shardings(mesh)
        banded = {k: jax.device_put(v, shardings[k]) for k, v in packed.items() if k in shardings}
        fn, _ = sb_jax.build_banded_scene_executor(
            ConfigJAX(**CFG_KW), scene_shape=BUCKET, overlap_hr=OVERLAP, chunk=CHUNK,
            max_depth=MAX_DEPTH, dem_pct_clip=PCT, mesh=mesh, transfer_dtype="float32",
        )
        bands, stats = fn(scene["params"], scene["state"], banded)
        outs[dp] = (np.asarray(bands).reshape(BUCKET), np.asarray(stats))
    return outs


def _forward(model):
    return lambda depth, dem: model(depth, dem)


def _port_banded(scene, dp, cap=None, transfer_dtype="float32", replicas=None):
    packed = sb.pack_banded_scene(
        scene["depth"], scene["dem"], scene["grid"], n_bands=dp, tile=CFG.hr_tile,
        scale=CFG.scale, chunk=CHUNK, cap=cap,
    )
    fn, n_bands = sb.build_banded_scene_executor(
        CFG, scene_shape=BUCKET, overlap_hr=OVERLAP, chunk=CHUNK, max_depth=MAX_DEPTH,
        dem_pct_clip=PCT, mesh=make_mesh(devices=[CPU] * dp),
        replicas=replicas or {CPU: _forward(scene["model"])}, transfer_dtype=transfer_dtype,
    )
    assert n_bands == dp
    bands, stats = fn(packed)
    return torch.cat(bands).numpy(), torch.stack(stats).numpy(), packed


@pytest.mark.parametrize("dp,cap", [(8, None), (4, 48)])
def test_pack_banded_scene_equals_jax(scene, dp, cap):
    kw = dict(n_bands=dp, tile=CFG.hr_tile, scale=CFG.scale, chunk=CHUNK, cap=cap)
    got = sb.pack_banded_scene(scene["depth"], scene["dem"], scene["grid"], **kw)
    want = sb_jax.pack_banded_scene(scene["depth"], scene["dem"], scene["grid"], **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the last band's halo has no rows below it: zeros
    assert not got["dem"][-1, BUCKET[0] // dp :].any()


def test_band_plan_errors_match_jax(scene):
    for fn in (sb.band_plan, sb_jax.band_plan):
        with pytest.raises(AssertionError, match="must divide into 8 bands"):
            fn((250, 256), 8, 32)
        with pytest.raises(ValueError, match=r"band height 16 must be at least one tile \(32\)"):
            fn((128, 256), 8, 32)
    for pack in (sb.pack_banded_scene, sb_jax.pack_banded_scene):
        with pytest.raises(ValueError, match="must be a multiple of scale 3"):
            pack(np.zeros((80, 80), np.float32), np.zeros((256, 240), np.float32),
                 scene["grid"], n_bands=4, tile=32, scale=3, chunk=CHUNK)


@pytest.mark.parametrize("dp", [8, 1])
def test_banded_executor_matches_jax(scene, jax_banded, dp):
    got, stats, packed = _port_banded(scene, dp)
    want, want_stats = jax_banded[dp]
    assert float(np.sqrt(np.mean((got - want) ** 2))) <= RMSE_VS_JAX_M
    np.testing.assert_allclose(got, want, atol=ATOL_VS_JAX_M, rtol=0)
    live = packed["grid_slot"] >= 0
    np.testing.assert_allclose(stats[live], want_stats[live], rtol=1e-5)


def test_banded_matches_the_ports_unsharded_executor(scene):
    got, stats, packed = _port_banded(scene, 8)
    executor = SceneExecutor(
        scene["model"], scene_shape=BUCKET, overlap_hr=OVERLAP, max_depth=MAX_DEPTH,
        dem_pct_clip=PCT, chunk=CHUNK, transfer_dtype="float32",
    )
    want, want_stats = executor(
        torch.from_numpy(scene["depth"]), torch.from_numpy(scene["dem"]), scene_indices(scene["grid"])
    )
    np.testing.assert_allclose(got, want.numpy(), atol=ATOL_M, rtol=0)
    slot = packed["grid_slot"]
    np.testing.assert_array_equal(stats[slot >= 0], want_stats.numpy()[slot[slot >= 0]])


def test_per_band_staging_is_banded(scene):
    """The banded inputs stage ~1/dp of the scene (+halo) per device."""
    packed = sb.pack_banded_scene(
        scene["depth"], scene["dem"], scene["grid"], n_bands=8, tile=CFG.hr_tile,
        scale=CFG.scale, chunk=CHUNK,
    )
    band_rows = BUCKET[0] // 8 + CFG.hr_tile
    assert packed["dem"].shape == (8, band_rows, BUCKET[1])
    assert packed["depth"].shape == (8, band_rows // CFG.scale, BUCKET[1] // CFG.scale)
    # total staged DEM = scene + 8 halos, nowhere near 8x replication
    assert packed["dem"].nbytes < 2.5 * scene["dem"].nbytes


def test_seam_adds_the_received_halo_after_the_bands_own_tiles(scene, monkeypatch):
    """Each band adds the previous band's bottom-halo sums to its own tile
    sums (``buf[:band].at[:halo].add(received)``), then normalizes and clips."""
    seen = []
    real = sb.ppermute

    def spy(halos, perm):
        # each halo is a view of its band's whole accumulator: keep a copy of
        # that accumulator as it was before the exchange
        seen.append(([h._base.clone() for h in halos], perm))
        return real(halos, perm)

    monkeypatch.setattr(sb, "ppermute", spy)
    got, _, _ = _port_banded(scene, 4)
    (accs, perm), (wsums, _) = seen
    assert perm == [(0, 1), (1, 2), (2, 3)]
    band, halo = BUCKET[0] // 4, CFG.hr_tile
    for d in range(1, 4):
        acc = accs[d][:halo] + accs[d - 1][band:]
        ws = wsums[d][:halo] + wsums[d - 1][band:]
        want = torch.clamp(
            torch.where(ws > 0, acc / torch.clamp_min(ws, 1e-6), torch.zeros_like(acc)),
            0.0, MAX_DEPTH,
        )
        np.testing.assert_array_equal(got[d * band : d * band + halo], want.numpy())
    # band 0 receives nothing: its top rows are its own tiles alone
    acc, ws = accs[0][:halo], wsums[0][:halo]
    want = torch.clamp(torch.where(ws > 0, acc / torch.clamp_min(ws, 1e-6), 0.0), 0.0, MAX_DEPTH)
    np.testing.assert_array_equal(got[:halo], want.numpy())


def test_dummy_slots_add_nothing(scene):
    """A larger per-band capacity only adds zero-weight dummy slots: the
    bands are the same bits, the live stats too, and a chunk of dummies only
    never runs."""
    calls = []
    model = scene["model"]

    def counted(depth, dem):
        calls.append(depth.shape[0])
        return model(depth, dem)

    got, stats, packed = _port_banded(scene, 8, replicas={CPU: counted})
    n_calls = len(calls)
    got_cap, stats_cap, packed_cap = _port_banded(scene, 8, cap=32, replicas={CPU: counted})
    np.testing.assert_array_equal(got_cap, got)
    assert packed_cap["valid"].shape[1] > packed["valid"].shape[1]
    assert len(calls) - n_calls == n_calls
    for d in range(8):
        live = packed["grid_slot"][d] >= 0
        np.testing.assert_array_equal(stats_cap[d][: live.size][live], stats[d][live])
