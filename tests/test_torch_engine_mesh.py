"""``EngineTorch`` under a mesh (replicated and banded scenes, ``run_tiles``,
``warmup``), the worker, ``tohr`` and ``TohrService`` with mesh options,
against ``EngineJAX`` on the same mesh.

The JAX halves run on the suite's 8-device virtual CPU mesh, each computed
once per module; the port's on ``make_mesh(devices=[cpu] * n)`` with the
plain versions of the kernels. Tolerances: a meshed port scene agrees with
the port's unsharded scene to 1e-4 m (the reference's bound between its
banded and replicated scenes, ``tests/test_scene_banded.py``); against
``EngineJAX`` on the same mesh to the port's bar against JAX, 1e-4 m RMSE
(``tests/test_torch_scene_tohr.py``), and 2e-4 m at any pixel (the port's
unsharded scene already differs from JAX's by up to 1.25e-4 m at 2 of 65536
pixels near the ``max_depth`` clip, ``tests/test_torch_scene_banded.py``);
``run_tiles`` to 2e-4 (``tests/test_parallel_train.py``); per-tile stats to
1e-4.
"""

import numpy as np
import pytest
import torch

from floodsr_tpu.engine import EngineJAX
from floodsr_tpu.nn import ResUNetConfig as ConfigJAX
from floodsr_tpu.nn import init_resunet
from floodsr_tpu.nn.checkpoint import save_artifact
from floodsr_tpu.parallel import make_mesh as make_mesh_jax
from floodsr_tpu.tohr import tohr as tohr_jax
from floodsr_tpu_torch.engine import EngineTorch
from floodsr_tpu_torch.io import read_raster
from floodsr_tpu_torch.parallel.mesh import make_mesh
from floodsr_tpu_torch.serve import TohrService
from floodsr_tpu_torch.tohr import tohr

pytestmark = [pytest.mark.unit, pytest.mark.multidev]

CFG_KW = dict(
    base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
    fuse_filters=8, fuse_blocks=1, scale=4, lr_tile=8,
)
BUCKET = (256, 256)
OVERLAP = 8
STRIDE = 32 - OVERLAP
RUN = dict(stride_hr=STRIDE, overlap_hr=OVERLAP, max_depth=5.0, dem_pct_clip=95.0)
CPU = torch.device("cpu")
ATOL_M = 1e-4
RMSE_VS_JAX_M = 1e-4
ATOL_VS_JAX_M = 2e-4


def _cpus(n):
    return make_mesh(devices=[CPU] * n)


def _engine(fp, mesh=None, mode="replicated", **kw):
    return EngineTorch(
        fp, device="cpu", mesh=mesh, scene_mode=mode, max_batch=4,
        output_transfer=kw.pop("output_transfer", "float32"), **kw,
    )


def _close_to_jax(got, want):
    assert float(np.sqrt(np.mean((got - want) ** 2))) <= RMSE_VS_JAX_M
    np.testing.assert_allclose(got, want, atol=ATOL_VS_JAX_M, rtol=0)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny artifact and a 256² scene (LR 64²) with a 1 x 24 tile wide scene."""
    params, state = init_resunet(77, ConfigJAX(**CFG_KW))
    fp = tmp_path_factory.mktemp("mesh") / "tiny.fsrz"
    save_artifact(fp, ConfigJAX(**CFG_KW), params, state, {"seed": 77})
    rng = np.random.default_rng(5)
    wide = (32, 32 * 24)
    return {
        "fp": fp,
        "dem": rng.uniform(300, 800, BUCKET).astype(np.float32),
        "depth": rng.uniform(0, 3, (BUCKET[0] // 4, BUCKET[1] // 4)).astype(np.float32),
        "wide_dem": rng.uniform(300, 800, wide).astype(np.float32),
        "wide_depth": rng.uniform(0, 3, (wide[0] // 4, wide[1] // 4)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_scenes(tiny):
    """``EngineJAX`` on the 8-device mesh: the scene in both modes, the wide
    scene banded, and ``run_tiles``."""
    mesh = make_mesh_jax(8, tp=1)
    out = {}
    for mode in ("replicated", "banded"):
        eng = EngineJAX(tiny["fp"], mesh=mesh, scene_mode=mode, max_batch=4, output_transfer="float32")
        out[mode] = eng.run_scene(tiny["depth"], tiny["dem"], crop_shape=BUCKET, **RUN)
        if mode == "banded":
            out["wide"] = eng.run_scene(
                tiny["wide_depth"], tiny["wide_dem"], crop_shape=tiny["wide_dem"].shape, **RUN
            )
            try:
                eng.run_scene(tiny["depth"][:24, :24], tiny["dem"][:96, :96], crop_shape=(96, 96), **RUN)
            except ValueError as err:
                out["too_small"] = str(err)
        else:
            rng = np.random.default_rng(3)
            tiles = (rng.uniform(0, 3, (5, 8, 8)).astype(np.float32),
                     rng.uniform(400, 900, (5, 32, 32)).astype(np.float32))
            out["tiles"] = (tiles, eng.run_tiles(*tiles))
        eng.close()
    return out


@pytest.fixture(scope="module")
def port_plain(tiny):
    eng = _engine(tiny["fp"])
    out = eng.run_scene(tiny["depth"], tiny["dem"], crop_shape=BUCKET, **RUN)
    eng.close()
    return out


@pytest.mark.parametrize("mode", ["replicated", "banded"])
def test_run_scene_matches_engine_jax_on_the_same_mesh(tiny, jax_scenes, port_plain, mode):
    eng = _engine(tiny["fp"], _cpus(8), mode)
    got, stats = eng.run_scene(tiny["depth"], tiny["dem"], crop_shape=BUCKET, **RUN)
    assert set(eng.last_scene_timings) >= {"h2d_s", "exec_s", "finish_s", "tiles"}
    want, want_stats = jax_scenes[mode]
    _close_to_jax(got, want)
    np.testing.assert_allclose(got, port_plain[0], atol=ATOL_M, rtol=0)
    for k in want_stats:
        np.testing.assert_allclose(stats[k], want_stats[k], atol=1e-4)
        np.testing.assert_array_equal(stats[k], port_plain[1][k])
    # the uint16 and uint12 transfers: the same scene within one code (half a
    # code of rounding, or a whole one where the 1e-3 m mask meets a code)
    for transfer, codes in (("uint16", 65535), ("uint12", 4095)):
        eng_q = _engine(tiny["fp"], _cpus(8), mode, output_transfer=transfer)
        got_q, _ = eng_q.run_scene(tiny["depth"], tiny["dem"], crop_shape=BUCKET, **RUN)
        masked = np.where(got < 1e-3, 0.0, got)
        assert np.abs(got_q - masked).max() <= 5.0 / codes + 1e-6, transfer


def test_run_tiles_under_a_mesh(tiny, jax_scenes):
    (depth, dem), want = jax_scenes["tiles"]
    got = _engine(tiny["fp"], _cpus(8)).run_tiles(depth, dem)
    plain = _engine(tiny["fp"]).run_tiles(depth, dem)
    for key in ("predictions_m", "predictions_norm"):
        assert got[key].shape == (5, 32, 32)
        np.testing.assert_allclose(got[key], want[key], atol=2e-4)
        np.testing.assert_allclose(got[key], plain[key], atol=2e-4)
    for k in want["dem_stats_used"]:
        np.testing.assert_array_equal(got["dem_stats_used"][k], plain["dem_stats_used"][k])


def test_wide_scene_bands_by_columns(tiny, jax_scenes):
    """1 tile row x 24 tile columns over 8 bands: the column path, held
    against the replicated scene and against ``EngineJAX``'s banded one; the
    stats come back in the original orientation's grid order."""
    shape = tiny["wide_dem"].shape
    eng = _engine(tiny["fp"], _cpus(8), "banded")
    _, bucket, chunk, _, transposed = eng.banded_scene_executor(shape, **RUN)
    assert transposed and bucket == (shape[1], shape[0]) and chunk == 4
    got, stats = eng.run_scene(tiny["wide_depth"], tiny["wide_dem"], crop_shape=shape, **RUN)
    want, want_stats = _engine(tiny["fp"], _cpus(8)).run_scene(
        tiny["wide_depth"], tiny["wide_dem"], crop_shape=shape, **RUN
    )
    np.testing.assert_allclose(got, want, atol=ATOL_M, rtol=0)
    jax_out, jax_stats = jax_scenes["wide"]
    _close_to_jax(got, jax_out)
    for k in want_stats:
        np.testing.assert_array_equal(stats[k], want_stats[k])
        np.testing.assert_allclose(stats[k], jax_stats[k], atol=1e-4)


def test_scene_too_small_to_band_raises_the_jax_message(tiny, jax_scenes):
    eng = _engine(tiny["fp"], _cpus(8), "banded")
    with pytest.raises(ValueError, match="too small to band") as err:
        eng.run_scene(tiny["depth"][:24, :24], tiny["dem"][:96, :96], crop_shape=(96, 96), **RUN)
    assert str(err.value) == jax_scenes["too_small"]


def test_warmup_counts_banded_geometries(tiny):
    """Shapes that band to the same bucket in the same orientation warm once;
    a wide shape (column banding) is another geometry."""
    eng = _engine(tiny["fp"], _cpus(8), "banded")
    n = eng.warmup([BUCKET, (200, 256), (240, 250), (32, 768)], **RUN)
    assert n == 2
    assert _engine(tiny["fp"], _cpus(8)).warmup([BUCKET, (200, 256)], **RUN) == 2


def test_a_replica_per_distinct_device(tiny):
    """``[cpu:0, cpu:1]`` holds two model copies; ``[cpu] * 8`` one. The scene
    is the same bits either way."""
    two = _engine(tiny["fp"], make_mesh(devices=[torch.device("cpu", i) for i in range(2)]))
    one = _engine(tiny["fp"], _cpus(2))
    assert len(two._replicas) == 2 and len(one._replicas) == 1
    a, _ = two.run_scene(tiny["depth"], tiny["dem"], crop_shape=BUCKET, **RUN)
    b, _ = one.run_scene(tiny["depth"], tiny["dem"], crop_shape=BUCKET, **RUN)
    np.testing.assert_array_equal(a, b)
    assert one.device == CPU and two.device == torch.device("cpu", 0)
    with pytest.raises(AssertionError):
        _engine(tiny["fp"], _cpus(2), "striped")


def test_device_postprocess_stays_off_under_a_mesh(tiny, monkeypatch):
    """A rectilinear post-resample runs on the host under a mesh, as in the
    JAX package, and gives the host plan applied to the plain engine's
    model-grid scene (``tests/test_torch_finish.py``'s ``_host_plan``)."""
    from floodsr_tpu_torch.io.affine import Affine

    from test_torch_finish import _host_plan

    post = ((200, 200), Affine(1.0, 0, 0, 0, -1.0, 256.0), Affine(1.28, 0, 0, 0, -1.28, 256.0))
    scene, _ = _engine(tiny["fp"]).run_scene(
        tiny["depth"], tiny["dem"], crop_shape=BUCKET, low_depth_mask_m=0.0, **RUN
    )
    want = _host_plan("torch", scene, post, RUN["max_depth"])
    eng = _engine(tiny["fp"], _cpus(4), "banded")
    monkeypatch.setattr(eng, "_postproc_on_device", None)
    got, _ = eng.run_scene(tiny["depth"], tiny["dem"], crop_shape=BUCKET, post_resample=post, **RUN)
    assert got.shape == (200, 200)
    np.testing.assert_allclose(got, want, atol=ATOL_M, rtol=0)


@pytest.mark.parametrize("mode", ["banded"])
def test_tohr_carries_the_mesh_through_the_worker(
    tiny_model_fp, synthetic_tohr_tiles, tmp_path, monkeypatch, mode
):
    """``engine_options={"mesh", "scene_mode"}`` reach the engine (nothing is
    dropped), and the raster is ``tohr`` of the JAX package on its mesh."""
    seen = []
    real_init = EngineTorch.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        seen.append((self.mesh, self.scene_mode))

    kw = dict(
        model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
        depth_lr_fp=synthetic_tohr_tiles["depth_lr_fp"], dem_hr_fp=synthetic_tohr_tiles["dem_fp"],
    )
    mesh = _cpus(2)
    monkeypatch.setattr(EngineTorch, "__init__", init)
    tohr(output_fp=tmp_path / "port.tif", device="cpu",
         engine_options={"mesh": mesh, "scene_mode": mode}, **kw)
    monkeypatch.undo()
    assert seen == [(mesh, mode)]
    tohr_jax(output_fp=tmp_path / "jax.tif",
             engine_options={"mesh": make_mesh_jax(2, tp=1), "scene_mode": mode}, **kw)
    tohr(output_fp=tmp_path / "plain.tif", device="cpu", **kw)
    got, want, plain = (read_raster(tmp_path / f"{n}.tif")[0] for n in ("port", "jax", "plain"))
    assert float(np.sqrt(np.mean((got - want) ** 2))) <= RMSE_VS_JAX_M
    # one uint16 step of the transfer (max_depth 5 m by the test artifact's default)
    assert np.abs(got - plain).max() <= 5.0 / 65535 + 1e-6


def test_tohr_service_runs_a_banded_mesh(tiny_model_fp, synthetic_tohr_tiles, tmp_path):
    """The one daemon thread drives every device of the mesh."""
    service = TohrService(
        device="cpu", model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
        engine_options={"mesh": _cpus(2), "scene_mode": "banded"},
    )
    service.start()
    try:
        assert service._worker.engine.scene_mode == "banded"
        assert service.warmup([(64, 64)]) == 1
        job = {"in": str(synthetic_tohr_tiles["depth_lr_fp"]),
               "dem": str(synthetic_tohr_tiles["dem_fp"]), "out": str(tmp_path / "served.tif")}
        service.handle_tohr(job)
    finally:
        service.close()
    tohr(model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
         depth_lr_fp=synthetic_tohr_tiles["depth_lr_fp"], dem_hr_fp=synthetic_tohr_tiles["dem_fp"],
         output_fp=tmp_path / "plain.tif", device="cpu")
    got, plain = read_raster(tmp_path / "served.tif")[0], read_raster(tmp_path / "plain.tif")[0]
    assert np.abs(got - plain).max() <= 5.0 / 65535 + 1e-6
