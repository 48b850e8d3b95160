"""The finish stage: ``uint12`` transfer and the device postprocess.

The port on ``device="cpu"`` against the JAX package on the same numpy-seeded
inputs. The 12-bit reduction and the pack are exact integer arithmetic, so
they are held bit for bit; the device postprocess is f32 lerps, which XLA may
contract into FMAs, so it is held to one uint16 code (``max_depth / 65535``)
or 1e-5 m in float32. The host path it is held against is the host plan
applied here (:func:`_host_plan`): the scene on the model grid, then
``separable_resample_np`` → clip → low-depth mask, as the engine's host
finish does under a mesh. ``tests/test_torch_finish_engines.py`` holds the same
stage against the JAX engine, through ``tohr`` and through the daemon.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from floodsr_tpu.engine import EngineJAX
from floodsr_tpu_torch.engine import EngineTorch
from floodsr_tpu_torch.io import read_raster
from floodsr_tpu_torch.io.affine import from_origin
from floodsr_tpu_torch.tohr import tohr as tohr_torch

pytestmark = pytest.mark.unit

MAX_DEPTH = 5.0


@pytest.fixture(scope="module")
def engines(tiny_model_fp):
    made = {}

    def get(kind, transfer):
        key = (kind, transfer)
        if key not in made:
            if kind == "jax":
                made[key] = EngineJAX(tiny_model_fp, max_batch=4, output_transfer=transfer)
            else:
                made[key] = EngineTorch(
                    tiny_model_fp, max_batch=4, output_transfer=transfer, device="cpu"
                )
        return made[key]

    yield get
    for eng in made.values():
        eng.close()


# -- uint12 -----------------------------------------------------------------


@pytest.mark.parametrize("cols", [10, 11, 1, 64], ids=["even", "odd", "one", "wide"])
def test_pack12_is_the_jax_pack_bit_for_bit(engines, cols):
    rng = np.random.default_rng(cols)
    rows = 7
    q16 = rng.integers(0, 65536, (rows + 2, cols + 3), dtype=np.uint16)
    q16[0, :4] = [0, 65535, 8, 7]  # the ends of the range and a rounding boundary
    jax_eng = engines("jax", "uint12")
    fn = jax_eng._row_slice_pack12_fn(q16.shape, q16.dtype, rows, cols)
    want = np.asarray(fn(jnp.asarray(q16), np.int32(0)))
    got = EngineTorch._pack12(torch.from_numpy(q16)[:rows, :cols])
    assert got.dtype == torch.uint8 and tuple(got.shape) == (rows, 3 * ((cols + 1) // 2))
    np.testing.assert_array_equal(got.numpy(), want)
    # the 12-bit codes are round(q16 * 4095 / 65535), and the unpack returns them
    dequant = MAX_DEPTH / 4095.0
    codes = np.round(q16[:rows, :cols].astype(np.float64) * 4095.0 / 65535.0)
    back = EngineTorch._unpack12(got.numpy(), cols, dequant)
    assert back.dtype == np.float32 and back.shape == (rows, cols)
    np.testing.assert_array_equal(back, (codes.astype(np.float32) * np.float32(dequant)))
    np.testing.assert_array_equal(back, EngineJAX._unpack12(want, cols, dequant))


def _scene(seed=21):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0, 3, (16, 16)).astype(np.float32)
    dem = rng.uniform(300, 800, (64, 64)).astype(np.float32)
    return depth, dem


def _run(eng, crop=(64, 64), post_resample=None, low_depth_mask_m=1e-3, **sink):
    """``eng``'s scene; ``sink=`` goes to the port's engine only."""
    depth, dem = _scene()
    out, _ = eng.run_scene(
        depth, dem, stride_hr=24, overlap_hr=8, max_depth=MAX_DEPTH, dem_pct_clip=95.0,
        crop_shape=crop, post_resample=post_resample, low_depth_mask_m=low_depth_mask_m,
        **sink,
    )
    return out


@pytest.mark.parametrize("crop", [(64, 64), (61, 59)], ids=["even", "odd_width"])
def test_engine_uint12_matches_the_jax_engine_and_float32(engines, crop):
    got = _run(engines("torch", "uint12"), crop)
    want = _run(engines("jax", "uint12"), crop)
    ref = _run(engines("torch", "float32"), crop)
    assert got.shape == want.shape == crop and got.dtype == np.float32
    step = MAX_DEPTH / 4095.0
    # a 12-bit code apart at most (the networks sum in another order), and
    # nearly everywhere the same code
    assert float(np.abs(got - want).max()) <= step * 1.0001
    assert float(np.mean(got == want)) > 0.99
    # uint12 is float32 within half its step (plus half a uint16 step before it);
    # pixels under the low-depth mask go to 0 on either side of it
    keep = (ref >= 1e-3) & (got >= 1e-3)
    assert float(np.abs(got - ref)[keep].max()) <= 0.5 * step + 0.5 * MAX_DEPTH / 65535.0 + 1e-6
    assert float(np.abs(got - ref).max()) <= step
    assert engines("torch", "uint12").last_scene_timings["d2h_bytes"] == crop[0] * 3 * ((crop[1] + 1) // 2)


class _Bands(list):
    """A sink that keeps the bands it is handed."""

    write_rows = list.append


def test_uint12_rows_reach_the_sink_and_tohr_writes_them(engines, tiny_model_fp, synthetic_tohr_tiles, tmp_path):
    bands = _Bands()
    out = _run(engines("torch", "uint12"), sink=bands)
    np.testing.assert_array_equal(np.concatenate(bands), out)
    outs = {}
    for transfer in ("uint12", "float32"):
        fp = tmp_path / f"{transfer}.tif"
        tohr_torch(
            model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
            depth_lr_fp=synthetic_tohr_tiles["depth_lr_fp"],
            dem_hr_fp=synthetic_tohr_tiles["dem_fp"], output_fp=fp, device="cpu",
            engine_options={"output_transfer": transfer},
        )
        outs[transfer] = read_raster(fp)[0]
    assert float(np.abs(outs["uint12"] - outs["float32"]).max()) <= MAX_DEPTH / 4095.0


# -- device postprocess -------------------------------------------------------


def _post_resample():
    # model space 64x64 @1.875 m -> raw grid 60x60 @2.0 m
    return (60, 60), from_origin(0.0, 120.0, 1.875, 1.875), from_origin(0.0, 120.0, 2.0, 2.0)


def _host_plan(kind, scene, post_resample, max_depth=MAX_DEPTH, low_depth_mask_m=1e-3):
    """The host finish after the model grid, with ``kind``'s package's
    resample: ``separable_resample_np`` → clip → low-depth mask. ``scene`` is
    the model grid finished without a mask (``low_depth_mask_m=0``)."""
    if kind == "jax":
        from floodsr_tpu.ops.resample import separable_resample_np
    else:
        from floodsr_tpu_torch.ops.resample import separable_resample_np
    dst_shape, src_t, dst_t = post_resample
    out = np.clip(separable_resample_np(scene, src_t, dst_shape, dst_t), 0.0, max_depth)
    return np.where(out < low_depth_mask_m, 0.0, out).astype(np.float32)


def _run_postproc(engines, kind, on_device, transfer):
    """The scene onto the raw grid: by the engine's device postprocess, or
    by the host plan applied to the engine's model-grid scene."""
    post = _post_resample()
    if kind == "jax":
        from floodsr_tpu.io.affine import from_origin as from_origin_jax

        post = ((60, 60), from_origin_jax(0.0, 120.0, 1.875, 1.875),
                from_origin_jax(0.0, 120.0, 2.0, 2.0))
    if on_device:
        return _run(engines(kind, transfer), post_resample=post)
    return _host_plan(kind, _run(engines(kind, transfer), low_depth_mask_m=0.0), post)


@pytest.mark.parametrize("transfer,atol", [
    ("float32", 1e-5), ("uint16", 2 * MAX_DEPTH / 65535.0), ("uint12", 2 * MAX_DEPTH / 4095.0),
])
def test_device_postproc_matches_host_resampler(engines, transfer, atol):
    dev = _run_postproc(engines, "torch", True, transfer)
    timings = dict(engines("torch", transfer).last_scene_timings)
    host = _run_postproc(engines, "torch", False, transfer)
    assert dev.shape == host.shape == (60, 60)
    # float32: f32 lerp rounding; quantized: one more quantization round trip
    np.testing.assert_allclose(dev, host, atol=atol, rtol=0)
    # the device path downloads the raw DEM grid, the host path the model grid
    per_px = {"float32": 4.0, "uint16": 2.0, "uint12": 1.5}[transfer]
    assert timings["d2h_bytes"] == int(60 * 60 * per_px)
    assert engines("torch", transfer).last_scene_timings["d2h_bytes"] == int(64 * 64 * per_px)
    assert timings["host_resample_s"] < 1e-3 < 1.0 + timings["device_post_s"]


def test_device_postproc_applies_low_depth_mask(engines):
    out = _run_postproc(engines, "torch", True, "float32")
    tiny = (out > 0) & (out < 1e-3)
    assert not tiny.any()  # sub-threshold depths were zeroed on the device
    assert (out > 0).any() and float(out.max()) <= MAX_DEPTH


def test_device_postproc_is_not_masked_again_on_the_host(tiny_model_fp, monkeypatch):
    # After the device postprocess the host must not clip and mask again: a
    # value the device kept is returned as it was downloaded.
    eng = EngineTorch(tiny_model_fp, output_transfer="float32", device="cpu")
    scene = torch.full((64, 64), 2.0)
    scene[8:16, 8:16] = 9.0  # above max_depth: the device clips it
    seen = {}
    real = eng._postproc_on_device

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        seen["max"] = float(res.max())
        res[0, 0] = 5e-4  # what a host-side mask would zero
        return res

    monkeypatch.setattr(eng, "_postproc_on_device", spy)
    out = eng._finish_scene(
        scene, crop_shape=(64, 64), max_depth=MAX_DEPTH, post_resample=_post_resample(),
        low_depth_mask_m=1e-3,
    )
    assert seen["max"] == MAX_DEPTH
    assert out[0, 0] == np.float32(5e-4)
    # a general (non-rectilinear) warp stays on the host
    from floodsr_tpu_torch.io.affine import Affine

    rot = Affine(1.4, 1.4, 0.0, 1.4, -1.4, 120.0)
    out = eng._finish_scene(
        scene, crop_shape=(64, 64), max_depth=MAX_DEPTH,
        post_resample=((40, 40), rot, from_origin(0.0, 120.0, 2.0, 2.0)), low_depth_mask_m=1e-3,
    )
    assert out.shape == (40, 40) and float(out.max()) <= MAX_DEPTH
    eng.close()
