"""The port's DEM upload and large-grid warp vs the JAX package, on the CPU."""

import numpy as np
import pytest
import torch

from floodsr_tpu.io.affine import Affine as AffineJax
from floodsr_tpu.ops.resample import reproject_bilinear_auto as warp_jax
from floodsr_tpu.ops.transfer import device_put_dem_quantized as put_jax
from floodsr_tpu_torch.io.affine import Affine
from floodsr_tpu_torch.ops.resample import reproject_bilinear, reproject_bilinear_auto
from floodsr_tpu_torch.ops.transfer import device_put_dem_quantized

pytestmark = pytest.mark.unit


@pytest.mark.parametrize("nodata", [None, -9999.0])
def test_quantized_dem_upload_matches_jax(nodata):
    # 1500² f32 is over the 8 MiB encoding threshold: the uint16 path runs.
    rng = np.random.default_rng(0)
    dem = (250.0 + np.cumsum(rng.normal(0, 0.2, (1500, 1500)), axis=1)).astype(np.float32)
    if nodata is not None:
        dem[:7, :11] = nodata
    got = device_put_dem_quantized(dem, nodata, device="cpu")
    want = np.asarray(put_jax(dem, nodata))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    # Same codes and the same f32 dequantization (code * step + min):
    # equal up to one f32 rounding of the product.
    step = (float(dem[dem != nodata].max()) - float(dem[dem != nodata].min())) / 65534.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * step + 6e-5)
    # Within half a step of the input; nodata round-trips exactly.
    valid = dem != nodata if nodata is not None else np.ones_like(dem, bool)
    assert np.abs(got.numpy()[valid] - dem[valid]).max() <= 0.5 * step + 1e-4
    if nodata is not None:
        assert np.all(got.numpy()[:7, :11] == np.float32(nodata))


def test_small_upload_is_exact():
    dem = np.arange(64, dtype=np.float32).reshape(8, 8)
    assert np.array_equal(device_put_dem_quantized(dem, device="cpu").numpy(), dem)


def test_large_warp_runs_separable_on_the_device_and_matches_jax():
    # 2100² destination pixels is over the device-warp threshold; the port
    # warps with two f32 matmuls, JAX with its jitted warp, numpy in f64.
    rng = np.random.default_rng(1)
    src = (100.0 + np.cumsum(rng.normal(0, 0.5, (140, 140)), axis=0)).astype(np.float32)
    x0, y0 = 500000.0, 4000000.0
    src_t = (30.0, 0.0, x0, 0.0, -30.0, y0)
    dst_t = (2.0, 0.0, x0 + 1.0, 0.0, -2.0, y0 - 1.0)
    dst_shape = (2100, 2100)
    got = reproject_bilinear_auto(
        src, Affine(*src_t), dst_shape, Affine(*dst_t), device="cpu"
    )
    want = warp_jax(src, AffineJax(*src_t), dst_shape, AffineJax(*dst_t))
    host = reproject_bilinear(src, Affine(*src_t), dst_shape, Affine(*dst_t))
    assert got.shape == dst_shape and got.dtype == np.float32
    # f32 products and sums of elevation-scale values (~1e2): a few ulps.
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-4)
