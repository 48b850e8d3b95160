"""``depth_metrics_torch`` against ``depth_metrics_jax`` and the host metrics.

The cases of ``tests/test_eval_metrics.py``'s ``TestDeviceMetrics`` against the
port on the CPU; rtol 1e-4 against the float64 host metrics, 1e-5 against the
JAX twin (f32 sums in another order), NaN where it gives NaN.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from floodsr_tpu.eval.metrics import depth_metrics_jax
from floodsr_tpu_torch.eval import compute_depth_error_metrics, depth_metrics_torch

pytestmark = pytest.mark.unit


def test_depth_metrics_torch_matches_jax_and_the_host_metrics():
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 3, size=(24, 24)).astype(np.float32)
    ref[ref < 0.5] = 0.0
    est = np.clip(ref + rng.normal(0, 0.2, ref.shape), 0, 5).astype(np.float32)
    host = compute_depth_error_metrics(ref, est, max_depth=5.0)
    dev = depth_metrics_torch(torch.from_numpy(ref), torch.from_numpy(est), max_depth=5.0)
    want = depth_metrics_jax(jnp.asarray(ref), jnp.asarray(est), max_depth=5.0)
    assert set(dev) == set(want)
    for key in ("rmse_m", "mase_m", "bias_m", "ssim", "psnr", "rmse_wet_m"):
        np.testing.assert_allclose(float(dev[key]), host[key], rtol=1e-4)
    for key in want:  # f32 sums in another order
        np.testing.assert_allclose(float(dev[key]), float(want[key]), rtol=1e-5, atol=1e-7)


def test_depth_metrics_torch_batched_shapes_and_nans():
    rng = np.random.default_rng(1)
    ref = rng.uniform(0, 3, size=(2, 3, 16, 16)).astype(np.float32)
    ref[0, 1] = 0.0  # no wet reference pixel
    est = ref + 0.1
    est[1, 2] = 0.0
    ref[1, 2] = 0.0  # dry on both sides
    dev = depth_metrics_torch(torch.from_numpy(ref), torch.from_numpy(est), max_depth=5.0)
    want = depth_metrics_jax(jnp.asarray(ref), jnp.asarray(est), max_depth=5.0)
    for key, value in dev.items():
        assert tuple(value.shape) == (2, 3)
        w = np.asarray(want[key])
        np.testing.assert_array_equal(np.isnan(value.numpy()), np.isnan(w))
        np.testing.assert_allclose(value.numpy(), w, rtol=1e-5, atol=1e-7, equal_nan=True)
    assert bool(torch.isnan(dev["rmse_wet_m"][0, 1])) and bool(torch.isnan(dev["csi"][1, 2]))
    assert not bool(torch.isnan(dev["csi"][0, 1]))  # the estimate is wet there: csi = 0
    assert float(dev["csi"][0, 1]) == 0.0


def test_depth_metrics_torch_csi_definition():
    ref = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
    est = torch.tensor([[1.0, 1.0], [0.0, 0.0]])
    dev = depth_metrics_torch(ref, est, max_depth=5.0)
    # hits=1, misses=1, false_alarms=1 -> csi = 1/3
    np.testing.assert_allclose(float(dev["csi"]), 1 / 3, rtol=1e-6)
