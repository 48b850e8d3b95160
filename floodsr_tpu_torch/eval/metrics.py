"""Depth-error metrics for evaluation and regression gating.

Copy of the JAX package's numpy metrics (reference: ``misc/eval.py:6-72``):
max_depth-referenced PSNR, a global (single-window) SSIM with ``c1/c2``
derived from ``max_depth``, RMSE, wet-pixel RMSE (wet = reference >= 1e-3 m),
MAE (also exported as ``mase_m``), bias, MSE, and wet/dry pixel counts; and
:func:`depth_metrics_torch`, the device twin (adds CSI), batched over leading
dims, for loops that aggregate on the device without a host read.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def compute_depth_error_metrics(
    reference_depth_m: np.ndarray,
    estimate_depth_m: np.ndarray,
    max_depth: float,
    dry_depth_thresh_m: float = 1e-3,
) -> dict[str, float]:
    """Pairwise depth error metrics for one 2-D scene (host, float64 accum)."""
    if reference_depth_m.ndim != 2:
        raise AssertionError(f"reference depth must be 2D; got {reference_depth_m.shape}")
    if estimate_depth_m.shape != reference_depth_m.shape:
        raise AssertionError(
            f"estimate shape {estimate_depth_m.shape} must match reference shape "
            f"{reference_depth_m.shape}"
        )
    if max_depth <= 0:
        raise AssertionError(f"max_depth must be > 0; got {max_depth}")

    ref = reference_depth_m.astype(np.float32, copy=False)
    est = estimate_depth_m.astype(np.float32, copy=False)
    diff = est - ref
    wet_mask = ref >= dry_depth_thresh_m
    wet_pixel_count = int(wet_mask.sum())
    total_pixels = int(ref.size)
    dry_pixel_count = total_pixels - wet_pixel_count

    mse_all = float(np.mean(np.square(diff), dtype=np.float64))
    rmse_all = float(np.sqrt(mse_all))
    mae_all = float(np.mean(np.abs(diff), dtype=np.float64))
    bias_all = float(np.mean(diff, dtype=np.float64))
    rmse_wet = (
        float(np.sqrt(np.mean(np.square(diff[wet_mask]), dtype=np.float64)))
        if wet_pixel_count > 0
        else float("nan")
    )
    psnr = (
        float(np.inf)
        if mse_all <= 0.0
        else float(20.0 * np.log10(max_depth) - 10.0 * np.log10(mse_all))
    )

    # Global single-window SSIM with max_depth-derived stabilizers.
    ref64 = ref.astype(np.float64, copy=False)
    est64 = est.astype(np.float64, copy=False)
    mu_x, mu_y = float(ref64.mean()), float(est64.mean())
    sigma_x, sigma_y = float(ref64.var()), float(est64.var())
    sigma_xy = float(((ref64 - mu_x) * (est64 - mu_y)).mean())
    c1 = float((0.01 * max_depth) ** 2)
    c2 = float((0.03 * max_depth) ** 2)
    ssim_num = (2.0 * mu_x * mu_y + c1) * (2.0 * sigma_xy + c2)
    ssim_den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    ssim = float(ssim_num / ssim_den) if ssim_den != 0.0 else float("nan")

    return {
        "psnr": psnr,
        "ssim": ssim,
        "rmse_m": rmse_all,
        "rmse_wet_m": rmse_wet,
        "mae_m": mae_all,
        "mase_m": mae_all,
        "bias_m": bias_all,
        "mse_m2": mse_all,
        "dry_pixel_count": dry_pixel_count,
        "wet_pixel_count": wet_pixel_count,
    }


@torch.no_grad()
def depth_metrics_torch(
    reference_depth_m: torch.Tensor,
    estimate_depth_m: torch.Tensor,
    max_depth: float,
    dry_depth_thresh_m: float = 1e-3,
) -> dict[str, torch.Tensor]:
    """Metric set over the two trailing spatial dims (leading dims batched).

    Port of the JAX package's ``depth_metrics_jax``: per-example tensors, on
    the inputs' device, for psnr/ssim/rmse/rmse_wet/mae/bias/mse/csi. NaN where
    it gives NaN: ``rmse_wet_m`` with no wet reference pixel, ``csi`` with no
    wet pixel on either side. Variances are population variances.
    """
    ref = reference_depth_m.to(torch.float32)
    est = estimate_depth_m.to(torch.float32)
    batch_shape = ref.shape[:-2]
    ref2 = ref.reshape(*batch_shape, -1)
    est2 = est.reshape(*batch_shape, -1)
    diff = est2 - ref2
    nan = torch.full((), float("nan"), dtype=torch.float32, device=ref.device)

    mse = torch.mean(torch.square(diff), dim=-1)
    rmse = torch.sqrt(mse)
    mae = torch.mean(torch.abs(diff), dim=-1)
    bias = torch.mean(diff, dim=-1)
    psnr = 20.0 * math.log10(max_depth) - 10.0 * torch.log10(torch.clamp_min(mse, 1e-12))

    wet_ref = ref2 >= dry_depth_thresh_m
    wet_count = torch.sum(wet_ref, dim=-1)
    wet_mse = torch.sum(torch.square(diff) * wet_ref, dim=-1) / torch.clamp_min(wet_count, 1)
    rmse_wet = torch.where(wet_count > 0, torch.sqrt(wet_mse), nan)

    mu_x = torch.mean(ref2, dim=-1)
    mu_y = torch.mean(est2, dim=-1)
    sigma_x = torch.var(ref2, dim=-1, unbiased=False)
    sigma_y = torch.var(est2, dim=-1, unbiased=False)
    sigma_xy = torch.mean((ref2 - mu_x[..., None]) * (est2 - mu_y[..., None]), dim=-1)
    c1 = (0.01 * max_depth) ** 2
    c2 = (0.03 * max_depth) ** 2
    ssim = ((2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)) / (
        (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    )

    wet_est = est2 >= dry_depth_thresh_m
    hits = torch.sum(wet_ref & wet_est, dim=-1)
    misses = torch.sum(wet_ref & ~wet_est, dim=-1)
    false_alarms = torch.sum(~wet_ref & wet_est, dim=-1)
    csi_den = hits + misses + false_alarms
    csi = torch.where(csi_den > 0, hits / torch.clamp_min(csi_den, 1), nan)

    return {
        "psnr": psnr,
        "ssim": ssim,
        "rmse_m": rmse,
        "rmse_wet_m": rmse_wet,
        "mae_m": mae,
        "mase_m": mae,
        "bias_m": bias,
        "mse_m2": mse,
        "csi": csi,
    }
