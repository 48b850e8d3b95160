"""Depth/DEM normalization math — numpy (host) and PyTorch (device) twins.

Semantics mirror the reference preprocessing exactly
(reference: ``floodsr/preprocessing.py:61-172``):

- depth: ``clip(x, 0, max_depth)`` → ``log1p(x) / log1p(max_depth)`` → clip [0,1]
  and the ``expm1`` inverse;
- DEM: clip negatives to 0, take the ``pct``-th percentile (numpy ``linear``
  interpolation, identical to ``np.nanpercentile`` on the finite inputs this
  pipeline guarantees), clip to it, min-max scale from the clipped stats with a
  zero-range guard.

The numpy functions are copies of the JAX package's host path and keep the
reference's raising validation. The torch functions run batched over tile
stacks on the device and map the zero-range error case to a zero output
(callers re-check the returned stats host-side where reference-parity raising
is required). The per-tile percentile stats go through the hand-written
``tile_stats`` CUDA kernel for a CUDA tensor
(:mod:`floodsr_tpu_torch.ops.kernels.tile_stats`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# numpy (host) implementations — raising validation, reference-parity names
# ---------------------------------------------------------------------------


def _as_numeric_np_array(
    arr: np.ndarray,
    name: str,
    min_rank: int = 1,
    allow_ranks: Optional[tuple[int, ...]] = None,
    require_single_channel_last_dim: bool = False,
) -> np.ndarray:
    """Validate numeric dtype, rank, and finiteness; return as ndarray."""
    out = np.asarray(arr)
    if out.dtype == np.bool_ or not np.issubdtype(out.dtype, np.number):
        raise AssertionError(f"{name} must have numeric dtype; got {out.dtype}")
    rank = int(out.ndim)
    if allow_ranks is not None:
        if rank not in allow_ranks:
            raise AssertionError(
                f"{name} rank must be one of {allow_ranks}; got rank {rank} shape {out.shape}"
            )
    elif rank < min_rank:
        raise AssertionError(f"{name} rank must be >= {min_rank}; got rank {rank} shape {out.shape}")
    if require_single_channel_last_dim and rank >= 3 and out.shape[-1] != 1:
        raise AssertionError(f"{name} last dim must be 1 for rank >=3; got shape {out.shape}")
    if not np.all(np.isfinite(out)):
        raise AssertionError(f"{name} must contain only finite values")
    return out


def _depth_log1p_denom(max_depth: float) -> float:
    """Validated ``log1p(max_depth)`` denominator for depth scaling."""
    max_depth = float(max_depth)
    if not np.isfinite(max_depth) or max_depth <= 0:
        raise AssertionError(f"max_depth must be finite and > 0; got {max_depth}")
    denom = float(np.log1p(max_depth))
    if not np.isfinite(denom) or denom <= 0:
        raise AssertionError(f"log1p(max_depth) must be finite and > 0; got {denom}")
    return denom


def scale_depth_log1p_np(arr: Optional[np.ndarray], max_depth: float) -> Optional[np.ndarray]:
    """Normalize depth meters to [0,1] with log1p scaling (host path)."""
    if arr is None:
        return None
    denom = _depth_log1p_denom(max_depth)
    arr_np = _as_numeric_np_array(arr, "depth_arr", min_rank=1).astype(np.float32, copy=False)
    arr_np = np.clip(arr_np, 0.0, float(max_depth))
    scaled = np.log1p(arr_np) / denom
    return np.clip(scaled, 0.0, 1.0).astype(np.float32, copy=False)


def invert_depth_log1p_np(arr: Optional[np.ndarray], max_depth: float) -> Optional[np.ndarray]:
    """Invert log1p-normalized depth back to meters (host path)."""
    if arr is None:
        return None
    denom = _depth_log1p_denom(max_depth)
    arr_np = _as_numeric_np_array(arr, "normalized_depth_arr", min_rank=1).astype(
        np.float32, copy=False
    )
    arr_np = np.clip(arr_np, 0.0, 1.0)
    inv = np.expm1(arr_np * denom)
    return np.clip(inv, 0.0, float(max_depth)).astype(np.float32, copy=False)


def _parse_dem_normalization_stats(ref_stats: dict[str, float]) -> tuple[float, float, float]:
    """Validate and unpack explicit DEM normalization statistics."""
    required = {"p_clip", "dem_min", "dem_max"}
    missing = required.difference(ref_stats.keys())
    if missing:
        raise AssertionError(f"DEM ref_stats missing keys: {sorted(missing)}")
    p_clip = float(ref_stats["p_clip"])
    dem_min = float(ref_stats["dem_min"])
    dem_max = float(ref_stats["dem_max"])
    if not (np.isfinite(p_clip) and np.isfinite(dem_min) and np.isfinite(dem_max)):
        raise AssertionError("DEM ref_stats values must be finite")
    if p_clip < 0:
        raise AssertionError(f"DEM p_clip must be >= 0; got {p_clip}")
    if dem_min > dem_max:
        raise AssertionError(f"DEM dem_min must be <= dem_max; got min={dem_min} max={dem_max}")
    if (dem_max - dem_min) <= 0:
        raise AssertionError(f"DEM range must be > 0; got min={dem_min}, max={dem_max}")
    return p_clip, dem_min, dem_max


def normalize_dem_with_stats_np(
    arr: np.ndarray,
    p_clip: float,
    dem_min: float,
    dem_max: float,
) -> np.ndarray:
    """Normalize DEM with explicit stats; zero output for the pinned-zero case."""
    if not (np.isfinite(p_clip) and np.isfinite(dem_min) and np.isfinite(dem_max)):
        raise AssertionError("p_clip, dem_min, and dem_max must be finite")
    dem_range = dem_max - dem_min
    arr_np = _as_numeric_np_array(
        arr, "dem_arr", allow_ranks=(2, 3, 4), require_single_channel_last_dim=True
    ).astype(np.float32, copy=False)
    if dem_range <= 0:
        if np.isclose(dem_range, 0.0) and np.isclose(dem_min, 0.0):
            # All-zero DEMs occur on padded/nodata edges; keep a stable output.
            return np.zeros_like(arr_np)
        raise AssertionError(f"DEM range must be > 0; got min={dem_min}, max={dem_max}")
    arr_clipped = np.clip(arr_np, 0.0, float(p_clip))
    arr_norm = (arr_clipped - float(dem_min)) / float(dem_range)
    return np.clip(arr_norm, 0.0, 1.0).astype(np.float32, copy=False)


def normalize_dem(
    arr: Optional[np.ndarray],
    pct_clip: float = 95.0,
    ref_stats: Optional[dict[str, float]] = None,
) -> tuple[Optional[np.ndarray], Optional[dict[str, float]]]:
    """Clip + min-max normalize a DEM to [0,1] with tile-local or explicit stats."""
    if arr is None:
        return None, None
    if ref_stats is None:
        pct_clip = float(pct_clip)
        if not np.isfinite(pct_clip) or not (0 < pct_clip <= 100):
            raise AssertionError(f"dem_pct_clip must be finite and in (0, 100]; got {pct_clip}")
        arr_np = _as_numeric_np_array(
            arr, "dem_arr", allow_ranks=(2, 3, 4), require_single_channel_last_dim=True
        ).astype(np.float32, copy=False)
        arr_np = np.clip(arr_np, 0.0, None)
        p_clip = float(np.nanpercentile(arr_np, pct_clip))
        arr_for_stats = np.clip(arr_np, 0.0, p_clip)
        dem_min = float(np.nanmin(arr_for_stats))
        dem_max = float(np.nanmax(arr_for_stats))
    else:
        p_clip, dem_min, dem_max = _parse_dem_normalization_stats(ref_stats)
    arr_norm = normalize_dem_with_stats_np(arr, p_clip=p_clip, dem_min=dem_min, dem_max=dem_max)
    return arr_norm, {"p_clip": p_clip, "dem_min": dem_min, "dem_max": dem_max}


def nodata_mask(arr: np.ndarray, nodata: float | None) -> np.ndarray:
    """Boolean mask of nodata cells; handles ``nodata=NaN``.

    GDAL writes ``GDAL_NODATA="nan"`` for float rasters routinely, and
    ``np.isclose(x, nan)`` is all-False — a NaN sentinel needs ``isnan``.
    """
    arr_np = np.asarray(arr)
    if nodata is None:
        return np.zeros(arr_np.shape, bool)
    if np.isnan(nodata):
        return np.isnan(arr_np)
    return np.isclose(arr_np, nodata)


def replace_nodata_with_zero(arr: np.ndarray, nodata: float | None) -> np.ndarray:
    """Replace nodata values with zero (``np.isclose`` tolerance semantics;
    NaN sentinels handled via ``isnan``)."""
    arr_np = np.asarray(arr, dtype=np.float32)
    if nodata is None:
        return arr_np
    return np.where(nodata_mask(arr_np, nodata), 0.0, arr_np).astype(
        np.float32, copy=False
    )


# ---------------------------------------------------------------------------
# torch (device) implementations — batched over tile stacks
# ---------------------------------------------------------------------------


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-dim tensor on ``like``'s device.

    Dividing by a Python scalar lets CUDA multiply by its reciprocal instead;
    a device tensor keeps the true division the numpy and JAX twins do.
    """
    return torch.tensor(float(value), dtype=torch.float32, device=like.device)


def scale_depth_log1p(arr: torch.Tensor, max_depth: float) -> torch.Tensor:
    """Device twin of :func:`scale_depth_log1p_np`."""
    denom = _depth_log1p_denom(max_depth)
    x = torch.clamp(arr.to(torch.float32), 0.0, float(max_depth))
    return torch.clamp(torch.log1p(x) / _scalar(denom, x), 0.0, 1.0)


def invert_depth_log1p(arr: torch.Tensor, max_depth: float) -> torch.Tensor:
    """Device twin of :func:`invert_depth_log1p_np`."""
    denom = _depth_log1p_denom(max_depth)
    x = torch.clamp(arr.to(torch.float32), 0.0, 1.0)
    return torch.clamp(torch.expm1(x * _scalar(denom, x)), 0.0, float(max_depth))


def dem_tile_stats(
    dem: torch.Tensor, pct_clip: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tile DEM stats for a ``[N, H, W]`` batch: ``(p_clip, dem_min, dem_max)``.

    Inputs are finite by pipeline contract (nodata already replaced). The
    percentile reproduces ``np.nanpercentile``'s linear interpolation
    (reference: ``floodsr/preprocessing.py:118``) by value-domain bisection
    of the two bracketing order statistics. A CUDA tensor runs the
    ``tile_stats`` kernel, a CPU tensor its plain torch version.
    """
    from floodsr_tpu_torch.ops.kernels.tile_stats import tile_stats

    out = tile_stats(dem, float(pct_clip))
    return out[:, 0], out[:, 1], out[:, 2]


def normalize_dem_with_stats(
    dem: torch.Tensor,
    p_clip: torch.Tensor,
    dem_min: torch.Tensor,
    dem_max: torch.Tensor,
) -> torch.Tensor:
    """Batched stats-based DEM normalize; zero-range tiles map to zeros.

    ``dem`` is ``[N, H, W]``; stats are ``[N]``. The reference raises on a
    zero range with nonzero min — callers validate the stats host-side; on
    device every zero-range tile yields zeros (the benign padded-tile case).
    """
    shape = (-1,) + (1,) * (dem.ndim - 1)
    p = p_clip.reshape(shape)
    lo = dem_min.reshape(shape)
    rng = (dem_max - dem_min).reshape(shape)
    clipped = torch.minimum(torch.clamp_min(dem.to(torch.float32), 0.0), p)
    ok = rng > 0
    norm = torch.clamp((clipped - lo) / torch.where(ok, rng, torch.ones_like(rng)), 0.0, 1.0)
    return torch.where(ok, norm, torch.zeros_like(norm))


def normalize_dem_batch(
    dem: torch.Tensor, pct_clip: float
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Tile-local normalize for a ``[N, H, W]`` DEM batch; returns stats tensors."""
    p_clip, dem_min, dem_max = dem_tile_stats(dem, pct_clip)
    norm = normalize_dem_with_stats(dem, p_clip, dem_min, dem_max)
    return norm, {"p_clip": p_clip, "dem_min": dem_min, "dem_max": dem_max}
