"""Host-side preprocessing: config resolution and geospatial alignment.

Port of the JAX package's ``preprocessing.py``: the host code is copied and
the device branches (a DEM kept on the device and warped there) run in
torch.

Behavioral parity with the reference module (reference:
``floodsr/preprocessing.py``): model-config resolution from
``train_config.json`` with CLI-override precedence, CRS/grid validation, DEM
clipping to the LR footprint, model-space HR grid derivation
(``lr_shape × scale``), and prepared-raster writes. Raster I/O and the warp
run on this framework's self-contained implementations instead of
rasterio/GDAL.

Normalization math is re-exported from :mod:`floodsr_tpu_torch.ops.normalize` under
the reference's public names so library callers of the reference find the
same surface here.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from floodsr_tpu_torch.io.affine import (
    Affine,
    from_bounds as bounds_to_transform,
    round_window,
    window_from_bounds,
    window_transform,
)
from floodsr_tpu_torch.io.geotiff import raster_bounds, read_raster, write_raster
from floodsr_tpu_torch.ops.normalize import (  # noqa: F401  (public API re-exports)
    invert_depth_log1p_np,
    normalize_dem,
    normalize_dem_with_stats_np,
    replace_nodata_with_zero,
    scale_depth_log1p_np,
)
from floodsr_tpu_torch.ops.resample import (
    reproject_bilinear_auto,
    reproject_bilinear_torch,
    warp_separable_device,
)


def load_train_config(model_fp: str | Path, logger=None) -> dict | None:
    """The ``train_config.json`` sitting beside the artifact, or ``None``."""
    sidecar = Path(model_fp).expanduser().resolve().parent / "train_config.json"
    if sidecar.exists():
        (logger or logging.getLogger(__name__)).debug("train config: %s", sidecar)
        return json.loads(sidecar.read_text(encoding="utf-8"))
    return None


# Training DEM filenames encode their resolution, e.g. "002_dem" -> 2 m.
_DEM_RES_HINT = re.compile(r"(?:^|[_/])([0-9]{2,})_?dem")

_REQUIRED_DEM_STAT_KEYS = frozenset({"p_clip", "dem_min", "dem_max"})


def _dem_stats_from(train_cfg: dict) -> dict[str, float] | None:
    stats = train_cfg.get("dem_stats") or {}
    if _REQUIRED_DEM_STAT_KEYS <= stats.keys():
        return {k: float(stats[k]) for k in sorted(_REQUIRED_DEM_STAT_KEYS)}
    return None


def _lr_tile_from(train_cfg: dict) -> int | None:
    shape = train_cfg.get("input_shape")
    if isinstance(shape, (tuple, list)) and len(shape) >= 2:
        edge = shape[0]
        if isinstance(edge, (int, float)) and float(edge).is_integer():
            return int(edge)
    return None


def _dem_resolution_from(train_cfg: dict) -> float | None:
    hint = _DEM_RES_HINT.search(str(train_cfg.get("dem_fp") or ""))
    return float(int(hint.group(1))) if hint else None


def resolve_preprocess_config(
    model_fp: str | Path,
    max_depth: float | None = None,
    dem_pct_clip: float | None = None,
    logger=None,
) -> dict[str, object]:
    """Merge preprocessing settings: caller override > train_config > defaults.

    Result keys and precedence match the reference resolver
    (``floodsr/preprocessing.py``): ``max_depth`` (default 5.0 m),
    ``dem_pct_clip`` (default 95.0), optional reference ``dem_ref_stats``,
    the trained LR tile edge and upscale factor, and the training DEM
    resolution parsed from the ``dem_fp`` filename hint (default 2.0 m).
    """
    log = logger or logging.getLogger(__name__)
    model_path = Path(model_fp).expanduser().resolve()
    assert model_path.exists(), f"model file does not exist: {model_path}"

    train_cfg = load_train_config(model_path, logger=log) or {}

    def trained(key: str) -> object | None:
        return train_cfg.get(key)

    if max_depth is None:
        max_depth = trained("max_depth") if trained("max_depth") is not None else 5.0
    if dem_pct_clip is None:
        dem_pct_clip = (
            trained("dem_pct_clip") if trained("dem_pct_clip") is not None else 95.0
        )

    resolved = {
        "max_depth": float(max_depth),
        "dem_pct_clip": float(dem_pct_clip),
        "dem_ref_stats": _dem_stats_from(train_cfg),
        "lr_tile": _lr_tile_from(train_cfg),
        "scale": int(train_cfg["upscale"]) if trained("upscale") is not None else None,
        "model_dem_resolution": _dem_resolution_from(train_cfg) or 2.0,
    }
    log.debug("preprocess config resolved: %s", resolved)
    return resolved


def _read_single_band_raster(fp: str | Path) -> tuple[np.ndarray, float | None, dict]:
    """Read a single-band raster from disk."""
    arr, nodata, profile = read_raster(fp)
    return arr.astype(np.float32, copy=False), nodata, profile


def _write_single_band_raster(
    fp: str | Path,
    arr: np.ndarray,
    profile: dict,
    driver: str | None = None,
    compress: str | None = "keep",
) -> Path:
    """Write a float32 single-band raster and return the output path.

    ``compress="keep"`` preserves the profile's compression; any other value
    (including None for uncompressed) overrides it — used for short-lived
    prepared rasters where LZW-encoding a 60 MB scene is pure overhead.
    """
    out_profile = dict(profile)
    out_profile.update(dtype="float32", count=1)
    out_profile["driver"] = driver or "GTiff"
    out_profile["height"] = int(arr.shape[0])
    out_profile["width"] = int(arr.shape[1])
    if compress != "keep":
        out_profile["compress"] = compress
    return write_raster(fp, arr.astype(np.float32, copy=False), out_profile)


def _valid_mask_any(arr, nodata):
    """Float validity mask (1=data, 0=nodata) or ``None``; numpy or torch."""
    if nodata is None:
        return None
    if isinstance(arr, np.ndarray):
        from floodsr_tpu_torch.ops.normalize import nodata_mask

        return (~nodata_mask(arr, nodata)).astype(np.float32)
    if np.isnan(nodata):
        return (~torch.isnan(arr)).to(torch.float32)
    return (~_isclose_scalar(arr, nodata)).to(torch.float32)


def _isclose_scalar(arr: torch.Tensor, value: float) -> torch.Tensor:
    """``np.isclose(arr, value)`` (rtol 1e-5, atol 1e-8) on a device tensor."""
    return torch.isclose(
        arr, torch.tensor(float(value), dtype=arr.dtype, device=arr.device)
    )


def _replace_nodata_any(arr, nodata):
    """Nodata→0 that stays on the device for torch tensors."""
    if isinstance(arr, np.ndarray):
        return replace_nodata_with_zero(arr, nodata)
    arr = arr.to(torch.float32)
    if nodata is None:
        return arr
    zero = torch.zeros((), dtype=torch.float32, device=arr.device)
    if np.isnan(nodata):  # GDAL_NODATA="nan" — isclose(x, nan) is all-False
        return torch.where(torch.isnan(arr), zero, arr)
    return torch.where(_isclose_scalar(arr, nodata), zero, arr)


def wse_to_depth_lr(
    wse_raw: np.ndarray,
    wse_nodata: float | None,
    lr_transform,
    dem_crop,
    dem_crop_valid,
    dem_crop_transform,
    logger=None,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Convert a water-surface-elevation raster to LR depth: ``max(WSE−DEM, 0)``.

    Implements the reference's planned-but-unbuilt WSE ingestion feature
    (reference: ``PLAN.md`` "preprocessing WSE feature" — "allow ingestion of
    water surface rasters (with a flag), and convert these"). The DEM is
    sampled onto the LR grid with the same mask-renormalized bilinear warp
    the aligner uses for the HR model grid; cells where the WSE is nodata,
    the DEM has no valid contribution, or the WSE sits at/below terrain
    come out dry (0 m).

    ``dem_crop`` is the nodata-zeroed clipped DEM (numpy array or device
    tensor) with ``dem_crop_valid`` its float validity mask (or None when
    fully valid). A tensor is warped on its own device; ``device`` is where a
    large host array would be warped.
    """
    log = logger or logging.getLogger(__name__)
    lr_shape = tuple(int(v) for v in wse_raw.shape)

    is_device = isinstance(dem_crop, torch.Tensor)
    rectilinear = (
        dem_crop_transform.is_rectilinear() and lr_transform.is_rectilinear()
    )
    if is_device and rectilinear:
        def warp(src):
            return _to_numpy(
                warp_separable_device(src, dem_crop_transform, lr_shape, lr_transform)
            )
    else:
        def warp(src):
            return reproject_bilinear_auto(
                np.asarray(_to_numpy(src), np.float32),
                dem_crop_transform, lr_shape, lr_transform, device=device,
            )
    dem_lr = warp(dem_crop)
    wmask = warp(dem_crop_valid) if dem_crop_valid is not None else None

    if wmask is not None:
        dem_valid = wmask > 1e-6
        dem_lr = np.where(dem_valid, dem_lr / np.maximum(wmask, 1e-6), 0.0)
    else:
        dem_valid = np.ones(lr_shape, dtype=bool)

    wse = np.asarray(wse_raw, np.float32)
    wse_valid_f = _valid_mask_any(wse, wse_nodata)
    valid = dem_valid if wse_valid_f is None else (dem_valid & (wse_valid_f > 0.5))
    depth = np.where(valid, np.clip(wse - dem_lr, 0.0, None), 0.0).astype(np.float32)
    wet = int(np.count_nonzero(depth > 0))
    log.info(
        f"WSE→depth conversion: {wet}/{depth.size} wet LR cells, "
        f"max depth {float(depth.max()):.3f} m"
    )
    return depth


def _renormalize(dem_model: torch.Tensor, wmask: torch.Tensor) -> torch.Tensor:
    """Divide the warped DEM by the warped validity mask (0 where no data)."""
    ok = wmask > 1e-6
    out = dem_model / torch.clamp_min(wmask, 1e-6)
    return torch.where(ok, out, torch.zeros_like(out))


def _align_depth_and_dem_inputs(
    depth_lr_fp: str | Path,
    dem_hr_fp: str | Path,
    scale: int,
    logger=None,
    preread: dict | None = None,
    device_dem: bool = False,
    input_kind: str = "depth",
    device: "str | torch.device" = "cuda",
) -> dict[str, Any]:
    """Align inputs for model scale: keep LR depth native, resample DEM.

    Same contract as the reference aligner (reference:
    ``floodsr/preprocessing.py:285-408``): CRS must match and be projected
    (depth inherits DEM CRS with a warning when missing), DEM is clipped to
    the LR bounds on its native grid, and the model-space HR grid is derived
    as ``lr_shape × scale`` over the LR bounds.

    ``device_dem=True`` keeps the DEM on the device: a torch DEM in
    ``preread`` stays on its device, a numpy one is uploaded to ``device``.
    """
    log = logger or logging.getLogger(__name__)
    assert scale > 0, f"scale must be > 0; got {scale}"
    assert input_kind in {"depth", "wse"}, (
        f"input_kind must be 'depth' or 'wse'; got {input_kind!r}"
    )
    depth_path = Path(depth_lr_fp).expanduser().resolve()
    dem_path = Path(dem_hr_fp).expanduser().resolve()
    assert depth_path.exists(), f"low-res depth raster does not exist: {depth_path}"
    assert dem_path.exists(), f"hires DEM raster does not exist: {dem_path}"

    if preread is not None:
        depth_raw = preread["depth"]
        depth_nodata = preread["depth_nodata"]
        depth_profile = dict(preread["depth_profile"])
        dem_raw = preread["dem"]
        dem_nodata = preread["dem_nodata"]
        dem_profile = dict(preread["dem_profile"])
    else:
        depth_raw, depth_nodata, depth_profile = _read_single_band_raster(depth_path)
        dem_raw, dem_nodata, dem_profile = _read_single_band_raster(dem_path)
    assert depth_profile["count"] == 1, "depth raster must have 1 band"
    assert dem_profile["count"] == 1, "DEM raster must have 1 band"
    if device_dem and isinstance(dem_raw, np.ndarray):
        dem_raw = torch.from_numpy(np.ascontiguousarray(dem_raw, np.float32)).to(device)

    depth_crs = depth_profile["crs"]
    dem_crs = dem_profile["crs"]
    if depth_crs is None:
        assert dem_crs is not None, "both rasters must include CRS when depth CRS is missing"
        depth_crs = dem_crs
        depth_profile = dict(depth_profile)
        depth_profile["crs"] = dem_crs
        log.warning(
            "assigning missing depth CRS from DEM CRS\n"
            f"    depth={depth_path}\n"
            f"    dem={dem_path}"
        )
    assert dem_crs is not None, "both rasters must define CRS"
    assert depth_crs == dem_crs, (
        f"CRS mismatch\n    depth={depth_crs}\n    dem={dem_crs}"
    )
    assert depth_crs.is_projected, f"CRS must be projected; got {depth_crs}"

    depth_t = depth_profile["transform"]
    dem_t = dem_profile["transform"]
    depth_res = (abs(depth_t.a), abs(depth_t.e))
    dem_res = (abs(dem_t.a), abs(dem_t.e))
    if not np.isclose(depth_res[0], depth_res[1]):
        log.warning(f"depth pixels are not square: res={depth_res}")
    if not np.isclose(dem_res[0], dem_res[1]):
        log.warning(f"DEM pixels are not square: res={dem_res}")

    lr_bounds = raster_bounds(depth_profile)
    dem_bounds = raster_bounds(dem_profile)
    if not all(np.isclose(lr_bounds, dem_bounds, atol=1e-6, rtol=0.0)):
        log.warning(
            "input bounds differ; clipping DEM to depth raster bounds.\n"
            f"    depth={lr_bounds}\n"
            f"    dem={dem_bounds}"
        )

    depth_lr = replace_nodata_with_zero(depth_raw, depth_nodata)
    depth_bounds = tuple(float(v) for v in lr_bounds)

    # Clip DEM to LR bounds on the source DEM grid for later raw-grid export.
    win = round_window(window_from_bounds(*lr_bounds, dem_t))
    row_off, col_off, win_h, win_w = win
    row0, col0 = max(0, row_off), max(0, col_off)
    dem_crop = dem_raw[row0 : row_off + win_h, col0 : col_off + win_w]
    assert dem_crop.shape[0] * dem_crop.shape[1] > 0, (
        f"clipped DEM is empty for bounds {lr_bounds}"
    )
    # Validity mask BEFORE zeroing: the device warp below renormalizes by
    # the warped mask so cells bilinearly adjacent to nodata holes are not
    # depressed toward the zero fill (host path: reproject_bilinear's
    # weight renormalization).
    dem_crop_valid = _valid_mask_any(dem_crop, dem_nodata)
    dem_crop = _replace_nodata_any(dem_crop, dem_nodata)
    dem_crop_transform = window_transform(row0, col0, dem_t)

    if input_kind == "wse":
        # The raw raster carries water-surface elevations, not depths:
        # convert on the LR grid before any depth validation/scaling.
        depth_lr = wse_to_depth_lr(
            depth_raw,
            depth_nodata,
            depth_t,
            dem_crop,
            dem_crop_valid,
            dem_crop_transform,
            logger=log,
            device=device,
        )

    if isinstance(dem_crop, np.ndarray) and not np.isfinite(dem_crop).all():
        # Device-resident DEMs were finite-checked by the caller pre-upload.
        raise AssertionError("DEM contains non-finite values after clipping")
    if not np.isfinite(depth_lr).all():
        raise AssertionError("low-res depth contains non-finite values")
    if depth_lr.min() < 0.0:
        raise AssertionError(
            f"low-res depth has negative values: min={float(depth_lr.min())}"
        )

    # Derive model-space HR grid directly from native LR shape and model scale.
    target_hr_h = int(depth_lr.shape[0] * scale)
    target_hr_w = int(depth_lr.shape[1] * scale)
    assert target_hr_h > 0 and target_hr_w > 0, (
        f"target HR shape invalid {(target_hr_h, target_hr_w)}"
    )
    dem_model_transform = bounds_to_transform(
        *depth_bounds, width=target_hr_w, height=target_hr_h
    )
    if device_dem:
        # Keep the warped DEM on the device: the consumer (the scene
        # executor) reads it there, so a host round-trip would be wasted.
        dst_shape = (target_hr_h, target_hr_w)
        if dem_crop_transform.is_rectilinear() and dem_model_transform.is_rectilinear():
            def warp(src):
                return warp_separable_device(
                    src, dem_crop_transform, dst_shape, dem_model_transform
                )
        else:
            # dem_crop was nodata->zeroed above, so nodata-matching inside
            # the warp can never fire — renormalize by the warped validity
            # mask instead (identical 4-tap semantics: the warp is linear).
            def warp(src):
                return reproject_bilinear_torch(
                    src, dem_crop_transform, dst_shape, dem_model_transform
                )
        dem_model = warp(dem_crop)
        if dem_crop_valid is not None:
            # Mask-renormalized warp: without it, cells bilinearly adjacent
            # to nodata holes blend in the zero fill and read as depressed
            # elevations.
            dem_model = _renormalize(dem_model, warp(dem_crop_valid))
        # No host-blocking finite check here: the inputs are finite (validated
        # above) and the nodata-renormalized bilinear warp of finite values is
        # finite by construction.
    else:
        # Same mask renormalization as the device paths: dem_crop is already
        # nodata->zeroed, so src_nodata matching could never fire here — a
        # latent zero-blend at hole boundaries found in the round-3 review.
        dem_model = reproject_bilinear_auto(
            dem_crop,
            dem_crop_transform,
            (target_hr_h, target_hr_w),
            dem_model_transform,
            device=device,
        )
        if dem_crop_valid is not None:
            wmask = reproject_bilinear_auto(
                np.asarray(dem_crop_valid, np.float32),
                dem_crop_transform,
                (target_hr_h, target_hr_w),
                dem_model_transform,
                device=device,
            )
            dem_model = np.where(
                wmask > 1e-6, dem_model / np.maximum(wmask, 1e-6), 0.0
            ).astype(np.float32)
        if not np.isfinite(dem_model).all():
            raise AssertionError("resampled DEM contains non-finite values")
    was_resampled = bool(
        tuple(dem_model.shape) != tuple(dem_crop.shape)
        or not all(
            np.isclose(
                (dem_model_transform.a, dem_model_transform.e),
                (dem_crop_transform.a, dem_crop_transform.e),
            )
        )
    )
    return {
        "depth_lr": depth_lr,
        "depth_lr_nodata": depth_nodata,
        "depth_lr_transform": depth_t,
        "depth_lr_profile": depth_profile,
        "dem_hr": dem_model,
        "dem_hr_nodata": dem_nodata,
        "dem_hr_transform": dem_model_transform,
        "dem_raw_shape": tuple(int(v) for v in dem_crop.shape),
        "dem_raw_transform": dem_crop_transform,
        "dem_profile": dem_profile,
        "crop_shape": (target_hr_h, target_hr_w),
        "resampled": was_resampled,
    }


def write_prepared_rasters(
    depth_lr_fp: str | Path,
    dem_hr_fp: str | Path,
    *,
    scale: int,
    out_dir: str | Path,
    logger=None,
    depth_lr_prepared_fp: str | Path | None = None,
    dem_hr_prepared_fp: str | Path | None = None,
    write_files: bool = True,
    preread: dict | None = None,
    device_dem: bool = False,
    input_kind: str = "depth",
    device: "str | torch.device" = "cuda",
) -> dict[str, object]:
    """Align depth/DEM for inference; optionally write the prepared rasters.

    With ``write_files=False`` the aligned arrays are returned in memory only
    (the ``*_prepared_fp`` keys are None) — the hot inference path skips the
    short-lived temp files entirely. ``device_dem=True`` keeps the warped DEM
    on the device (``device``, or the preread DEM tensor's) for direct
    consumption by the scene executor.
    ``input_kind="wse"`` treats the LR raster as water-surface elevation and
    converts it to depth against the DEM (:func:`wse_to_depth_lr`).
    """
    log = logger or logging.getLogger(__name__)
    out_dir = Path(out_dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    aligned = _align_depth_and_dem_inputs(
        depth_lr_fp,
        dem_hr_fp,
        scale=scale,
        logger=log,
        preread=preread,
        device_dem=device_dem,
        input_kind=input_kind,
        device=device,
    )

    depth_prepared_fp = (
        Path(depth_lr_prepared_fp)
        if depth_lr_prepared_fp is not None
        else out_dir / f"{Path(depth_lr_fp).stem}_prepped_depth.tif"
    )
    dem_prepared_fp = (
        Path(dem_hr_prepared_fp)
        if dem_hr_prepared_fp is not None
        else out_dir / f"{Path(dem_hr_fp).stem}_prepped_dem.tif"
    )

    depth_profile = dict(aligned["depth_lr_profile"])
    depth_profile.update(
        height=int(aligned["depth_lr"].shape[0]),
        width=int(aligned["depth_lr"].shape[1]),
        transform=aligned["depth_lr_transform"],
    )
    dem_profile = dict(aligned["dem_profile"])
    dem_profile.update(
        height=int(aligned["dem_hr"].shape[0]),
        width=int(aligned["dem_hr"].shape[1]),
        transform=aligned["dem_hr_transform"],
    )
    dem_raw_profile = dict(aligned["dem_profile"])
    dem_raw_profile.update(
        height=int(aligned["dem_raw_shape"][0]),
        width=int(aligned["dem_raw_shape"][1]),
        transform=aligned["dem_raw_transform"],
    )

    if write_files:
        # Prepared rasters are short-lived intermediates: write uncompressed.
        depth_prepared_path = _write_single_band_raster(
            depth_prepared_fp, aligned["depth_lr"], depth_profile, compress=None
        )
        dem_prepared_path = _write_single_band_raster(
            dem_prepared_fp, _to_numpy(aligned["dem_hr"]), dem_profile, compress=None
        )
    else:
        depth_prepared_path = None
        dem_prepared_path = None
    return {
        "depth_lr": aligned["depth_lr"],
        "dem_hr": aligned["dem_hr"],
        "depth_lr_prepared_fp": depth_prepared_path,
        "dem_hr_prepared_fp": dem_prepared_path,
        "depth_lr_profile": depth_profile,
        "dem_profile": dem_profile,
        "depth_lr_nodata": aligned["depth_lr_nodata"],
        "dem_hr_nodata": aligned["dem_hr_nodata"],
        "crop_shape": aligned["crop_shape"],
        "resampled": aligned["resampled"],
        "depth_lr_shape": tuple(aligned["depth_lr"].shape),
        "dem_hr_shape": tuple(aligned["dem_hr"].shape),
        "dem_raw_shape": tuple(aligned["dem_raw_shape"]),
        "dem_raw_profile": dem_raw_profile,
    }


def _to_numpy(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)
