"""CostGrow model worker: hydraulic-connectivity WSE downscaling on device.

Port of the JAX package's ``models/CostGrow.py``: the host code is copied, the
phases run as torch ops on the worker's device, and every least-cost
relaxation goes through the hand-written ``relax_step`` CUDA kernel
(:mod:`floodsr_tpu_torch.ops.kernels.relax_step`) when that device is a GPU.
The worker runs on the GPU unless constructed with ``device="cpu"``, and
raises when CUDA is absent.

Implements the reference's planned CostGrow model (reference:
``others/CostGrow_inline.ipynb`` phases 01-04; ``PLAN.md`` "add
costgrow_pcraster model feature"; README lists it as a future model) as a
first-class worker in the same registry/worker framework as ResUNet_16x_DEM:

1. resample low-res WSE onto the high-res DEM grid (bilinear) with a
   nearest-neighbor validity mask;
2. wet partials: keep cells where WSE > DEM (anchors);
3. dry partials: neutral MCP fill → terrain-penalized cost
   ``1 + |Δ|·scale`` where the filled surface sits below terrain → anchor
   distance threshold (``max_grow_coarse_pixels × downscale``) → MCP value
   propagation of anchor WSE with optional linear distance decay;
4. drop wet components not connected to any anchor (orthogonal adjacency,
   the reference's ``label(..., connectivity=1)``).

The PCRaster variant the reference plans as a sibling model
(``others/CostGrow_pcraster_inline.ipynb``) ships as
:mod:`floodsr_tpu_torch.models.CostGrow_pcraster`, subclassing this worker and
overriding :meth:`ModelWorker._apply_phases`.

All wavefront solves run as relaxations on the device
(:mod:`floodsr_tpu_torch.ops.costgrow`) instead of the reference's sequential
Cython Dijkstra.

The "model artifact" is a JSON parameter file (CostGrow has no weights):
``{"model_version": "CostGrow", "max_grow_coarse_pixels": 4,
"terrain_penalty_scale": 1.0, "decay_per_meter": 0.0,
"output_kind": "wse"|"depth"}`` — every key optional.
"""

from __future__ import annotations

import json
import logging
import math
from pathlib import Path
from typing import Any

import numpy as np
import torch

from floodsr_tpu_torch import tracing
from floodsr_tpu_torch.device import resolve_device
from floodsr_tpu_torch.io.geotiff import raster_bounds, read_raster, write_raster
from floodsr_tpu_torch.models.base import Model
from floodsr_tpu_torch.ops.costgrow import (
    keep_components_connected_to_anchor,
    mcp_distance,
    mcp_fill,
    traced_solve,
)
from floodsr_tpu_torch.ops.resample import reproject_bilinear_auto, reproject_nearest


def _costgrow_phases(
    wse_fine: torch.Tensor,
    dem: torch.Tensor,
    dem_valid: torch.Tensor,
    *,
    max_grow_fine_pixels: float,
    terrain_penalty_scale: float,
    decay_per_pixel: float,
    solves: dict | None = None,
) -> torch.Tensor:
    """Phases 02-04 on the tensors' device; returns WSE with NaN dry.

    ``solves``, when given, receives each least-cost solve's relaxation and
    convergence-check counts and its seconds, by name. Each solve is a span
    ``solve.<name>`` of the open request (``solve.components`` for phase 04),
    the least-cost ones with those counts and their K3 launches as counters.
    """
    solves = {} if solves is None else solves
    # 02: wet partials (anchors) where resampled WSE clears the terrain.
    wse_wet = torch.where(wse_fine > dem, wse_fine, math.nan)
    anchor_mask = torch.isfinite(wse_wet)

    # 03a: neutral fill of the resampled WSE over the whole domain.
    neutral_seed_mask = torch.isfinite(wse_fine)
    with traced_solve("neutral_fill", solves) as stats:
        neutral_filled, _ = mcp_fill(
            torch.where(neutral_seed_mask, wse_fine, math.nan),
            neutral_seed_mask,
            torch.ones_like(dem),
            dem_valid,
            stats=stats,
        )

    # 03b: terrain-penalized cost where the filled surface dips below ground.
    delta = neutral_filled - dem
    cost_surface = torch.where(
        delta > 0.0, 1.0, 1.0 + torch.abs(delta) * terrain_penalty_scale
    )

    # 03c: growth threshold from anchor distance (unit cost).
    with traced_solve("anchor_distance", solves) as stats:
        distance_pixels = mcp_distance(anchor_mask, dem_valid, stats=stats)
    grow_mask = torch.isfinite(distance_pixels) & (distance_pixels <= max_grow_fine_pixels)

    # 03d: propagate anchor WSE along terrain-penalized least-cost paths.
    with traced_solve("penalized_fill", solves) as stats:
        wse_grown, _ = mcp_fill(
            torch.where(anchor_mask, wse_wet, math.nan),
            anchor_mask,
            cost_surface,
            dem_valid,
            target_mask=grow_mask,
            stats=stats,
        )

    # 03e: optional linear decay with travel distance.
    decay = distance_pixels * decay_per_pixel
    wse_grown = wse_grown - torch.where(torch.isfinite(decay), decay, 0.0)

    # merge growth where the final surface stays above ground.
    add_mask = (
        ~anchor_mask & grow_mask & torch.isfinite(wse_grown) & (wse_grown > dem)
    )
    out = torch.where(add_mask, wse_grown, wse_wet)

    # 04: drop wet blobs disconnected from the anchors.
    wet_post = torch.isfinite(out)
    with traced_solve("components"):
        keep = keep_components_connected_to_anchor(wet_post, anchor_mask)
    return torch.where(keep & dem_valid, out, math.nan)


class ModelWorker(Model):
    """Worker running the CostGrow downscale through the standard ToHR flow."""

    model_version = "CostGrow"
    # Keys this variant's artifact JSON consumes. Unknown keys (e.g. a
    # sibling variant's tuning) are warned about, not silently ignored.
    _PARAM_KEYS = frozenset(
        {
            "model_version",
            "max_grow_coarse_pixels",
            "terrain_penalty_scale",
            "decay_per_meter",
            "output_kind",
        }
    )

    def __init__(self, model_fp: str | Path, *, logger=None, device: str = "cuda"):
        super().__init__(model_fp=model_fp, model_version=self.model_version, logger=logger)
        self.device = resolve_device(device)
        self.params: dict[str, Any] = {}
        #: per-solve relaxation/check counts and seconds of the last run
        self.last_solves: dict[str, dict] = {}

    def __enter__(self):
        try:
            payload = json.loads(Path(self.model_fp).read_text(encoding="utf-8"))
            if isinstance(payload, dict):
                self.params = payload
        except (ValueError, OSError):
            self.params = {}
        unknown = sorted(set(self.params) - self._PARAM_KEYS)
        if unknown:
            self.log.warning(
                f"{self.model_version}: ignoring unrecognized parameter keys "
                f"{unknown} (accepted: {sorted(self._PARAM_KEYS)})"
            )
        return self

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _dem_to_device(
        self, dem: np.ndarray, dem_valid: np.ndarray
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The DEM on the device with ``inf`` on its NaN cells (so comparisons
        stay NaN-free), and the validity mask."""
        dem_t = self._to_device(dem)
        dem_t = torch.where(torch.isnan(dem_t), math.inf, dem_t)
        return dem_t, self._to_device(dem_valid)

    def _apply_phases(
        self,
        *,
        wse_fine: np.ndarray,
        dem: np.ndarray,
        dem_valid: np.ndarray,
        wse_coarse: np.ndarray,
        wse_transform,
        dem_transform,
        downscale: int,
        fine_pixel: float,
    ) -> tuple[np.ndarray, dict[str, Any]]:
        """Run phases 02-04 on the resampled WSE; returns (wse_out, params).

        Subclasses (the PCRaster variant) override this with their own
        phase semantics; the coarse WSE grid and both geotransforms are
        provided for variants whose fill order differs.
        """
        max_grow_coarse_pixels = float(self.params.get("max_grow_coarse_pixels", 4.0))
        terrain_penalty_scale = float(self.params.get("terrain_penalty_scale", 1.0))
        decay_per_meter = float(self.params.get("decay_per_meter", 0.0))
        max_grow_fine_pixels = max_grow_coarse_pixels * downscale

        self.last_solves = {}
        dem_t, valid_t = self._dem_to_device(dem, dem_valid)
        wse_out = _costgrow_phases(
            self._to_device(wse_fine),
            dem_t,
            valid_t,
            max_grow_fine_pixels=max_grow_fine_pixels,
            terrain_penalty_scale=terrain_penalty_scale,
            decay_per_pixel=decay_per_meter * fine_pixel,
            solves=self.last_solves,
        ).cpu().numpy()
        return wse_out, {
            "max_grow_coarse_pixels": max_grow_coarse_pixels,
            "max_grow_fine_pixels": max_grow_fine_pixels,
            "terrain_penalty_scale": terrain_penalty_scale,
            "decay_per_meter": decay_per_meter,
        }

    def run(
        self,
        *,
        depth_lr_fp: str | Path,
        dem_hr_fp: str | Path,
        output_fp: str | Path,
        max_depth: float | None = None,
        dem_pct_clip: float | None = None,
        window_method: str = "feather",
        tile_overlap: int | None = None,
        tile_size: int | None = None,
        input_kind: str | None = None,
        buildings_fp: str | Path | None = None,
        output_compress: str | None = None,
    ) -> dict[str, Any]:
        """Run CostGrow; the LR input is natively a WSE raster.

        Unused ToHR knobs (window/tile) are accepted for CLI compatibility.
        ``max_depth`` clips the depth-domain output when ``output_kind`` is
        ``depth``. ``input_kind`` defaults to this worker's native ``wse``;
        ``input_kind="depth"`` ingests an LR depth raster instead and lifts
        it to WSE on the DEM grid (``WSE = DEM + max(depth, 0)``) before the
        connectivity phases (the reference's planned WSE/conversion flag,
        reference ``PLAN.md`` "preprocessing WSE feature").

        ``buildings_fp`` (GeoJSON footprints) blocks buildings out of the
        hydraulic-connectivity domain: no anchors inside them, growth cannot
        route through them, and they come out dry (the reference's planned
        building-blocking feature, reference ``docs/dev/adr/0016-buildings.md``).

        The run is span ``worker.run`` (``runtime_s``) of the request open in
        this context, the service's, or of a request of its own, whose record
        it then returns as ``scene_timings["trace"]``. Its children:
        ``worker.inputs``, ``read`` (``read.wse``, ``read.dem``),
        ``costgrow.resample`` (the masks and phase 01), ``costgrow.phases``
        (phases 02-04 with a span per solve, and the D2H) and ``worker.write``
        (the output's encode and write).
        """
        opened = tracing.current() is None
        with tracing.request() as trace, tracing.span("worker.run") as root:
            log = self.log
            with tracing.span("worker.inputs"):
                wse_lr_path = Path(depth_lr_fp).expanduser().resolve()
                dem_path = Path(dem_hr_fp).expanduser().resolve()
                out_path = Path(output_fp).expanduser().resolve()
                assert wse_lr_path.exists(), f"low-res WSE raster does not exist: {wse_lr_path}"
                assert dem_path.exists(), f"DEM raster does not exist: {dem_path}"

                output_kind = str(self.params.get("output_kind", "wse")).lower()
                assert output_kind in {"wse", "depth"}, f"unsupported output_kind={output_kind}"
                input_kind = (input_kind or "wse").strip().lower()
                assert input_kind in {"wse", "depth"}, f"unsupported input_kind={input_kind}"
                output_compress = (output_compress or "lzw").strip().lower()
                assert output_compress in {"lzw", "zstd", "deflate", "packbits", "none"}, (
                    f"unsupported output_compress={output_compress}"
                )

            with tracing.span("read") as read:
                with tracing.span("read.wse"):
                    wse_raw, wse_nodata, wse_profile = read_raster(wse_lr_path)
                with tracing.span("read.dem"):
                    dem_raw, dem_nodata, dem_profile = read_raster(dem_path)

            with tracing.span("costgrow.resample") as resample:
                wse = np.where(
                    np.isclose(wse_raw, wse_nodata) if wse_nodata is not None
                    else ~np.isfinite(wse_raw),
                    np.nan,
                    wse_raw,
                ).astype(np.float32)
                dem = np.where(
                    np.isclose(dem_raw, dem_nodata) if dem_nodata is not None
                    else ~np.isfinite(dem_raw),
                    np.nan,
                    dem_raw,
                ).astype(np.float32)
                dem_valid = np.isfinite(dem)
                blocked_cells = 0
                if buildings_fp is not None:
                    from floodsr_tpu_torch.features import building_mask_for_grid

                    bmask = building_mask_for_grid(
                        buildings_fp,
                        dem_profile["transform"],
                        dem.shape,
                        crs=str(dem_profile["crs"]),
                        logger_=log,
                    )
                    blocked_cells = int(bmask.sum())
                    dem_valid &= ~bmask

                # CRS/bounds compatibility (reference notebook cell 6 validators).
                assert wse_profile["crs"] is not None and dem_profile["crs"] is not None, (
                    "both rasters must define CRS"
                )
                assert wse_profile["crs"] == dem_profile["crs"], (
                    f"CRS mismatch: {wse_profile['crs']} vs {dem_profile['crs']}"
                )
                wse_bounds = raster_bounds(wse_profile)
                dem_bounds = raster_bounds(dem_profile)
                assert all(np.isclose(a, b, atol=1e-6) for a, b in zip(wse_bounds, dem_bounds)), (
                    f"WSE bounds {wse_bounds} != DEM bounds {dem_bounds}"
                )

                dem_t = dem_profile["transform"]
                wse_t = wse_profile["transform"]
                fine_pixel = float(np.mean([abs(dem_t.a), abs(dem_t.e)]))
                coarse_pixel = float(np.mean([abs(wse_t.a), abs(wse_t.e)]))
                downscale = max(1, int(round(coarse_pixel / fine_pixel)))

                log.info(
                    f"{self.model_version}: {wse.shape} @ {coarse_pixel} m -> "
                    f"{dem.shape} @ {fine_pixel} m (downscale {downscale})"
                )

                # 01: resample WSE to the DEM grid; mask invalid source coverage.
                dem_shape = dem.shape
                wse_fine = reproject_bilinear_auto(
                    np.where(np.isfinite(wse), wse, -9999.0),
                    wse_t,
                    dem_shape,
                    dem_t,
                    src_nodata=-9999.0,
                    dst_nodata=np.nan,
                    device=self.device,
                )
                valid_fine = reproject_nearest(
                    np.isfinite(wse).astype(np.uint8), wse_t, dem_shape, dem_t, fill=0
                ).astype(bool)
                wse_fine = np.where(valid_fine & dem_valid, wse_fine, np.nan).astype(np.float32)
                if input_kind == "depth":
                    # The LR raster carried depths: lift onto the terrain so the
                    # wet-anchor condition (WSE > DEM) becomes depth > 0.
                    wse_fine = np.where(
                        np.isfinite(wse_fine), dem + np.clip(wse_fine, 0.0, None), np.nan
                    ).astype(np.float32)
                    # Variants that consume the coarse surface directly (the
                    # PCRaster variant's coarse-grid neutral fill) need it in the
                    # WSE domain too: lift against the DEM resampled to coarse.
                    dem_coarse = reproject_bilinear_auto(
                        np.where(dem_valid, dem, -9999.0),
                        dem_t,
                        wse.shape,
                        wse_t,
                        src_nodata=-9999.0,
                        dst_nodata=np.nan,
                        device=self.device,
                    )
                    wse = np.where(
                        np.isfinite(wse) & np.isfinite(dem_coarse),
                        dem_coarse + np.clip(wse, 0.0, None),
                        np.nan,
                    ).astype(np.float32)

            with tracing.span("costgrow.phases") as phases:
                wse_out, phase_params = self._apply_phases(
                    wse_fine=wse_fine,
                    dem=dem,
                    dem_valid=dem_valid,
                    wse_coarse=wse,
                    wse_transform=wse_t,
                    dem_transform=dem_t,
                    downscale=downscale,
                    fine_pixel=fine_pixel,
                )
                wet_count = int(np.isfinite(wse_out).sum())
                assert wet_count > 0, (
                    f"{self.model_version} produced no wet cells (no anchors above terrain?)"
                )

            with tracing.span("worker.write") as write:
                if output_kind == "depth":
                    depth_out = np.where(np.isfinite(wse_out), wse_out - dem, np.nan)
                    depth_out = np.clip(depth_out, 0.0, max_depth if max_depth else np.inf)
                    result_arr = depth_out
                else:
                    result_arr = wse_out

                nodata = -9999.0
                out_arr = np.where(np.isfinite(result_arr), result_arr, nodata).astype(np.float32)
                profile = dict(dem_profile)
                profile.update(dtype="float32", count=1, nodata=nodata)
                # Fixed output write profile (reference default LZW), never inherited
                # from the input DEM's compression tags.
                profile["compress"] = (
                    None if output_compress == "none" else output_compress.upper()
                )
                profile.pop("predictor", None)
                write_raster(out_path, out_arr, profile)
                out_size = int(out_path.stat().st_size)

        log.info(f"finished {self.model_version} in {root.seconds:.3f}s -> {out_path}")
        result = {
            "output_fp": str(out_path),
            "runtime_s": root.seconds,
            "model_version": self.model_version,
            "model_fp": str(self.model_fp),
            "output_size_bytes": out_size,
            # Each least-cost solve's relaxations, convergence checks (host
            # syncs), K3 launches and seconds.
            "solves": {k: dict(v) for k, v in self.last_solves.items()},
            # Each time is a span's; "trace" is the request's record, where
            # this run opened it.
            "scene_timings": {
                "runtime_s": root.seconds,
                "read_s": read.seconds,
                "resample_s": resample.seconds,
                "phases_s": phases.seconds,
                "write_s": write.seconds,
            },
            "preprocess": {
                **phase_params,
                "downscale": downscale,
                "building_blocked_cells": blocked_cells,
                "output_kind": output_kind,
                "wet_pixel_count": wet_count,
                "input_shape": {
                    "wse_lr_shape": [int(v) for v in wse.shape],
                    "dem_shape": [int(v) for v in dem.shape],
                },
            },
        }
        if opened:
            result["scene_timings"]["trace"] = trace.export(root)
        return result
