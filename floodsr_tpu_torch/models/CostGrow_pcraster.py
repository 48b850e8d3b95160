"""CostGrow_pcraster model worker: the PCRaster-variant CostGrow on device.

Port of the JAX package's ``models/CostGrow_pcraster.py``: the host prologue
is copied, the phases run as torch ops on the worker's device, and the
spreadzone fill relaxes through the ``relax_step`` CUDA kernel on a GPU.

Implements the reference's planned ``costgrow_pcraster`` model feature
(reference ``PLAN.md`` "add costgrow_pcraster model feature";
``others/CostGrow_pcraster_inline.ipynb``) as a sibling worker of
:mod:`floodsr_tpu_torch.models.CostGrow`. The two variants share phases 01
(resample), 02 (wet partials) and 04 (anchored-component filter); this one
reproduces the notebook's phase-03 differences exactly:

- the *neutral* fill happens on the COARSE grid — nearest finite value
  under a grid metric (the notebook's ``distance_transform_cdt`` index
  fill) — and is then bilinear-resampled to the fine grid to build the
  terrain-penalty cost surface (notebook ``_distance_fill_cost_terrain``);
- the growth threshold and linear decay use the plain grid distance
  (chessboard by default) from the wet anchors over the WHOLE raster,
  not the cost-weighted geodesic distance (notebook ``_03_dry_partials``);
- the fill allocation is PCRaster ``spreadzone`` semantics: every dry cell
  takes the WSE of its minimum-cost source over the friction surface
  (notebook ``_distance_fill_cost_pcraster``). On device this is the same
  least-cost value propagation as the base worker's MCP fill — PCRaster's
  ``spread`` and skimage's ``MCP_Geometric`` share the edge-weight
  convention (step length × mean endpoint friction), so one wavefront
  kernel serves both variants.

The "model artifact" is a JSON parameter file (no weights):
``{"model_version": "CostGrow_pcraster", "dp_coarse_pixel_max": 10,
"decay_frac": 0.001, "terrain_penalty_scale": 1.0,
"distance_metric": "chessboard", "output_kind": "wse"|"depth"}`` —
every key optional. ``dp_coarse_pixel_max: null`` disables the growth
threshold (the notebook's ``dp_coarse_pixel_max=None`` branch).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from floodsr_tpu_torch.models.CostGrow import ModelWorker as _CostGrowWorker
from floodsr_tpu_torch.ops.costgrow import (
    grid_distance,
    keep_components_connected_to_anchor,
    mcp_fill,
    nearest_fill_numpy,
)
from floodsr_tpu_torch.ops.resample import reproject_bilinear_auto


def _costgrow_pcraster_phases(
    wse_fine: torch.Tensor,
    dem: torch.Tensor,
    dem_valid: torch.Tensor,
    cost_fine: torch.Tensor,
    *,
    dp_fine_pixel_max: float | None,
    decay_per_pixel: float,
    metric: str,
    solves: dict | None = None,
) -> torch.Tensor:
    """Phases 02-04 (PCRaster semantics) on the tensors' device.

    ``cost_fine`` is the terrain-penalty friction surface built host-side
    from the coarse-filled WSE (NaN = outside the traversable domain);
    ``dem`` carries ``inf`` on invalid cells so comparisons stay NaN-free.
    ``solves``, when given, receives the spreadzone solve's relaxation and
    convergence-check counts and its seconds.
    """
    solves = {} if solves is None else solves
    # 02: wet partials — keep cells strictly above terrain (notebook
    # ``_02_wet_partials`` masks ``wse <= dem``).
    wse_wet = torch.where(wse_fine > dem, wse_fine, math.nan)
    anchor_mask = torch.isfinite(wse_wet)

    # 03a: plain grid distance from the anchors over the whole raster
    # (notebook ``distance_transform_cdt`` on ``wse2.isnull()``). With a
    # growth threshold, only distances < dp_fine_pixel_max are consumed
    # (farther cells never grow, and their untouched ``inf`` distance
    # fails the threshold exactly like a converged large value), so the
    # relaxation is bounded instead of running to whole-grid fixpoint.
    dist_iters = None
    if dp_fine_pixel_max is not None:
        dist_iters = max(8, int(np.ceil(dp_fine_pixel_max)) + 1)
    distance_px = grid_distance(anchor_mask, metric=metric, max_iters=dist_iters)

    # 03b: spreadzone allocation — each dry cell inherits the WSE of its
    # minimum-cost source over the friction surface.
    cost_valid = torch.isfinite(cost_fine)
    domain = dem_valid & cost_valid
    filled, _ = mcp_fill(
        torch.where(anchor_mask, wse_wet, math.nan),
        anchor_mask,
        torch.where(cost_valid, cost_fine, math.inf),
        domain,
        stats=solves.setdefault("spreadzone_fill", {}),
    )

    # 03c: linear decay with grid distance, grown zone only (anchors keep
    # their exact WSE — notebook ``decay_zone_bar = wse2.isnull()``).
    decay = torch.where(anchor_mask, 0.0, distance_px * decay_per_pixel)
    filled_decayed = filled - decay

    # 03d: growth threshold in coarse-pixel grid distance.
    if dp_fine_pixel_max is None:
        grow_thresh = torch.ones_like(anchor_mask)
    else:
        grow_thresh = distance_px < dp_fine_pixel_max

    grown = torch.where(grow_thresh & (filled_decayed > dem), filled_decayed, math.nan)
    out = torch.where(anchor_mask, wse_wet, grown)

    # 04: drop wet blobs disconnected from the anchors (orthogonal
    # adjacency — the notebook's ``label(..., connectivity=1)``).
    wet_post = torch.isfinite(out)
    keep = keep_components_connected_to_anchor(wet_post, anchor_mask)
    return torch.where(keep & dem_valid, out, math.nan)


class ModelWorker(_CostGrowWorker):
    """CostGrow with the PCRaster variant's phase-03 semantics."""

    model_version = "CostGrow_pcraster"
    _PARAM_KEYS = frozenset(
        {
            "model_version",
            "dp_coarse_pixel_max",
            "decay_frac",
            "terrain_penalty_scale",
            "distance_metric",
            "output_kind",
        }
    )

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
        dp_raw = self.params.get("dp_coarse_pixel_max", 10)
        dp_coarse_pixel_max = None if dp_raw is None else float(dp_raw)
        decay_frac = float(self.params.get("decay_frac", 0.001))
        terrain_penalty_scale = float(self.params.get("terrain_penalty_scale", 1.0))
        metric = str(self.params.get("distance_metric", "chessboard")).lower()
        if metric not in {"chessboard", "taxicab"}:
            raise ValueError(
                f"unsupported distance_metric={metric!r} (chessboard|taxicab)"
            )
        dp_fine_pixel_max = (
            None if dp_coarse_pixel_max is None else dp_coarse_pixel_max * downscale
        )

        # 03 prologue (host): neutral-fill the COARSE WSE, resample to the
        # fine grid, and build the terrain-penalty friction surface
        # (notebook ``_distance_fill_cost_terrain``).
        coarse = np.asarray(wse_coarse, dtype=np.float64)
        finite = np.isfinite(coarse)
        if finite.any() and not finite.all():
            coarse_filled = nearest_fill_numpy(coarse, metric=metric)
        else:
            coarse_filled = coarse
        filled_fine = reproject_bilinear_auto(
            np.where(np.isfinite(coarse_filled), coarse_filled, -9999.0),
            wse_transform,
            dem.shape,
            dem_transform,
            src_nodata=-9999.0,
            dst_nodata=np.nan,
            device=self.device,
        )
        delta = filled_fine - dem
        cost_fine = np.where(
            delta > 0.0, 1.0, 1.0 + np.abs(delta) * terrain_penalty_scale
        )
        cost_fine = np.where(
            dem_valid & np.isfinite(delta), cost_fine, np.nan
        ).astype(np.float32)

        self.last_solves = {}
        dem_t, valid_t = self._dem_to_device(dem, dem_valid)
        wse_out = _costgrow_pcraster_phases(
            self._to_device(wse_fine),
            dem_t,
            valid_t,
            self._to_device(cost_fine),
            dp_fine_pixel_max=dp_fine_pixel_max,
            decay_per_pixel=decay_frac * fine_pixel,
            metric=metric,
            solves=self.last_solves,
        ).cpu().numpy()
        return wse_out, {
            "variant": "pcraster",
            "dp_coarse_pixel_max": dp_coarse_pixel_max,
            "dp_fine_pixel_max": dp_fine_pixel_max,
            "decay_frac": decay_frac,
            "terrain_penalty_scale": terrain_penalty_scale,
            "distance_metric": metric,
        }
