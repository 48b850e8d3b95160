"""Vector feature ingestion (building footprints) for blocking.

Host-only port of the JAX package's ``features`` package: load building
footprints, rasterize them onto a raster grid, and block them in the models —
CostGrow excludes buildings from the hydraulic-connectivity growth domain; the
ResUNet worker masks super-resolved depths inside footprints. The NRCan
footprint fetcher is :mod:`.nrcan_buildings`.
"""

from floodsr_tpu_torch.features.footprints import (
    building_mask_for_grid,
    load_footprints,
    rasterize_polygons,
)

__all__ = [
    "building_mask_for_grid",
    "load_footprints",
    "rasterize_polygons",
]
