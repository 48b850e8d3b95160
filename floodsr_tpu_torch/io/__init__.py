from floodsr_tpu_torch.io.affine import Affine, array_bounds, from_bounds, from_origin
from floodsr_tpu_torch.io.crs import CRS
from floodsr_tpu_torch.io.geotiff import (
    GEOTIF_OPTIONS,
    get_geotif_options,
    read_raster,
    write_raster,
)

__all__ = [
    "Affine",
    "CRS",
    "from_origin",
    "from_bounds",
    "array_bounds",
    "read_raster",
    "write_raster",
    "GEOTIF_OPTIONS",
    "get_geotif_options",
]
