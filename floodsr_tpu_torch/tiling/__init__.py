from floodsr_tpu_torch.tiling.mosaic import build_window_grid
from floodsr_tpu_torch.tiling.windows import (
    build_feather_ramp,
    build_tile_starts,
    iter_window_origins,
)

__all__ = [
    "build_tile_starts",
    "build_feather_ramp",
    "iter_window_origins",
    "build_window_grid",
]
