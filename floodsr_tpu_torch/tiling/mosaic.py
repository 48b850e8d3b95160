"""Host-side window-origin grid for the scene executor.

The device-side mosaic (feather weights and the tile scatter-add) lives in
:mod:`floodsr_tpu_torch.engine.scene`; this module keeps only the numpy grid
builder it consumes.
"""

from __future__ import annotations

import numpy as np

from floodsr_tpu_torch.tiling.windows import build_tile_starts


def build_window_grid(
    height: int,
    width: int,
    tile: int,
    stride: int,
) -> dict[str, np.ndarray | int]:
    """Build the full row-major window-origin grid for a padded scene.

    Returns origin arrays ``y0``/``x0`` with grid indices ``yi``/``xi`` (used
    for edge-flattened feather weights) plus grid extents ``ny``/``nx``.
    """
    y_starts = build_tile_starts(height, tile, stride)
    x_starts = build_tile_starts(width, tile, stride)
    ny, nx = len(y_starts), len(x_starts)
    yi, xi = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    y0 = np.asarray(y_starts, dtype=np.int32)[yi]
    x0 = np.asarray(x_starts, dtype=np.int32)[xi]
    return {
        "y0": y0.reshape(-1).astype(np.int32),
        "x0": x0.reshape(-1).astype(np.int32),
        "yi": yi.reshape(-1).astype(np.int32),
        "xi": xi.reshape(-1).astype(np.int32),
        "ny": ny,
        "nx": nx,
    }
