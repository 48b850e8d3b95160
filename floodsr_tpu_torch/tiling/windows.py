"""Window-grid and feather-ramp math shared by all model workers.

Behavioral parity with the reference helpers (reference:
``floodsr/tiling.py:7-45``): overlap-aware tile starts with forced
trailing-edge coverage, an indexed window-origin iterator with optional
progress rendering, and a separable 1-D linear feather ramp clipped to
``[1e-3, 1]``. These are pure host-side functions; the device-side use of
their outputs lives in :mod:`floodsr_tpu_torch.tiling.mosaic`.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator

import numpy as np


def build_tile_starts(total_size: int, tile_size: int, stride: int) -> list[int]:
    """Tile start offsets covering ``[0, total_size)`` with a guaranteed final tile.

    Starts advance by ``stride``; if the regular grid does not land exactly on
    ``total_size - tile_size``, one extra start is appended there so the
    trailing edge is always covered (reference: ``floodsr/tiling.py:7-16``).
    """
    if total_size <= 0:
        raise ValueError(f"total_size must be > 0; got {total_size}")
    if tile_size <= 0:
        raise ValueError(f"tile_size must be > 0; got {tile_size}")
    if stride <= 0:
        raise ValueError(f"stride must be > 0; got {stride}")
    starts = list(range(0, max(total_size - tile_size + 1, 1), stride))
    last_start = total_size - tile_size
    if starts[-1] != last_start:
        starts.append(last_start)
    return starts


def iter_window_origins(
    y_starts: Iterable[int],
    x_starts: Iterable[int],
    *,
    use_progress: bool,
    desc: str = "windowed inference",
) -> Iterator[tuple[int, int, int, int]]:
    """Yield ``(yi, xi, y0, x0)`` window origins in row-major order.

    Mirrors reference ``floodsr/tiling.py:19-31``; with ``use_progress`` a tqdm
    bar is rendered. In the TPU pipeline this iterator is used only for
    host-side bookkeeping — the device path consumes the full origin grid at
    once (see :func:`floodsr_tpu_torch.tiling.mosaic.build_window_grid`).
    """
    y_list = list(y_starts)
    x_list = list(x_starts)
    total = len(y_list) * len(x_list)
    windows = (
        (yi, xi, y0, x0)
        for yi, y0 in enumerate(y_list)
        for xi, x0 in enumerate(x_list)
    )
    if use_progress:
        from tqdm import tqdm

        return tqdm(windows, desc=desc, total=total, unit="window")
    return windows


def build_feather_ramp(tile_size: int, overlap: int) -> np.ndarray:
    """Symmetric 1-D feather weights: linear ramps over ``overlap`` px each side.

    The interior is 1.0; the ramp excludes the exact 0/1 endpoints and the
    result is clipped to ``[1e-3, 1]`` so weight sums stay strictly positive
    (reference: ``floodsr/tiling.py:34-45``).
    """
    if tile_size <= 0:
        raise ValueError(f"tile_size must be > 0; got {tile_size}")
    if overlap < 0:
        raise ValueError(f"overlap must be >= 0; got {overlap}")
    if overlap >= tile_size:
        raise ValueError(
            f"overlap must be < tile_size; got overlap={overlap}, tile_size={tile_size}"
        )
    feather_1d = np.ones(tile_size, dtype=np.float32)
    if overlap > 0:
        ramp = np.linspace(0.0, 1.0, overlap + 2, dtype=np.float32)[1:-1]
        feather_1d[:overlap] = ramp
        feather_1d[-overlap:] = ramp[::-1]
    return np.clip(feather_1d, 1e-3, 1.0)
