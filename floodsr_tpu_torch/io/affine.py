"""Affine georeferencing transforms (self-contained; no GDAL/affine deps).

Same coefficient convention as the ``affine`` package used by rasterio:
``(x, y) = (a*col + b*row + c, d*col + e*row + f)`` where ``(col, row)`` are
pixel coordinates (pixel-is-area: integer coordinates are pixel corners, the
pixel center sits at ``col + 0.5``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Affine:
    """2-D affine transform with rasterio-compatible coefficient order."""

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    @staticmethod
    def identity() -> "Affine":
        return Affine(1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    def __mul__(self, point: tuple[float, float]) -> tuple[float, float]:
        col, row = point
        return (
            self.a * col + self.b * row + self.c,
            self.d * col + self.e * row + self.f,
        )

    def __iter__(self):
        return iter((self.a, self.b, self.c, self.d, self.e, self.f))

    def __getitem__(self, idx: int) -> float:
        return (self.a, self.b, self.c, self.d, self.e, self.f)[idx]

    @property
    def xoff(self) -> float:
        return self.c

    @property
    def yoff(self) -> float:
        return self.f

    def invert(self) -> "Affine":
        """Inverse transform mapping (x, y) back to (col, row)."""
        det = self.a * self.e - self.b * self.d
        if det == 0:
            raise ValueError("affine transform is not invertible")
        ia = self.e / det
        ib = -self.b / det
        id_ = -self.d / det
        ie = self.a / det
        ic = -(ia * self.c + ib * self.f)
        if_ = -(id_ * self.c + ie * self.f)
        return Affine(ia, ib, ic, id_, ie, if_)

    def is_rectilinear(self) -> bool:
        return self.b == 0.0 and self.d == 0.0

    def almost_equals(self, other: "Affine", precision: float = 1e-9) -> bool:
        return all(
            math.isclose(x, y, rel_tol=0.0, abs_tol=precision)
            for x, y in zip(self, other)
        )


def from_origin(west: float, north: float, xsize: float, ysize: float) -> Affine:
    """North-up transform from the upper-left corner and pixel sizes."""
    return Affine(float(xsize), 0.0, float(west), 0.0, -float(ysize), float(north))


def from_bounds(
    west: float,
    south: float,
    east: float,
    north: float,
    width: int,
    height: int,
) -> Affine:
    """North-up transform covering the given bounds with width×height pixels."""
    if width <= 0 or height <= 0:
        raise ValueError(f"width/height must be > 0; got {(width, height)}")
    return Affine(
        (east - west) / float(width),
        0.0,
        float(west),
        0.0,
        (south - north) / float(height),
        float(north),
    )


def array_bounds(height: int, width: int, transform: Affine) -> tuple[float, float, float, float]:
    """(left, bottom, right, top) bounds of a raster under ``transform``."""
    corners = [
        transform * (0.0, 0.0),
        transform * (float(width), 0.0),
        transform * (0.0, float(height)),
        transform * (float(width), float(height)),
    ]
    xs = [p[0] for p in corners]
    ys = [p[1] for p in corners]
    return (min(xs), min(ys), max(xs), max(ys))


def window_from_bounds(
    left: float,
    bottom: float,
    right: float,
    top: float,
    transform: Affine,
) -> tuple[float, float, float, float]:
    """Fractional ``(row_off, col_off, height, width)`` window covering bounds."""
    inv = transform.invert()
    col0, row0 = inv * (left, top)
    col1, row1 = inv * (right, bottom)
    return (
        min(row0, row1),
        min(col0, col1),
        abs(row1 - row0),
        abs(col1 - col0),
    )


def round_window(
    window: tuple[float, float, float, float],
) -> tuple[int, int, int, int]:
    """Round offsets and lengths to integers (nearest, ties-to-even like rasterio)."""
    row_off, col_off, height, width = window
    return (
        int(round(row_off)),
        int(round(col_off)),
        int(round(height)),
        int(round(width)),
    )


def window_transform(
    window_row_off: int, window_col_off: int, transform: Affine
) -> Affine:
    """Transform of a sub-window located at the given pixel offsets."""
    x, y = transform * (float(window_col_off), float(window_row_off))
    return Affine(transform.a, transform.b, x, transform.d, transform.e, y)
