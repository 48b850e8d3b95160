"""ESRI ASCII (.asc) and Surfer DSAA grid readers.

Widens the input boundary beyond the TIFF family for the two text grid
formats common in flood-modelling toolchains (LISFLOOD-FP, HEC-RAS exports
use AAIGrid; Surfer grids show up in survey data). The reference inherits
these through GDAL (``floodsr/preprocessing.py:247-282`` reads any
GDAL-supported source); this build parses them directly and resolves the
CRS from the ESRI ``.prj`` WKT sidecar through the same
:class:`~floodsr_tpu_torch.io.crs.CRS` ingestion the TIFF path uses.

Both formats decode to the rasterio-shaped ``(array, nodata, profile)``
triple of :func:`floodsr_tpu_torch.io.geotiff.read_raster`, which dispatches here
on the leading bytes — so ``tohr`` accepts ``.asc`` inputs end to end while
outputs stay GeoTIFF.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from floodsr_tpu_torch.io.affine import Affine
from floodsr_tpu_torch.io.crs import CRS

#: Surfer's "blanked node" sentinel: any value >= this is no-data.
SURFER_BLANK = 1.70141e38

_ESRI_HEAD_RE = re.compile(rb"^\s*ncols[ \t]", re.IGNORECASE)

# ESRI AAIGrid header keys (case-insensitive). ``dx``/``dy`` is the GDAL
# extension for non-square cells; ``*llcenter`` registers the lower-left
# CELL CENTER instead of the cell corner.
_ESRI_KEYS = {
    "ncols", "nrows",
    "xllcorner", "yllcorner", "xllcenter", "yllcenter",
    "cellsize", "dx", "dy", "nodata_value",
}


def sniff_ascii_grid(head: bytes) -> str | None:
    """``"esri"`` / ``"surfer"`` when the leading bytes are a text grid."""
    if _ESRI_HEAD_RE.match(head):
        return "esri"
    if head[:4] == b"DSAA":
        return "surfer"
    return None


def crs_from_prj_sidecar(fp: str | Path) -> CRS | None:
    """CRS from the ESRI ``.prj`` WKT sidecar next to ``fp``, if present."""
    for candidate in (Path(fp).with_suffix(".prj"), Path(str(fp) + ".prj")):
        if candidate.exists():
            text = candidate.read_text(encoding="utf-8", errors="replace").strip()
            if text:
                return CRS.from_wkt(text)
    return None


def parse_esri_ascii_grid(
    data: bytes,
) -> tuple[np.ndarray, float | None, Affine]:
    """Parse AAIGrid text: ``(array[H, W] float32, nodata, transform)``.

    Header rows are ``key value`` pairs until the first line whose leading
    token is not a known key; data rows follow top-row-first (north up).
    """
    text = data.decode("ascii", errors="replace")
    header: dict[str, float] = {}
    pos = 0
    while True:
        eol = text.find("\n", pos)
        line = text[pos:] if eol < 0 else text[pos:eol]
        parts = line.split()
        if len(parts) >= 2 and parts[0].lower() in _ESRI_KEYS:
            try:
                header[parts[0].lower()] = float(parts[1])
            except ValueError as exc:
                raise ValueError(
                    f"ESRI ASCII grid: bad header line {line!r}"
                ) from exc
            if eol < 0:
                pos = len(text)
                break
            pos = eol + 1
        else:
            break

    for key in ("ncols", "nrows"):
        if key not in header:
            raise ValueError(f"ESRI ASCII grid: missing header key {key!r}")
    ncols = int(header["ncols"])
    nrows = int(header["nrows"])
    if ncols <= 0 or nrows <= 0:
        raise ValueError(
            f"ESRI ASCII grid: bad dimensions ncols={ncols} nrows={nrows}"
        )
    if "cellsize" in header:
        dx = dy = float(header["cellsize"])
    elif "dx" in header and "dy" in header:
        dx, dy = float(header["dx"]), float(header["dy"])
    else:
        raise ValueError("ESRI ASCII grid: need cellsize (or dx+dy)")
    if dx <= 0 or dy <= 0:
        raise ValueError(f"ESRI ASCII grid: bad cell size dx={dx} dy={dy}")

    if "xllcorner" in header:
        west = float(header["xllcorner"])
    elif "xllcenter" in header:
        west = float(header["xllcenter"]) - dx / 2.0
    else:
        raise ValueError("ESRI ASCII grid: need xllcorner or xllcenter")
    if "yllcorner" in header:
        south = float(header["yllcorner"])
    elif "yllcenter" in header:
        south = float(header["yllcenter"]) - dy / 2.0
    else:
        raise ValueError("ESRI ASCII grid: need yllcorner or yllcenter")

    nodata = header.get("nodata_value")
    values = np.array(text[pos:].split(), dtype=np.float32)
    if values.size != nrows * ncols:
        raise ValueError(
            f"ESRI ASCII grid: expected {nrows * ncols} values "
            f"({nrows}x{ncols}), found {values.size}"
        )
    arr = values.reshape(nrows, ncols)
    north = south + nrows * dy
    transform = Affine(dx, 0.0, west, 0.0, -dy, north)
    return arr, nodata, transform


def parse_surfer_ascii_grid(
    data: bytes,
) -> tuple[np.ndarray, float | None, Affine]:
    """Parse a Surfer DSAA grid: ``(array[H, W] float32, nodata, transform)``.

    DSAA grids are NODE-registered (values at grid nodes, ``xlo..xhi``
    spanning node centers) and stored bottom-row-first; this returns a
    north-up pixel-is-area array with nodes treated as pixel centers.
    Blanked nodes (>= :data:`SURFER_BLANK`) become ``nan`` with
    ``nodata = nan``.
    """
    tokens = data.decode("ascii", errors="replace").split()
    if not tokens or tokens[0] != "DSAA":
        raise ValueError("Surfer ASCII grid: missing DSAA signature")
    if len(tokens) < 9:
        raise ValueError("Surfer ASCII grid: truncated header")
    nx, ny = int(tokens[1]), int(tokens[2])
    if nx <= 0 or ny <= 0:
        raise ValueError(f"Surfer ASCII grid: bad dimensions nx={nx} ny={ny}")
    xlo, xhi = float(tokens[3]), float(tokens[4])
    ylo, yhi = float(tokens[5]), float(tokens[6])
    # tokens[7:9] are zlo/zhi (informational)
    values = np.array(tokens[9:], dtype=np.float32)
    if values.size != nx * ny:
        raise ValueError(
            f"Surfer ASCII grid: expected {nx * ny} values "
            f"({ny}x{nx}), found {values.size}"
        )
    dx = (xhi - xlo) / (nx - 1) if nx > 1 else 1.0
    dy = (yhi - ylo) / (ny - 1) if ny > 1 else 1.0
    if dx <= 0 or dy <= 0:
        raise ValueError(f"Surfer ASCII grid: bad node spacing dx={dx} dy={dy}")
    # Rows are stored south to north; flip to north-up.
    arr = values.reshape(ny, nx)[::-1].copy()
    nodata: float | None = None
    blank = arr >= np.float32(SURFER_BLANK)
    if blank.any():
        arr[blank] = np.nan
        nodata = float("nan")
    transform = Affine(dx, 0.0, xlo - dx / 2.0, 0.0, -dy, yhi + dy / 2.0)
    return arr, nodata, transform


def read_ascii_grid(
    fp: str | Path, data: bytes | None = None
) -> tuple[np.ndarray, float | None, dict]:
    """Read an ESRI/Surfer text grid: ``(array, nodata, profile)``.

    The profile mirrors :func:`floodsr_tpu_torch.io.geotiff.read_raster` (driver
    names follow GDAL: ``AAIGrid`` / ``GSAG``); CRS comes from the ``.prj``
    sidecar when present, else ``None``.
    """
    path = Path(fp).expanduser().resolve()
    if data is None:
        data = path.read_bytes()
    kind = sniff_ascii_grid(data[:64])
    if kind == "esri":
        arr, nodata, transform = parse_esri_ascii_grid(data)
        driver = "AAIGrid"
    elif kind == "surfer":
        arr, nodata, transform = parse_surfer_ascii_grid(data)
        driver = "GSAG"
    else:
        raise ValueError(f"not an ESRI/Surfer ASCII grid: {path}")
    profile = {
        "driver": driver,
        "dtype": str(arr.dtype),
        "nodata": nodata,
        "width": int(arr.shape[1]),
        "height": int(arr.shape[0]),
        "count": 1,
        "crs": crs_from_prj_sidecar(path),
        "transform": transform,
        "compress": None,
    }
    return arr, nodata, profile
