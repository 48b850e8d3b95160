"""GeoTIFF read/write on top of the self-contained TIFF codec.

Provides the rasterio-shaped surface the pipeline needs — profile dicts with
``crs``/``transform``/``nodata``, single-band float32 defaults
(reference: ``floodsr/io/rasterio_io.py:4-14``), and georeferencing tags
(ModelPixelScale + ModelTiepoint, GeoKeyDirectory with EPSG codes,
GDAL_NODATA) compatible with GDAL-written files.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from floodsr_tpu_torch.io import tiff as _tiff
from floodsr_tpu_torch.io.affine import Affine
from floodsr_tpu_torch.io.crs import CRS

TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_MODEL_TRANSFORMATION = 34264
TAG_GEO_KEY_DIRECTORY = 34735
TAG_GEO_DOUBLE_PARAMS = 34736
TAG_GEO_ASCII_PARAMS = 34737
TAG_GDAL_NODATA = 42113

GEOKEY_MODEL_TYPE = 1024
GEOKEY_RASTER_TYPE = 1025
GEOKEY_CITATION = 1026
GEOKEY_GEOGRAPHIC_TYPE = 2048
GEOKEY_GEOG_CITATION = 2049
GEOKEY_PROJECTED_CS_TYPE = 3072
GEOKEY_PCS_CITATION = 3073

MODEL_TYPE_PROJECTED = 1
MODEL_TYPE_GEOGRAPHIC = 2
RASTER_PIXEL_IS_AREA = 1
USER_DEFINED = 32767

# Default GeoTIFF write options (reference: floodsr/io/rasterio_io.py:4-14).
GEOTIF_OPTIONS = {
    "driver": "GTiff",
    "dtype": "float32",
    "compress": "LZW",
    "nodata": -9999,
}


def get_geotif_options() -> dict:
    """Return a copy of default GeoTIFF options for safe per-call mutation."""
    return dict(GEOTIF_OPTIONS)


_COMPRESS_TO_TIFF = {
    None: _tiff.COMPRESSION_NONE,
    "NONE": _tiff.COMPRESSION_NONE,
    "LZW": _tiff.COMPRESSION_LZW,
    "DEFLATE": _tiff.COMPRESSION_DEFLATE_ADOBE,
    "PACKBITS": _tiff.COMPRESSION_PACKBITS,
    "ZSTD": _tiff.COMPRESSION_ZSTD,
}
_TIFF_TO_COMPRESS = {
    _tiff.COMPRESSION_NONE: None,
    _tiff.COMPRESSION_LZW: "LZW",
    _tiff.COMPRESSION_DEFLATE_ADOBE: "DEFLATE",
    _tiff.COMPRESSION_DEFLATE_OLD: "DEFLATE",
    _tiff.COMPRESSION_PACKBITS: "PACKBITS",
    _tiff.COMPRESSION_ZSTD: "ZSTD",
}


def _profile_predictor(profile: dict, dtype: np.dtype) -> int | None:
    """Predictor from an advisory profile, dropped when it can't apply.

    Profiles are commonly copied from an input raster and re-used for an
    output of a different dtype (e.g. int DEM profile → float depth
    output); like GDAL's creation options, a kind-mismatched predictor is
    ignored rather than fatal. Direct ``encode_tiff(predictor=...)`` calls
    keep the hard validation.
    """
    predictor = profile.get("predictor")
    if predictor is None:
        return None
    predictor = int(predictor)
    kind = np.dtype(dtype).kind
    if (predictor == 2 and kind not in "ui") or (predictor == 3 and kind != "f"):
        return None
    return predictor


def _crs_from_geokeys(tags: dict[int, object]) -> CRS | None:
    directory = tags.get(TAG_GEO_KEY_DIRECTORY)
    if directory is None:
        return None
    vals = list(directory) if isinstance(directory, tuple) else [directory]
    if len(vals) < 4:
        return None
    ascii_params = str(tags.get(TAG_GEO_ASCII_PARAMS, "") or "")
    num_keys = int(vals[3])
    keys: dict[int, int] = {}
    texts: dict[int, str] = {}
    for k in range(num_keys):
        base = 4 + 4 * k
        if base + 3 >= len(vals):
            break
        key_id, location, count, value = (int(v) for v in vals[base : base + 4])
        if location == 0:
            keys[key_id] = value
        elif location == TAG_GEO_ASCII_PARAMS:
            # value = char offset into GeoAsciiParams, count includes the
            # "|" terminator the spec uses in place of NUL.
            texts[key_id] = ascii_params[value : value + count].rstrip("|\x00")
    epsg = keys.get(GEOKEY_PROJECTED_CS_TYPE) or keys.get(GEOKEY_GEOGRAPHIC_TYPE)
    if epsg is not None and epsg not in (0, USER_DEFINED):
        return CRS(epsg=epsg)
    # User-defined / absent code: the reference (GDAL) still resolves such
    # rasters from their WKT/citation keys (floodsr/preprocessing.py:304-331
    # accepts any rasterio CRS). Recover an EPSG code if the citation embeds
    # one; otherwise carry an opaque-but-comparable WKT identity with the
    # projected flag taken from the model-type key.
    citation = (
        texts.get(GEOKEY_PCS_CITATION)
        or texts.get(GEOKEY_GEOG_CITATION)
        or texts.get(GEOKEY_CITATION)
    )
    if not citation:
        return None
    model_type = keys.get(GEOKEY_MODEL_TYPE)
    projected = {MODEL_TYPE_PROJECTED: True, MODEL_TYPE_GEOGRAPHIC: False}.get(
        model_type if model_type is None else int(model_type)
    )
    crs = CRS.from_wkt(citation)
    if projected is not None and crs.epsg is None:
        crs = CRS(epsg=None, wkt=crs.wkt, projected=projected)
    return crs


def _transform_from_tags(tags: dict[int, object]) -> Affine | None:
    model = tags.get(TAG_MODEL_TRANSFORMATION)
    if model is not None and len(model) >= 8:
        m = list(model)
        return Affine(m[0], m[1], m[3], m[4], m[5], m[7])
    scale = tags.get(TAG_MODEL_PIXEL_SCALE)
    tiepoint = tags.get(TAG_MODEL_TIEPOINT)
    if scale is None or tiepoint is None:
        return None
    sx, sy = float(scale[0]), float(scale[1])
    i, j, _k, x, y, _z = (float(v) for v in list(tiepoint)[:6])
    # Tiepoint maps raster (i, j) to model (x, y) with north-up convention.
    west = x - i * sx
    north = y + j * sy
    return Affine(sx, 0.0, west, 0.0, -sy, north)


def _geo_tags_for(
    transform: Affine | None,
    crs: CRS | None,
    nodata: float | None,
) -> list[tuple[int, int, object]]:
    extra: list[tuple[int, int, object]] = []
    if transform is not None:
        # PixelScale+Tiepoint can only express north-up grids (positive x
        # scale, negative y scale); anything else — including south-up
        # rectilinear — must go through ModelTransformation or it would
        # silently round-trip with flipped georeferencing.
        north_up = transform.a > 0 and transform.e < 0
        if not transform.is_rectilinear() or not north_up:
            extra.append(
                (
                    TAG_MODEL_TRANSFORMATION,
                    12,
                    (
                        transform.a, transform.b, 0.0, transform.c,
                        transform.d, transform.e, 0.0, transform.f,
                        0.0, 0.0, 0.0, 0.0,
                        0.0, 0.0, 0.0, 1.0,
                    ),
                )
            )
        else:
            extra.append(
                (TAG_MODEL_PIXEL_SCALE, 12, (abs(transform.a), abs(transform.e), 0.0))
            )
            extra.append(
                (TAG_MODEL_TIEPOINT, 12, (0.0, 0.0, 0.0, transform.c, transform.f, 0.0))
            )
    if crs is not None:
        model_type = MODEL_TYPE_PROJECTED if crs.is_projected else MODEL_TYPE_GEOGRAPHIC
        cs_type_key = (
            GEOKEY_PROJECTED_CS_TYPE if crs.is_projected else GEOKEY_GEOGRAPHIC_TYPE
        )
        keys = [
            (GEOKEY_MODEL_TYPE, 0, 1, model_type),
            (GEOKEY_RASTER_TYPE, 0, 1, RASTER_PIXEL_IS_AREA),
        ]
        ascii_params: str | None = None
        if crs.epsg is not None:
            keys.append((cs_type_key, 0, 1, crs.epsg))
        else:
            # WKT-only CRS: user-defined code + the WKT as a citation in
            # GeoAsciiParams ("|" is the spec's NUL stand-in), so identity
            # survives a write→read round trip (GDAL reads this layout).
            citation_key = (
                GEOKEY_PCS_CITATION if crs.is_projected else GEOKEY_GEOG_CITATION
            )
            wkt = (crs.wkt or "").replace("|", " ")
            ascii_params = wkt + "|"
            keys.append((cs_type_key, 0, 1, USER_DEFINED))
            keys.append((citation_key, TAG_GEO_ASCII_PARAMS, len(ascii_params), 0))
        directory = [1, 1, 0, len(keys)]
        for key in sorted(keys):
            directory.extend(key)
        extra.append((TAG_GEO_KEY_DIRECTORY, 3, tuple(directory)))
        if ascii_params is not None:
            extra.append((TAG_GEO_ASCII_PARAMS, 2, ascii_params))
    if nodata is not None:
        nodata_f = float(nodata)
        if np.isnan(nodata_f):  # GDAL writes GDAL_NODATA="nan" for floats
            text = "nan"
        elif np.isfinite(nodata_f) and nodata_f == int(nodata_f):
            text = str(int(nodata_f))
        else:
            text = repr(nodata_f)
        extra.append((TAG_GDAL_NODATA, 2, text))
    return extra


def _slice_window(
    arr: np.ndarray,
    transform: Affine,
    window: tuple[int, int, int, int],
) -> tuple[np.ndarray, Affine]:
    """Slice ``(row_off, col_off, height, width)`` and shift the transform."""
    row_off, col_off, height, width = window
    row0 = max(0, row_off)
    col0 = max(0, col_off)
    arr = arr[row0 : row_off + height, col0 : col_off + width]
    x, y = transform * (float(col0), float(row0))
    return arr, Affine(transform.a, transform.b, x, transform.d, transform.e, y)


def read_raster(
    fp: str | Path,
    band: int = 1,
    window: tuple[int, int, int, int] | None = None,
) -> tuple[np.ndarray, float | None, dict]:
    """Read one band of a raster: ``(array, nodata, profile)``.

    Primary format is the TIFF family (GeoTIFF/BigTIFF/COG); ESRI ASCII
    (.asc) and Surfer DSAA text grids are dispatched to
    :mod:`floodsr_tpu_torch.io.ascii_grid` (reference breadth: GDAL reads these
    through the same ``rasterio.open``, ``floodsr/preprocessing.py:247-282``).
    ``window`` is ``(row_off, col_off, height, width)`` in pixel coordinates;
    the returned profile describes the windowed extent.
    """
    from floodsr_tpu_torch.io.ascii_grid import read_ascii_grid, sniff_ascii_grid

    path = Path(fp).expanduser().resolve()
    if not path.exists():
        raise AssertionError(f"raster does not exist: {path}")
    data = path.read_bytes()
    if sniff_ascii_grid(data[:64]) is not None:
        arr, nodata, profile = read_ascii_grid(path, data)
        if band != 1:
            raise ValueError(f"band {band} requested from single-band raster")
        if window is not None:
            arr, transform = _slice_window(arr, profile["transform"], window)
            profile["transform"] = transform
            profile["height"], profile["width"] = map(int, arr.shape)
        return arr, nodata, profile
    arr, tags = _tiff.decode_tiff(data)
    if arr.ndim == 3:
        count = arr.shape[2]
        arr = arr[:, :, band - 1]
    else:
        count = 1
        if band != 1:
            raise ValueError(f"band {band} requested from single-band raster")

    nodata: float | None = None
    nodata_text = tags.get(TAG_GDAL_NODATA)
    if nodata_text is not None:
        try:
            nodata = float(str(nodata_text).strip())
        except ValueError:
            nodata = None

    transform = _transform_from_tags(tags) or Affine.identity()
    crs = _crs_from_geokeys(tags)
    if window is not None:
        arr, transform = _slice_window(arr, transform, window)

    profile = {
        "driver": "GTiff",
        "dtype": str(arr.dtype),
        "nodata": nodata,
        "width": int(arr.shape[1]),
        "height": int(arr.shape[0]),
        "count": count,
        "crs": crs,
        "transform": transform,
        "compress": _TIFF_TO_COMPRESS.get(
            int(tags.get(_tiff.TAG_COMPRESSION, _tiff.COMPRESSION_NONE))
        ),
    }
    predictor = int(tags.get(_tiff.TAG_PREDICTOR, 1))
    if predictor != 1:
        profile["predictor"] = predictor
    return arr, nodata, profile


def _profile_from_tags(
    tags: dict[int, object], dtype_str: str, height: int, width: int, count: int
) -> tuple[float | None, dict]:
    """(nodata, rasterio-shaped profile) from decoded TIFF tags."""
    nodata = None
    nodata_text = tags.get(TAG_GDAL_NODATA)
    if nodata_text is not None:
        try:
            nodata = float(str(nodata_text).strip())
        except ValueError:
            nodata = None
    profile = {
        "driver": "GTiff",
        "dtype": dtype_str,
        "nodata": nodata,
        "width": int(width),
        "height": int(height),
        "count": int(count),
        "crs": _crs_from_geokeys(tags),
        "transform": _transform_from_tags(tags) or Affine.identity(),
        "compress": _TIFF_TO_COMPRESS.get(
            int(tags.get(_tiff.TAG_COMPRESSION, _tiff.COMPRESSION_NONE))
        ),
    }
    predictor = int(tags.get(_tiff.TAG_PREDICTOR, 1))
    if predictor != 1:
        profile["predictor"] = predictor
    return nodata, profile


def open_raster_window_reader(
    src: str | Path, transport=None
) -> tuple["object", float | None, dict]:
    """Open a raster for windowed reads: ``(reader, nodata, full profile)``.

    ``src`` may be a local path or an ``http(s)`` href — remote rasters are
    read via HTTP ``Range`` requests through ``transport`` (the
    ``(url, body, headers) -> bytes`` hook; required for hrefs), so a window
    fetches only the intersecting tiles/strips, never the whole asset
    (reference behavior: ``floodsr/dem_sources/hrdem_stac.py:117-219`` via
    GDAL's ranged COG reads). The profile describes the FULL raster; use
    ``reader.read_window(row, col, h, w)`` for pixels and shift the
    transform for the window origin.
    """
    from floodsr_tpu_torch.io.tiff_window import (
        FileByteSource,
        RangeTransportByteSource,
        TiffWindowReader,
    )

    if isinstance(src, str) and src.startswith(("http://", "https://")):
        assert transport is not None, "remote window reads require a transport"
        source = RangeTransportByteSource(src, transport)
    else:
        path = Path(src).expanduser().resolve()
        if not path.exists():
            raise AssertionError(f"raster does not exist: {path}")
        source = FileByteSource(path)
    reader = TiffWindowReader(source)
    page = reader.page
    nodata, profile = _profile_from_tags(
        page.tags,
        str(np.dtype(page.dtype.newbyteorder("="))),
        page.height,
        page.width,
        page.samples_per_pixel,
    )
    return reader, nodata, profile


def read_raster_header(fp: str | Path) -> dict:
    """Read only the georeferencing profile (IFD tags, no pixel decode).

    Used for cheap post-write verification — shape/bounds checks don't need
    a full strip decode of a multi-MB scene. Reads only the header/IFD byte
    ranges (classic TIFF and BigTIFF) instead of the whole file.
    """
    _, _, profile = open_raster_window_reader(fp)
    return profile


def write_raster(
    fp: str | Path,
    array: np.ndarray,
    profile: dict,
    *,
    tile: tuple[int, int] | None = None,
    bigtiff: bool | None = None,
    overviews: tuple[int, ...] | None = None,
) -> Path:
    """Write a single-band raster with the given rasterio-style profile.

    ``tile`` writes a tiled (COG-style) layout; ``bigtiff`` forces the
    8-byte-offset container (``None`` auto-switches past the classic 4 GiB
    limit). ``overviews`` appends reduced-resolution pages (average-pooled
    decimation levels, e.g. ``(2, 4, 8)``) — the internal-overview COG
    layout GDAL builds, which :class:`~floodsr_tpu_torch.io.tiff_window.
    TiffWindowReader` serves coarse-target window reads from.
    """
    path = Path(fp).expanduser().resolve()
    path.parent.mkdir(parents=True, exist_ok=True)

    if array.ndim != 2:
        raise AssertionError(f"array must be 2D; got {array.shape}")
    dtype = np.dtype(profile.get("dtype", array.dtype))
    arr = np.ascontiguousarray(array.astype(dtype, copy=False))

    nodata = profile.get("nodata")
    nodata_f = None if nodata is None else float(nodata)
    crs = CRS.from_user_input(profile.get("crs"))
    transform = profile.get("transform")
    if transform is not None and not isinstance(transform, Affine):
        transform = Affine(*list(transform)[:6])
    compress_name = profile.get("compress")
    if isinstance(compress_name, str):
        compress_name = compress_name.upper()
    compression = _COMPRESS_TO_TIFF.get(compress_name, _tiff.COMPRESSION_LZW)

    height = profile.get("height")
    width = profile.get("width")
    if height is not None and int(height) != arr.shape[0]:
        raise AssertionError(f"profile height {height} != array height {arr.shape[0]}")
    if width is not None and int(width) != arr.shape[1]:
        raise AssertionError(f"profile width {width} != array width {arr.shape[1]}")

    extra_tags = _geo_tags_for(transform, crs, nodata_f)
    if overviews:
        data = _tiff.encode_tiff_overviews(
            arr, extra_tags=extra_tags, compression=compression,
            predictor=_profile_predictor(profile, arr.dtype), tile=tile,
            bigtiff=bool(bigtiff), overview_levels=tuple(overviews),
        )
    else:
        data = _tiff.encode_tiff(
            arr, extra_tags=extra_tags, compression=compression,
            predictor=_profile_predictor(profile, arr.dtype), tile=tile,
            bigtiff=bigtiff,
        )
    path.write_bytes(data)
    return path


def open_raster_stream(fp: str | Path, profile: dict) -> "_tiff.StripStreamWriter":
    """Open a streaming single-band GeoTIFF writer for row-band output.

    Same profile semantics as :func:`write_raster`; the caller feeds
    ``write_rows(band)`` top to bottom and ``close()``s (or uses it as a
    context manager). Strips are compressed and written incrementally, which
    lets GeoTIFF encoding overlap the device→host transfer of later bands.
    """
    path = Path(fp).expanduser().resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    dtype = np.dtype(profile.get("dtype", "float32"))
    nodata = profile.get("nodata")
    crs = CRS.from_user_input(profile.get("crs"))
    transform = profile.get("transform")
    if transform is not None and not isinstance(transform, Affine):
        transform = Affine(*list(transform)[:6])
    compress_name = profile.get("compress")
    if isinstance(compress_name, str):
        compress_name = compress_name.upper()
    compression = _COMPRESS_TO_TIFF.get(compress_name, _tiff.COMPRESSION_LZW)
    extra_tags = _geo_tags_for(
        transform, crs, None if nodata is None else float(nodata)
    )
    return _tiff.StripStreamWriter(
        path,
        int(profile["height"]),
        int(profile["width"]),
        dtype,
        extra_tags=extra_tags,
        compression=compression,
        predictor=_profile_predictor(profile, dtype),
    )


def raster_bounds(profile: dict) -> tuple[float, float, float, float]:
    """(left, bottom, right, top) from a profile's shape + transform."""
    from floodsr_tpu_torch.io.affine import array_bounds

    height = int(profile["height"])
    width = int(profile["width"])
    transform = profile["transform"]
    if height <= 0 or width <= 0:
        raise AssertionError(f"profile height/width must be > 0; got {(height, width)}")
    if transform is None:
        raise AssertionError("profile transform is required to compute bounds")
    return array_bounds(height, width, transform)


def pixel_size(profile: dict) -> tuple[float, float]:
    """Absolute pixel size in projection units (nan when no transform)."""
    transform = profile.get("transform")
    if transform is None:
        return (math.nan, math.nan)
    t = list(transform)
    return (abs(float(t[0])), abs(float(t[4])))
