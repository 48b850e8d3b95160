"""HRDEM provider: NRCan datacube STAC search + offline raster merge.

Covers the reference's HRDEM fetcher behavior
(``floodsr/dem_sources/hrdem_stac.py``): search ``hrdem-mosaic-1m`` for
``dtm`` assets intersecting the depth raster's EPSG:4326 footprint, warp each
asset onto the depth CRS grid at source resolution, keep the valid pixels,
pick nodata as depth > source > −9999, and write an LZW GeoTIFF. Results are
memoized for the process lifetime by a digest of
(CRS, bounds, endpoint, collection, asset).

Implementation is self-contained for this framework: the STAC search is one
urllib POST (no pystac-client), assets are decoded by the in-tree TIFF
reader (remote hrefs are pulled whole — no HTTP range reads yet), and
coordinate transforms come from :mod:`floodsr_tpu_torch.dem_sources.geodesy`. All
HTTP goes through a swappable transport hook so the suite runs offline.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Callable
from urllib.request import Request, urlopen

import numpy as np

from floodsr_tpu_torch.dem_sources.base import DemFetchResult
from floodsr_tpu_torch.dem_sources.geodesy import transform_bounds
from floodsr_tpu_torch.io.affine import from_bounds as bounds_to_transform
from floodsr_tpu_torch.io.geotiff import raster_bounds, read_raster, write_raster
from floodsr_tpu_torch.ops.resample import reproject_bilinear

SOURCE_ID = "hrdem"
STAC_URL = "https://datacube.services.geo.ca/api"
COLLECTION = "hrdem-mosaic-1m"
DEFAULT_ASSET = "dtm"

_FILL = np.float32(-3.4028235e38)  # internal sentinel during merge

# ---------------------------------------------------------------------------
# transport hook + session memo
# ---------------------------------------------------------------------------

# (url, POST body or None for GET, headers) -> response bytes
Transport = Callable[[str, bytes | None, dict[str, str]], bytes]


def _urllib_transport(url: str, data: bytes | None, headers: dict[str, str]) -> bytes:
    with urlopen(Request(url, data=data, headers=headers), timeout=120) as resp:  # nosec B310
        return resp.read()


_TRANSPORT: Transport = _urllib_transport
_SESSION_FETCH_CACHE: dict[str, Path] = {}


def set_transport(transport: Transport | None) -> None:
    """Swap the HTTP transport; ``None`` restores urllib."""
    global _TRANSPORT
    _TRANSPORT = transport if transport is not None else _urllib_transport


# ---------------------------------------------------------------------------
# depth-footprint resolution
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Footprint:
    """Geometry of the depth raster that anchors the fetch."""

    path: Path
    crs: object
    bounds: tuple[float, float, float, float]
    nodata: float | None
    bbox_4326: tuple[float, float, float, float]

    def cache_key(
        self, stac_url: str, collection: str, asset_key: str,
        target_res: float | None = None,
    ) -> str:
        crs_text = self.crs.to_string() if self.crs is not None else "unknown"
        stamp = "|".join(
            (
                crs_text,
                ",".join(f"{v:.8f}" for v in self.bounds),
                stac_url,
                collection,
                asset_key,
                # overview-served fetches land on a coarser grid — a
                # different artifact, never a cache alias of the native one
                "" if target_res is None else f"res={float(target_res):.6f}",
            )
        )
        return hashlib.sha256(stamp.encode("utf-8")).hexdigest()[:24]


def _footprint_of(depth_lr_fp: str | Path) -> _Footprint:
    path = Path(depth_lr_fp).expanduser().resolve()
    assert path.exists(), f"low-res depth raster does not exist: {path}"
    _, nodata, profile = read_raster(path)
    crs = profile["crs"]
    assert crs is not None, f"low-res depth CRS is required for STAC query: {path}"
    bounds = tuple(float(v) for v in raster_bounds(profile))
    bbox = tuple(
        float(v)
        for v in transform_bounds(crs, "EPSG:4326", *bounds, densify_pts=21)
    )
    assert bbox[0] < bbox[2] and bbox[1] < bbox[3], (
        f"depth footprint degenerate after EPSG:4326 transform: {bbox}"
    )
    return _Footprint(path=path, crs=crs, bounds=bounds, nodata=nodata, bbox_4326=bbox)


def _scratch_tile_path(cache_key: str) -> Path:
    root = Path(tempfile.gettempdir()) / "floodsr" / "hrdem-fetch"
    root.mkdir(parents=True, exist_ok=True)
    return (root / f"{cache_key}.tif").resolve()


# ---------------------------------------------------------------------------
# STAC search
# ---------------------------------------------------------------------------


def _query_hrdem_assets(
    *,
    bbox_4326: tuple[float, float, float, float],
    stac_url: str,
    collection: str,
    asset_key: str,
) -> tuple[list[str], list[str]]:
    """One STAC item-search POST; returns (item ids, asset hrefs)."""
    body = json.dumps(
        {"collections": [collection], "bbox": list(bbox_4326), "limit": 200}
    ).encode("utf-8")
    raw = _TRANSPORT(
        stac_url.rstrip("/") + "/search",
        body,
        {"Content-Type": "application/json", "Accept": "application/geo+json"},
    )
    features = json.loads(raw.decode("utf-8")).get("features", [])
    if not features:
        raise RuntimeError(
            f"HRDEM STAC query returned 0 items for bbox={bbox_4326} "
            f"collection={collection} at {stac_url}"
        )
    ids, hrefs = [], []
    for feature in features:
        href = feature.get("assets", {}).get(asset_key, {}).get("href")
        if href:
            ids.append(str(feature.get("id")))
            hrefs.append(str(href))
    if not hrefs:
        raise RuntimeError(
            f"HRDEM STAC returned items but no '{asset_key}' assets for bbox={bbox_4326}"
        )
    return ids, hrefs


# ---------------------------------------------------------------------------
# asset read + merge
# ---------------------------------------------------------------------------


def _open_asset_window(
    href: str,
    bounds: tuple[float, float, float, float] | None,
    logger: logging.Logger | None = None,
    expect_crs: str | None = None,
    target_res: float | None = None,
) -> tuple[np.ndarray, float | None, dict] | None:
    """Read the part of an asset intersecting ``bounds`` (asset-CRS coords).

    Remote hrefs are served by HTTP ``Range`` requests through the transport
    hook — only the header/IFD plus the tiles/strips under the footprint are
    transferred, never the whole asset (reference behavior via GDAL:
    ``floodsr/dem_sources/hrdem_stac.py:117-219``). When
    ``target_res`` is coarser than the asset's native resolution and the
    asset carries internal overviews (COG), the window is served from the
    coarsest overview still at least as fine as the target — GDAL's
    overview rule — cutting the fetched bytes by roughly the squared
    decimation. Returns ``(array, nodata, windowed profile)`` or ``None``
    when the asset does not overlap ``bounds``.
    """
    from floodsr_tpu_torch.io.affine import Affine
    from floodsr_tpu_torch.io.geotiff import open_raster_window_reader

    reader, nodata, profile = open_raster_window_reader(href, transport=_TRANSPORT)
    if expect_crs is not None:
        # CRS must be checked BEFORE the bounds intersection: the window
        # math below compares asset-CRS pixel coordinates against depth-CRS
        # bounds, so a cross-CRS asset could "miss" the bounds numerically
        # and be silently skipped instead of rejected loudly.
        crs = profile.get("crs")
        assert crs is not None, f"asset CRS is required: {href}"
        if crs != expect_crs:
            raise AssertionError(
                f"asset CRS {crs} != depth CRS {expect_crs}: cross-CRS asset "
                f"reprojection is not supported by the offline warp: {href}"
            )
    if bounds is None:
        return reader.read_full(), nodata, profile
    t = profile["transform"]
    assert t.is_rectilinear(), (
        f"rotated asset grids are not supported for windowed reads: {href}"
    )
    west, south, east, north = bounds
    # Pixel window of the footprint with a 2-px bilinear margin.
    cols = sorted(((west - t.c) / t.a, (east - t.c) / t.a))
    rows = sorted(((north - t.f) / t.e, (south - t.f) / t.e))
    col0 = max(0, math.floor(cols[0]) - 2)
    row0 = max(0, math.floor(rows[0]) - 2)
    col1 = min(profile["width"], math.ceil(cols[1]) + 2)
    row1 = min(profile["height"], math.ceil(rows[1]) + 2)
    if col1 <= col0 or row1 <= row0:
        return None
    dec_y = dec_x = 1.0
    if target_res is not None and target_res > 0:
        native_res = min(abs(float(t.a)), abs(float(t.e)))
        max_dec = float(target_res) / native_res if native_res > 0 else 1.0
        if max_dec > 1.0:
            arr, (dec_y, dec_x), (pr0, pc0) = reader.read_window_decimated(
                row0, col0, row1 - row0, col1 - col0, max_decimation=max_dec
            )
            row0, col0 = pr0 * dec_y, pc0 * dec_x  # back to full-res coords
        else:
            arr = reader.read_window(row0, col0, row1 - row0, col1 - col0)
    else:
        arr = reader.read_window(row0, col0, row1 - row0, col1 - col0)
    x0, y0 = t * (float(col0), float(row0))
    win_profile = dict(profile)
    win_profile["height"], win_profile["width"] = arr.shape[0], arr.shape[1]
    win_profile["transform"] = Affine(
        t.a * dec_x, t.b, x0, t.d, t.e * dec_y, y0
    )
    if logger is not None:
        logger.debug(
            "asset window %sx%s of %sx%s (%d bytes in %d range request(s)): %s",
            arr.shape[0], arr.shape[1], profile["height"], profile["width"],
            reader.bytes_fetched, reader.requests, href,
        )
    return arr, nodata, win_profile


def write_dem_from_asset_hrefs(
    depth_lr_fp: str | Path,
    asset_hrefs: list[str],
    output_fp: str | Path,
    *,
    logger: logging.Logger | None = None,
    target_res: float | None = None,
) -> Path:
    """Warp + merge assets onto the depth footprint and write the DEM GeoTIFF.

    The output grid spans the depth bounds in the depth CRS at the first
    asset's SERVED resolution — its native grid, or, when ``target_res`` is
    coarser and the asset carries COG overviews, the coarsest overview still
    at least as fine as ``target_res`` (remote bytes then drop by roughly
    the squared decimation). Later assets only fill pixels still invalid
    (first-valid-wins merge, matching the reference). Cross-CRS assets are
    rejected — the HRDEM mosaic serves per-CRS assets, and the offline warp
    does not chain CRS transforms.
    """
    log = logger or logging.getLogger(__name__)
    assert asset_hrefs, "asset_hrefs must not be empty"
    fp = _footprint_of(depth_lr_fp)
    west, south, east, north = fp.bounds
    assert east > west and north > south, f"invalid depth bounds for fetch: {fp.bounds}"

    out_path = Path(output_fp).expanduser().resolve()
    out_path.parent.mkdir(parents=True, exist_ok=True)

    lead = _open_asset_window(
        asset_hrefs[0], fp.bounds, log, expect_crs=fp.crs, target_res=target_res
    )
    assert lead is not None, (
        f"lead asset does not overlap depth bounds {fp.bounds}: {asset_hrefs[0]}"
    )
    lead_arr, lead_nodata, lead_profile = lead
    lead_t = lead_profile["transform"]
    res_x, res_y = abs(float(lead_t.a)), abs(float(lead_t.e))
    assert res_x > 0 and res_y > 0

    width = max(1, math.ceil((east - west) / res_x))
    height = max(1, math.ceil((north - south) / res_y))
    grid_transform = bounds_to_transform(west, south, east, north, width, height)

    # nodata precedence: depth raster's > lead asset's > -9999
    candidates = (fp.nodata, lead_nodata, -9999.0)
    out_nodata = float(next(v for v in candidates if v is not None))

    mosaic = np.full((height, width), _FILL, dtype=np.float32)
    covered = np.zeros((height, width), dtype=bool)
    pending = [(lead_arr, lead_nodata, lead_profile)] + [None] * (len(asset_hrefs) - 1)
    for i, href in enumerate(asset_hrefs):
        opened = pending[i] or _open_asset_window(
            href, fp.bounds, log, expect_crs=fp.crs, target_res=target_res
        )
        if opened is None:
            log.debug("asset outside depth bounds, skipped: %s", href)
            continue
        arr, src_nodata, src_profile = opened
        warped = reproject_bilinear(
            arr,
            src_profile["transform"],
            (height, width),
            grid_transform,
            src_nodata=src_nodata,
            dst_nodata=float(_FILL),
        )
        fresh = ~np.isclose(warped, _FILL) & ~covered
        if fresh.any():
            mosaic[fresh] = warped[fresh]
            covered |= fresh

    if not covered.any():
        raise RuntimeError(
            f"no valid DEM pixels found across {len(asset_hrefs)} assets "
            f"for bounds={fp.bounds}"
        )

    write_raster(
        out_path,
        np.where(covered, mosaic, np.float32(out_nodata)).astype(np.float32, copy=False),
        {
            "driver": "GTiff",
            "height": height,
            "width": width,
            "count": 1,
            "dtype": "float32",
            "crs": fp.crs,
            "transform": grid_transform,
            "nodata": out_nodata,
            "compress": "LZW",
        },
    )
    log.info("HRDEM tile written:\n    %s", out_path)
    return out_path


# ---------------------------------------------------------------------------
# entrypoint
# ---------------------------------------------------------------------------


def _deliver(cached: Path, output_fp: str | Path | None) -> Path:
    """Hand a memoized tile to the caller, copying when a target was named."""
    if output_fp is None:
        return cached
    target = Path(output_fp).expanduser().resolve()
    target.parent.mkdir(parents=True, exist_ok=True)
    if target != cached:
        shutil.copy2(cached, target)
    return target


def fetch_hrdem_for_lowres_tile(
    *,
    depth_lr_fp: str | Path,
    output_fp: str | Path | None = None,
    logger: logging.Logger | None = None,
    stac_url: str = STAC_URL,
    collection: str = COLLECTION,
    asset_key: str = DEFAULT_ASSET,
    target_res: float | None = None,
) -> DemFetchResult:
    """Resolve one HRDEM tile aligned to a depth raster footprint.

    ``target_res``: coarsest acceptable DEM resolution (same units as the
    asset CRS). When coarser than the asset's native grid and the asset has
    COG overviews, reads are served from the matching overview level —
    GDAL's behavior in the reference fetcher
    (``floodsr/dem_sources/hrdem_stac.py:117-219``).
    """
    log = logger or logging.getLogger(__name__)
    fp = _footprint_of(depth_lr_fp)
    log.info(
        "DEM fetch: source=%s endpoint=%s collection=%s asset=%s\n    depth=%s",
        SOURCE_ID, stac_url, collection, asset_key, fp.path,
    )

    key = fp.cache_key(stac_url, collection, asset_key, target_res)
    memoized = _SESSION_FETCH_CACHE.get(key)
    if memoized is not None and memoized.exists():
        log.debug("HRDEM session memo hit (%s)", key)
        return DemFetchResult(
            dem_fp=_deliver(memoized, output_fp),
            source_id=SOURCE_ID,
            stac_url=stac_url,
            collection=collection,
            asset_key=asset_key,
            item_ids=[],
        )

    item_ids, hrefs = _query_hrdem_assets(
        bbox_4326=fp.bbox_4326,
        stac_url=stac_url,
        collection=collection,
        asset_key=asset_key,
    )
    log.info("%d HRDEM item(s) intersect the depth footprint", len(item_ids))

    target = (
        _scratch_tile_path(key)
        if output_fp is None
        else Path(output_fp).expanduser().resolve()
    )
    written = write_dem_from_asset_hrefs(
        depth_lr_fp=fp.path, asset_hrefs=hrefs, output_fp=target, logger=log,
        target_res=target_res,
    )
    _SESSION_FETCH_CACHE[key] = written
    return DemFetchResult(
        dem_fp=written,
        source_id=SOURCE_ID,
        stac_url=stac_url,
        collection=collection,
        asset_key=asset_key,
        item_ids=item_ids,
    )
