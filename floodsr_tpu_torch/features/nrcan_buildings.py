"""NRCan automatically-extracted building footprints via STAC (bbox fetch).

The reference chose this dataset for its planned building-blocking feature
("NRCan - Automatically Extracted Buildings ... **lets use this one**" —
reference ``docs/dev/adr/0016-buildings.md``) and sketched the integration as
"similar to dem fetching" (reference ``PLAN.md``). This module mirrors the
HRDEM fetcher's architecture (``floodsr_tpu_torch/dem_sources/hrdem_stac.py``):
one STAC item-search POST for the raster footprint's EPSG:4326 bbox, asset
downloads through the same swappable transport hook (so the suite runs
offline against a mock), and a session cache keyed by the query.

Assets are expected to be GeoJSON feature collections; every intersecting
item's features are merged into one FeatureCollection written next to the
scene (or into a scratch path). The collection id below is the dataset's
published datacube name; override via ``collection=`` (the live service is
unreachable from this development environment, so the id is best-effort and
exercised only through the injectable transport).
"""

from __future__ import annotations

import hashlib
import json
import logging
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path

from floodsr_tpu_torch.dem_sources import hrdem_stac as _stac
from floodsr_tpu_torch.io.geotiff import raster_bounds, read_raster_header
from floodsr_tpu_torch.dem_sources.geodesy import transform_bounds

SOURCE_ID = "nrcan-buildings"
STAC_URL = _stac.STAC_URL
COLLECTION = "automatically-extracted-buildings"
DEFAULT_ASSET = "footprints"

_SESSION_FETCH_CACHE: dict[str, Path] = {}


@dataclass(frozen=True)
class BuildingsFetchResult:
    buildings_fp: Path
    source_id: str
    stac_url: str
    collection: str
    asset_key: str
    item_ids: list[str]
    feature_count: int


def _bbox_4326_of(raster_fp: str | Path) -> tuple[tuple[float, ...], str]:
    path = Path(raster_fp).expanduser().resolve()
    assert path.exists(), f"raster does not exist: {path}"
    profile = read_raster_header(path)
    crs = profile["crs"]
    assert crs is not None, f"raster CRS is required for the STAC query: {path}"
    bounds = tuple(float(v) for v in raster_bounds(profile))
    bbox = tuple(
        float(v) for v in transform_bounds(crs, "EPSG:4326", *bounds, densify_pts=21)
    )
    assert bbox[0] < bbox[2] and bbox[1] < bbox[3], (
        f"footprint degenerate after EPSG:4326 transform: {bbox}"
    )
    return bbox, str(crs)


def _scratch_path(cache_key: str) -> Path:
    root = Path(tempfile.gettempdir()) / "floodsr" / "buildings-fetch"
    root.mkdir(parents=True, exist_ok=True)
    return (root / f"{cache_key}.geojson").resolve()


def _query_building_assets(
    *,
    bbox_4326,
    stac_url: str,
    collection: str,
    asset_key: str,
) -> tuple[list[str], list[str]]:
    """One STAC item-search POST; returns (item ids, asset hrefs)."""
    body = json.dumps(
        {"collections": [collection], "bbox": list(bbox_4326), "limit": 200}
    ).encode("utf-8")
    raw = _stac._TRANSPORT(
        stac_url.rstrip("/") + "/search",
        body,
        {"Content-Type": "application/json", "Accept": "application/geo+json"},
    )
    features = json.loads(raw.decode("utf-8")).get("features", [])
    if not features:
        raise RuntimeError(
            f"buildings STAC query returned 0 items for bbox={bbox_4326} "
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
            f"buildings STAC returned items but no '{asset_key}' assets "
            f"for bbox={bbox_4326}"
        )
    return ids, hrefs


def _merge_geojson_assets(hrefs: list[str]) -> tuple[dict, int]:
    """Download per-asset GeoJSON and merge features into one collection."""
    merged: list[dict] = []
    for href in hrefs:
        raw = _stac._TRANSPORT(href, None, {"Accept": "application/geo+json"})
        doc = json.loads(raw.decode("utf-8"))
        t = doc.get("type")
        if t == "FeatureCollection":
            merged.extend(doc.get("features", []))
        elif t == "Feature":
            merged.append(doc)
        else:
            raise RuntimeError(f"asset {href} is not GeoJSON features: type={t!r}")
    return {"type": "FeatureCollection", "features": merged}, len(merged)


def fetch_buildings_for_raster(
    *,
    raster_fp: str | Path,
    output_fp: str | Path | None = None,
    logger: logging.Logger | None = None,
    stac_url: str = STAC_URL,
    collection: str = COLLECTION,
    asset_key: str = DEFAULT_ASSET,
) -> BuildingsFetchResult:
    """Fetch building footprints covering a raster's footprint as GeoJSON."""
    log = logger or logging.getLogger(__name__)
    bbox, crs = _bbox_4326_of(raster_fp)
    log.info(
        "buildings fetch: source=%s endpoint=%s collection=%s asset=%s bbox=%s",
        SOURCE_ID, stac_url, collection, asset_key, bbox,
    )

    key = hashlib.sha256(
        "|".join(
            [crs, repr(bbox), stac_url, collection, asset_key]
        ).encode("utf-8")
    ).hexdigest()[:24]
    memoized = _SESSION_FETCH_CACHE.get(key)
    if memoized is not None and memoized.exists():
        log.debug("buildings session memo hit (%s)", key)
        return BuildingsFetchResult(
            buildings_fp=_deliver(memoized, output_fp),
            source_id=SOURCE_ID,
            stac_url=stac_url,
            collection=collection,
            asset_key=asset_key,
            item_ids=[],
            feature_count=-1,
        )

    item_ids, hrefs = _query_building_assets(
        bbox_4326=bbox, stac_url=stac_url, collection=collection, asset_key=asset_key
    )
    log.info("%d building item(s) intersect the raster footprint", len(item_ids))
    doc, n = _merge_geojson_assets(hrefs)

    target = (
        _scratch_path(key)
        if output_fp is None
        else Path(output_fp).expanduser().resolve()
    )
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(json.dumps(doc))
    _SESSION_FETCH_CACHE[key] = target
    return BuildingsFetchResult(
        buildings_fp=target,
        source_id=SOURCE_ID,
        stac_url=stac_url,
        collection=collection,
        asset_key=asset_key,
        item_ids=item_ids,
        feature_count=n,
    )


def _deliver(cached: Path, output_fp: str | Path | None) -> Path:
    if output_fp is None:
        return cached
    target = Path(output_fp).expanduser().resolve()
    target.parent.mkdir(parents=True, exist_ok=True)
    if target != cached:
        shutil.copy2(cached, target)
    return target
