"""GeoJSON footprint loading and polygon rasterization (dependency-free).

The reference planned to consume NRCan's automatically-extracted building
footprints "similar to dem fetching" (reference ``docs/dev/adr/0016-buildings.md``)
but never built it; GDAL would have done the vector I/O + rasterization
there. Here the GeoJSON subset needed for footprints (FeatureCollection /
Feature / Polygon / MultiPolygon) is parsed with the stdlib, coordinates are
reprojected with the in-tree geodesy, and rasterization is a scanline fill
evaluated at pixel centers — even-odd within each polygon's rings, unioned
across polygons (GDAL's default ``all_touched=False`` convention).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

# One polygon = [exterior_ring, hole_ring, ...]; ring = float64 [N, 2] (x, y).
Polygon = list


def _rings_of_polygon(coords) -> Polygon:
    rings = []
    for ring in coords:
        arr = np.asarray(ring, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[1] < 2:
            raise ValueError(f"malformed polygon ring of shape {arr.shape}")
        if not np.isfinite(arr[:, :2]).all():
            # A non-finite vertex would desync the rasterizer's open/close
            # crossing pairing for every polygon sorted after this one —
            # reject it at parse time where the damage can be named.
            raise ValueError("polygon ring contains non-finite coordinates")
        rings.append(arr[:, :2])
    if not rings:
        raise ValueError("polygon with no rings")
    return rings


def _geometries(obj) -> list:
    """Flatten a GeoJSON object into geometry dicts (ignores null geometry)."""
    t = obj.get("type")
    if t == "FeatureCollection":
        out = []
        for feature in obj.get("features", []):
            out.extend(_geometries(feature))
        return out
    if t == "Feature":
        geom = obj.get("geometry")
        return _geometries(geom) if geom else []
    if t == "GeometryCollection":
        out = []
        for geom in obj.get("geometries", []):
            out.extend(_geometries(geom))
        return out
    if t in ("Polygon", "MultiPolygon"):
        return [obj]
    if t in ("Point", "MultiPoint", "LineString", "MultiLineString"):
        return []  # not area features; nothing to block
    raise ValueError(f"unsupported GeoJSON object type: {t!r}")


def _crs_of_geojson(obj) -> str | None:
    """Legacy GeoJSON ``crs`` member → 'EPSG:nnnn' string, if present."""
    crs = obj.get("crs")
    if not isinstance(crs, dict):
        return None
    name = str(crs.get("properties", {}).get("name", ""))
    # Accept both 'EPSG:2961' and 'urn:ogc:def:crs:EPSG::2961' spellings.
    if "EPSG" in name.upper():
        code = name.split(":")[-1]
        if code.isdigit():
            return f"EPSG:{code}"
    if "CRS84" in name.upper():
        return "EPSG:4326"
    return None


def load_footprints(
    src: str | Path | dict,
    dst_crs: str | None = None,
    src_crs: str | None = None,
) -> list[Polygon]:
    """Load polygons from GeoJSON (path, JSON text, or parsed dict).

    Coordinates are reprojected from ``src_crs`` to ``dst_crs`` via the
    in-tree geodesy when both are given and differ. ``src_crs`` defaults to
    the document's legacy ``crs`` member, else EPSG:4326 (the GeoJSON
    specification's mandate).
    """
    if isinstance(src, dict):
        obj = src
    elif isinstance(src, str) and src.lstrip()[:1] in ("{", "["):
        obj = json.loads(src)  # inline JSON text
    else:
        # A path: raise FileNotFoundError naming it (a mistyped --buildings
        # path must not surface as a cryptic JSONDecodeError).
        obj = json.loads(Path(src).read_text())
    if not isinstance(obj, dict):
        raise ValueError(
            "GeoJSON document must be a JSON object "
            f"(got top-level {type(obj).__name__})"
        )

    doc_crs = _crs_of_geojson(obj)
    effective_src = src_crs or doc_crs or "EPSG:4326"
    polygons: list[Polygon] = []
    for geom in _geometries(obj):
        if geom["type"] == "Polygon":
            polygons.append(_rings_of_polygon(geom["coordinates"]))
        else:  # MultiPolygon
            for poly in geom["coordinates"]:
                polygons.append(_rings_of_polygon(poly))

    if dst_crs is not None and _crs_key(effective_src) != _crs_key(dst_crs):
        if src_crs is None and doc_crs is None and polygons:
            # EPSG:4326 was *assumed* (GeoJSON's mandate), so sanity-check
            # that the coordinates are plausible lon/lat before transforming:
            # a document exported in a projected CRS without a crs member
            # (common for tooling that strips the legacy member) would
            # otherwise reproject garbage silently.
            all_xy = np.concatenate([r for rings in polygons for r in rings])
            if (np.abs(all_xy[:, 0]) > 180.0).any() or (
                np.abs(all_xy[:, 1]) > 90.0
            ).any():
                raise ValueError(
                    "footprint coordinates fall outside lon/lat bounds but no "
                    "source CRS is declared; pass src_crs (or add a legacy "
                    "'crs' member) for projected-CRS GeoJSON"
                )
        from floodsr_tpu_torch.dem_sources.geodesy import transform_points

        # One transform_points call over every vertex: projection objects are
        # resolved once instead of once per ring (NRCan scenes carry tens of
        # thousands of rings), then the flat result is split back into rings.
        all_rings = [ring for rings in polygons for ring in rings]
        flat = np.concatenate(all_rings) if all_rings else np.zeros((0, 2))
        pts = transform_points(
            effective_src, dst_crs, [(float(x), float(y)) for x, y in flat]
        )
        flat_out = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        bounds = np.cumsum([len(r) for r in all_rings])
        pieces = np.split(flat_out, bounds[:-1]) if all_rings else []
        it = iter(pieces)
        polygons = [[next(it) for _ in rings] for rings in polygons]
    return polygons


def _crs_key(crs) -> str:
    return str(crs).strip().upper()


def rasterize_polygons(
    polygons: list[Polygon], transform, out_shape: tuple[int, int]
) -> np.ndarray:
    """Scanline fill of polygons, evaluated at pixel centers.

    ``transform`` is the raster's affine georeference (north-up rectilinear
    required). Returns a boolean ``[H, W]`` mask. Matches GDAL's
    ``all_touched=False`` center-containment convention: each polygon is
    filled even-odd over its own rings (holes excluded) and independent
    polygons are **unioned** — overlapping or duplicated footprints stay
    blocked, exactly as GDAL burns each geometry independently. A pixel
    whose center lies exactly on a horizontal edge follows the half-open
    rule (bottom vertex included, top excluded), so shared edges never
    double-count.
    """
    h, w = int(out_shape[0]), int(out_shape[1])
    a, e = float(transform.a), float(transform.e)
    if transform.b or transform.d:
        raise ValueError("rasterize_polygons requires a rectilinear transform")
    if a <= 0 or e >= 0:
        raise ValueError("rasterize_polygons requires north-up pixels (a>0, e<0)")
    x0 = float(transform.c)
    y0 = float(transform.f)

    # Pixel-center world coordinates per row (descending: north-up).
    y_centers = y0 + (np.arange(h, dtype=np.float64) + 0.5) * e

    # Gather every non-horizontal edge across all rings into flat arrays so
    # the scanline work is one vectorized pass (NRCan scenes carry tens of
    # thousands of footprints; per-ring numpy calls alone cost ~10 s at 20k
    # rings, this is milliseconds). All rings are concatenated once; each
    # vertex's successor is the next vertex, wrapped to the ring start at
    # ring ends (the closure edge — degenerate when the ring repeats its
    # first point, and dropped below like any horizontal edge).
    ring_list = [
        ring for rings in polygons for ring in rings if len(ring) >= 3
    ]
    poly_ids = np.repeat(
        np.arange(len(polygons), dtype=np.int64),
        [sum(len(r) >= 3 for r in rings) for rings in polygons],
    )
    if not ring_list:
        return np.zeros((h, w), dtype=bool)
    lens = np.array([len(r) for r in ring_list], dtype=np.int64)
    pts = np.concatenate(ring_list)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    nxt = np.arange(pts.shape[0], dtype=np.int64) + 1
    nxt[starts + lens - 1] = starts  # wrap each ring's last vertex
    xs, ys = pts[:, 0], pts[:, 1]
    xn, yn = xs[nxt], ys[nxt]
    keep = ys != yn  # horizontal (and degenerate closure) edges: no crossing
    x1, yy1, x2, yy2 = xs[keep], ys[keep], xn[keep], yn[keep]
    poly_of_edge = np.repeat(poly_ids, lens)[keep]
    if x1.size == 0:
        return np.zeros((h, w), dtype=bool)
    ylo = np.minimum(yy1, yy2)
    yhi = np.maximum(yy1, yy2)

    # Rows with ylo <= y_center < yhi (half-open: a vertex row counts for
    # exactly one of the two edges that meet there). y_centers is strictly
    # descending, so each edge's rows are one contiguous [start, end) range;
    # searchsorted compares against the same float values a direct
    # comparison would.
    neg_centers = -y_centers  # ascending
    start = np.searchsorted(neg_centers, -yhi, side="right")
    end = np.searchsorted(neg_centers, -ylo, side="right")
    counts = np.maximum(end - start, 0)
    total = int(counts.sum())
    if total == 0:
        return np.zeros((h, w), dtype=bool)

    edge_of = np.repeat(np.arange(x1.size, dtype=np.int64), counts)
    offsets = np.concatenate(([0], np.cumsum(counts)[:-1]))
    rows = np.arange(total, dtype=np.int64) - np.repeat(offsets, counts)
    rows += np.repeat(start, counts)

    t = (y_centers[rows] - yy1[edge_of]) / (yy2[edge_of] - yy1[edge_of])
    x_cross = x1[edge_of] + t * (x2[edge_of] - x1[edge_of])
    # First pixel center at or right of the crossing; column w is the
    # overflow bin for crossings right of the raster (dropped below).
    cols = np.clip(
        np.ceil((x_cross - x0) / a - 0.5).astype(np.int64), 0, w
    )

    # Per-polygon even-odd fill, unioned across polygons: sort crossings by
    # (row, polygon, col); within each (row, polygon) group parity flips at
    # each crossing, so consecutive pairs bound that polygon's inside runs
    # (holes excluded). Every group's crossing count is even (closed rings +
    # the half-open vertex rule), so the sorted stream's global alternation
    # aligns with group boundaries. Opens get +1 / closes -1 into a delta
    # image; the row cumsum is then the number of polygons covering each
    # pixel, and the union mask is cover > 0.
    poly_c = poly_of_edge[edge_of]
    order = np.lexsort((cols, poly_c, rows))
    flat = rows[order] * np.int64(w + 1) + cols[order]
    # Aggregate crossing counts per cell first (np.unique — O(n log n) in
    # the number of crossings), then scatter with one buffered fancy
    # assignment per side: severalfold faster than unbuffered np.add.at on
    # the millions-of-crossings NRCan hot path, while the dense image stays
    # int16 (8x less first-touch memory than a bincount int64 image —
    # docs/perf/hostmem_study.json).
    open_idx, open_n = np.unique(flat[0::2], return_counts=True)
    close_idx, close_n = np.unique(flat[1::2], return_counts=True)
    if open_n.max(initial=0) > 32767 or close_n.max(initial=0) > 32767:
        raise ValueError(">32767 coincident polygon crossings in one cell")
    delta = np.zeros(h * (w + 1), dtype=np.int16)
    delta[open_idx] = open_n.astype(np.int16)
    delta[close_idx] -= close_n.astype(np.int16)
    cover = np.cumsum(delta.reshape(h, w + 1)[:, :w], axis=1, dtype=np.int16)
    if int(cover.min()) < 0:
        # Two reachable causes: malformed geometry desyncing the open/close
        # pairing (parse-time validation rejects non-finite vertices, but a
        # caller bypassing load_footprints could still feed one), or int16
        # cumulative-coverage wraparound when >32767 well-formed polygons
        # stack on one pixel. A real exception, not an assert, because a
        # misaligned pairing corrupts every later polygon's fill.
        raise ValueError(
            "scanline coverage went negative: open/close crossing pairing "
            "is misaligned (malformed polygon geometry, or >32767 polygons "
            "overlapping one pixel)"
        )
    return cover.astype(bool)


def building_mask_for_grid(
    src: str | Path | dict,
    transform,
    out_shape: tuple[int, int],
    crs: str | None = None,
    src_crs: str | None = None,
    logger_=None,
) -> np.ndarray:
    """Convenience: load footprints and rasterize them onto a target grid."""
    log = logger_ or logger
    polygons = load_footprints(src, dst_crs=crs, src_crs=src_crs)
    mask = rasterize_polygons(polygons, transform, out_shape)
    log.info(
        f"building footprints: {len(polygons)} polygons -> "
        f"{int(mask.sum())}/{mask.size} blocked cells"
    )
    return mask
