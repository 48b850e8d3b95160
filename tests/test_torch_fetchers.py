"""The port's DEM and building fetchers against the JAX package's, offline.

The same injected transport (no network: the fake answers the STAC search,
the asset bytes and the GeoJSON assets from memory) goes through
``floodsr_tpu.dem_sources.fetch_dem`` /
``floodsr_tpu.features.nrcan_buildings.fetch_buildings_for_raster`` and the
port's host-only copies: the files written are byte-identical and the request
lists are the same.
"""

import json

import numpy as np
import pytest

import floodsr_tpu.dem_sources as dem_sources_jax
import floodsr_tpu.dem_sources.hrdem_stac as stac_jax
import floodsr_tpu.features.nrcan_buildings as buildings_jax
import floodsr_tpu_torch.dem_sources as dem_sources_torch
import floodsr_tpu_torch.dem_sources.hrdem_stac as stac_torch
import floodsr_tpu_torch.features.nrcan_buildings as buildings_torch
from floodsr_tpu_torch.io import from_origin, read_raster, write_raster

pytestmark = pytest.mark.unit

CRS = "EPSG:3979"
PACKAGES = {
    "jax": (dem_sources_jax, stac_jax, buildings_jax),
    "torch": (dem_sources_torch, stac_torch, buildings_torch),
}


def _profile(shape, transform, nodata=-9999.0):
    return {
        "height": shape[0], "width": shape[1], "count": 1, "dtype": "float32",
        "crs": CRS, "nodata": nodata, "transform": transform, "compress": "LZW",
    }


@pytest.fixture()
def lowres_fp(tmp_path):
    """An 8x8 LR depth raster at 30 m: a 240 m footprint."""
    lr = np.full((8, 8), 1.0, np.float32)
    fp = tmp_path / "lowres.tif"
    write_raster(fp, lr, _profile(lr.shape, from_origin(1510000.0, -170000.0, 30.0, 30.0)))
    return fp


def _with_transport(stac, transport, fn):
    stac.set_transport(transport)
    stac._SESSION_FETCH_CACHE.clear()
    try:
        return fn()
    finally:
        stac.set_transport(None)
        stac._SESSION_FETCH_CACHE.clear()


def test_fetch_dem_local_asset_same_bytes_and_requests(lowres_fp, tmp_path):
    rng = np.random.default_rng(11)
    dem = (300.0 + rng.normal(0.0, 5.0, (300, 300))).astype(np.float32)
    asset_fp = tmp_path / "asset_dtm.tif"
    write_raster(
        asset_fp, dem,
        _profile(dem.shape, from_origin(1509970.0, -169970.0, 1.0, 1.0), nodata=-32767.0),
    )
    results, requests = {}, {}
    for name, (sources, stac, _) in PACKAGES.items():
        seen = requests.setdefault(name, [])

        def transport(url, data, headers, seen=seen):
            seen.append((url, json.loads(data)))
            return json.dumps({"features": [
                {"id": "tile-1", "assets": {"dtm": {"href": str(asset_fp)}}},
                {"id": "tile-2", "assets": {"other": {"href": "x"}}},
            ]}).encode()

        results[name] = _with_transport(stac, transport, lambda: sources.fetch_dem(
            source_id="hrdem", depth_lr_fp=lowres_fp, output_fp=tmp_path / f"{name}_dem.tif"
        ))
    assert requests["torch"] == requests["jax"] and len(requests["torch"]) == 1
    assert results["torch"].item_ids == results["jax"].item_ids == ["tile-1"]
    assert results["torch"].source_id == results["jax"].source_id == "hrdem"
    assert results["torch"].dem_fp.read_bytes() == results["jax"].dem_fp.read_bytes()
    got, _, _ = read_raster(results["torch"].dem_fp)
    assert got.shape == (240, 240)


def test_remote_cog_window_same_bytes_and_ranges(lowres_fp, tmp_path):
    """A tiled remote asset read by HTTP ranges (``io/tiff_window.py``)."""
    rng = np.random.default_rng(7)
    dem = rng.normal(300.0, 30.0, (1024, 1024)).astype(np.float32)
    asset_fp = tmp_path / "asset_dtm_big.tif"
    write_raster(
        asset_fp, dem,
        _profile(dem.shape, from_origin(1509800.0, -169800.0, 1.0, 1.0), nodata=-32767.0),
        tile=(256, 256),
    )
    blob = asset_fp.read_bytes()
    written, ranges = {}, {}
    for name, (_, stac, _) in PACKAGES.items():
        seen = ranges.setdefault(name, [])

        def transport(url, data, headers, seen=seen):
            header = headers["Range"]
            seen.append((url, header))
            a, b = header[len("bytes="):].split("-")
            return blob[int(a): int(b) + 1]

        written[name] = _with_transport(stac, transport, lambda: stac.write_dem_from_asset_hrefs(
            lowres_fp, ["https://remote.example/asset_dtm_big.tif"], tmp_path / f"{name}_win.tif"
        ))
    assert ranges["torch"] == ranges["jax"] and ranges["torch"]
    assert written["torch"].read_bytes() == written["jax"].read_bytes()
    spans = [header[len("bytes="):].split("-") for _, header in ranges["torch"]]
    assert sum(int(b) - int(a) + 1 for a, b in spans) < len(blob)


def test_fetch_buildings_same_bytes_and_requests(lowres_fp, tmp_path):
    def square(x1, y1, x2, y2):
        return [[x1, y1], [x2, y1], [x2, y2], [x1, y2], [x1, y1]]

    catalog = {"type": "FeatureCollection", "features": [
        {"id": "tile-1", "assets": {"footprints": {"href": "https://x/a.geojson"}}},
        {"id": "tile-2", "assets": {"footprints": {"href": "https://x/b.geojson"}}},
    ]}
    assets = {
        "a.geojson": {"type": "FeatureCollection", "features": [
            {"type": "Feature", "geometry": {"type": "Polygon",
                                             "coordinates": [square(0, 0, 1, 1)]}},
        ]},
        "b.geojson": {"type": "Feature", "geometry": {
            "type": "Polygon", "coordinates": [square(2, 2, 3, 3)]}},
    }
    results, requests = {}, {}
    for name, (_, stac, buildings) in PACKAGES.items():
        seen = requests.setdefault(name, [])

        def transport(url, data, headers, seen=seen):
            seen.append((url, json.loads(data) if data else None))
            if url.endswith("/search"):
                return json.dumps(catalog).encode()
            return json.dumps(assets[url.rsplit("/", 1)[1]]).encode()

        def fetch(buildings=buildings, name=name):
            buildings._SESSION_FETCH_CACHE.clear()
            try:
                return buildings.fetch_buildings_for_raster(
                    raster_fp=lowres_fp, output_fp=tmp_path / f"{name}_b.geojson"
                )
            finally:
                buildings._SESSION_FETCH_CACHE.clear()

        results[name] = _with_transport(stac, transport, fetch)
    assert requests["torch"] == requests["jax"] and len(requests["torch"]) == 3
    assert results["torch"].item_ids == results["jax"].item_ids == ["tile-1", "tile-2"]
    assert results["torch"].feature_count == results["jax"].feature_count == 2
    assert (
        results["torch"].buildings_fp.read_bytes() == results["jax"].buildings_fp.read_bytes()
    )


def test_session_cache_and_empty_result_behave_alike(lowres_fp, tmp_path):
    asset = np.full((300, 300), 250.0, np.float32)
    asset[::7] += 3.0
    asset_fp = tmp_path / "asset.tif"
    write_raster(
        asset_fp, asset,
        _profile(asset.shape, from_origin(1509970.0, -169970.0, 1.0, 1.0), nodata=-32767.0),
    )
    for name, (sources, stac, _) in PACKAGES.items():
        calls = []

        def transport(url, data, headers, calls=calls):
            calls.append(url)
            return json.dumps({"features": [
                {"id": "t", "assets": {"dtm": {"href": str(asset_fp)}}},
            ]}).encode()

        def twice(sources=sources, name=name):
            first = sources.fetch_dem(source_id="hrdem", depth_lr_fp=lowres_fp)
            second = sources.fetch_dem(
                source_id="hrdem", depth_lr_fp=lowres_fp, output_fp=tmp_path / f"{name}_2.tif"
            )
            return first, second

        first, second = _with_transport(stac, transport, twice)
        assert len(calls) == 1, name  # the second fetch came from the session cache
        assert first.dem_fp.read_bytes() == second.dem_fp.read_bytes()
        with pytest.raises(Exception, match="0 items"):
            _with_transport(
                stac, lambda u, d, h: b'{"features": []}',
                lambda sources=sources: sources.fetch_dem(source_id="hrdem", depth_lr_fp=lowres_fp),
            )
        with pytest.raises(Exception, match="nope"):
            sources.fetch_dem(source_id="nope", depth_lr_fp=lowres_fp)
