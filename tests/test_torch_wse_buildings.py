"""WSE input and building blocking in the port vs the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function and its counterpart:
``wse_to_depth_lr``, the ResUNet worker's ``input_kind="wse"`` and
``buildings_fp`` through ``tohr`` on a tiny artifact, the footprint loader and
rasterizer, and the projection math they use.
"""

import inspect
import json

import numpy as np
import pytest
import torch

from floodsr_tpu.dem_sources import geodesy as geodesy_jax
from floodsr_tpu.features import footprints as fp_jax
from floodsr_tpu.io import from_origin, read_raster, write_raster
from floodsr_tpu.preprocessing import wse_to_depth_lr as wse_to_depth_lr_jax
from floodsr_tpu.tohr import tohr as tohr_jax
from floodsr_tpu_torch import features as features_torch
from floodsr_tpu_torch.dem_sources import geodesy as geodesy_torch
from floodsr_tpu_torch.features import footprints as fp_torch
from floodsr_tpu_torch.preprocessing import wse_to_depth_lr as wse_to_depth_lr_torch
from floodsr_tpu_torch.tohr import tohr as tohr_torch

pytestmark = pytest.mark.unit

NODATA = -9999.0
CRS = "EPSG:32633"


def _profile(arr, transform):
    return {
        "height": int(arr.shape[0]), "width": int(arr.shape[1]), "count": 1,
        "dtype": "float32", "crs": CRS, "transform": transform,
        "nodata": NODATA, "compress": "LZW",
    }


# ---------------------------------------------------------------------------
# (e) WSE -> depth conversion and the ResUNet worker
# ---------------------------------------------------------------------------


def _wse_case(seed, with_hole):
    rng = np.random.default_rng(seed)
    lr_shape, hr_shape = (8, 10), (32, 40)
    lr_t = from_origin(0, 320, 40.0, 40.0)
    dem_t = from_origin(0, 320, 10.0, 10.0)
    dem = (100.0 + np.cumsum(rng.normal(0, 0.3, hr_shape), axis=1)).astype(np.float32)
    dem_valid = None
    if with_hole:
        dem_valid = np.ones(hr_shape, np.float32)
        dem_valid[0:4, 0:4] = 0.0      # a whole LR cell without terrain
        dem_valid[10:13, 17:22] = 0.0  # a hole inside some LR cells
        dem = dem * dem_valid          # the aligner's nodata -> 0 form
    wse = (100.0 + rng.uniform(-1.0, 2.0, lr_shape)).astype(np.float32)
    wse[rng.random(lr_shape) > 0.8] = NODATA
    wse[0, 0] = 105.0
    return wse, lr_t, dem, dem_valid, dem_t


@pytest.mark.parametrize("with_hole", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_wse_to_depth_lr_equals_jax(with_hole, as_tensor):
    wse, lr_t, dem, dem_valid, dem_t = _wse_case(21, with_hole)
    want = wse_to_depth_lr_jax(wse, NODATA, lr_t, dem, dem_valid, dem_t)
    if as_tensor:  # the worker's path: the DEM already lies on the device
        dem_in = torch.from_numpy(dem)
        valid_in = None if dem_valid is None else torch.from_numpy(dem_valid)
    else:
        dem_in, valid_in = dem, dem_valid
    got = wse_to_depth_lr_torch(wse, NODATA, lr_t, dem_in, valid_in, dem_t, device="cpu")
    assert got.shape == wse.shape and got.dtype == np.float32
    assert (got > 0).any() and (got == 0).any()
    if as_tensor:
        # The separable f32 matmul warp vs the host's float64 4-tap warp:
        # rounding of elevation-scale sums, ~1e-5 m at 100 m.
        np.testing.assert_allclose(got, want, atol=5e-5)
    else:
        np.testing.assert_array_equal(got, want)  # the same numpy code
    if with_hole:
        assert got[0, 0] == 0.0  # no terrain under the cell: dry


@pytest.fixture(scope="module")
def flat_scene(tmp_path_factory):
    """The JAX WSE test's scene: a per-LR-cell-constant DEM, so depth and WSE
    inputs interconvert exactly."""
    root = tmp_path_factory.mktemp("torch_wse_scene")
    lr_shape, scale = (16, 16), 4
    lr_res, hr_res = 30.0, 7.5
    x0, y0 = 500000.0, 4000000.0
    rng = np.random.default_rng(11)
    depth = (rng.uniform(0.0, 2.0, lr_shape) * (rng.random(lr_shape) > 0.3)).astype(np.float32)
    dem_lr = (100.0 + rng.uniform(0.0, 5.0, lr_shape)).astype(np.float32)
    dem = np.kron(dem_lr, np.ones((scale, scale), np.float32))
    wse = dem_lr + depth
    lr_t = from_origin(x0, y0 + lr_shape[0] * lr_res, lr_res, lr_res)
    hr_t = from_origin(x0, y0 + dem.shape[0] * hr_res, hr_res, hr_res)
    paths = {k: root / f"{k}.tif" for k in ("depth", "wse", "dem")}
    write_raster(paths["depth"], depth, _profile(depth, lr_t))
    write_raster(paths["wse"], wse, _profile(wse, lr_t))
    write_raster(paths["dem"], dem, _profile(dem, hr_t))
    # A footprint over a block of the 64x64 HR grid.
    ytop = y0 + dem.shape[0] * hr_res
    paths["buildings"] = root / "buildings.geojson"
    paths["buildings"].write_text(json.dumps({
        "type": "Polygon",
        "crs": {"type": "name", "properties": {"name": CRS}},
        "coordinates": [[
            [x0 + 10 * hr_res, ytop - 30 * hr_res], [x0 + 25 * hr_res, ytop - 30 * hr_res],
            [x0 + 25 * hr_res, ytop - 12 * hr_res], [x0 + 10 * hr_res, ytop - 12 * hr_res],
            [x0 + 10 * hr_res, ytop - 30 * hr_res],
        ]],
    }))
    return paths


def _resunet_both(tiny_model_fp, scene, tmp_path, lr, **kw):
    outs, diags = {}, {}
    for name, fn, extra in (("jax", tohr_jax, {}), ("torch", tohr_torch, {"device": "cpu"})):
        out_fp = tmp_path / f"{name}_{lr}.tif"
        diags[name] = fn(
            model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
            depth_lr_fp=scene[lr], dem_hr_fp=scene["dem"], output_fp=out_fp,
            **kw, **extra,
        )
        outs[name], _, _ = read_raster(out_fp)
    return outs, diags


def test_resunet_tohr_wse_input_matches_jax_and_depth_input(tiny_model_fp, flat_scene, tmp_path):
    wse, diags = _resunet_both(tiny_model_fp, flat_scene, tmp_path, "wse", input_kind="wse")
    depth, _ = _resunet_both(tiny_model_fp, flat_scene, tmp_path, "depth")
    assert diags["torch"]["preprocess"]["input_kind"] == "wse"
    assert wse["torch"].max() > 0.0
    # f32 convolutions in another summation order, as for depth input.
    np.testing.assert_allclose(wse["torch"], wse["jax"], atol=1e-4)
    # The JAX WSE test's own tolerance: (100 + d) - 100 rounds d in f32.
    np.testing.assert_allclose(wse["torch"], depth["torch"], atol=1e-3)


def test_resunet_tohr_buildings_match_jax(tiny_model_fp, flat_scene, tmp_path):
    plain, _ = _resunet_both(tiny_model_fp, flat_scene, tmp_path, "depth")
    blocked, diags = _resunet_both(
        tiny_model_fp, flat_scene, tmp_path, "depth", buildings_fp=flat_scene["buildings"]
    )
    _, _, prof = read_raster(tmp_path / "torch_depth.tif")
    mask = features_torch.building_mask_for_grid(
        flat_scene["buildings"], prof["transform"], blocked["torch"].shape, crs=CRS
    )
    assert mask.sum() == 15 * 18
    assert (blocked["torch"][mask] == 0.0).all()
    np.testing.assert_array_equal(blocked["torch"][~mask], plain["torch"][~mask])
    np.testing.assert_allclose(blocked["torch"], blocked["jax"], atol=1e-4)
    got = diags["torch"]["preprocess"]["building_blocked_wet_cells"]
    assert got == int((plain["torch"][mask] > 0).sum()) and got > 0
    # The two packages' depths differ by ~1e-6, so a cell at the low-depth
    # mask's edge may be wet in one only.
    assert abs(got - diags["jax"]["preprocess"]["building_blocked_wet_cells"]) <= 2


def test_resunet_tohr_bad_buildings_file_leaves_the_output_alone(tiny_model_fp, flat_scene, tmp_path):
    out_fp = tmp_path / "keep.tif"
    out_fp.write_bytes(b"previous result")
    with pytest.raises(FileNotFoundError):
        tohr_torch(
            model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
            depth_lr_fp=flat_scene["depth"], dem_hr_fp=flat_scene["dem"],
            output_fp=out_fp, buildings_fp=tmp_path / "missing.geojson", device="cpu",
        )
    assert out_fp.read_bytes() == b"previous result"
    with pytest.raises(AssertionError, match="input_kind"):
        tohr_torch(
            model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
            depth_lr_fp=flat_scene["depth"], dem_hr_fp=flat_scene["dem"],
            output_fp=tmp_path / "p.tif", input_kind="velocity", device="cpu",
        )


# ---------------------------------------------------------------------------
# (f) footprints and the projection math
# ---------------------------------------------------------------------------


def _seeded_polygons(seed, n, x0, y0, span):
    """Convex-ish polygons (one with a hole) scattered over a square."""
    rng = np.random.default_rng(seed)
    feats = []
    for k in range(n):
        cx, cy = np.array([x0, y0]) + rng.uniform(0.1, 0.9, 2) * span
        r = rng.uniform(0.03, 0.12) * span
        ang = np.sort(rng.uniform(0, 2 * np.pi, rng.integers(4, 9)))
        ring = [[cx + r * np.cos(a), cy + r * np.sin(a)] for a in ang]
        rings = [ring + [ring[0]]]
        if k == 0:
            hole = [[cx + 0.3 * r * np.cos(a), cy + 0.3 * r * np.sin(a)] for a in ang]
            rings.append(hole + [hole[0]])
        feats.append({"type": "Feature", "properties": {}, "geometry": {
            "type": "Polygon", "coordinates": rings}})
    multi = {"type": "Feature", "geometry": {"type": "MultiPolygon", "coordinates": [
        f["geometry"]["coordinates"] for f in feats[:2]]}}
    return {"type": "FeatureCollection", "features": feats + [multi]}


def test_rasterize_and_load_footprints_equal_jax_in_the_grids_crs():
    doc = _seeded_polygons(3, 7, 500000.0, 4000000.0, 480.0)
    doc["crs"] = {"type": "name", "properties": {"name": CRS}}
    transform = from_origin(500000.0, 4000480.0, 7.5, 7.5)
    polys_t = fp_torch.load_footprints(doc, dst_crs=CRS)
    polys_j = fp_jax.load_footprints(doc, dst_crs=CRS)
    assert len(polys_t) == len(polys_j) == 9
    for pt, pj in zip(polys_t, polys_j):
        for rt, rj in zip(pt, pj):
            np.testing.assert_array_equal(rt, rj)
    got = fp_torch.rasterize_polygons(polys_t, transform, (64, 64))
    want = fp_jax.rasterize_polygons(polys_j, transform, (64, 64))
    assert got.dtype == bool and 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)


def test_building_mask_with_4326_to_utm_reprojection_equals_jax(tmp_path):
    # Lon/lat polygons just east of 15E, the central meridian of UTM 33N.
    doc = _seeded_polygons(5, 5, 15.0, 45.0, 0.01)
    fp = tmp_path / "lonlat.geojson"
    fp.write_text(json.dumps(doc))
    (x0, y0), (x1, y1) = geodesy_torch.transform_points(
        "EPSG:4326", CRS, [(15.0, 45.0), (15.01, 45.01)]
    )
    assert 499000 < x0 < 501500 and 4.97e6 < y0 < 5.0e6
    transform = from_origin(x0, y1, (x1 - x0) / 96, (y1 - y0) / 80)
    got = features_torch.building_mask_for_grid(fp, transform, (80, 96), crs=CRS)
    want = fp_jax.building_mask_for_grid(fp, transform, (80, 96), crs=CRS)
    assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside lon/lat bounds"):
        features_torch.building_mask_for_grid(
            _seeded_polygons(3, 2, 500000.0, 4000000.0, 480.0), transform, (80, 96), crs=CRS
        )


@pytest.mark.parametrize(
    "src,dst", [("EPSG:4326", "EPSG:32633"), ("EPSG:32633", "EPSG:3857"),
                ("EPSG:3979", "EPSG:4326"), ("EPSG:2169", "EPSG:4326")]
)
def test_geodesy_transform_points_equals_jax(src, dst):
    rng = np.random.default_rng(9)
    if src == "EPSG:4326":
        pts = [(15.0 + dx, 45.0 + dy) for dx, dy in rng.uniform(-1, 1, (6, 2))]
    elif src == "EPSG:2169":
        pts = [(80000.0 + dx, 100000.0 + dy) for dx, dy in rng.uniform(-2e4, 2e4, (6, 2))]
    else:
        pts = [(500000.0 + dx, 5000000.0 + dy) for dx, dy in rng.uniform(-1e5, 1e5, (6, 2))]
    got = geodesy_torch.transform_points(src, dst, pts)
    assert got == geodesy_jax.transform_points(src, dst, pts)
    (xa, ya), (xb, yb) = pts[0], pts[1]
    box = (min(xa, xb), min(ya, yb), max(xa, xb), max(ya, yb))
    assert geodesy_torch.transform_bounds(src, dst, *box) == (
        geodesy_jax.transform_bounds(src, dst, *box)
    )


def test_host_only_copies_differ_from_the_jax_package_only_in_their_imports():
    for ours, theirs in ((fp_torch, fp_jax), (geodesy_torch, geodesy_jax)):
        a = inspect.getsource(theirs).replace("floodsr_tpu.", "floodsr_tpu_torch.")
        assert a == inspect.getsource(ours)
    assert set(features_torch.__all__) == {
        "building_mask_for_grid", "load_footprints", "rasterize_polygons"
    }
