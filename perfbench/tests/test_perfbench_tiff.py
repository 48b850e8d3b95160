"""The benchmark's GeoTIFF writer and reader against the program's."""

from __future__ import annotations

import numpy as np

from perfbench.harness.synth import make_terrain
from perfbench.reference import tiff


def test_lzw_round_trip():
    rng = np.random.default_rng(0)
    for data in (b"", b"a", bytes(10000), rng.integers(0, 256, 200000, dtype=np.uint8).tobytes(),
                 make_terrain((300, 300), 3).tobytes()):
        assert tiff.lzw_decode(tiff.lzw_encode(data), len(data)) == data


def test_program_reads_the_benchmarks_rasters(tmp_path):
    from floodsr_tpu_torch.io import read_raster

    dem = make_terrain((133, 97), 7)
    fp = tmp_path / "dem.tif"
    tiff.write_geotiff(fp, dem, west=500000.0, north=4001000.0, res=2.0, epsg=32633)
    arr, nodata, prof = read_raster(fp)
    assert np.array_equal(arr, dem) and nodata == -9999.0
    assert prof["crs"].epsg == 32633 and prof["crs"].is_projected
    t = prof["transform"]
    assert (t.a, t.c, t.e, t.f) == (2.0, 500000.0, -2.0, 4001000.0)


def test_benchmark_reads_the_programs_rasters(tmp_path):
    from floodsr_tpu_torch.io import from_origin, write_raster

    arr = np.where(make_terrain((211, 130), 9) > 270, 0.0, 1.5).astype(np.float32)
    fp = tmp_path / "out.tif"
    write_raster(fp, arr, {"height": 211, "width": 130, "count": 1, "dtype": "float32",
                           "crs": "EPSG:32633", "transform": from_origin(1000.0, 9000.0, 2.0, 2.0),
                           "nodata": -9999.0, "compress": "LZW"})
    got, prof = tiff.read_geotiff(fp)
    assert np.array_equal(got, arr)
    assert (prof["west"], prof["north"], prof["res_x"], prof["epsg"]) == (1000.0, 9000.0, 2.0, 32633)
