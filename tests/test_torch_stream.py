"""The port's serving path on the CPU: DEM cache, prefetch, ``run_many``, ``tohr_many``.

Inputs are made from a seed with numpy; everything runs with ``device="cpu"``
at the tiny committed artifact. ``tohr_many`` is held against the JAX
package's on the same jobs; ``run_many`` against the port's own single
``run``, bit for bit.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from floodsr_tpu.tohr import tohr_many as tohr_many_jax
from floodsr_tpu_torch.io import from_origin, read_raster, write_raster
from floodsr_tpu_torch.models.ResUNet_16x_DEM import ModelWorker
from floodsr_tpu_torch.tohr import tohr_many as tohr_many_torch

pytestmark = pytest.mark.unit


def _scene(tmp_path, seed: int, name: str, hr=(128, 128), scale=4):
    """A seeded HR DEM and LR depth as GeoTIFFs (the tiny model's 4x scale)."""
    rng = np.random.default_rng(seed)
    lr = (hr[0] // scale, hr[1] // scale)
    dem = (
        400.0
        + np.cumsum(rng.normal(0, 0.5, hr), axis=1)
        + np.linspace(0, 30, hr[0])[:, None]
    ).astype(np.float32)
    depth = rng.uniform(0.0, 2.5, lr).astype(np.float32)
    x0, y0 = 500000.0, 4000000.0

    def profile(shape, res):
        return {
            "height": shape[0], "width": shape[1], "count": 1, "dtype": "float32",
            "crs": "EPSG:32633", "nodata": -9999.0, "compress": "LZW",
            "transform": from_origin(x0, y0 + hr[0] * 7.5, res, res),
        }

    dem_fp, depth_fp = tmp_path / f"{name}_dem.tif", tmp_path / f"{name}_depth.tif"
    write_raster(dem_fp, dem, profile(hr, 7.5))
    write_raster(depth_fp, depth, profile(lr, 7.5 * scale))
    return dem_fp, depth_fp


def _worker(model_fp, logger=None):
    return ModelWorker(model_fp=model_fp, logger=logger, device="cpu")


def _jobs(tmp_path, prefix, scenes):
    return [
        {"depth_lr_fp": depth_fp, "dem_hr_fp": dem_fp, "output_fp": tmp_path / f"{prefix}{i}.tif"}
        for i, (dem_fp, depth_fp) in enumerate(scenes)
    ]


def test_run_many_equals_single_run_bit_for_bit_and_keeps_dems_resident(
    tiny_model_fp, tmp_path, logger
):
    scenes = [_scene(tmp_path, 1, "a"), _scene(tmp_path, 2, "b")]
    with _worker(tiny_model_fp, logger) as worker:
        results = worker.run_many(_jobs(tmp_path, "many", scenes), tile_overlap=1)
        assert len(results) == 2
        assert len(worker._dem_device_cache) == 2  # both DEMs resident
        assert worker._dem_cache_bytes == 2 * 128 * 128 * 4
        assert worker.dem_counts == {
            "decoded_in_run": 1, "decoded_by_prefetch": 1, "resident": 1,
        }
    assert [r["scene_timings"]["dem_resident"] for r in results] == [False, True]
    assert results[1]["scene_timings"]["dem_counts"] == worker.dem_counts
    for i, job in enumerate(_jobs(tmp_path, "solo", scenes)):
        with _worker(tiny_model_fp, logger) as worker:
            solo = worker.run(tile_overlap=1, **job)
        assert solo["scene_timings"]["dem_resident"] is False
        got, _, _ = read_raster(tmp_path / f"many{i}.tif")
        want, _, _ = read_raster(tmp_path / f"solo{i}.tif")
        np.testing.assert_array_equal(got, want)
        assert results[i]["output_fp"] == str(tmp_path / f"many{i}.tif")


def test_tohr_many_matches_the_jax_package(tiny_model_fp, tmp_path, logger):
    """Six scenes over three DEMs, each DEM used twice and never by neighbours."""
    dems = [_scene(tmp_path, 10 + k, f"d{k}") for k in range(3)]
    scenes = [dems[k] for k in (0, 1, 2, 0, 1, 2)]
    shared = dict(model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp, logger=logger)
    got = tohr_many_torch(jobs=_jobs(tmp_path, "torch", scenes), device="cpu", **shared)
    want = tohr_many_jax(jobs=_jobs(tmp_path, "jax", scenes), **shared)
    assert len(got) == len(want) == 6
    for i, (res_t, res_j) in enumerate(zip(got, want)):
        assert set(res_t) == set(res_j)
        assert set(res_t["preprocess"]) == set(res_j["preprocess"])
        pred_t, _, _ = read_raster(tmp_path / f"torch{i}.tif")
        pred_j, _, _ = read_raster(tmp_path / f"jax{i}.tif")
        # The bar of tests/test_torch_scene_tohr.py: both quantize to uint16
        # codes of 7.6e-5 m, and f32 sums in another order move a few codes
        # by one, far inside 1e-4 m RMSE.
        assert float(np.sqrt(np.mean((pred_t - pred_j) ** 2))) <= 1e-4
    # Three decodes (one in run, two by the prefetch thread); five of the six
    # scenes found their DEM resident.
    assert got[-1]["scene_timings"]["dem_counts"] == {
        "decoded_in_run": 1, "decoded_by_prefetch": 2, "resident": 5,
    }
    assert [r["scene_timings"]["dem_resident"] for r in got] == [False] + [True] * 5


def test_tohr_many_validates_its_arguments(tiny_model_fp, tmp_path):
    with pytest.raises(AssertionError, match="jobs cannot be empty"):
        tohr_many_torch(model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp, jobs=[], device="cpu")
    with pytest.raises(AssertionError, match="model_version"):
        tohr_many_torch(model_version="", model_fp=tiny_model_fp, jobs=[{}], device="cpu")
    with pytest.raises(AssertionError, match="does not exist"):
        tohr_many_torch(
            model_version="ResUNet_16x_DEM", model_fp=tmp_path / "no.fsrz", jobs=[{}], device="cpu"
        )


def test_tohr_many_raises_without_cuda_by_default(tiny_model_fp, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dem_fp, depth_fp = _scene(tmp_path, 3, "c")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tohr_many_torch(
            model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
            jobs=_jobs(tmp_path, "x", [(dem_fp, depth_fp)]),
        )
    assert not (tmp_path / "x0.tif").exists()


def test_cache_key_changes_with_mtime_and_size(tiny_model_fp, tmp_path):
    dem_fp, _ = _scene(tmp_path, 4, "k")
    worker = _worker(tiny_model_fp)
    key = worker._dem_cache_key(dem_fp)
    assert key == worker._dem_cache_key(dem_fp)
    assert key[0] == str(dem_fp) and key[3] == "uint16"
    st = dem_fp.stat()
    os.utime(dem_fp, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    touched = worker._dem_cache_key(dem_fp)
    assert touched != key and touched[2] == key[2]
    with open(dem_fp, "ab") as fh:
        fh.write(b"\0")
    assert worker._dem_cache_key(dem_fp)[2] == key[2] + 1
    assert worker._dem_cache_key(tmp_path / "missing.tif") is None
    other = ModelWorker(model_fp=tiny_model_fp, device="cpu", input_transfer="float32")
    assert other._dem_cache_key(dem_fp)[3] == "float32"


def _value(n_floats: int):
    return (torch.zeros(n_floats), None, {})


@pytest.mark.parametrize("by", ["count", "bytes"])
def test_eviction_keeps_the_newest(by, tiny_model_fp, monkeypatch):
    worker = _worker(tiny_model_fp)
    if by == "count":
        monkeypatch.setattr(ModelWorker, "DEM_CACHE_CAP", 2)
        for k in range(4):
            worker._dem_cache_put(("dem", k), _value(10))
        assert list(worker._dem_device_cache) == [("dem", 2), ("dem", 3)]
        assert worker._dem_cache_bytes == 80
        # A hit makes an entry the newest: the other one goes first.
        assert worker._dem_cache_get(("dem", 2)) is not None
        worker._dem_cache_put(("dem", 4), _value(10))
        assert list(worker._dem_device_cache) == [("dem", 2), ("dem", 4)]
    else:
        monkeypatch.setattr(ModelWorker, "DEM_CACHE_MAX_BYTES", 100)
        worker._dem_cache_put("a", _value(10))
        worker._dem_cache_put("b", _value(10))
        assert list(worker._dem_device_cache) == ["a", "b"] and worker._dem_cache_bytes == 80
        worker._dem_cache_put("c", _value(10))  # 120 bytes > 100: the oldest goes
        assert list(worker._dem_device_cache) == ["b", "c"] and worker._dem_cache_bytes == 80
        # One entry over the budget alone is still kept (always keeps one).
        worker._dem_cache_put("big", _value(1000))
        assert list(worker._dem_device_cache) == ["big"] and worker._dem_cache_bytes == 4000
        # Replacing a key does not count its bytes twice.
        worker._dem_cache_put("big", _value(5))
        assert worker._dem_cache_bytes == 20
    assert worker._dem_cache_get(None) is None


def test_constants_are_the_reference_ones():
    from floodsr_tpu.models.ResUNet_16x_DEM import ModelWorker as ModelWorkerJax

    assert ModelWorker.DEM_CACHE_CAP == ModelWorkerJax.DEM_CACHE_CAP == 4
    assert ModelWorker.DEM_CACHE_MAX_BYTES == ModelWorkerJax.DEM_CACHE_MAX_BYTES == 2 * 1024**3


def test_prefetch_of_a_cached_or_in_flight_dem_starts_no_thread(
    tiny_model_fp, tmp_path, monkeypatch
):
    dem_fp, _ = _scene(tmp_path, 5, "p")
    gate = threading.Event()
    decode = ModelWorker._decode_and_upload_dem

    def slow_decode(self, path, stream=None):
        assert gate.wait(timeout=60)
        return decode(self, path, stream=stream)

    monkeypatch.setattr(ModelWorker, "_decode_and_upload_dem", slow_decode)
    with _worker(tiny_model_fp) as worker:
        first = worker.prefetch_dem(dem_fp)
        assert first is not None and first.name == "floodsr-dem-prefetch"
        assert worker.prefetch_dem(dem_fp) is None  # in flight
        gate.set()
        first.join(timeout=60)
        assert not first.is_alive()
        assert worker._dem_prefetch == {}
        assert len(worker._dem_device_cache) == 1
        assert worker.prefetch_dem(dem_fp) is None  # cached
        assert worker.prefetch_dem(tmp_path / "missing.tif") is None
        assert worker.dem_counts["decoded_by_prefetch"] == 1


def test_exit_joins_the_prefetch_and_clears(tiny_model_fp, tmp_path, monkeypatch):
    dem_fp, _ = _scene(tmp_path, 6, "e")
    decode = ModelWorker._decode_and_upload_dem

    def slow_decode(self, path, stream=None):
        time.sleep(0.3)
        return decode(self, path, stream=stream)

    monkeypatch.setattr(ModelWorker, "_decode_and_upload_dem", slow_decode)
    with _worker(tiny_model_fp) as worker:
        thread = worker.prefetch_dem(dem_fp)
        assert thread is not None
    # __exit__ waited for the thread, then cleared what it had inserted.
    assert not thread.is_alive()
    assert worker.dem_counts["decoded_by_prefetch"] == 1
    assert len(worker._dem_device_cache) == 0 and worker._dem_cache_bytes == 0
    assert worker._dem_prefetch == {} and worker.engine is None


def test_failed_prefetch_is_logged_and_run_raises_the_real_error(
    tiny_model_fp, tmp_path, caplog
):
    _, depth_fp = _scene(tmp_path, 7, "f")
    bad_dem = tmp_path / "bad_dem.tif"
    bad_dem.write_bytes(b"this is not a GeoTIFF")
    with _worker(tiny_model_fp) as worker:
        with caplog.at_level("ERROR"):
            thread = worker.prefetch_dem(bad_dem)
            thread.join(timeout=60)
        assert not thread.is_alive()
        assert "DEM prefetch failed" in caplog.text
        assert worker._dem_prefetch == {} and len(worker._dem_device_cache) == 0
        assert worker.dem_counts["decoded_by_prefetch"] == 0
        with pytest.raises(Exception) as err:
            worker.run(depth_lr_fp=depth_fp, dem_hr_fp=bad_dem, output_fp=tmp_path / "o.tif")
        assert not isinstance(err.value, (KeyError, AttributeError))
    assert not (tmp_path / "o.tif").exists()


def test_warmup_counts_distinct_geometries_and_validates_like_run(tiny_model_fp, logger):
    with _worker(tiny_model_fp, logger) as worker:
        # The tiny model's HR tile is 64: 64x64 and 50x60 pad to one scene.
        assert worker.warmup([(64, 64), (50, 60), (128, 64), (64, 128)]) == 3
        assert worker.warmup([(64, 64)], window_method="hard") == 1
        assert worker.warmup([]) == 0
        with pytest.raises(AssertionError, match="overlap_lr > 0"):
            worker.warmup([(64, 64)], window_method="feather", tile_overlap=0)
        assert worker.dem_counts == {"decoded_in_run": 0, "decoded_by_prefetch": 0, "resident": 0}
    with pytest.raises(AssertionError, match="entered"):
        _worker(tiny_model_fp).warmup([(64, 64)])


def test_tohr_many_over_a_costgrow_worker_takes_the_loop(tmp_path, logger):
    from floodsr_tpu_torch.model_registry import resolve_model_worker_class
    from floodsr_tpu_torch.tohr import tohr

    assert not hasattr(resolve_model_worker_class("CostGrow_pcraster"), "run_many")
    nodata = -9999.0
    rng = np.random.default_rng(8)
    dem = (100.0 + rng.normal(0.0, 0.05, (64, 64))).astype(np.float32)
    wse = np.full((8, 8), nodata, np.float32)
    wse[3:5, 2:6] = 102.5
    base = {"count": 1, "dtype": "float32", "crs": "EPSG:32633", "nodata": nodata, "compress": "LZW"}
    wse_fp, dem_fp = tmp_path / "wse.tif", tmp_path / "dem.tif"
    write_raster(wse_fp, wse, dict(base, height=8, width=8, transform=from_origin(0, 512, 64.0, 64.0)))
    write_raster(dem_fp, dem, dict(base, height=64, width=64, transform=from_origin(0, 512, 8.0, 8.0)))
    params_fp = tmp_path / "p.json"
    params_fp.write_text(json.dumps({"dp_coarse_pixel_max": 2}))
    shared = dict(model_version="CostGrow_pcraster", model_fp=params_fp, logger=logger, device="cpu")
    jobs = [
        {"depth_lr_fp": wse_fp, "dem_hr_fp": dem_fp, "output_fp": tmp_path / f"grown{i}.tif"}
        for i in range(2)
    ]
    results = tohr_many_torch(jobs=jobs, **shared)
    assert [r["output_fp"] for r in results] == [str(j["output_fp"]) for j in jobs]
    tohr(depth_lr_fp=wse_fp, dem_hr_fp=dem_fp, output_fp=tmp_path / "single.tif", **shared)
    want, _, _ = read_raster(tmp_path / "single.tif")
    for job in jobs:
        got, _, _ = read_raster(job["output_fp"])
        np.testing.assert_array_equal(got, want)


def test_concurrent_puts_keep_the_byte_count_true(tiny_model_fp, monkeypatch):
    """More threads than cores inserting and evicting: a lost update would
    leave ``_dem_cache_bytes`` different from the entries' sum."""
    monkeypatch.setattr(ModelWorker, "DEM_CACHE_CAP", 3)
    worker = _worker(tiny_model_fp)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer(tid):
            for k in range(300):
                worker._dem_cache_put((tid, k % 5), _value(1 + (k % 7)))
                worker._dem_cache_get((tid, (k + 1) % 5))

        threads = [threading.Thread(target=hammer, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    entries = list(worker._dem_device_cache.values())
    assert 1 <= len(entries) <= 3
    assert worker._dem_cache_bytes == sum(v[0].numel() * 4 for v in entries)


def test_dem_upload_on_a_side_stream_needs_cuda_only_when_given():
    """``stream=None`` (the CPU, and ``run`` on the card) takes the plain path."""
    from floodsr_tpu_torch.ops.transfer import device_put_dem_quantized

    rng = np.random.default_rng(9)
    arr = rng.uniform(100.0, 200.0, (1500, 1500)).astype(np.float32)  # 9 MB: encoded
    arr[3, 4] = -9999.0
    out = device_put_dem_quantized(arr, -9999.0, device="cpu", stream=None).numpy()
    assert out[3, 4] == -9999.0
    step = (arr[arr > 0].max() - arr[arr > 0].min()) / 65534.0
    assert np.abs(out - arr).max() <= 0.5 * step * 1.001 + 1e-4
