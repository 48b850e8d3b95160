"""The native one-pass dequant + strip encode alone, and its failure path.

``native.DequantEncodePass`` hands strips to the codec threads from a shared
counter: its payloads and counts are held against the sequential
``fsr_lzw_encode_strips`` at 1, 2 and 4 threads and under more threads than
cores; a strip over its capacity and an output buffer too small fail without
writing past them; a library older than its source is rebuilt and serves the
pass, and one whose rebuild fails still serves the one-chunk paths. A file
handle that fails mid-scene makes ``run_scene``, the worker and the writer
raise its error with no codec thread left running, and the worker removes the
partial output (``tests/test_torch_finish_fused.py`` holds the values and the
file bytes).
"""

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np
import pytest

from floodsr_tpu_torch.engine import EngineTorch
from floodsr_tpu_torch.io import geotiff, native
from floodsr_tpu_torch.io.affine import from_origin
from floodsr_tpu_torch.io.tiff import StripStreamWriter
from floodsr_tpu_torch.tohr import tohr as tohr_torch

pytestmark = pytest.mark.unit

STEP = 5.0 / 65535.0


@pytest.fixture(autouse=True)
def _native_pass():
    if not native.dequant_encode_available():
        pytest.skip("the native TIFF codec did not build here (no g++)")


def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 65536, shape).astype(np.uint16)
    codes[rng.random(shape[0]) < 0.4] = 0
    return codes


def _sequential(dst, rps, predictor):
    rows, cols = dst.shape
    n = -(-rows // rps)
    blob, counts = native.lzw_encode_strips(
        dst.reshape(-1).view(np.uint8), strip_bytes=rps * cols * 4, n_strips=n,
        cols=cols, itemsize=4, predictor=predictor, threads=1,
    )
    return bytes(blob), counts


def _run_pass(codes, rps, predictor):
    dst = np.full(codes.shape, np.nan, np.float32)
    with native.DequantEncodePass(codes, STEP, dst, rows_per_strip=rps, predictor=predictor) as job:
        assert job.wait(job.n_strips) == job.n_strips
        payloads = [bytes(job.strip(s)) for s in range(job.n_strips)]
        counts = [int(c) for c in job.counts]
    return dst, payloads, counts


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_the_pass_equals_the_sequential_strip_encode(threads, monkeypatch):
    monkeypatch.setenv("FLOODSR_CODEC_THREADS", str(threads))
    for shape, rps in (((37, 3840), 16), ((64, 3840), 16), ((45, 17), 4), ((9, 1), 2)):
        codes = _codes(shape, seed=shape[0] + shape[1])
        want = codes.astype(np.float32)
        want *= STEP
        for predictor in (1, 3):
            dst, payloads, counts = _run_pass(codes, rps, predictor)
            np.testing.assert_array_equal(dst.view(np.uint32), want.view(np.uint32))
            blob, seq_counts = _sequential(want, rps, predictor)
            assert counts == seq_counts == [len(p) for p in payloads], (shape, predictor)
            assert b"".join(payloads) == blob, (shape, predictor)


def test_more_threads_than_cores_on_many_small_strips(monkeypatch):
    # 1-row strips over 16 threads: the shared counter and the in-order
    # readiness under contention; payloads as the sequential encode's
    monkeypatch.setenv("FLOODSR_CODEC_THREADS", "16")
    codes = _codes((1500, 33), seed=3)
    want = codes.astype(np.float32)
    want *= STEP
    blob, seq_counts = _sequential(want, 1, 1)
    for _ in range(3):
        dst, payloads, counts = _run_pass(codes, 1, 1)
        assert counts == seq_counts and b"".join(payloads) == blob
        np.testing.assert_array_equal(dst.view(np.uint32), want.view(np.uint32))


def _begin(lib, codes, dst, out, counts, *, rps, strip_cap, out_cap):
    return lib.fsr_dequant_encode_begin(
        codes.ctypes.data, dst.ctypes.data, codes.shape[0], codes.shape[1],
        float(np.float32(STEP)), rps, 1, out.ctypes.data, out_cap, strip_cap,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), 4,
    )


def test_a_strip_over_its_capacity_fails_without_writing_past_it():
    codes = _codes((64, 3840), seed=4)
    lib = native._load()
    dst = np.empty(codes.shape, np.float32)
    counts = np.zeros(4, np.int64)
    out = np.full(4 * 100 + 64, 0xAB, np.uint8)  # four strips of 100 bytes, then a guard
    handle = _begin(lib, codes, dst, out, counts, rps=16, strip_cap=100, out_cap=400)
    assert handle
    assert lib.fsr_dequant_encode_wait(handle, 4) == -2
    assert lib.fsr_dequant_encode_end(handle) == -2
    assert (out[400:] == 0xAB).all()


def test_an_output_buffer_too_small_is_rejected_before_any_write():
    codes = _codes((64, 3840), seed=5)
    lib = native._load()
    dst = np.full(codes.shape, 7.0, np.float32)
    counts = np.full(4, -9, np.int64)
    out = np.full(4 * 1000, 0xAB, np.uint8)
    # four strips of 1000 bytes do not fit in 3999
    assert not _begin(lib, codes, dst, out, counts, rps=16, strip_cap=1000, out_cap=3999)
    assert (out == 0xAB).all() and (dst == 7.0).all() and (counts == -9).all()
    with pytest.raises(ValueError, match="codes must be 2-D uint16"):
        native.DequantEncodePass(codes.astype(np.int32), STEP, dst, rows_per_strip=16)
    with pytest.raises(ValueError, match="dst must be"):
        native.DequantEncodePass(codes, STEP, dst[:, :100], rows_per_strip=16)


_LEGACY_SOURCE = r"""
// The codec as it was before the strip and one-pass entry points.
extern "C" {
long long fsr_lzw_decode(const unsigned char*, long long, unsigned char*, long long) { return -1; }
long long fsr_lzw_encode_bound(long long n) { return n + (n >> 1) + 64; }
long long fsr_lzw_encode(const unsigned char*, long long, unsigned char*, long long) { return -1; }
}
"""


@pytest.fixture
def stale_library(tmp_path, monkeypatch):
    """A library built from an older source than the ``tiff_codec.cc`` beside
    it, loaded through a fresh ``native`` state at that path."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build a stale library")
    src_dir = tmp_path / "_native"
    src_dir.mkdir()
    legacy = tmp_path / "legacy.cc"
    legacy.write_text(_LEGACY_SOURCE)
    lib_path = src_dir / "libfloodsr_tiff.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib_path), str(legacy)], check=True)
    shutil.copy(native._LIB_PATH.parent / "tiff_codec.cc", src_dir / "tiff_codec.cc")
    os.utime(lib_path, (1_000_000_000, 1_000_000_000))  # older than the source
    monkeypatch.setattr(native, "_LIB_PATH", lib_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "_build_failed", False)
    return lib_path


def test_a_library_older_than_its_source_is_rebuilt_with_the_pass(stale_library):
    assert native.dequant_encode_available() and native.strips_available()
    assert stale_library.stat().st_mtime > 1_000_000_000
    dst, payloads, counts = _run_pass(_codes((20, 50), seed=6), 8, 1)
    assert len(payloads) == 3 and all(c > 0 for c in counts)


def test_a_stale_library_whose_rebuild_fails_serves_the_band_path(stale_library, tmp_path, monkeypatch):
    from floodsr_tpu_torch.io import build_native

    monkeypatch.setattr(build_native, "build", lambda **kw: None)
    assert native.available()
    assert not native.dequant_encode_available() and not native.strips_available()
    writer = StripStreamWriter(tmp_path / "x.tif", 20, 50, np.float32)
    assert not writer.takes_codes((20, 50))
    writer._handle.close()


class _FailingHandle:
    """A file handle whose ``fail_at``-th write raises, as a full disk would."""

    def __init__(self, handle, fail_at):
        self._handle, self._left = handle, fail_at

    def write(self, data):
        self._left -= 1
        if self._left == 0:
            raise OSError(28, "No space left on device")
        return self._handle.write(data)

    def __getattr__(self, name):
        return getattr(self._handle, name)


def _threads():
    return len(os.listdir("/proc/self/task")), threading.active_count()


def _tohr(tiny_model_fp, tiles, fp):
    return tohr_torch(
        model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
        depth_lr_fp=tiles["depth_lr_fp"], dem_hr_fp=tiles["dem_fp"], output_fp=fp,
        device="cpu",
    )


@pytest.mark.parametrize("where", ["writer", "engine", "worker"])
def test_a_handle_that_fails_mid_scene_raises_and_leaves_no_thread(
    where, tiny_model_fp, synthetic_nonnative_tiles, tmp_path, monkeypatch
):
    monkeypatch.setenv("FLOODSR_CODEC_THREADS", "4")
    if where == "writer":
        # 2048 strips of one row: the threads are still encoding when the
        # second write fails, so only a stop and a join leave none running
        codes = _codes((2048, 3840), seed=8)
        writer = StripStreamWriter(tmp_path / "out.tif", 2048, 3840, np.float32,
                                   rows_per_strip=1)
        writer._handle = _FailingHandle(writer._handle, fail_at=2)
        before = _threads()
        with pytest.raises(OSError, match="No space left"):
            writer.write_codes(codes, STEP, np.empty(codes.shape, np.float32))
        assert _threads() == before
        writer._handle.close()
        return
    if where == "engine":
        # a 64^2 scene onto a 60^2 grid: 2 strips of 32 rows; the second write fails
        eng = EngineTorch(tiny_model_fp, max_batch=4, device="cpu")
        rng = np.random.default_rng(5)
        depth = rng.uniform(0, 3, (16, 16)).astype(np.float32)
        dem = rng.uniform(300, 800, (64, 64)).astype(np.float32)
        post = ((60, 60), from_origin(0.0, 120.0, 1.875, 1.875),
                from_origin(0.0, 120.0, 2.0, 2.0))

        def run(sink):
            return eng.run_scene(
                depth, dem, stride_hr=24, overlap_hr=8, max_depth=5.0,
                dem_pct_clip=95.0, crop_shape=(64, 64), post_resample=post, sink=sink,
            )

        run(None)  # the threads PyTorch keeps start here, not in the count
        writer = StripStreamWriter(tmp_path / "out.tif", 60, 60, np.float32)
        writer._handle = _FailingHandle(writer._handle, fail_at=2)
        before = _threads()
        with pytest.raises(OSError, match="No space left"):
            run(writer)
        assert _threads() == before
        writer._handle.close()
        eng.close()
        return
    real = geotiff.open_raster_stream

    def failing_stream(fp, profile):
        w = real(fp, profile)
        w._handle = _FailingHandle(w._handle, fail_at=2)  # a strip, then the next
        return w

    _tohr(tiny_model_fp, synthetic_nonnative_tiles, tmp_path / "first.tif")
    monkeypatch.setattr(geotiff, "open_raster_stream", failing_stream)
    fp = tmp_path / "out.tif"
    before = _threads()
    with pytest.raises(OSError, match="No space left"):
        _tohr(tiny_model_fp, synthetic_nonnative_tiles, fp)
    assert _threads() == before
    assert not fp.exists()  # the worker's cleanup removed the partial file
