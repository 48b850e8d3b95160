"""The finish's one pass: uint16 codes dequantized inside the strip encode.

Where the device post-processed a ``uint16`` scene and the sink is a
``StripStreamWriter`` that takes codes, the engine hands the writer the
downloaded codes (``StripStreamWriter.write_codes``): the codec threads write
``float32(code) * float32(step)`` into the scene and encode each strip from it
while the caller writes the strips already done. Held here against the band
path (``codes.astype(np.float32) * step`` fed to ``write_rows`` in 512-row
bands): the same file bytes and the same float32 bits, at 1, 2 and 4 codec
threads; and the ``fused_strips`` counter on the pass and on each fallback.
``tests/test_torch_finish_fused_native.py`` holds the native pass alone and a
file handle that fails mid-scene.
"""

import json

import numpy as np
import pytest
import torch

from floodsr_tpu_torch.engine import EngineTorch
from floodsr_tpu_torch.io import native, read_raster
from floodsr_tpu_torch.io.tiff import StripStreamWriter
from floodsr_tpu_torch.parallel.mesh import make_mesh
from floodsr_tpu_torch.tohr import tohr as tohr_torch

pytestmark = pytest.mark.unit

MAX_DEPTH = 5.0
STEP = MAX_DEPTH / 65535.0


@pytest.fixture(autouse=True)
def _native_pass():
    if not native.dequant_encode_available():
        pytest.skip("the native TIFF codec did not build here (no g++)")


def _codes(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros(shape, np.uint16)
    if kind == "full":
        return np.full(shape, 65535, np.uint16)
    codes = rng.integers(0, 65536, shape).astype(np.uint16)
    # dry rows (exact zeros, long runs) among wet ones, and a few dry cells
    codes[rng.random(shape[0]) < 0.4] = 0
    codes[rng.random(shape) < 0.1] = 0
    return codes


def _band_path(fp, codes, rps):
    """Today's path: numpy's dequant, then ``write_rows`` in 512-row bands."""
    scene = codes.astype(np.float32)
    scene *= STEP
    with StripStreamWriter(fp, *codes.shape, np.float32, rows_per_strip=rps) as w:
        for r in range(0, codes.shape[0], 512):
            w.write_rows(scene[r : r + 512])
    return scene


@pytest.mark.parametrize("shape,kind,rps", [
    ((40, 1), "mix", None),
    ((600, 17), "mix", 16),
    ((29, 17), "mix", 5),
    ((64, 3840), "mix", None),
    ((37, 3840), "mix", None),
    ((1, 3840), "mix", None),
    ((37, 3840), "zero", None),
    ((37, 3840), "full", None),
], ids=["w1", "w17_bands", "w17_ragged", "w3840_whole_strips", "w3840_ragged",
        "one_row", "all_zero", "all_65535"])
def test_write_codes_equals_the_band_path(tmp_path, monkeypatch, shape, kind, rps):
    codes = _codes(shape, kind, seed=shape[0] * 7 + shape[1])
    want = _band_path(tmp_path / "bands.tif", codes, rps)
    want_bytes = (tmp_path / "bands.tif").read_bytes()
    for threads in (1, 2, 4):
        monkeypatch.setenv("FLOODSR_CODEC_THREADS", str(threads))
        fp = tmp_path / f"pass_{threads}.tif"
        got = np.full(shape, np.nan, np.float32)
        with StripStreamWriter(fp, *shape, np.float32, rows_per_strip=rps) as w:
            assert w.takes_codes(shape)
            n = w.write_codes(codes, STEP, got)
            assert n == len(w._offsets) == -(-shape[0] // w._rps)
        assert fp.read_bytes() == want_bytes, threads
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    back, _, _ = read_raster(tmp_path / "pass_4.tif")
    np.testing.assert_array_equal(back, want)


def _footprint(root):
    """A building over a block of the 96x96 DEM grid (5 m, origin 500000,
    4000480, EPSG:32633)."""
    x0, ytop, res = 500000.0, 4000000.0 + 96 * 5.0, 5.0
    fp = root / "buildings.geojson"
    fp.write_text(json.dumps({
        "type": "Polygon",
        "crs": {"type": "name", "properties": {"name": "EPSG:32633"}},
        "coordinates": [[
            [x0 + 20 * res, ytop - 60 * res], [x0 + 50 * res, ytop - 60 * res],
            [x0 + 50 * res, ytop - 10 * res], [x0 + 20 * res, ytop - 10 * res],
            [x0 + 20 * res, ytop - 60 * res],
        ]],
    }))
    return fp


def _tohr(tiny_model_fp, tiles, fp, **kw):
    return tohr_torch(
        model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
        depth_lr_fp=tiles["depth_lr_fp"], dem_hr_fp=tiles["dem_fp"], output_fp=fp,
        device="cpu", **kw,
    )


class _RowsOnly:
    """A sink with the writer's ``write_rows`` and nothing else."""

    def __init__(self, writer):
        self.write_rows = writer.write_rows


@pytest.mark.parametrize("case", [
    "pass", "uint12", "float32", "zstd", "buildings", "mesh",
])
def test_fused_strips_counts_the_pass_and_each_fallback_reads_0(
    case, tiny_model_fp, synthetic_nonnative_tiles, tmp_path, monkeypatch
):
    # A 96x96 DEM over a 64x64 model space: the device post-resamples, and the
    # float32 output's strips are 64 rows, so the pass encodes 2 strips.
    kw = {}
    if case in ("uint12", "float32"):
        kw["engine_options"] = {"output_transfer": case}
    elif case == "zstd":
        kw["output_compress"] = "zstd"
    elif case == "buildings":
        kw["buildings_fp"] = _footprint(tmp_path)
    elif case == "mesh":
        # the host resamples under a mesh
        kw["engine_options"] = {"mesh": make_mesh(devices=[torch.device("cpu")] * 2)}
    diag = _tohr(tiny_model_fp, synthetic_nonnative_tiles, tmp_path / "out.tif", **kw)
    timings = diag["scene_timings"]
    assert timings["fused_strips"] == (2 if case == "pass" else 0)
    assert diag["scene_timings"]["trace"]["counters"].get("fused_strips", 0) == timings["fused_strips"]
    if case == "pass":
        # the pass's file equals the band path's, byte for byte, and reads
        # back as the codes the device sent
        real = EngineTorch.run_scene

        def run_scene(self, *args, sink=None, **kw):
            return real(self, *args, sink=_RowsOnly(sink), **kw)

        monkeypatch.setattr(EngineTorch, "run_scene", run_scene)
        band = _tohr(tiny_model_fp, synthetic_nonnative_tiles, tmp_path / "band.tif")
        assert band["scene_timings"]["fused_strips"] == 0
        assert (tmp_path / "out.tif").read_bytes() == (tmp_path / "band.tif").read_bytes()
        out = read_raster(tmp_path / "out.tif")[0]
        assert out.shape == synthetic_nonnative_tiles["dem_shape"]
        codes = np.round(out.astype(np.float64) / STEP)
        np.testing.assert_array_equal((codes.astype(np.float32) * np.float32(STEP)), out)
        # the spans keep their names; the dequant is left to the pass
        names = {s[0] for s in timings["trace"]["spans"]}
        assert {"finish.dequant", "finish.sink", "sink.encode", "sink.write"} <= names
