"""The ONNX path of the port: reader, engine, operator edge cases.

The parser, engine and edge-case classes of ``tests/test_onnx.py`` run against
the port's modules on the CPU, with that file's tolerances (f32 on both sides,
sums in another order), plus the port against the JAX package on the same
graph. The operators are in ``tests/test_torch_onnx_ops.py`` and
``tests/test_torch_onnx_pools.py``, the converter and the full-scale replica in
``tests/test_torch_onnx_convert.py``.
"""

import numpy as np
import pytest

from onnx_build import _node, build_onnx
from test_onnx import build_dual_input_onnx

from floodsr_tpu.engine import EngineJAX
from floodsr_tpu.nn.onnx_exec import OnnxGraphExecutor as OnnxGraphExecutorJax
from floodsr_tpu.nn.onnx_reader import load_model as load_model_jax
from floodsr_tpu_torch.engine import EngineTorch
from floodsr_tpu_torch.engine.scene import SceneExecutor
from floodsr_tpu_torch.io import from_origin, read_raster, write_raster
from floodsr_tpu_torch.nn.onnx_exec import OnnxGraphExecutor
from floodsr_tpu_torch.nn.onnx_reader import count_parameters, load_model
from floodsr_tpu_torch.tohr import tohr

pytestmark = pytest.mark.unit


@pytest.fixture
def rng():
    """A generator of this file's own, fresh for every test: the suite's own
    one is shared by all its tests, and drawing from it here would change
    the numbers every later test on the same worker sees."""
    return np.random.default_rng(20260816)


def _run(data: bytes, feeds: dict) -> np.ndarray:
    out = OnnxGraphExecutor(load_model(data))(feeds)
    return list(out.values())[0].numpy()


def _run_jax(data: bytes, feeds: dict) -> np.ndarray:
    out = OnnxGraphExecutorJax(load_model_jax(data))(feeds)
    return np.asarray(list(out.values())[0])


class TestParser:
    def test_parse_roundtrip(self, rng):
        w = rng.normal(size=(4, 1, 3, 3)).astype(np.float32)
        data = build_onnx(
            [_node("Conv", ["x", "w"], ["y"], {"strides": [1, 1], "pads": [1, 1, 1, 1]})],
            {"w": w},
            [("x", (1, 1, 8, 8))],
            [("y", (1, 4, 8, 8))],
        )
        model = load_model(data)
        assert model.ir_version == 7
        assert model.opset == 13
        assert model.producer == "floodsr-tpu-test"
        assert len(model.nodes) == 1
        assert model.nodes[0].op_type == "Conv"
        assert model.nodes[0].attributes["pads"] == [1, 1, 1, 1]
        np.testing.assert_array_equal(model.initializers["w"], w)
        assert [vi.name for vi in model.graph_inputs] == ["x"]
        assert count_parameters(model) == w.size

    def test_not_onnx_raises(self):
        with pytest.raises(ValueError):
            load_model(b"\x0a\x02hi")  # field 1 as LEN: no graph


class TestEngineWithOnnxArtifact:
    @pytest.fixture(scope="class")
    def onnx_model_fp(self, tmp_path_factory):
        fp = tmp_path_factory.mktemp("onnx_model") / "model_infer.onnx"
        fp.write_bytes(build_dual_input_onnx())
        return fp

    def test_engine_loads_onnx_and_resolves_contract(self, onnx_model_fp):
        eng = EngineTorch(onnx_model_fp, max_batch=4, device="cpu")
        assert eng.contract.depth_lr_hwc == (4, 4, 1)
        assert eng.contract.dem_hr_hwc == (8, 8, 1)
        assert eng.contract.scale == 2
        assert eng.model is None  # a graph does not split into trunk and tail
        depth = np.random.default_rng(0).uniform(0, 2, (4, 4)).astype(np.float32)
        dem = np.random.default_rng(1).uniform(100, 300, (8, 8)).astype(np.float32)
        r = eng.run_tile(depth, dem)
        assert r["prediction_m"].shape == (8, 8)
        assert np.isfinite(r["prediction_m"]).all()
        eng.close()
        # the same tile through the JAX engine
        eng = EngineJAX(onnx_model_fp, max_batch=4)
        want = eng.run_tile(depth, dem)
        eng.close()
        np.testing.assert_allclose(r["prediction_m"], want["prediction_m"], atol=1e-5)
        assert r["dem_stats_used"] == want["dem_stats_used"]

    def test_tohr_with_onnx_model(self, onnx_model_fp, tmp_path, logger):
        rng = np.random.default_rng(3)
        lr = rng.uniform(0, 2, (8, 8)).astype(np.float32)
        dem = rng.uniform(100, 200, (16, 16)).astype(np.float32)

        def prof(a, res, top):
            return {
                "height": a.shape[0], "width": a.shape[1], "count": 1,
                "dtype": "float32", "crs": "EPSG:32633", "nodata": -9999.0,
                "transform": from_origin(0.0, top, res, res), "compress": "LZW",
            }

        lr_fp, dem_fp = tmp_path / "lr.tif", tmp_path / "dem.tif"
        write_raster(lr_fp, lr, prof(lr, 30.0, 240.0))
        write_raster(dem_fp, dem, prof(dem, 15.0, 240.0))
        out_fp = tmp_path / "sr.tif"
        result = tohr(
            model_version="ResUNet_16x_DEM",
            model_fp=onnx_model_fp,
            depth_lr_fp=lr_fp,
            dem_hr_fp=dem_fp,
            output_fp=out_fp,
            tile_overlap=1,
            logger=logger,
            device="cpu",
        )
        pred, _, _ = read_raster(result["output_fp"])
        assert pred.shape == (16, 16)
        assert np.isfinite(pred).all()
        # the JAX package's tohr on the same files: the bar of the ResUNet scenes
        from floodsr_tpu.tohr import tohr as tohr_jax

        want_fp = tmp_path / "sr_jax.tif"
        tohr_jax(
            model_version="ResUNet_16x_DEM", model_fp=onnx_model_fp, depth_lr_fp=lr_fp,
            dem_hr_fp=dem_fp, output_fp=want_fp, tile_overlap=1, logger=logger,
        )
        want, _, _ = read_raster(want_fp)
        assert float(np.sqrt(np.mean((pred - want) ** 2))) <= 1e-4

    def test_engine_rejects_a_graph_without_the_contract(self, tmp_path):
        w = np.zeros((1, 1, 1, 1), np.float32)
        fp = tmp_path / "other.onnx"
        fp.write_bytes(build_onnx(
            [_node("Conv", ["x", "w"], ["y"], {"strides": [1, 1]})], {"w": w},
            [("x", (1, 1, 8, 8))], [("y", (1, 1, 8, 8))],
        ))
        with pytest.raises(AssertionError, match="model input 'depth_lr' not found"):
            EngineTorch(fp, device="cpu")


class TestOpEdgeCases:
    """Edge-case op semantics: Clip min-only, Pad modes."""

    def test_clip_min_only_input(self, rng):
        # Opset-11+ Clip with exactly (x, min): must clip the low side.
        x = rng.normal(size=(2, 3)).astype(np.float32)
        data = build_onnx(
            [_node("Clip", ["x", "lo"], ["y"])],
            {"lo": np.float32(0.0).reshape(())},
            [("x", x.shape)],
            [("y", x.shape)],
        )
        got = _run(data, {"x": x})
        np.testing.assert_allclose(got, np.clip(x, 0.0, None), atol=0)

    def test_clip_min_and_max_inputs(self, rng):
        x = rng.normal(size=(2, 3)).astype(np.float32)
        data = build_onnx(
            [_node("Clip", ["x", "lo", "hi"], ["y"])],
            {"lo": np.float32(-0.5).reshape(()), "hi": np.float32(0.5).reshape(())},
            [("x", x.shape)],
            [("y", x.shape)],
        )
        got = _run(data, {"x": x})
        np.testing.assert_allclose(got, np.clip(x, -0.5, 0.5), atol=0)

    def test_pad_reflect_and_edge_modes(self, rng):
        x = rng.normal(size=(1, 1, 4, 4)).astype(np.float32)
        pads = np.array([0, 0, 1, 1, 0, 0, 1, 1], np.int64)
        for mode in ("reflect", "edge"):
            data = build_onnx(
                [_node("Pad", ["x", "pads"], ["y"], {"mode": mode})],
                {"pads": pads},
                [("x", x.shape)],
                [("y", (1, 1, 6, 6))],
            )
            got = _run(data, {"x": x})
            want = np.pad(x, [(0, 0), (0, 0), (1, 1), (1, 1)], mode=mode)
            np.testing.assert_allclose(got, want, atol=0, err_msg=mode)

    def test_pad_constant_value_input(self, rng):
        x = rng.normal(size=(1, 1, 4, 4)).astype(np.float32)
        pads = np.array([0, 0, 1, 1, 0, 0, 1, 1], np.int64)
        data = build_onnx(
            [_node("Pad", ["x", "pads", "cval"], ["y"])],
            {"pads": pads, "cval": np.float32(7.5).reshape(())},
            [("x", x.shape)],
            [("y", (1, 1, 6, 6))],
        )
        got = _run(data, {"x": x})
        want = np.pad(x, [(0, 0), (0, 0), (1, 1), (1, 1)], constant_values=7.5)
        np.testing.assert_allclose(got, want, atol=0)

    def test_unsupported_op_names_the_node(self):
        data = build_onnx(
            [_node("Einsum", ["x"], ["y"])], {}, [("x", (1, 2))], [("y", (1, 2))],
        )
        with pytest.raises(NotImplementedError, match="ONNX op 'Einsum'"):
            _run(data, {"x": np.zeros((1, 2), np.float32)})
        with pytest.raises(KeyError, match="missing graph input"):
            _run(data, {})


# -- converter ---------------------------------------------------------------


# -- the full-scale replica ----------------------------------------------------


def test_single_phase_executor_needs_a_forward_and_a_geometry():
    with pytest.raises(AssertionError, match="needs a model to split"):
        SceneExecutor(None, scene_shape=(8, 8), overlap_hr=0, max_depth=5.0, dem_pct_clip=95.0)
