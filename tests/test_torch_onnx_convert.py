"""The ONNX converter of the port and the runtime of the converted graph.

The cases of ``tests/test_onnx_convert.py`` and ``tests/test_onnx_replica.py``
against the port on the CPU, with those files' tolerances (f32 on both sides,
sums in another order), plus the port against the JAX package on the same
graph, and an artifact converted by one package loaded by the other.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from onnx_build import _node, build_onnx
from onnx_replica import HR_TILE, LR_TILE, build_reference_replica
from test_onnx import build_dual_input_onnx
from test_torch_onnx import _run_jax

from floodsr_tpu.engine import EngineJAX
from floodsr_tpu.nn.checkpoint import load_artifact as load_artifact_jax
from floodsr_tpu.nn.onnx_convert import convert_onnx_to_fsrz as convert_jax
from floodsr_tpu.nn.onnx_convert import graph_apply as graph_apply_jax
from floodsr_tpu_torch.engine import EngineTorch
from floodsr_tpu_torch.nn.checkpoint import load_artifact
from floodsr_tpu_torch.nn.onnx_convert import GraphProgram, convert_onnx_to_fsrz, graph_apply
from floodsr_tpu_torch.nn.onnx_exec import OnnxGraphExecutor
from floodsr_tpu_torch.nn.onnx_reader import count_parameters, load_model

pytestmark = pytest.mark.unit

REAL_PARAM_COUNT = 12_045_568  # reference probe, infer_test_tiles.ipynb cell 9


@pytest.fixture
def rng():
    """A generator of this file's own, fresh for every test (the suite's shared
    one is used by every other test of its worker)."""
    return np.random.default_rng(20260816)


class TestConverterSmallGraph:
    @pytest.fixture(scope="class")
    def small(self, tmp_path_factory):
        data = build_dual_input_onnx(lr_tile=8, scale=4, channels=8, seed=5)
        fsrz = tmp_path_factory.mktemp("conv") / "converted.fsrz"
        convert_onnx_to_fsrz(data, fsrz)
        return data, fsrz

    def test_ir_matches_interpreter(self, small):
        data, fsrz = small
        model = load_model(data)
        art = load_artifact(fsrz)
        manifest = art["manifest"]
        assert manifest["architecture"] == "onnx-graph"

        rng = np.random.default_rng(0)
        depth = rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
        dem = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
        want = OnnxGraphExecutor(model)({"depth_lr": depth, "dem_hr": dem})["depth_hr_pred"]
        got = graph_apply(
            manifest["graph_ir"], art["params"], {"depth_lr": depth, "dem_hr": dem},
            [manifest["graph_output_edge"]],
        )[manifest["graph_output_edge"]]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)

    def test_transposes_and_plumbing_eliminated(self, small):
        _, fsrz = small
        ir = load_artifact(fsrz)["manifest"]["graph_ir"]
        kinds = {op["op"] for op in ir}
        assert "transpose" not in kinds
        assert not any(k in kinds for k in ("shape", "gather", "slice", "reshape"))

    def test_engine_scene_parity_onnx_vs_converted(self, small, tmp_path):
        data, fsrz = small
        onnx_fp = tmp_path / "model.onnx"
        onnx_fp.write_bytes(data)

        rng = np.random.default_rng(1)
        depth = rng.uniform(0, 3, (16, 16)).astype(np.float32)
        dem = rng.uniform(300, 800, (64, 64)).astype(np.float32)
        kw = dict(stride_hr=24, overlap_hr=8, max_depth=5.0, dem_pct_clip=95.0, crop_shape=(64, 64))
        outs = {}
        for name, fp in (("onnx", onnx_fp), ("converted", fsrz)):
            eng = EngineTorch(fp, max_batch=4, output_transfer="float32", device="cpu", scene_chunk=4)
            outs[name], stats = eng.run_scene(depth, dem, **kw)
            assert eng.last_scene_timings["tiles"] == 9 and stats["p_clip"].shape == (9,)
            eng.close()
        np.testing.assert_allclose(outs["converted"], outs["onnx"], atol=5e-5)
        # and the JAX engine on the same files
        for name, fp in (("onnx", onnx_fp), ("converted", fsrz)):
            eng = EngineJAX(fp, max_batch=4, output_transfer="float32")
            want, want_stats = eng.run_scene(depth, dem, **kw)
            eng.close()
            np.testing.assert_allclose(outs[name], want, atol=5e-5)
        # the same bisection; XLA's CPU code may round a midpoint the other way
        np.testing.assert_allclose(stats["p_clip"], want_stats["p_clip"][:9], rtol=1e-6)

    def test_an_artifact_converted_by_one_package_loads_in_the_other(self, small, tmp_path):
        data, fsrz = small
        jax_fsrz = tmp_path / "converted_by_jax.fsrz"
        convert_jax(data, jax_fsrz)
        ours, theirs = load_artifact(fsrz), load_artifact_jax(jax_fsrz)
        for key in ("graph_ir", "graph_output_edge", "io_contract", "params_skeleton", "config"):
            assert ours["manifest"][key] == theirs["manifest"][key], key
        # each loader reads the other's file: same names, same arrays
        crossed_ours, crossed_theirs = load_artifact(jax_fsrz), load_artifact_jax(fsrz)
        assert sorted(ours["params"]) == sorted(crossed_ours["params"]) == sorted(crossed_theirs["params"])
        for key, value in ours["params"].items():
            np.testing.assert_array_equal(value, np.asarray(theirs["params"][key]))
            np.testing.assert_array_equal(value, crossed_ours["params"][key])
            np.testing.assert_array_equal(value, np.asarray(crossed_theirs["params"][key]))
        # and runs it: the port's engine on the JAX package's artifact and back
        rng = np.random.default_rng(2)
        depth = rng.uniform(0, 3, (8, 8)).astype(np.float32)
        dem = rng.uniform(300, 800, (32, 32)).astype(np.float32)
        a = EngineTorch(jax_fsrz, device="cpu").run_tile(depth, dem)["prediction_m"]
        b = EngineJAX(fsrz).run_tile(depth, dem)["prediction_m"]
        np.testing.assert_allclose(a, b, atol=2e-5)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_graph_apply_matches_the_jax_runtime(self, small, dtype):
        _, fsrz = small
        art = load_artifact(fsrz)
        m, edge = art["manifest"], art["manifest"]["graph_output_edge"]
        rng = np.random.default_rng(4)
        depth = rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
        dem = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
        got = graph_apply(
            m["graph_ir"], art["params"], {"depth_lr": depth, "dem_hr": dem}, [edge],
            getattr(torch, dtype),
        )[edge].numpy()
        want = np.asarray(graph_apply_jax(
            m["graph_ir"], {k: jnp.asarray(v) for k, v in art["params"].items()},
            {"depth_lr": jnp.asarray(depth), "dem_hr": jnp.asarray(dem)}, [edge],
            compute_dtype=getattr(jnp, dtype),
        )[edge])
        f32 = graph_apply(
            m["graph_ir"], art["params"], {"depth_lr": depth, "dem_hr": dem}, [edge]
        )[edge].numpy()
        assert got.dtype == np.float32
        if dtype == "bfloat16":
            # exact products, f32 sums in another order: a flipped rounding at most
            assert float(np.abs(want - f32).max()) > 1e-4
            assert float(np.abs(got - want).max()) <= 2.0 ** -8 * float(np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)

    def test_engine_bfloat16_applies_to_the_converted_graph_only(self, small, tmp_path):
        data, fsrz = small
        onnx_fp = tmp_path / "model.onnx"
        onnx_fp.write_bytes(data)
        rng = np.random.default_rng(6)
        depth = rng.uniform(0, 3, (8, 8)).astype(np.float32)
        dem = rng.uniform(300, 800, (32, 32)).astype(np.float32)

        def tile(fp, dtype):
            eng = EngineTorch(fp, compute_dtype=dtype, device="cpu")
            out = eng.run_tile(depth, dem)["prediction_m"]
            eng.close()
            return out

        # the interpreter ignores the policy, as the JAX package's does
        np.testing.assert_array_equal(tile(onnx_fp, "bfloat16"), tile(onnx_fp, "float32"))
        # the converted graph computes in bf16 under 'bfloat16' alone
        assert not np.array_equal(tile(fsrz, "bfloat16"), tile(fsrz, "float32"))
        np.testing.assert_array_equal(tile(fsrz, "mixed"), tile(fsrz, "float32"))


def test_stride_4_transposed_conv_through_the_converted_graph(rng):
    # The IR holds a ConvTranspose as an input-dilated convolution (flipped
    # kernel, lhs_dilation = the strides, pads eff_k - 1 - p); the port maps it
    # back to a transposed convolution. Kernel 6, stride 4, asymmetric pads
    # and an output_padding: against the interpreter and the JAX runtime.
    w = rng.normal(size=(3, 5, 6, 6)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    nodes = [
        _node("Transpose", ["depth_lr"], ["d"], {"perm": [0, 3, 1, 2]}),
        _node("Transpose", ["dem_hr"], ["m"], {"perm": [0, 3, 1, 2]}),
        _node("Concat", ["d", "d", "d"], ["d3"], {"axis": 1}),
        _node("ConvTranspose", ["d3", "w", "b"], ["u"], {
            "strides": [4, 4], "pads": [1, 2, 1, 0], "output_padding": [0, 1]}),
        _node("Concat", ["u", "m"], ["cat"], {"axis": 1}),
        _node("Conv", ["cat", "hw"], ["p"], {"strides": [1, 1]}),
        _node("Transpose", ["p"], ["depth_hr_pred"], {"perm": [0, 2, 3, 1]}),
    ]
    # 6x7 in -> (6-1)*4 + 6 - 2 = 24 rows, (7-1)*4 + 6 - 2 + 1 = 29 columns
    inits = {"w": w, "b": b, "hw": rng.normal(size=(1, 6, 1, 1)).astype(np.float32)}
    data = build_onnx(
        nodes, inits, [("depth_lr", (1, 6, 7, 1)), ("dem_hr", (1, 24, 29, 1))],
        [("depth_hr_pred", (1, 24, 29, 1))],
    )
    depth = rng.normal(size=(2, 6, 7, 1)).astype(np.float32)
    dem = rng.normal(size=(2, 24, 29, 1)).astype(np.float32)
    feeds = {"depth_lr": depth, "dem_hr": dem}
    want = OnnxGraphExecutor(load_model(data))(feeds)["depth_hr_pred"].numpy()
    np.testing.assert_allclose(want, _run_jax(data, feeds), atol=1e-5)

    from floodsr_tpu_torch.nn.onnx_convert import _Converter

    conv = _Converter(load_model(data))
    conv.run()
    op = next(op for op in conv.ir if op["op"] == "conv")
    assert op["lhs_dilation"] == [4, 4] and op["pads"] == [[4, 4], [3, 6]]
    edge = conv.env["depth_hr_pred"].name
    program = GraphProgram(conv.ir, conv.weights)
    assert tuple(program.weights[op["w"]].shape) == (3, 5, 6, 6)
    np.testing.assert_array_equal(program.weights[op["w"]].numpy(), w)  # the flip undone
    got = program(feeds, [edge])[edge].numpy()
    assert got.shape == want.shape == (2, 24, 29, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    jax_out = graph_apply_jax(
        conv.ir, {k: jnp.asarray(v) for k, v in conv.weights.items()},
        {k: jnp.asarray(v) for k, v in feeds.items()}, [edge],
    )[edge]
    np.testing.assert_allclose(got, np.asarray(jax_out), atol=1e-5)


@pytest.fixture(scope="module")
def replica():
    data, torch_net = build_reference_replica(seed=7)
    return data, load_model(data), torch_net


class TestReplicaScale:
    def test_parameter_scale_matches_reference(self, replica):
        _, model, _ = replica
        n = count_parameters(model)
        assert abs(n - REAL_PARAM_COUNT) / REAL_PARAM_COUNT < 0.03, n

    def test_opset_and_io_contract(self, replica):
        _, model, _ = replica
        assert model.opset == 13
        names = [vi.name for vi in model.graph_inputs]
        assert names == ["depth_lr", "dem_hr"]


class TestReplicaParity:
    def test_executor_matches_torch_full_scale(self, replica):
        _, model, torch_net = replica
        rng = np.random.default_rng(3)
        depth = rng.uniform(0, 1, (1, LR_TILE, LR_TILE, 1)).astype(np.float32)
        dem = rng.uniform(0, 1, (1, HR_TILE, HR_TILE, 1)).astype(np.float32)
        with torch.no_grad():
            want = torch_net(torch.from_numpy(depth), torch.from_numpy(dem)).numpy()
        got = OnnxGraphExecutor(model)({"depth_lr": depth, "dem_hr": dem})["depth_hr_pred"].numpy()
        assert got.shape == want.shape == (1, HR_TILE, HR_TILE, 1)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


class TestConverterFullScaleReplica:
    def test_replica_round_trip_and_scene_parity(self, replica, tmp_path):
        data, _, _ = replica
        onnx_fp = tmp_path / "replica.onnx"
        onnx_fp.write_bytes(data)
        fsrz = tmp_path / "replica.fsrz"
        convert_onnx_to_fsrz(data, fsrz)

        art = load_artifact(fsrz)
        manifest = art["manifest"]
        assert manifest["io_contract"]["scale"] == 16
        assert manifest["metadata"]["onnx_param_count"] > 12_000_000
        # BN folding: no standalone affines should survive (every BN follows
        # a single-consumer conv in this family).
        assert not any(op["op"] == "affine" for op in manifest["graph_ir"])

        rng = np.random.default_rng(2)
        depth = rng.uniform(0, 3, (LR_TILE, LR_TILE)).astype(np.float32)
        dem = rng.uniform(300, 800, (HR_TILE, HR_TILE)).astype(np.float32)
        outs = {}
        for name, fp in (("onnx", onnx_fp), ("converted", fsrz)):
            eng = EngineTorch(fp, max_batch=1, output_transfer="float32", device="cpu")
            out, _ = eng.run_scene(
                depth, dem, stride_hr=HR_TILE, overlap_hr=0,
                max_depth=5.0, dem_pct_clip=95.0, crop_shape=(HR_TILE, HR_TILE),
            )
            outs[name] = out
            eng.close()
        assert outs["onnx"].shape == (HR_TILE, HR_TILE)
        np.testing.assert_allclose(outs["converted"], outs["onnx"], atol=5e-5)
