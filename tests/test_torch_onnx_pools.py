"""The port's ONNX interpreter: pools, Resize, elementwise plumbing.

Against torch and against the JAX package's interpreter on the same graph
(atol 1e-5 to 1e-6: f32 on both sides).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from onnx_build import _node, build_onnx
from test_torch_onnx import _run, _run_jax

pytestmark = pytest.mark.unit


@pytest.fixture
def rng():
    """A generator of this file's own, fresh for every test (the suite's shared
    one is used by every other test of its worker)."""
    return np.random.default_rng(20260816)


class TestPoolsAndResize:
    def test_avgpool_concat_add(self, rng):
        x = rng.normal(size=(1, 2, 8, 8)).astype(np.float32)
        pool = nn.AvgPool2d(2)
        want_pool = pool(torch.from_numpy(x)).numpy()
        want = np.concatenate([want_pool, want_pool + 1.0], axis=1)
        data = build_onnx(
            [
                _node("AveragePool", ["x"], ["p"], {"kernel_shape": [2, 2], "strides": [2, 2]}),
                _node("Add", ["p", "one"], ["p1"]),
                _node("Concat", ["p", "p1"], ["y"], {"axis": 1}),
            ],
            {"one": np.ones((1,), np.float32)},
            [("x", x.shape)],
            [("y", want.shape)],
        )
        got = _run(data, {"x": x})
        np.testing.assert_allclose(got, want, atol=1e-6)

    @pytest.mark.parametrize("op,attrs", [
        ("MaxPool", {}), ("AveragePool", {}), ("AveragePool", {"count_include_pad": 1}),
    ], ids=["max", "avg", "avg_count_include_pad"])
    def test_pools_with_asymmetric_pads_match_the_jax_executor(self, rng, op, attrs):
        x = rng.normal(size=(1, 2, 7, 7)).astype(np.float32)
        data = build_onnx(
            [_node(op, ["x"], ["y"], {
                "kernel_shape": [3, 3], "strides": [2, 2], "pads": [0, 1, 1, 2], **attrs})],
            {}, [("x", x.shape)], [("y", (1, 2, 3, 4))],
        )
        got, want = _run(data, {"x": x}), _run_jax(data, {"x": x})
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)

    @pytest.mark.parametrize("mode,sizes", [
        ("nearest", (1, 2, 8, 12)), ("nearest", (1, 2, 6, 5)), ("linear", (1, 2, 8, 12)),
        ("linear", (1, 2, 3, 2)), ("linear", (1, 4, 8, 6)), ("cubic", (1, 2, 8, 12)),
        ("cubic", (1, 2, 3, 2)), ("cubic", (1, 2, 6, 5)),
    ], ids=["nearest_up", "nearest_ragged", "linear_up", "linear_down", "linear_other_axes",
            "cubic_up", "cubic_down", "cubic_ragged"])
    def test_resize_matches_the_jax_executor(self, rng, mode, sizes):
        x = rng.normal(size=(1, 2, 4, 6)).astype(np.float32)
        data = build_onnx(
            [_node("Resize", ["x", "", "", "sizes"], ["y"], {"mode": mode})],
            {"sizes": np.asarray(sizes, np.int64)}, [("x", x.shape)], [("y", sizes)],
        )
        got, want = _run(data, {"x": x}), _run_jax(data, {"x": x})
        assert got.shape == want.shape == sizes
        np.testing.assert_allclose(got, want, atol=1e-5)
