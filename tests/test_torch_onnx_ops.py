"""The port's ONNX interpreter, operator by operator.

The convolution cases of ``tests/test_onnx.py`` against the port on the CPU,
held against torch modules of the same weights (atol 1e-5, f32 sums in another
order) and against the JAX package's interpreter on the same graph.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from onnx_build import _node, build_onnx
from test_torch_onnx import _run, _run_jax

from floodsr_tpu_torch.nn.onnx_exec import OnnxGraphExecutor
from floodsr_tpu_torch.nn.onnx_reader import load_model

pytestmark = pytest.mark.unit


@pytest.fixture
def rng():
    """A generator of this file's own, fresh for every test (the suite's shared
    one is used by every other test of its worker)."""
    return np.random.default_rng(20260816)


class TestExecutorVsTorch:
    def test_conv_bn_relu(self, rng):
        torch_net = nn.Sequential(
            nn.Conv2d(2, 6, 3, padding=1), nn.BatchNorm2d(6), nn.ReLU()
        ).eval()
        with torch.no_grad():
            torch_net[1].running_mean.copy_(torch.randn(6))
            torch_net[1].running_var.copy_(torch.rand(6) + 0.5)
        x = rng.normal(size=(1, 2, 10, 10)).astype(np.float32)
        want = torch_net(torch.from_numpy(x)).detach().numpy()

        conv, bn = torch_net[0], torch_net[1]
        data = build_onnx(
            [
                _node("Conv", ["x", "w", "b"], ["c"], {"strides": [1, 1], "pads": [1, 1, 1, 1]}),
                _node(
                    "BatchNormalization",
                    ["c", "scale", "offset", "mean", "var"],
                    ["n"],
                    {"epsilon": float(bn.eps)},
                ),
                _node("Relu", ["n"], ["y"]),
            ],
            {
                "w": conv.weight.detach().numpy(),
                "b": conv.bias.detach().numpy(),
                "scale": bn.weight.detach().numpy(),
                "offset": bn.bias.detach().numpy(),
                "mean": bn.running_mean.numpy(),
                "var": bn.running_var.numpy(),
            },
            [("x", x.shape)],
            [("y", want.shape)],
        )
        got = _run(data, {"x": x})
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, _run_jax(data, {"x": x}), atol=1e-5)

    @pytest.mark.parametrize("auto_pad", ["SAME_UPPER", "SAME_LOWER"])
    def test_strided_conv_same_upper(self, rng, auto_pad):
        # tf2onnx-style SAME_UPPER auto padding with stride 2: total pad is
        # k - stride = 1, placed at the END (unlike torch's symmetric pad);
        # SAME_LOWER places it at the beginning.
        torch_net = nn.Conv2d(3, 5, 3, stride=2, padding=0).eval()
        x = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
        pad = (0, 1, 0, 1) if auto_pad == "SAME_UPPER" else (1, 0, 1, 0)
        x_padded = torch.nn.functional.pad(torch.from_numpy(x), pad)
        want = torch_net(x_padded).detach().numpy()
        data = build_onnx(
            [_node("Conv", ["x", "w", "b"], ["y"], {"strides": [2, 2], "auto_pad": auto_pad})],
            {"w": torch_net.weight.detach().numpy(), "b": torch_net.bias.detach().numpy()},
            [("x", x.shape)],
            [("y", want.shape)],
        )
        got = _run(data, {"x": x})
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, _run_jax(data, {"x": x}), atol=1e-5)

    @pytest.mark.parametrize("stride,kernel", [(2, 2), (2, 4), (4, 4)])
    def test_conv_transpose(self, rng, stride, kernel):
        pad = (kernel - stride) // 2
        torch_net = nn.ConvTranspose2d(4, 3, kernel, stride=stride, padding=pad).eval()
        x = rng.normal(size=(1, 4, 6, 6)).astype(np.float32)
        want = torch_net(torch.from_numpy(x)).detach().numpy()
        data = build_onnx(
            [
                _node(
                    "ConvTranspose",
                    ["x", "w", "b"],
                    ["y"],
                    {"strides": [stride, stride], "pads": [pad, pad, pad, pad]},
                )
            ],
            {"w": torch_net.weight.detach().numpy(), "b": torch_net.bias.detach().numpy()},
            [("x", x.shape)],
            [("y", want.shape)],
        )
        got = _run(data, {"x": x})
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)

    @pytest.mark.parametrize("attrs,out_hw", [
        ({"pads": [1, 0, 0, 2], "output_padding": [1, 0]}, (11, 9)),
        ({"auto_pad": "SAME_UPPER"}, (10, 10)),
        ({"auto_pad": "SAME_LOWER"}, (10, 10)),
        ({"output_shape": [11, 12]}, (11, 12)),
    ], ids=["asymmetric_pads_output_padding", "same_upper", "same_lower", "output_shape"])
    def test_conv_transpose_pads_match_the_jax_executor(self, rng, attrs, out_hw):
        # kernel 3, stride 2 on 5x5: the full transposed conv is 11x11
        w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
        b = rng.normal(size=(3,)).astype(np.float32)
        x = rng.normal(size=(2, 4, 5, 5)).astype(np.float32)
        data = build_onnx(
            [_node("ConvTranspose", ["x", "w", "b"], ["y"], {"strides": [2, 2], **attrs})],
            {"w": w, "b": b}, [("x", x.shape)], [("y", (2, 3, *out_hw))],
        )
        got, want = _run(data, {"x": x}), _run_jax(data, {"x": x})
        assert got.shape == want.shape == (2, 3, *out_hw)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_mini_dual_input_sr_graph(self, rng):
        """A miniature of the reference's dual-input graph shape: depth_lr +
        dem_hr -> pooled concat -> conv -> convT upsample -> fuse -> head."""
        depth = rng.uniform(0, 1, (1, 1, 4, 4)).astype(np.float32)
        dem = rng.uniform(0, 1, (1, 1, 8, 8)).astype(np.float32)

        conv = nn.Conv2d(2, 4, 3, padding=1).eval()
        up = nn.ConvTranspose2d(4, 4, 2, stride=2).eval()
        head = nn.Conv2d(5, 1, 1).eval()
        with torch.no_grad():
            t_pool = nn.functional.avg_pool2d(torch.from_numpy(dem), 2)
            t_cat = torch.cat([torch.from_numpy(depth), t_pool], dim=1)
            t_feat = torch.relu(conv(t_cat))
            t_up = torch.relu(up(t_feat))
            t_fuse = torch.cat([t_up, torch.from_numpy(dem)], dim=1)
            want = head(t_fuse).numpy()

        data = build_onnx(
            [
                _node("AveragePool", ["dem_hr"], ["dem_lr"], {"kernel_shape": [2, 2], "strides": [2, 2]}),
                _node("Concat", ["depth_lr", "dem_lr"], ["cat"], {"axis": 1}),
                _node("Conv", ["cat", "w1", "b1"], ["f0"], {"strides": [1, 1], "pads": [1, 1, 1, 1]}),
                _node("Relu", ["f0"], ["f"]),
                _node("ConvTranspose", ["f", "w2", "b2"], ["u0"], {"strides": [2, 2], "pads": [0, 0, 0, 0]}),
                _node("Relu", ["u0"], ["u"]),
                _node("Concat", ["u", "dem_hr"], ["fuse"], {"axis": 1}),
                _node("Conv", ["fuse", "w3", "b3"], ["depth_hr_pred"], {"strides": [1, 1], "pads": [0, 0, 0, 0]}),
            ],
            {
                "w1": conv.weight.detach().numpy(),
                "b1": conv.bias.detach().numpy(),
                "w2": up.weight.detach().numpy(),
                "b2": up.bias.detach().numpy(),
                "w3": head.weight.detach().numpy(),
                "b3": head.bias.detach().numpy(),
            },
            [("depth_lr", depth.shape), ("dem_hr", dem.shape)],
            [("depth_hr_pred", want.shape)],
        )
        model = load_model(data)
        assert [vi.name for vi in model.graph_inputs] == ["depth_lr", "dem_hr"]
        executor = OnnxGraphExecutor(model)
        got = executor({"depth_lr": depth, "dem_hr": dem})["depth_hr_pred"].numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        # constants moved to the device once, and kept
        moved = dict(executor._device_constants)
        executor({"depth_lr": depth, "dem_hr": dem})
        assert moved.keys() == executor._device_constants.keys() == {"w1", "b1", "w2", "b2", "w3", "b3"}
        assert all(moved[k] is executor._device_constants[k] for k in moved)
