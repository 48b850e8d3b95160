"""Execute parsed ONNX graphs as PyTorch computations.

Port of the JAX package's ``nn/onnx_exec.py``. Covers the operator set a
tf2onnx/torch-exported convolutional SR network uses (the reference's released
graph is a conv/BN/ReLU ResUNet with transposed-conv upsampling — reference:
``floodsr/models/ResUNet_16x_DEM.py:15-24``): Conv, ConvTranspose,
BatchNormalization, Relu/LeakyRelu/Sigmoid/Tanh, Add/Sub/Mul/Div, Concat,
AveragePool/MaxPool/GlobalAveragePool, Transpose, Identity/Cast, Pad, Reshape,
Resize (nearest/linear/cubic), Clip, and constant plumbing. Everything lowers to
``torch`` ops on one explicit device, so a loaded ONNX artifact runs on the GPU
with no ONNX Runtime. The graph's constants are moved to the device once, at
their first use.

Values in the interpreter's environment are either torch tensors (on the
executor's device) or numpy arrays: constants and the tf2onnx shape plumbing
(Shape/Gather/Slice/Concat over shape vectors) stay numpy, so a Reshape's
target is known on the host without a device read.

Usage::

    model = onnx_reader.load_model("model_infer.onnx")
    runner = OnnxGraphExecutor(model, device="cuda")
    outputs = runner({"depth_lr": x, "dem_hr": d})     # name → tensor
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from floodsr_tpu_torch.nn.onnx_reader import _ONNX_DTYPES, OnnxModel, OnnxNode


def _attr(node: OnnxNode, name: str, default=None):
    return node.attributes.get(name, default)


def _text(value) -> str:
    return value.decode() if isinstance(value, bytes) else str(value)


def _auto_pad_pairs(node: OnnxNode, kernel: tuple[int, int], strides, in_hw, dilations=(1, 1)):
    """Resolve ONNX padding attributes to per-dimension (lo, hi) pairs."""
    auto_pad = _text(_attr(node, "auto_pad", "NOTSET"))
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        pads = []
        for dim in range(2):
            eff_k = (kernel[dim] - 1) * dilations[dim] + 1
            out = -(-in_hw[dim] // strides[dim])
            total = max(0, (out - 1) * strides[dim] + eff_k - in_hw[dim])
            lo = total // 2
            hi = total - lo
            pads.append((hi, lo) if auto_pad == "SAME_LOWER" else (lo, hi))
        return pads
    if auto_pad == "VALID":
        return [(0, 0), (0, 0)]
    raw = _attr(node, "pads", [0, 0, 0, 0])
    # ONNX order: [y_begin, x_begin, y_end, x_end]
    return [(int(raw[0]), int(raw[2])), (int(raw[1]), int(raw[3]))]


def pad_hw(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Pad (negative: crop) the two last axes by ``[(top, bottom), (left, right)]``."""
    (top, bottom), (left, right) = pads
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def conv_transpose_padded(
    x: torch.Tensor, w: torch.Tensor, strides, pads, dilations
) -> torch.Tensor:
    """NCHW transposed conv with per-side output pads ``[(lo, hi), (lo, hi)]``.

    ``w`` is ``[Cin, Cout, kH, kW]`` (the ONNX and the PyTorch layout). The
    full transposed convolution is computed and ``lo``/``hi`` rows cropped
    from its two ends; a negative pad (ONNX ``output_padding``) extends the
    output by rows no input reaches, which are zero before the bias.
    """
    full = F.conv_transpose2d(x, w, None, tuple(strides), 0, 0, 1, tuple(dilations))
    return pad_hw(full, [(-int(p[0]), -int(p[1])) for p in pads])


def resize_nearest(x: torch.Tensor, sizes) -> torch.Tensor:
    """Nearest-neighbour resize to ``sizes`` with half-pixel centres, any axes."""
    for axis, (old, new) in enumerate(zip(x.shape, sizes)):
        if old != new:
            pos = (torch.arange(new, device=x.device, dtype=torch.float32) + 0.5) * (old / new)
            x = x.index_select(axis, pos.floor().clamp_(0, old - 1).to(torch.int64))
    return x


def _triangle_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - x)


def _keys_cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel (a = -0.5) of a distance ``x >= 0``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(old: int, new: int, kernel) -> np.ndarray:
    """``[old, new]`` f32 weights of a 1-D resize with half-pixel centres.

    Column ``j`` holds ``kernel(|sample_j - i|)`` over the input positions
    ``i``, widened by ``old / new`` when shrinking (antialiasing) and scaled to
    sum to one, so a sample near an edge re-weights the taps that exist
    instead of reading outside.
    """
    inv_scale = old / new
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(new, dtype=np.float64) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(old, dtype=np.float64)[:, None])
    weights = kernel(dist / kernel_scale)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample >= -0.5) & (sample <= old - 0.5)
    return np.where(inside[None, :], weights, 0.0).astype(np.float32)


def resize_by_kernel(x: torch.Tensor, sizes, kernel) -> torch.Tensor:
    """Separable resize to ``sizes``: one weight matrix per axis that changes."""
    for axis, (old, new) in enumerate(zip(x.shape, sizes)):
        if old != new:
            w = torch.from_numpy(resize_weights(int(old), int(new), kernel)).to(x.device)
            x = torch.movedim(torch.movedim(x, axis, -1).to(torch.float32) @ w, -1, axis)
    return x


class OnnxGraphExecutor:
    """Interpret an ONNX graph with torch ops (NCHW, per ONNX convention)."""

    def __init__(self, model: OnnxModel, device: "str | torch.device" = "cpu"):
        self.model = model
        self.device = torch.device(device)
        self.constants: dict[str, np.ndarray] = dict(model.initializers)
        # Fold Constant nodes into the environment up front.
        self.nodes: list[OnnxNode] = []
        for node in model.nodes:
            if node.op_type == "Constant":
                value = _attr(node, "value")
                if value is None:
                    value = _attr(node, "value_float")
                self.constants[node.outputs[0]] = np.asarray(value)
            else:
                self.nodes.append(node)
        self.input_names = [vi.name for vi in model.graph_inputs]
        self.output_names = [vi.name for vi in model.outputs]
        self._device_constants: dict[str, torch.Tensor] = {}

    # -- values ---------------------------------------------------------------

    def _tensor(self, env: dict, name: str) -> torch.Tensor:
        """The value as a tensor on the device; a graph constant moves once."""
        v = env[name]
        if isinstance(v, torch.Tensor):
            return v
        if name in self.constants and v is self.constants[name]:
            t = self._device_constants.get(name)
            if t is None:
                t = torch.from_numpy(np.array(v)).to(self.device)  # a copy torch may own
                self._device_constants[name] = t
            return t
        return torch.from_numpy(np.array(v)).to(self.device)

    def _binary(self, node: OnnxNode, env: dict, np_fn, torch_fn):
        a, b = env[node.inputs[0]], env[node.inputs[1]]
        if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
            return np_fn(a, b)  # constant or shape plumbing
        return torch_fn(self._tensor(env, node.inputs[0]), self._tensor(env, node.inputs[1]))

    # -- op implementations --------------------------------------------------

    def _op_conv(self, node: OnnxNode, env: dict) -> Any:
        x = self._tensor(env, node.inputs[0])
        w = self._tensor(env, node.inputs[1])
        b = self._tensor(env, node.inputs[2]) if len(node.inputs) > 2 else None
        strides = tuple(_attr(node, "strides", [1, 1]))
        dilations = tuple(_attr(node, "dilations", [1, 1]))
        groups = int(_attr(node, "group", 1))
        kernel = (int(w.shape[2]), int(w.shape[3]))
        pads = _auto_pad_pairs(node, kernel, strides, x.shape[2:4], dilations)
        out = F.conv2d(pad_hw(x, pads), w, None, strides, 0, dilations, groups)
        if b is not None:
            out = out + b.reshape(1, -1, 1, 1)
        return out.to(x.dtype)

    def _op_conv_transpose(self, node: OnnxNode, env: dict) -> Any:
        x = self._tensor(env, node.inputs[0])
        w = self._tensor(env, node.inputs[1])  # [Cin, Cout/groups, kH, kW]
        b = self._tensor(env, node.inputs[2]) if len(node.inputs) > 2 else None
        strides = tuple(_attr(node, "strides", [1, 1]))
        dilations = tuple(_attr(node, "dilations", [1, 1]))
        groups = int(_attr(node, "group", 1))
        if groups != 1:
            raise NotImplementedError("grouped ConvTranspose is not supported")
        kernel = (int(w.shape[2]), int(w.shape[3]))
        output_padding = tuple(_attr(node, "output_padding", [0, 0]))

        auto_pad = _text(_attr(node, "auto_pad", "NOTSET"))
        output_shape_attr = _attr(node, "output_shape")
        in_hw = x.shape[2:4]

        def totals(out_hw):
            return [
                (in_hw[d] - 1) * strides[d] + ((kernel[d] - 1) * dilations[d] + 1) - out_hw[d]
                for d in range(2)
            ]

        if output_shape_attr is not None:
            pads = [(t // 2, t - t // 2) for t in totals(tuple(int(v) for v in output_shape_attr))]
        elif auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            pads = []
            for t in totals(tuple(in_hw[d] * strides[d] for d in range(2))):
                lo, hi = t // 2, t - t // 2
                pads.append((hi, lo) if auto_pad == "SAME_LOWER" else (lo, hi))
        else:
            raw = _attr(node, "pads", [0, 0, 0, 0])
            pads = [(raw[0], raw[2]), (raw[1], raw[3])]
            pads = [(p[0], p[1] - output_padding[d]) for d, p in enumerate(pads)]

        out = conv_transpose_padded(x, w, strides, pads, dilations)
        if b is not None:
            out = out + b.reshape(1, -1, 1, 1)
        return out.to(x.dtype)

    def _op_batch_norm(self, node: OnnxNode, env: dict) -> Any:
        x, scale, offset, mean, var = (self._tensor(env, name) for name in node.inputs[:5])
        eps = float(_attr(node, "epsilon", 1e-5))
        inv = scale / torch.sqrt(var + eps)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * inv.reshape(shape) + (offset - mean * inv).reshape(shape)

    def _op_pool(self, node: OnnxNode, env: dict, reducer: str) -> Any:
        x = self._tensor(env, node.inputs[0])
        kernel = tuple(_attr(node, "kernel_shape"))
        strides = tuple(_attr(node, "strides", list(kernel)))
        pads = _auto_pad_pairs(node, kernel, strides, x.shape[2:4])
        if reducer == "max":
            return F.max_pool2d(pad_hw(x, pads, float("-inf")), kernel, strides)
        area = float(np.prod(kernel))
        if all(p == (0, 0) for p in pads):
            return F.avg_pool2d(x, kernel, strides)
        summed = F.avg_pool2d(pad_hw(x, pads), kernel, strides) * area
        if _attr(node, "count_include_pad", 0):
            return summed / area
        ones = torch.ones((1, 1, *x.shape[2:4]), dtype=x.dtype, device=x.device)
        counts = F.avg_pool2d(pad_hw(ones, pads), kernel, strides) * area
        return summed / counts

    def _op_resize(self, node: OnnxNode, env: dict) -> Any:
        x = self._tensor(env, node.inputs[0])
        sizes = None
        if len(node.inputs) > 3 and node.inputs[3] and node.inputs[3] in env:
            sizes = np.asarray(env[node.inputs[3]]).astype(int).tolist()
        elif len(node.inputs) > 2 and node.inputs[2] and node.inputs[2] in env:
            scales = np.asarray(env[node.inputs[2]]).astype(float)
            sizes = [int(round(s * d)) for s, d in zip(scales, x.shape)]
        if sizes is None:
            raise NotImplementedError("Resize without scales/sizes")
        mode = _text(_attr(node, "mode", "nearest"))
        if mode == "nearest":
            return resize_nearest(x, sizes)
        if mode == "linear":
            if x.ndim == 4 and list(sizes[:2]) == list(x.shape[:2]):
                # half-pixel centres, antialiased when shrinking
                return F.interpolate(
                    x, size=tuple(sizes[2:]), mode="bilinear", align_corners=False,
                    antialias=True,
                )
            return resize_by_kernel(x, sizes, _triangle_kernel)
        if mode == "cubic":
            # Keys' kernel with a = -0.5, as the JAX package's interpreter
            # (torch's own bicubic takes a = -0.75)
            return resize_by_kernel(x, sizes, _keys_cubic_kernel)
        raise NotImplementedError(f"Resize mode {mode!r} is not supported")

    def _op_pad(self, node: OnnxNode, env: dict) -> Any:
        x = self._tensor(env, node.inputs[0])
        if len(node.inputs) > 1 and node.inputs[1] in env:
            raw = np.asarray(env[node.inputs[1]]).astype(int)
        else:
            raw = np.asarray(_attr(node, "pads"), int)
        half = len(raw) // 2
        pairs = [(int(raw[i]), int(raw[i + half])) for i in range(half)]
        while pairs and pairs[0] == (0, 0):  # leading axes without padding
            pairs = pairs[1:]
        flat = [v for pair in reversed(pairs) for v in pair]  # last axis first
        if not flat:
            return x
        mode = _text(_attr(node, "mode", b"constant"))
        if mode == "constant":
            cval = 0.0
            if len(node.inputs) > 2 and node.inputs[2] and node.inputs[2] in env:
                cval = float(np.asarray(env[node.inputs[2]]).reshape(()))
            return F.pad(x, flat, value=cval)
        if mode in ("reflect", "edge"):
            return F.pad(x, flat, mode="reflect" if mode == "reflect" else "replicate")
        raise NotImplementedError(f"Pad mode {mode!r} not supported")

    def _op_slice(self, node: OnnxNode, env: dict) -> Any:
        data = env[node.inputs[0]]
        if len(node.inputs) > 1:
            starts = np.asarray(env[node.inputs[1]]).astype(np.int64)
            ends = np.asarray(env[node.inputs[2]]).astype(np.int64)
            axes = (
                np.asarray(env[node.inputs[3]]).astype(np.int64)
                if len(node.inputs) > 3 and node.inputs[3]
                else np.arange(starts.size, dtype=np.int64)
            )
            steps = (
                np.asarray(env[node.inputs[4]]).astype(np.int64)
                if len(node.inputs) > 4 and node.inputs[4]
                else np.ones(starts.size, np.int64)
            )
        else:  # opset <10: attribute form
            starts = np.asarray(_attr(node, "starts"), np.int64)
            ends = np.asarray(_attr(node, "ends"), np.int64)
            axes = np.asarray(_attr(node, "axes", list(range(starts.size))), np.int64)
            steps = np.ones(starts.size, np.int64)
        slices = [slice(None)] * data.ndim
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            ax = int(ax) % data.ndim
            big = np.iinfo(np.int64).max // 2
            en = int(np.clip(en, -big, big))
            if int(sp) < 1 and isinstance(data, torch.Tensor):
                raise NotImplementedError("Slice with a negative step on a runtime tensor")
            slices[ax] = slice(int(st), en, int(sp))
        return data[tuple(slices)]

    # -- graph walk -----------------------------------------------------------

    @torch.no_grad()
    def __call__(self, feeds: dict[str, Any]) -> dict[str, Any]:
        env: dict[str, Any] = dict(self.constants)
        for name in self.input_names:
            if name not in feeds:
                raise KeyError(f"missing graph input '{name}'")
        env.update({name: torch.as_tensor(v).to(self.device) for name, v in feeds.items()})
        tensor = self._tensor

        for node in self.nodes:
            op = node.op_type
            ins = node.inputs
            if op == "Conv":
                result = self._op_conv(node, env)
            elif op == "ConvTranspose":
                result = self._op_conv_transpose(node, env)
            elif op == "BatchNormalization":
                result = self._op_batch_norm(node, env)
            elif op == "Relu":
                result = torch.relu(tensor(env, ins[0]))
            elif op == "LeakyRelu":
                result = F.leaky_relu(tensor(env, ins[0]), float(_attr(node, "alpha", 0.01)))
            elif op == "Sigmoid":
                result = torch.sigmoid(tensor(env, ins[0]))
            elif op == "Tanh":
                result = torch.tanh(tensor(env, ins[0]))
            elif op == "Elu":
                result = F.elu(tensor(env, ins[0]), float(_attr(node, "alpha", 1.0)))
            elif op == "Add":
                result = self._binary(node, env, np.add, torch.add)
            elif op == "Sub":
                result = self._binary(node, env, np.subtract, torch.sub)
            elif op == "Mul":
                result = self._binary(node, env, np.multiply, torch.mul)
            elif op == "Div":
                result = self._binary(node, env, np.divide, torch.div)
            elif op == "Sqrt":
                result = torch.sqrt(tensor(env, ins[0]))
            elif op == "Exp":
                result = torch.exp(tensor(env, ins[0]))
            elif op == "Log":
                result = torch.log(tensor(env, ins[0]))
            elif op == "Concat":
                axis = int(_attr(node, "axis", 1))
                if all(isinstance(env[i], np.ndarray) for i in ins):
                    result = np.concatenate([env[i] for i in ins], axis=axis)  # shape plumbing
                else:
                    result = torch.cat([tensor(env, i) for i in ins], dim=axis)
            elif op in ("AveragePool", "MaxPool"):
                result = self._op_pool(node, env, "max" if op == "MaxPool" else "avg")
            elif op == "GlobalAveragePool":
                result = tensor(env, ins[0]).mean(dim=(2, 3), keepdim=True)
            elif op == "Transpose":
                result = tensor(env, ins[0]).permute(*_attr(node, "perm"))
            elif op in ("Identity", "Cast", "Dropout"):
                result = env[ins[0]]
                if op == "Cast":
                    to = np.dtype(_ONNX_DTYPES.get(int(_attr(node, "to", 1)), np.float32))
                    if isinstance(result, np.ndarray):
                        result = result.astype(to)
                    else:
                        result = result.to(torch.from_numpy(np.zeros(0, to)).dtype)
            elif op == "Clip":
                # Opset-11+ passes min/max as optional inputs (either may be
                # an empty name); earlier opsets use attributes.
                lo = env[ins[1]] if len(ins) > 1 and ins[1] else _attr(node, "min", None)
                hi = env[ins[2]] if len(ins) > 2 and ins[2] else _attr(node, "max", None)
                lo = None if lo is None else float(np.asarray(lo).reshape(()))
                hi = None if hi is None else float(np.asarray(hi).reshape(()))
                x = tensor(env, ins[0])
                result = x if lo is None and hi is None else torch.clamp(x, lo, hi)
            elif op == "Pad":
                result = self._op_pad(node, env)
            elif op == "Reshape":
                shape = np.asarray(env[ins[1]]).astype(int).tolist()
                x = env[ins[0]]
                shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
                result = x.reshape(shape)
            elif op == "Flatten":
                x = tensor(env, ins[0])
                axis = int(_attr(node, "axis", 1))
                result = x.reshape(int(np.prod(x.shape[:axis])), -1)
            elif op == "Squeeze":
                axes = _attr(node, "axes")
                if axes is None and len(ins) > 1:
                    axes = np.asarray(env[ins[1]]).astype(int).tolist()
                x = tensor(env, ins[0])
                result = x.squeeze(tuple(axes)) if axes else x.squeeze()
            elif op == "Unsqueeze":
                axes = _attr(node, "axes")
                if axes is None and len(ins) > 1:
                    axes = np.asarray(env[ins[1]]).astype(int).tolist()
                x = env[ins[0]]
                if isinstance(x, np.ndarray):
                    result = np.expand_dims(x, axis=tuple(axes))
                else:
                    result = x
                    for axis in sorted(a % (x.ndim + len(axes)) for a in axes):
                        result = result.unsqueeze(axis)
            elif op == "Resize":
                result = self._op_resize(node, env)
            elif op == "Shape":
                # Host constant (numpy): tf2onnx shape plumbing (Gather/Slice/
                # Concat/Reshape over this) is evaluated on the host.
                result = np.asarray(env[ins[0]].shape, np.int64)
            elif op == "MatMul":
                result = torch.matmul(tensor(env, ins[0]), tensor(env, ins[1]))
            elif op == "Gather":
                data = env[ins[0]]
                indices = np.asarray(env[ins[1]])
                axis = int(_attr(node, "axis", 0))
                if isinstance(data, np.ndarray):
                    result = np.take(data, indices, axis=axis)  # shape plumbing
                else:
                    axis %= data.ndim
                    flat = torch.as_tensor(
                        indices.reshape(-1) % data.shape[axis], device=data.device
                    ).to(torch.int64)
                    result = data.index_select(axis, flat).reshape(
                        *data.shape[:axis], *indices.shape, *data.shape[axis + 1:]
                    )
            elif op == "Slice":
                result = self._op_slice(node, env)
            elif op == "ConstantOfShape":
                shape = [int(v) for v in np.asarray(env[ins[0]])]
                fill = _attr(node, "value", None)
                value = float(np.asarray(fill).ravel()[0]) if fill is not None else 0.0
                result = torch.full(shape, value, dtype=torch.float32, device=self.device)
            elif op == "Gemm":
                a = tensor(env, ins[0])
                b = tensor(env, ins[1])
                if _attr(node, "transA", 0):
                    a = a.T
                if _attr(node, "transB", 0):
                    b = b.T
                result = _attr(node, "alpha", 1.0) * torch.matmul(a, b)
                if len(ins) > 2:
                    result = result + _attr(node, "beta", 1.0) * tensor(env, ins[2])
            else:
                raise NotImplementedError(
                    f"ONNX op '{op}' (node '{node.name}') is not supported by the "
                    "torch executor"
                )
            for out_name in node.outputs:
                if out_name:
                    env[out_name] = result

        return {name: self._tensor(env, name) for name in self.output_names}
