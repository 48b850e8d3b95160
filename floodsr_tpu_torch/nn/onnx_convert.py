"""ONNX → native ``.fsrz`` conversion, and the runtime of the converted graph.

Port of the JAX package's ``nn/onnx_convert.py``. The reference ships weights
as a tf2onnx export (``floodsr/models.json``; NCHW compute wrapped in
Transposes, separate BatchNormalization nodes, shape-plumbing around the
dynamic batch dim). Running that through the generic graph interpreter works
(``nn/onnx_exec.py``) but keeps the export's artifacts. Conversion compiles
the graph ONCE into a layout-free IR and stores it in the standard ``.fsrz``
artifact:

- every rank-4 tensor lives physically in NHWC; Transpose nodes that merely
  flip NHWC↔NCHW become layout RE-TAGS and vanish (axis attributes of
  downstream ops are remapped instead);
- tf2onnx batch plumbing (Shape/Gather/Slice/Unsqueeze/Concat/Cast feeding
  Reshape) is constant-folded at convert time against the static spatial
  dims with a symbolic batch; identity reshapes vanish;
- inference BatchNormalization folds to a per-channel affine, and an affine
  directly consuming a conv/conv-transpose output folds into its weights;
- ConvTranspose is pre-lowered to its input-dilated-conv form (flipped HWIO
  kernel + computed pads, ``lhs_dilation`` = the strides), the form the JAX
  package executes; :class:`GraphProgram` maps such an op back to
  ``F.conv_transpose2d`` once, when it lays the weights out;
- weights are a flat dict of named arrays, stored in sorted-key order, so an
  artifact written by either package loads in both.

The converter (:class:`_Converter`) is numpy and Python, copied; the runtime
(:class:`GraphProgram`, :func:`graph_apply`) is torch on an explicit device.
The op coverage targets convolutional SR graphs (the reference family);
anything else raises ``NotImplementedError`` with the node name.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from floodsr_tpu_torch.nn.onnx_exec import conv_transpose_padded, pad_hw
from floodsr_tpu_torch.nn.onnx_reader import OnnxModel, load_model
from floodsr_tpu_torch.nn.resunet import ResUNetConfig, bf16_products

GRAPH_ARCHITECTURE = "onnx-graph"

# NCHW axis -> NHWC axis (for remapping axis attributes of layout-tagged ops)
_NCHW_TO_NHWC_AXIS = {0: 0, 1: 3, 2: 1, 3: 2}


@dataclasses.dataclass
class _Val:
    """Abstract value during conversion."""

    name: str                       # runtime tensor name (IR edge)
    shape: tuple | None             # logical ONNX shape; batch dim is None
    layout: str | None              # "NCHW"/"NHWC" for rank-4, else None
    const: np.ndarray | None = None  # set when fully known at convert time
    shape_vec: list | None = None    # set for 1-D shape-like values (None=batch)


def _attr(node, name, default=None):
    return node.attributes.get(name, default)


def _conv_pads(node, kernel, strides, in_hw, dilations):
    auto_pad = _attr(node, "auto_pad", "NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        pads = []
        for d in range(2):
            eff_k = (kernel[d] - 1) * dilations[d] + 1
            out = -(-in_hw[d] // strides[d])
            total = max(0, (out - 1) * strides[d] + eff_k - in_hw[d])
            lo = total // 2
            hi = total - lo
            pads.append((hi, lo) if auto_pad == "SAME_LOWER" else (lo, hi))
        return pads
    if auto_pad == "VALID":
        return [(0, 0), (0, 0)]
    raw = _attr(node, "pads", [0, 0, 0, 0])
    return [(int(raw[0]), int(raw[2])), (int(raw[1]), int(raw[3]))]


class _Converter:
    def __init__(self, model: OnnxModel):
        self.model = model
        self.ir: list[dict] = []
        self.weights: dict[str, np.ndarray] = {}
        self.env: dict[str, _Val] = {}
        self.consumers: dict[str, int] = {}
        for node in model.nodes:
            for i in node.inputs:
                if i:
                    self.consumers[i] = self.consumers.get(i, 0) + 1

    # -- helpers -------------------------------------------------------------

    def _weight(self, base: str, arr: np.ndarray) -> str:
        key = base
        n = 0
        while key in self.weights:
            n += 1
            key = f"{base}_{n}"
        self.weights[key] = np.asarray(arr)
        return key

    def _const_of(self, name: str) -> np.ndarray | None:
        v = self.env.get(name)
        if v is None:
            return None
        if v.const is not None:
            return v.const
        if v.shape_vec is not None and all(d is not None for d in v.shape_vec):
            return np.asarray(v.shape_vec, np.int64)
        return None

    def _emit(self, op: dict) -> None:
        self.ir.append(op)

    def _phys_axis(self, val: _Val, onnx_axis: int) -> int:
        if val.layout == "NCHW":
            return _NCHW_TO_NHWC_AXIS[onnx_axis % 4]
        return onnx_axis

    # -- conversion ----------------------------------------------------------

    def run(self) -> None:
        model = self.model
        for vi in model.graph_inputs:
            dims = tuple(d if isinstance(d, int) and d > 0 else None for d in vi.shape)
            assert len(dims) == 4, f"graph input {vi.name} must be rank-4 NHWC"
            self.env[vi.name] = _Val(vi.name, dims, "NHWC")
        for name, arr in model.initializers.items():
            self.env[name] = _Val(name, tuple(arr.shape), None, const=np.asarray(arr))

        for node in model.nodes:
            self._convert_node(node)

    def _convert_node(self, node) -> None:
        op = node.op_type
        handler = getattr(self, f"_op_{op.lower()}", None)
        if handler is None:
            raise NotImplementedError(
                f"ONNX op '{op}' (node '{node.name}') is not supported by the "
                "fsrz converter"
            )
        handler(node)

    def _in(self, node, i=0) -> _Val:
        return self.env[node.inputs[i]]

    def _out_tensor(self, node, shape, layout, i=0) -> _Val:
        val = _Val(node.outputs[i], shape, layout)
        self.env[node.outputs[i]] = val
        return val

    # --- layout / plumbing ops (vanish at convert time) ----------------------

    def _op_transpose(self, node) -> None:
        x = self._in(node)
        perm = tuple(_attr(node, "perm"))
        if x.const is not None:
            self.env[node.outputs[0]] = _Val(
                node.outputs[0], None, None, const=np.transpose(x.const, perm)
            )
            return
        if perm == (0, 3, 1, 2):  # NHWC -> NCHW view
            assert x.layout == "NHWC", f"unexpected layout for {node.name}: {x.layout}"
            shape = (x.shape[0], x.shape[3], x.shape[1], x.shape[2])
            self.env[node.outputs[0]] = _Val(x.name, shape, "NCHW")
        elif perm == (0, 2, 3, 1):  # NCHW -> NHWC view
            assert x.layout == "NCHW", f"unexpected layout for {node.name}: {x.layout}"
            shape = (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
            self.env[node.outputs[0]] = _Val(x.name, shape, "NHWC")
        else:
            raise NotImplementedError(
                f"Transpose perm {perm} (node '{node.name}') is not a layout flip"
            )

    def _op_shape(self, node) -> None:
        x = self._in(node)
        self.env[node.outputs[0]] = _Val(
            node.outputs[0], (len(x.shape),), None, shape_vec=list(x.shape)
        )

    def _op_gather(self, node) -> None:
        x = self._in(node)
        idx = self._const_of(node.inputs[1])
        assert idx is not None, f"Gather indices must be constant ({node.name})"
        if x.shape_vec is not None:
            taken = [x.shape_vec[int(i)] for i in np.atleast_1d(idx)]
            self.env[node.outputs[0]] = _Val(
                node.outputs[0], (len(taken),), None, shape_vec=taken
            )
            return
        if x.const is not None:
            arr = np.take(x.const, idx, axis=int(_attr(node, "axis", 0)))
            self.env[node.outputs[0]] = _Val(node.outputs[0], None, None, const=arr)
            return
        raise NotImplementedError(f"Gather on runtime tensors ({node.name})")

    def _op_slice(self, node) -> None:
        x = self._in(node)
        starts = self._const_of(node.inputs[1]) if len(node.inputs) > 1 else np.asarray(
            _attr(node, "starts"), np.int64
        )
        ends = self._const_of(node.inputs[2]) if len(node.inputs) > 2 else np.asarray(
            _attr(node, "ends"), np.int64
        )
        if x.shape_vec is not None:
            s, e = int(starts[0]), int(ends[0])
            self.env[node.outputs[0]] = _Val(
                node.outputs[0], None, None, shape_vec=x.shape_vec[s:e]
            )
            return
        if x.const is not None:
            self.env[node.outputs[0]] = _Val(
                node.outputs[0], None, None, const=x.const[int(starts[0]):int(ends[0])]
            )
            return
        raise NotImplementedError(f"Slice on runtime tensors ({node.name})")

    def _op_unsqueeze(self, node) -> None:
        x = self._in(node)
        if x.shape_vec is not None:
            self.env[node.outputs[0]] = _Val(
                node.outputs[0], None, None, shape_vec=list(x.shape_vec)
            )
            return
        if x.const is not None:
            self.env[node.outputs[0]] = _Val(
                node.outputs[0], None, None, const=np.atleast_1d(x.const)
            )
            return
        raise NotImplementedError(f"Unsqueeze on runtime tensors ({node.name})")

    def _op_cast(self, node) -> None:
        x = self._in(node)
        self.env[node.outputs[0]] = dataclasses.replace(x)

    def _op_identity(self, node) -> None:
        self.env[node.outputs[0]] = dataclasses.replace(self._in(node))

    def _op_dropout(self, node) -> None:
        self.env[node.outputs[0]] = dataclasses.replace(self._in(node))

    def _op_reshape(self, node) -> None:
        x = self._in(node)
        target = self.env[node.inputs[1]]
        vec = target.shape_vec if target.shape_vec is not None else (
            list(target.const) if target.const is not None else None
        )
        assert vec is not None, f"Reshape target must be convert-time known ({node.name})"
        norm = [None if (d is None or int(d) in (0, -1)) else int(d) for d in vec]
        logical = list(x.shape)
        same = len(norm) == len(logical) and all(
            (a is None or b is None or a == b) for a, b in zip(norm, logical)
        )
        if same:
            self.env[node.outputs[0]] = dataclasses.replace(x)
            return
        raise NotImplementedError(
            f"non-identity Reshape {logical} -> {norm} (node '{node.name}')"
        )

    def _op_concat(self, node) -> None:
        vals = [self.env[i] for i in node.inputs]
        if all(v.shape_vec is not None or v.const is not None for v in vals):
            merged: list = []
            for v in vals:
                merged.extend(v.shape_vec if v.shape_vec is not None else [int(t) for t in v.const])
            self.env[node.outputs[0]] = _Val(
                node.outputs[0], None, None, shape_vec=merged
            )
            return
        x = vals[0]
        axis = self._phys_axis(x, int(_attr(node, "axis", 1)))
        onnx_axis = int(_attr(node, "axis", 1))
        ch = sum(v.shape[onnx_axis] for v in vals)
        shape = list(x.shape)
        shape[onnx_axis] = ch
        out = self._out_tensor(node, tuple(shape), x.layout)
        self._emit({"op": "concat", "ins": [v.name for v in vals], "out": out.name, "axis": axis})

    # --- compute ops ----------------------------------------------------------

    def _op_conv(self, node) -> None:
        x = self._in(node)
        assert x.layout == "NCHW", f"Conv input must be NCHW-tagged ({node.name})"
        w = self.env[node.inputs[1]].const
        assert w is not None, f"Conv weight must be an initializer ({node.name})"
        b = self.env[node.inputs[2]].const if len(node.inputs) > 2 else None
        strides = tuple(int(v) for v in _attr(node, "strides", [1, 1]))
        dilations = tuple(int(v) for v in _attr(node, "dilations", [1, 1]))
        assert int(_attr(node, "group", 1)) == 1, "grouped Conv is not supported"
        kernel = (int(w.shape[2]), int(w.shape[3]))
        in_hw = (x.shape[2], x.shape[3])
        pads = _conv_pads(node, kernel, strides, in_hw, dilations)
        out_hw = tuple(
            (in_hw[d] + pads[d][0] + pads[d][1] - ((kernel[d] - 1) * dilations[d] + 1))
            // strides[d] + 1
            for d in range(2)
        )
        cout = int(w.shape[0])
        wkey = self._weight(node.outputs[0] + ".w", np.transpose(w, (2, 3, 1, 0)))  # HWIO
        bkey = self._weight(node.outputs[0] + ".b", b if b is not None else np.zeros(cout, np.float32))
        out = self._out_tensor(node, (x.shape[0], cout, out_hw[0], out_hw[1]), "NCHW")
        self._emit({
            "op": "conv", "in": x.name, "out": out.name, "w": wkey, "b": bkey,
            "strides": list(strides), "pads": [list(p) for p in pads],
            "dilations": list(dilations), "lhs_dilation": [1, 1],
        })

    def _op_convtranspose(self, node) -> None:
        x = self._in(node)
        assert x.layout == "NCHW", f"ConvTranspose input must be NCHW-tagged ({node.name})"
        w = self.env[node.inputs[1]].const  # [Cin, Cout, kH, kW]
        assert w is not None
        b = self.env[node.inputs[2]].const if len(node.inputs) > 2 else None
        strides = tuple(int(v) for v in _attr(node, "strides", [1, 1]))
        dilations = tuple(int(v) for v in _attr(node, "dilations", [1, 1]))
        assert int(_attr(node, "group", 1)) == 1, "grouped ConvTranspose unsupported"
        kernel = (int(w.shape[2]), int(w.shape[3]))
        output_padding = tuple(_attr(node, "output_padding", [0, 0]))
        auto_pad = _attr(node, "auto_pad", "NOTSET")
        if isinstance(auto_pad, bytes):
            auto_pad = auto_pad.decode()
        in_hw = (x.shape[2], x.shape[3])
        if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            out_hw = tuple(in_hw[d] * strides[d] for d in range(2))
            pads = []
            for d in range(2):
                total = (in_hw[d] - 1) * strides[d] + ((kernel[d] - 1) * dilations[d] + 1) - out_hw[d]
                lo = total // 2
                hi = total - lo
                pads.append((hi, lo) if auto_pad == "SAME_LOWER" else (lo, hi))
        else:
            raw = _attr(node, "pads", [0, 0, 0, 0])
            pads = [(int(raw[0]), int(raw[2])), (int(raw[1]), int(raw[3]))]
            pads = [(p[0], p[1] - output_padding[d]) for d, p in enumerate(pads)]
            out_hw = tuple(
                (in_hw[d] - 1) * strides[d] + ((kernel[d] - 1) * dilations[d] + 1)
                - pads[d][0] - pads[d][1]
                for d in range(2)
            )
        # Pre-lower: flipped kernel, HWIO, input dilation = strides.
        w_flip = np.flip(w, axis=(2, 3))
        w_hwio = np.transpose(w_flip, (2, 3, 0, 1))  # [kH, kW, Cin, Cout]
        conv_pads = []
        for d in range(2):
            eff_k = (kernel[d] - 1) * dilations[d] + 1
            conv_pads.append((eff_k - 1 - pads[d][0], eff_k - 1 - pads[d][1]))
        cout = int(w.shape[1])
        wkey = self._weight(node.outputs[0] + ".w", w_hwio)
        bkey = self._weight(node.outputs[0] + ".b", b if b is not None else np.zeros(cout, np.float32))
        out = self._out_tensor(node, (x.shape[0], cout, out_hw[0], out_hw[1]), "NCHW")
        self._emit({
            "op": "conv", "in": x.name, "out": out.name, "w": wkey, "b": bkey,
            "strides": [1, 1], "pads": [list(p) for p in conv_pads],
            "dilations": list(dilations), "lhs_dilation": list(strides),
        })

    def _op_batchnormalization(self, node) -> None:
        x = self._in(node)
        scale, offset, mean, var = (self.env[n].const for n in node.inputs[1:5])
        eps = float(_attr(node, "epsilon", 1e-5))
        inv = (scale / np.sqrt(var + eps)).astype(np.float32)
        a = inv
        c = (offset - mean * inv).astype(np.float32)
        # Fold into an immediately preceding conv when it has one consumer.
        prev = self.ir[-1] if self.ir else None
        if (
            prev is not None
            and prev.get("op") == "conv"
            and prev["out"] == x.name
            and self.consumers.get(x.name, 0) == 1
        ):
            self.weights[prev["w"]] = (self.weights[prev["w"]] * a[None, None, None, :]).astype(np.float32)
            self.weights[prev["b"]] = (self.weights[prev["b"]] * a + c).astype(np.float32)
            prev["out"] = node.outputs[0]
            self.env[node.outputs[0]] = _Val(node.outputs[0], x.shape, x.layout)
            return
        akey = self._weight(node.outputs[0] + ".a", a)
        ckey = self._weight(node.outputs[0] + ".c", c)
        out = self._out_tensor(node, x.shape, x.layout)
        self._emit({"op": "affine", "in": x.name, "out": out.name, "a": akey, "c": ckey})

    def _unary(self, node, kind, **extra) -> None:
        x = self._in(node)
        out = self._out_tensor(node, x.shape, x.layout)
        self._emit({"op": kind, "in": x.name, "out": out.name, **extra})

    def _op_relu(self, node) -> None:
        self._unary(node, "relu")

    def _op_leakyrelu(self, node) -> None:
        self._unary(node, "leaky_relu", alpha=float(_attr(node, "alpha", 0.01)))

    def _op_sigmoid(self, node) -> None:
        self._unary(node, "sigmoid")

    def _op_tanh(self, node) -> None:
        self._unary(node, "tanh")

    def _binary(self, node, kind) -> None:
        a, b = self._in(node, 0), self._in(node, 1)
        if a.const is not None and b.const is not None:
            self.env[node.outputs[0]] = _Val(
                node.outputs[0], None, None,
                const={"add": np.add, "sub": np.subtract, "mul": np.multiply,
                       "div": np.divide}[kind](a.const, b.const),
            )
            return
        runtime, constv = (a, b) if b.const is not None else ((b, a) if a.const is not None else (a, b))
        if constv.const is not None:
            key = self._weight(node.outputs[0] + ".k", np.asarray(constv.const, np.float32))
            out = self._out_tensor(node, runtime.shape, runtime.layout)
            self._emit({
                "op": kind, "in": runtime.name, "out": out.name, "k": key,
                "swapped": runtime is b,
            })
            return
        assert a.layout == b.layout, f"{kind} layout mismatch ({node.name})"
        out = self._out_tensor(node, a.shape, a.layout)
        self._emit({"op": kind, "in": a.name, "in2": b.name, "out": out.name})

    def _op_add(self, node) -> None:
        self._binary(node, "add")

    def _op_sub(self, node) -> None:
        self._binary(node, "sub")

    def _op_mul(self, node) -> None:
        self._binary(node, "mul")

    def _op_div(self, node) -> None:
        self._binary(node, "div")

    def _pool(self, node, kind) -> None:
        x = self._in(node)
        assert x.layout == "NCHW", f"pool input must be NCHW-tagged ({node.name})"
        kernel = tuple(int(v) for v in _attr(node, "kernel_shape"))
        strides = tuple(int(v) for v in _attr(node, "strides", list(kernel)))
        pads = _conv_pads(node, kernel, strides, (x.shape[2], x.shape[3]), (1, 1))
        out_hw = tuple(
            (x.shape[2 + d] + pads[d][0] + pads[d][1] - kernel[d]) // strides[d] + 1
            for d in range(2)
        )
        out = self._out_tensor(node, (x.shape[0], x.shape[1], out_hw[0], out_hw[1]), "NCHW")
        self._emit({
            "op": kind, "in": x.name, "out": out.name,
            "kernel": list(kernel), "strides": list(strides),
            "pads": [list(p) for p in pads],
        })

    def _op_averagepool(self, node) -> None:
        self._pool(node, "avg_pool")

    def _op_maxpool(self, node) -> None:
        self._pool(node, "max_pool")

    def _op_clip(self, node) -> None:
        lo = self._const_of(node.inputs[1]) if len(node.inputs) > 1 and node.inputs[1] else _attr(node, "min", -np.inf)
        hi = self._const_of(node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2] else _attr(node, "max", np.inf)
        self._unary(node, "clip", lo=float(np.asarray(lo).ravel()[0]), hi=float(np.asarray(hi).ravel()[0]))


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor → its NCHW view (channels-last strides: no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class GraphProgram:
    """A converted NHWC graph IR with its weights laid out for torch, on one device.

    Built once per artifact: each ``conv`` weight goes from HWIO to the layout
    its torch call takes (OIHW for a convolution; for an op with
    ``lhs_dilation`` != 1, the pre-lowered ConvTranspose, the flip is undone and
    the weight becomes ``[Cin, Cout, kH, kW]`` for ``F.conv_transpose2d``, with
    the transposed convolution's own pads recovered from the dilated conv's).
    ``program(feeds, output_names, compute_dtype)`` executes it; activations
    stay NHWC between ops, convolutions see channels-last NCHW views.

    ``compute_dtype=torch.bfloat16`` applies to ``conv``, ``affine`` and the
    pools, as in the JAX package: bf16 operands, f32 accumulation, the f32
    bias added before the one rounding (the products run on operands upcast to
    f32, exact for bf16 values; see :mod:`floodsr_tpu_torch.nn.resunet`).
    """

    def __init__(self, ir: list[dict], weights: dict, device: "str | torch.device" = "cpu"):
        self.ir = ir
        self.device = torch.device(device)
        self.weights: dict[str, torch.Tensor] = {}
        self._cast: dict[tuple[str, torch.dtype], torch.Tensor] = {}
        transposed = {op["w"] for op in ir if op["op"] == "conv" and self._is_transposed(op)}
        conv_w = {op["w"] for op in ir if op["op"] == "conv"}
        for key, value in weights.items():
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value))  # a copy: the converter's are views
            t = value.to(self.device)
            if key in transposed:
                t = t.flip(0, 1).permute(2, 3, 0, 1)  # flipped HWIO → [Cin, Cout, kH, kW]
            elif key in conv_w:
                t = t.permute(3, 2, 0, 1)  # HWIO → OIHW
            self.weights[key] = t.contiguous()

    @staticmethod
    def _is_transposed(op: dict) -> bool:
        return tuple(op["lhs_dilation"]) != (1, 1)

    def _w(self, key: str, dtype: torch.dtype) -> torch.Tensor:
        """The weight rounded to ``dtype``; the rounded copy is kept."""
        w = self.weights[key]
        if w.dtype == dtype:
            return w
        cached = self._cast.get((key, dtype))
        if cached is None:
            cached = w.to(dtype)
            self._cast[(key, dtype)] = cached
        return cached

    def _conv(self, op: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        w = self._w(op["w"], dtype)
        if dtype == torch.bfloat16:
            x, w = x.to(torch.float32), w.to(torch.float32)
        dil = tuple(op["dilations"])
        if self._is_transposed(op):
            if tuple(op["strides"]) != (1, 1):
                raise NotImplementedError("a strided convolution with input dilation")
            # the dilated conv pads eff_k-1-p where the transposed conv crops p
            eff_k = [(int(w.shape[2 + d]) - 1) * dil[d] + 1 for d in range(2)]
            pads = [
                (eff_k[d] - 1 - int(op["pads"][d][0]), eff_k[d] - 1 - int(op["pads"][d][1]))
                for d in range(2)
            ]
            out = conv_transpose_padded(_nchw(x), w, op["lhs_dilation"], pads, dil)
        else:
            pads = [tuple(int(v) for v in p) for p in op["pads"]]
            out = F.conv2d(pad_hw(_nchw(x), pads), w, None, tuple(op["strides"]), 0, dil)
        return (_nhwc(out) + self.weights[op["b"]]).to(dtype)

    @torch.no_grad()
    def __call__(
        self, feeds: dict, output_names: list[str], compute_dtype: torch.dtype = torch.float32
    ) -> dict[str, torch.Tensor]:
        env: dict[str, torch.Tensor] = {
            k: torch.as_tensor(v).to(self.device) for k, v in feeds.items()
        }
        dtype = compute_dtype
        on_cuda = self.device.type == "cuda"
        for op in self.ir:
            kind = op["op"]
            if kind == "conv":
                with bf16_products(dtype == torch.bfloat16 and on_cuda):
                    env[op["out"]] = self._conv(op, env[op["in"]], dtype)
            elif kind == "affine":
                x = env[op["in"]]
                env[op["out"]] = (x * self._w(op["a"], dtype) + self._w(op["c"], dtype)).to(dtype)
            elif kind == "relu":
                env[op["out"]] = torch.relu(env[op["in"]])
            elif kind == "leaky_relu":
                env[op["out"]] = F.leaky_relu(env[op["in"]], op["alpha"])
            elif kind == "sigmoid":
                env[op["out"]] = torch.sigmoid(env[op["in"]])
            elif kind == "tanh":
                env[op["out"]] = torch.tanh(env[op["in"]])
            elif kind == "clip":
                env[op["out"]] = torch.clamp(env[op["in"]], op["lo"], op["hi"])
            elif kind == "concat":
                env[op["out"]] = torch.cat([env[n] for n in op["ins"]], dim=op["axis"])
            elif kind in ("add", "sub", "mul", "div"):
                a = env[op["in"]]
                b = env[op["in2"]] if "in2" in op else self._w(op["k"], dtype)
                if op.get("swapped"):
                    a, b = b, a
                fn = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div}[kind]
                env[op["out"]] = fn(a, b)
            elif kind == "avg_pool":
                x = _nchw(env[op["in"]].to(torch.float32))
                k = op["kernel"]
                pads = [tuple(int(v) for v in p) for p in op["pads"]]
                # the sum over the zero-padded window, over the full window's area
                out = F.avg_pool2d(pad_hw(x, pads), tuple(k), tuple(op["strides"]))
                env[op["out"]] = _nhwc(out).to(dtype)
            elif kind == "max_pool":
                x = _nchw(env[op["in"]])
                pads = [tuple(int(v) for v in p) for p in op["pads"]]
                out = F.max_pool2d(
                    pad_hw(x, pads, float("-inf")), tuple(op["kernel"]), tuple(op["strides"])
                )
                env[op["out"]] = _nhwc(out)
            else:
                raise NotImplementedError(f"graph IR op '{kind}'")
        return {name: env[name].to(torch.float32) for name in output_names}


def graph_apply(
    ir: list[dict],
    weights: dict,
    feeds: dict,
    output_names: list[str],
    compute_dtype: torch.dtype = torch.float32,
    device: "str | torch.device" = "cpu",
) -> dict[str, torch.Tensor]:
    """Execute a converted NHWC graph IR once (lays the weights out per call;
    an engine keeps a :class:`GraphProgram`)."""
    return GraphProgram(ir, weights, device)(feeds, output_names, compute_dtype)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def convert_onnx_to_fsrz(onnx_src: "str | Path | bytes", fsrz_fp: "str | Path") -> Path:
    """Compile an ONNX SR graph into a native ``.fsrz`` artifact.

    The artifact carries ``architecture: "onnx-graph"`` plus the NHWC IR in
    its manifest; weights live in the standard params payload. ``EngineTorch``
    and the JAX package's engine both load it like any other ``.fsrz``.
    """
    import json
    import zipfile

    from floodsr_tpu_torch.nn.checkpoint import (
        ARTIFACT_FORMAT,
        ARTIFACT_VERSION,
        _npz_bytes,
        _skeleton,
    )

    model = load_model(onnx_src)
    conv = _Converter(model)
    conv.run()

    inputs = {vi.name: vi for vi in model.graph_inputs}
    assert "depth_lr" in inputs and "dem_hr" in inputs, (
        "converter expects the reference I/O contract (depth_lr, dem_hr)"
    )
    out_vi = model.outputs[0]
    # Map graph output to the IR edge name (aliases collapse to source names).
    out_edge = conv.env[out_vi.name].name

    def hwc(vi):
        return [int(vi.shape[1]), int(vi.shape[2]), int(vi.shape[3])]

    depth_hwc = hwc(inputs["depth_lr"])
    dem_hwc = hwc(inputs["dem_hr"])
    scale = dem_hwc[0] // depth_hwc[0]
    config = ResUNetConfig(lr_tile=depth_hwc[0], scale=scale)

    manifest = {
        "format": ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "architecture": GRAPH_ARCHITECTURE,
        "config": config.to_dict(),
        "graph_ir": conv.ir,
        "graph_output_edge": out_edge,
        "io_contract": {
            "depth_input_name": "depth_lr",
            "dem_input_name": "dem_hr",
            "output_name": out_vi.name,
            "depth_lr_hwc": depth_hwc,
            "dem_hr_hwc": dem_hwc,
            "output_hwc": hwc(out_vi),
            "scale": scale,
        },
        "params_skeleton": _skeleton(conv.weights),
        "state_skeleton": _skeleton({}),
        "metadata": {
            "converted_from": "onnx",
            "onnx_opset": model.opset,
            "onnx_producer": model.producer,
            "onnx_param_count": int(sum(a.size for a in model.initializers.values())),
        },
    }
    # Leaves in sorted-key order: the order the skeleton numbers them in, and
    # the order the JAX package's tree flattening gives a flat dict.
    named = {
        f"leaf_{i:05d}": np.asarray(conv.weights[key])
        for i, key in enumerate(sorted(conv.weights))
    }

    path = Path(fsrz_fp).expanduser().resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest))
        zf.writestr("params.npz", _npz_bytes(named))
        zf.writestr("state.npz", _npz_bytes({}))
    return path
