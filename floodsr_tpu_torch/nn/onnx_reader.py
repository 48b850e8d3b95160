"""Dependency-free ONNX model reader (protobuf wire-format parser).

The ``onnx`` package is not available in this stack; this module parses the
ONNX protobuf container directly (stable wire format, field numbers from the
onnx.proto3 spec) into plain Python structures:

- :func:`load_model` → ``OnnxModel`` with graph nodes, initializers (numpy
  arrays), and typed inputs/outputs.

Own copy of the JAX package's ``nn/onnx_reader.py`` (numpy only). Together
with :mod:`floodsr_tpu_torch.nn.onnx_exec` this lets the reference's released
``model_infer.onnx`` (reference: ``floodsr/models.json:5``) run under PyTorch
on the GPU, and feeds the converter (:mod:`floodsr_tpu_torch.nn.onnx_convert`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator

import numpy as np

# protobuf wire types
_VARINT = 0
_FIXED64 = 1
_LENGTH = 2
_FIXED32 = 5

# ONNX TensorProto.DataType → numpy dtype
_ONNX_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _iter_fields(data: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a message's bytes."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        fnum = key >> 3
        wtype = key & 7
        if wtype == _VARINT:
            value, pos = _read_varint(data, pos)
        elif wtype == _FIXED64:
            value = data[pos : pos + 8]
            pos += 8
        elif wtype == _LENGTH:
            length, pos = _read_varint(data, pos)
            value = data[pos : pos + length]
            pos += length
        elif wtype == _FIXED32:
            value = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} for field {fnum}")
        yield fnum, wtype, value


def _zigzag(v: int) -> int:
    # ONNX int64 fields are plain varints (not zigzag); negatives come as
    # 64-bit two's complement varints.
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(data: bytes) -> list[int]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        out.append(_zigzag(v))
    return out


@dataclass
class OnnxTensor:
    name: str
    array: np.ndarray


@dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: list[str]
    outputs: list[str]
    attributes: dict[str, Any]


@dataclass
class OnnxValueInfo:
    name: str
    dtype: int | None = None
    shape: list[int | str | None] = field(default_factory=list)


@dataclass
class OnnxModel:
    ir_version: int
    producer: str
    opset: int
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[OnnxValueInfo]
    outputs: list[OnnxValueInfo]

    @property
    def graph_inputs(self) -> list[OnnxValueInfo]:
        """Graph inputs that are not initializer-backed (true feeds)."""
        return [vi for vi in self.inputs if vi.name not in self.initializers]


def _parse_tensor(data: bytes) -> OnnxTensor:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw: bytes | None = None
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    double_data: list[float] = []
    for fnum, wtype, value in _iter_fields(data):
        if fnum == 1:  # dims
            if wtype == _VARINT:
                dims.append(_zigzag(value))
            else:
                dims.extend(_packed_varints(value))
        elif fnum == 2:
            data_type = value
        elif fnum == 4:  # float_data
            if wtype == _LENGTH:
                float_data.extend(np.frombuffer(value, "<f4").tolist())
            else:
                float_data.append(np.frombuffer(value, "<f4")[0])
        elif fnum == 5:  # int32_data
            if wtype == _VARINT:
                int32_data.append(_zigzag(value))
            else:
                int32_data.extend(_packed_varints(value))
        elif fnum == 7:  # int64_data
            if wtype == _VARINT:
                int64_data.append(_zigzag(value))
            else:
                int64_data.extend(_packed_varints(value))
        elif fnum == 8:
            name = value.decode("utf-8")
        elif fnum == 9:
            raw = bytes(value)
        elif fnum == 11:  # double_data
            if wtype == _LENGTH:
                double_data.extend(np.frombuffer(value, "<f8").tolist())
            else:
                double_data.append(np.frombuffer(value, "<f8")[0])
    dtype = _ONNX_DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"unsupported ONNX tensor dtype {data_type} for '{name}'")
    shape = tuple(int(d) for d in dims)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<")).reshape(shape)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype).reshape(shape)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=dtype).reshape(shape)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=dtype).reshape(shape)
    elif double_data:
        arr = np.asarray(double_data, dtype=dtype).reshape(shape)
    else:
        arr = np.zeros(shape, dtype=dtype)
    return OnnxTensor(name=name, array=np.asarray(arr))


def _parse_attribute(data: bytes) -> tuple[str, Any]:
    name = ""
    atype = 0
    f_val = None
    i_val = None
    s_val = None
    t_val = None
    floats: list[float] = []
    ints: list[int] = []
    strings: list[bytes] = []
    for fnum, wtype, value in _iter_fields(data):
        if fnum == 1:
            name = value.decode("utf-8")
        elif fnum == 20:
            atype = value
        elif fnum == 2:
            f_val = np.frombuffer(value, "<f4")[0] if wtype == _FIXED32 else value
        elif fnum == 3:
            i_val = _zigzag(value)
        elif fnum == 4:
            s_val = bytes(value)
        elif fnum == 5:
            t_val = _parse_tensor(value)
        elif fnum == 7:
            if wtype == _LENGTH:
                floats.extend(np.frombuffer(value, "<f4").tolist())
            else:
                floats.append(np.frombuffer(value, "<f4")[0])
        elif fnum == 8:
            if wtype == _VARINT:
                ints.append(_zigzag(value))
            else:
                ints.extend(_packed_varints(value))
        elif fnum == 9:
            strings.append(bytes(value))
    # AttributeType: 1 FLOAT, 2 INT, 3 STRING, 4 TENSOR, 6 FLOATS, 7 INTS, 8 STRINGS
    if atype == 1:
        return name, float(f_val)
    if atype == 2:
        return name, int(i_val)
    if atype == 3:
        return name, s_val.decode("utf-8", "replace")
    if atype == 4:
        return name, t_val.array if t_val is not None else None
    if atype == 6:
        return name, [float(x) for x in floats]
    if atype == 7:
        return name, [int(x) for x in ints]
    if atype == 8:
        return name, [s.decode("utf-8", "replace") for s in strings]
    # Untyped (legacy exporters): best-effort priority.
    for candidate in (i_val, f_val, s_val):
        if candidate is not None:
            return name, candidate
    if ints:
        return name, ints
    if floats:
        return name, floats
    return name, t_val.array if t_val is not None else None


def _parse_node(data: bytes) -> OnnxNode:
    inputs: list[str] = []
    outputs: list[str] = []
    name = ""
    op_type = ""
    attributes: dict[str, Any] = {}
    for fnum, _wtype, value in _iter_fields(data):
        if fnum == 1:
            inputs.append(value.decode("utf-8"))
        elif fnum == 2:
            outputs.append(value.decode("utf-8"))
        elif fnum == 3:
            name = value.decode("utf-8")
        elif fnum == 4:
            op_type = value.decode("utf-8")
        elif fnum == 5:
            key, attr_value = _parse_attribute(value)
            attributes[key] = attr_value
    return OnnxNode(op_type=op_type, name=name, inputs=inputs, outputs=outputs, attributes=attributes)


def _parse_value_info(data: bytes) -> OnnxValueInfo:
    name = ""
    dtype = None
    shape: list[int | str | None] = []
    for fnum, _wtype, value in _iter_fields(data):
        if fnum == 1:
            name = value.decode("utf-8")
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(value):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 1:
                            dtype = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dim_value: int | str | None = None
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim_value = _zigzag(v5)
                                        elif f5 == 2:
                                            dim_value = v5.decode("utf-8")
                                    shape.append(dim_value)
    return OnnxValueInfo(name=name, dtype=dtype, shape=shape)


def _parse_graph(data: bytes) -> tuple[list[OnnxNode], dict[str, np.ndarray], list, list]:
    nodes: list[OnnxNode] = []
    initializers: dict[str, np.ndarray] = {}
    inputs: list[OnnxValueInfo] = []
    outputs: list[OnnxValueInfo] = []
    for fnum, _wtype, value in _iter_fields(data):
        if fnum == 1:
            nodes.append(_parse_node(value))
        elif fnum == 5:
            tensor = _parse_tensor(value)
            initializers[tensor.name] = tensor.array
        elif fnum == 11:
            inputs.append(_parse_value_info(value))
        elif fnum == 12:
            outputs.append(_parse_value_info(value))
    return nodes, initializers, inputs, outputs


def load_model(fp: str | Path | bytes) -> OnnxModel:
    """Parse an ONNX file (or raw bytes) into an :class:`OnnxModel`."""
    if isinstance(fp, (str, Path)):
        data = Path(fp).expanduser().read_bytes()
    else:
        data = fp
    ir_version = 0
    producer = ""
    opset = 0
    graph_bytes = None
    for fnum, _wtype, value in _iter_fields(data):
        if fnum == 1:
            ir_version = value
        elif fnum == 2:
            producer = value.decode("utf-8", "replace")
        elif fnum == 7:
            graph_bytes = value
        elif fnum == 8:  # OperatorSetIdProto
            for f2, _w2, v2 in _iter_fields(value):
                if f2 == 2:
                    opset = max(opset, int(v2))
    if graph_bytes is None:
        raise ValueError("not an ONNX model: no graph found")
    nodes, initializers, inputs, outputs = _parse_graph(graph_bytes)
    return OnnxModel(
        ir_version=int(ir_version),
        producer=producer,
        opset=int(opset),
        nodes=nodes,
        initializers=initializers,
        inputs=inputs,
        outputs=outputs,
    )


def count_parameters(model: OnnxModel) -> int:
    """Total initializer element count (the reference reports 12,045,568)."""
    return int(sum(arr.size for arr in model.initializers.values()))
