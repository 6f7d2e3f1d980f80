"""Dependency-free ONNX emission (protobuf wire-format writer), a copy
of `ghost_tpu/convert/onnx_writer.py` (numpy only).

The reference exports its generator/recognizer to ONNX for the
inswapper-style deployment ecosystem (reference export-onnx.py:44-77).
Neither `onnx` nor `onnxruntime` is a dependency, so — mirroring
`onnx_reader` — models are serialized by writing the protobuf wire
format directly: ModelProto { ir_version, opset_import, graph } with
nodes, initializers and typed graph I/O (dynamic batch via dim_param).
The bytes equal the JAX package's writer's for the same calls.

Field numbers (onnx.proto), same map as the reader:
  ModelProto: ir_version=1 producer_name=2 graph=7 opset_import=8
  OperatorSetIdProto: domain=1 version=2
  GraphProto: node=1 name=2 initializer=5 input=11 output=12
  NodeProto: input=1 output=2 name=3 op_type=4 attribute=5
  AttributeProto: name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 type=20
    (type codes: FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6 INTS=7)
  TensorProto: dims=1 data_type=2 name=8 raw_data=9
  ValueInfoProto: name=1 type=2; TypeProto.tensor_type=1;
  TensorTypeProto: elem_type=1 shape=2; TensorShapeProto.dim=1;
  Dimension: dim_value=1 dim_param=2
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence, Union

import numpy as np

_NP_TO_ONNX = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4,
    np.dtype(np.int16): 5,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10,
    np.dtype(np.float64): 11,
}


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field."""
    return _tag(field, 2) + _varint(len(payload)) + payload


def _vi(field: int, v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's complement varint
    return _tag(field, 0) + _varint(v)


def _f32(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _NP_TO_ONNX:
        raise ValueError(f"tensor {name!r}: unsupported dtype {arr.dtype}")
    out = b"".join(_vi(1, int(d)) for d in arr.shape)
    out += _vi(2, _NP_TO_ONNX[arr.dtype])
    out += _ld(8, name.encode("utf-8"))
    out += _ld(9, arr.tobytes())
    return out


def _attribute_proto(name: str, value: Any) -> bytes:
    out = _ld(1, name.encode("utf-8"))
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, float):
        out += _f32(2, value) + _vi(20, 1)
    elif isinstance(value, int):
        out += _vi(3, value) + _vi(20, 2)
    elif isinstance(value, str):
        out += _ld(4, value.encode("utf-8")) + _vi(20, 3)
    elif isinstance(value, np.ndarray):
        out += _ld(5, _tensor_proto("", value)) + _vi(20, 4)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            packed = b"".join(_varint(int(v) + (1 << 64 if v < 0 else 0))
                              for v in value)
            out += _ld(8, packed) + _vi(20, 7)
        else:
            packed = struct.pack(f"<{len(value)}f",
                                 *[float(v) for v in value])
            out += _ld(7, packed) + _vi(20, 6)
    else:
        raise TypeError(f"attribute {name!r}: unsupported {type(value)}")
    return out


def _value_info(name: str, shape: Sequence[Union[int, str]],
                elem_type: int = 1) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _ld(1, _ld(2, d.encode("utf-8")))
        else:
            dims += _ld(1, _vi(1, int(d)))
    ttype = _vi(1, elem_type) + _ld(2, dims)
    return _ld(1, name.encode("utf-8")) + _ld(2, _ld(1, ttype))


class OnnxBuilder:
    """Accumulates nodes/initializers/IO; `serialize()` -> .onnx bytes.

    `node()` returns the (auto-named) output value name(s) so emitters
    read like a forward pass:
        y = b.node("Conv", [x, w], strides=[2, 2], pads=[1, 1, 1, 1])
    """

    def __init__(self, name: str = "ghost_tpu"):
        self.name = name
        self._nodes: List[bytes] = []
        self._inits: List[bytes] = []
        self._init_names: set = set()
        self._inputs: List[bytes] = []
        self._outputs: List[bytes] = []
        self._n = 0

    # ------------------------------------------------------------ values
    def fresh(self, hint: str = "v") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def initializer(self, arr: np.ndarray, name: str | None = None) -> str:
        name = name or self.fresh("w")
        if name in self._init_names:
            raise ValueError(f"duplicate initializer {name!r}")
        self._init_names.add(name)
        self._inits.append(_tensor_proto(name, np.asarray(arr)))
        return name

    def graph_input(self, name: str, shape: Sequence[Union[int, str]],
                    elem_type: int = 1) -> str:
        self._inputs.append(_value_info(name, shape, elem_type))
        return name

    def graph_output(self, name: str, shape: Sequence[Union[int, str]],
                     elem_type: int = 1) -> None:
        self._outputs.append(_value_info(name, shape, elem_type))

    # ------------------------------------------------------------- nodes
    def node(self, op_type: str, inputs: Sequence[str], n_out: int = 1,
             outputs: Sequence[str] | None = None,
             **attrs: Any) -> Union[str, List[str]]:
        outs = list(outputs) if outputs is not None else [
            self.fresh(op_type.lower()) for _ in range(n_out)]
        buf = b"".join(_ld(1, i.encode("utf-8")) for i in inputs)
        buf += b"".join(_ld(2, o.encode("utf-8")) for o in outs)
        buf += _ld(4, op_type.encode("utf-8"))
        for k, v in attrs.items():
            if v is not None:
                buf += _ld(5, _attribute_proto(k, v))
        self._nodes.append(buf)
        return outs[0] if len(outs) == 1 else outs

    # --------------------------------------------------------- serialize
    def serialize(self, opset: int = 13, ir_version: int = 8) -> bytes:
        graph = b"".join(_ld(1, n) for n in self._nodes)
        graph += _ld(2, self.name.encode("utf-8"))
        graph += b"".join(_ld(5, t) for t in self._inits)
        graph += b"".join(_ld(11, i) for i in self._inputs)
        graph += b"".join(_ld(12, o) for o in self._outputs)
        model = _vi(1, ir_version)
        model += _ld(2, b"ghost-tpu")
        model += _ld(7, graph)
        model += _ld(8, _ld(1, b"") + _vi(2, opset))
        return model


def save_onnx(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)
