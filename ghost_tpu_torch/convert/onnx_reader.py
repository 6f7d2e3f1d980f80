"""Dependency-free ONNX parsing (protobuf wire-format reader), a copy of
`ghost_tpu/convert/onnx_reader.py` (numpy only).

The reference ships its detector/recognizer/teacher as ONNX graphs
(scrfd_10g_bnkps.onnx, glintr100.onnx, inswapper_128.onnx — reference
download_models.sh:6-8, train.py:44), and neither `onnx` nor
`onnxruntime` is a dependency. ONNX files are protobuf; a small
wire-format walker extracts both the weights AND the graph topology,
which feeds the port's torch executor (`convert/onnx_exec.py`).

Field numbers (onnx.proto):
  ModelProto.graph        = 7  (GraphProto)
  GraphProto.node         = 1  (repeated NodeProto)
  GraphProto.initializer  = 5  (repeated TensorProto)
  GraphProto.input/output = 11/12 (ValueInfoProto; .name = 1)
  NodeProto: input=1 output=2 name=3 op_type=4 attribute=5
  AttributeProto: name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 strings=9
  TensorProto: dims=1 data_type=2 float_data=4 int32_data=5
               string_data=6 int64_data=7 name=8 raw_data=9
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

_DTYPE = {
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


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _signed(v: int) -> int:
    """Two's-complement interpretation of a 64-bit varint."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over one message's fields."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw = None
    floats: List[float] = []
    int64s: List[int] = []
    int32s: List[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 0:
            dims.append(_signed(int(val)))
        elif field == 1 and wire == 2:  # packed dims
            pos = 0
            while pos < len(val):
                d, pos = _read_varint(val, pos)
                dims.append(_signed(d))
        elif field == 2 and wire == 0:
            dtype_code = int(val)
        elif field == 4 and wire == 2:  # packed float_data
            floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 4 and wire == 5:
            floats.append(struct.unpack("<f", val)[0])
        elif field == 5 and wire == 2:  # packed int32_data
            pos = 0
            while pos < len(val):
                d, pos = _read_varint(val, pos)
                int32s.append(_signed(d))
        elif field == 5 and wire == 0:
            int32s.append(_signed(int(val)))
        elif field == 7 and wire == 2:  # packed int64_data
            pos = 0
            while pos < len(val):
                d, pos = _read_varint(val, pos)
                int64s.append(_signed(d))
        elif field == 7 and wire == 0:  # non-packed int64_data entry
            int64s.append(_signed(int(val)))
        elif field == 8 and wire == 2:
            name = val.decode("utf-8")
        elif field == 9 and wire == 2:
            raw = val
    if raw is not None:
        if dtype_code not in _DTYPE:
            raise ValueError(
                f"tensor {name!r}: unsupported ONNX data_type {dtype_code}")
        arr = np.frombuffer(raw, dtype=_DTYPE[dtype_code])
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    elif int32s:
        arr = np.asarray(int32s, np.int32)
    else:
        arr = np.zeros(0, _DTYPE.get(dtype_code, np.float32))
    if dims or arr.size == 1:
        # empty dims = ONNX scalar: reshape to () rather than (1,)
        arr = arr.reshape(dims)
    return name, arr


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]
    name: str = ""


@dataclasses.dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]   # graph inputs that are NOT initializers
    outputs: List[str]


def _parse_attribute(buf: bytes) -> Tuple[str, Any]:
    name = ""
    value: Any = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            name = val.decode("utf-8")
        elif field == 2 and wire == 5:  # f
            value = struct.unpack("<f", val)[0]
        elif field == 3 and wire == 0:  # i
            value = _signed(int(val))
        elif field == 4 and wire == 2:  # s
            value = val.decode("utf-8", errors="replace")
        elif field == 5 and wire == 2:  # t (TensorProto)
            value = _parse_tensor(val)[1]
        elif field == 7:  # floats
            if wire == 5:
                floats.append(struct.unpack("<f", val)[0])
            elif wire == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 8:  # ints
            if wire == 0:
                ints.append(_signed(int(val)))
            elif wire == 2:
                pos = 0
                while pos < len(val):
                    d, pos = _read_varint(val, pos)
                    ints.append(_signed(d))
        elif field == 9 and wire == 2:  # strings
            strings.append(val)
    if value is None:
        if floats:
            value = floats
        elif ints:
            value = ints
        elif strings:
            value = [s.decode("utf-8", errors="replace") for s in strings]
    return name, value


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", [], [], {}, "")
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            node.inputs.append(val.decode("utf-8"))
        elif field == 2 and wire == 2:
            node.outputs.append(val.decode("utf-8"))
        elif field == 3 and wire == 2:
            node.name = val.decode("utf-8")
        elif field == 4 and wire == 2:
            node.op_type = val.decode("utf-8")
        elif field == 5 and wire == 2:
            k, v = _parse_attribute(val)
            node.attrs[k] = v
    return node


def _value_info_name(buf: bytes) -> str:
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            return val.decode("utf-8")
    return ""


def read_onnx_graph(path: str) -> OnnxGraph:
    """Parse nodes + initializers + graph I/O from an .onnx file."""
    with open(path, "rb") as f:
        model = f.read()
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    g_in: List[str] = []
    g_out: List[str] = []
    for field, wire, val in _iter_fields(model):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gval in _iter_fields(val):
                if gfield == 1 and gwire == 2:
                    nodes.append(_parse_node(gval))
                elif gfield == 5 and gwire == 2:
                    name, arr = _parse_tensor(gval)
                    inits[name] = arr
                elif gfield == 11 and gwire == 2:
                    g_in.append(_value_info_name(gval))
                elif gfield == 12 and gwire == 2:
                    g_out.append(_value_info_name(gval))
    g_in = [n for n in g_in if n and n not in inits]
    return OnnxGraph(nodes, inits, g_in, [n for n in g_out if n])


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Extract all initializer tensors (name -> ndarray) from an .onnx
    file (back-compat shim over read_onnx_graph)."""
    return read_onnx_graph(path).initializers
