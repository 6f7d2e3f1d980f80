"""MXNet NDArray ``.params`` file (de)serialization in pure numpy, the
port's own copy of `ghost_tpu/convert/mxnet_nd.py` (the port imports
nothing of the JAX package): the same reader, and a writer whose bytes
equal the JAX package's for the same dict.

The reference's 106-pt landmarker ships as an MXNet checkpoint
(`reference coordinate_reg/image_infer.py:96-141` loads
``2d106det-0000.params``); mxnet itself is not needed: this module reads
and writes the on-disk format directly.

Format (mxnet 1.x, src/ndarray/ndarray.cc `NDArray::Save/Load` and
src/c_api/c_api.cc `MXNDArraySave`):

  uint64  kMXAPINDArrayListMagic = 0x112
  uint64  reserved = 0
  uint64  N                       # vector<NDArray> size
  N x NDArray:
      uint32  magic               # V2 0xF993fac9 (V3 0xF993faca is the
                                  # same layout under np-shape semantics;
                                  # V1 0xF993fac8 lacks the stype field)
      int32   storage type        # kDefaultStorage = 0 (dense only here)
      uint32  ndim
      ndim x int64 dims
      int32   dev_type, int32 dev_id   # context; cpu = (1, 0)
      int32   type_flag           # 0=f32 1=f64 2=f16 3=u8 4=i32 5=i8 6=i64
      raw little-endian data bytes
  uint64  M                       # vector<string> size (names; M == N)
  M x { uint64 len, bytes }       # e.g. "arg:conv_1_conv2d_weight"

`mx.mod.Module.save_checkpoint` writes names with ``arg:``/``aux:``
prefixes; `models/landmark_mxnet.py:convert_2d106det_params` consumes
that layout as it is.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9
_V3_MAGIC = 0xF993FACA

_TYPE_FLAGS = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.float16): 2,
    np.dtype(np.uint8): 3,
    np.dtype(np.int32): 4,
    np.dtype(np.int8): 5,
    np.dtype(np.int64): 6,
}
_FLAG_TYPES = {v: k for k, v in _TYPE_FLAGS.items()}


def save_ndarray_dict(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write ``{name: array}`` as an MXNet ``.params`` file (V2 records)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for arr in arrays.values():
            arr = np.ascontiguousarray(arr)
            flag = _TYPE_FLAGS[np.dtype(arr.dtype)]
            f.write(struct.pack("<Ii", _V2_MAGIC, 0))  # magic, kDefaultStorage
            f.write(struct.pack("<I", arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            f.write(struct.pack("<iii", 1, 0, flag))  # cpu ctx, type flag
            f.write(arr.astype(arr.dtype.newbyteorder("<")).tobytes())
        f.write(struct.pack("<Q", len(arrays)))
        for name in arrays:
            b = name.encode()
            f.write(struct.pack("<Q", len(b)) + b)


def load_ndarray_dict(path: str) -> Dict[str, np.ndarray]:
    """Read an MXNet ``.params`` file -> ``{name: array}`` (names keep
    their ``arg:``/``aux:`` prefixes, like ``mx.nd.load``)."""
    with open(path, "rb") as f:
        buf = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from(fmt, buf, off)
        off += struct.calcsize(fmt)
        return vals

    magic, reserved = take("<QQ")
    if magic != _LIST_MAGIC:
        raise ValueError(f"not an MXNet NDArray list file (magic {magic:#x})")
    (count,) = take("<Q")
    arrays = []
    for _ in range(count):
        (rec_magic,) = take("<I")
        if rec_magic in (_V2_MAGIC, _V3_MAGIC):
            (stype,) = take("<i")
            if stype != 0:
                raise NotImplementedError(
                    f"sparse NDArray storage type {stype} not supported")
            (ndim,) = take("<I")
        elif rec_magic == _V1_MAGIC:
            (ndim,) = take("<I")
        else:
            # legacy record: the word read is already the ndim of a
            # uint32 TShape (pre-V1 save)
            ndim = rec_magic
            shape = take(f"<{ndim}I")
            dev_type, dev_id, flag = take("<iii")
            arrays.append(_read_data(buf, off, shape, flag))
            off += arrays[-1].nbytes
            continue
        shape = take(f"<{ndim}q")
        dev_type, dev_id, flag = take("<iii")
        arrays.append(_read_data(buf, off, shape, flag))
        off += arrays[-1].nbytes
    (n_names,) = take("<Q")
    names = []
    for _ in range(n_names):
        (ln,) = take("<Q")
        names.append(buf[off:off + ln].decode())
        off += ln
    if n_names != count:
        raise ValueError(f"{count} arrays but {n_names} names")
    return dict(zip(names, arrays))


def _read_data(buf, off, shape, flag):
    dtype = _FLAG_TYPES[flag]
    n = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(buf, dtype=dtype.newbyteorder("<"),
                        count=n, offset=off)
    return arr.reshape(shape).astype(dtype)
