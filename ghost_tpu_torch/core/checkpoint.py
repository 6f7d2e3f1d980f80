"""Read flax's msgpack checkpoints without flax, mirroring
`ghost_tpu/core/checkpoint.py:load_msgpack`.

flax's `serialization.msgpack_restore` format: a msgpack map of maps
whose array leaves are msgpack ext type 1 holding a nested msgpack
`(shape, dtype name, C-order bytes)`; a numpy scalar is ext type 3 in
the same packing; arrays above 2^30 bytes are written as chunked-array
maps `{"__msgpack_chunked_array__": True, "shape": {"0": ...},
"chunks": {"0": flat part, ...}}`. `load_msgpack` returns the same tree
of dicts with numpy leaves. bfloat16 leaves (numpy has no such dtype)
come back as float32 holding the same values.
"""

from __future__ import annotations

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape, order="C")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _ext_hook(code, data):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        parts = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(parts).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_msgpack(path) -> dict:
    """The variables tree of a flax msgpack file (e.g. the bundled
    `assets/srvgg_student_x2_r05.msgpack`): nested dicts of numpy arrays."""
    import msgpack

    with open(path, "rb") as f:
        data = f.read()
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_hook, raw=False))
