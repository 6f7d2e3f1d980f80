"""Checkpoints, mirroring `ghost_tpu/core/checkpoint.py` without flax,
jax or orbax.

`load_msgpack` / `save_msgpack` read and write flax's msgpack bytes:
`save_msgpack` writes what `flax.serialization.to_bytes` writes for the
same tree, so the JAX package's `load_msgpack` reads it back (and the
port's reads JAX's files).

`CheckpointManager` keeps the JAX class's API (`save(step, state,
force)`, `restore(step, like)`, `latest_step()`, the last `keep`
snapshots) over a torch-native format: `<dir>/step_<step>/state.pt`, a
`torch.save` of CPU tensors and plain scalars, written under a temporary
name and renamed into place. It is not orbax's format: the two packages
cannot read each other's training checkpoints. The whole training state
goes in (parameters, BN statistics, optimizer moments and counts, the
step, the adversarial EMA, the ratchets), so a restored run continues
exactly.

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

import os
import re
import shutil
from typing import Any

import numpy as np
import torch

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


# --------------------------------------------------------- msgpack writer
_MAX_CHUNK = 2**30  # flax's MAX_CHUNK_SIZE: msgpack caps an object at 2^31-1


def _ndarray_bytes(arr: np.ndarray, dtype_name: str | None = None) -> bytes:
    import msgpack

    return msgpack.packb((arr.shape, dtype_name or arr.dtype.name,
                          arr.tobytes("C")), use_bin_type=True)


class _BFloat16:
    """A bfloat16 tensor's bits (numpy has no bfloat16), packed under the
    dtype name flax writes for it."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits


def _ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_bytes(x))
    if isinstance(x, _BFloat16):
        return msgpack.ExtType(_EXT_NDARRAY,
                               _ndarray_bytes(x.bits, "bfloat16"))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    return x


def _chunked(arr: np.ndarray) -> dict:
    size = max(1, int(_MAX_CHUNK / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): n for i, n in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _state_dict(x):
    """flax's to_state_dict for plain trees: dicts keep string keys,
    lists and tuples become {"0": ..., "1": ...}, tensors numpy."""
    if isinstance(x, dict):
        return {str(k): _state_dict(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(x)}
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return _BFloat16(x.contiguous().view(torch.int16).numpy()
                             .view(np.uint16))
        x = x.numpy()
    if isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > _MAX_CHUNK:
        return _chunked(x)
    return x


def save_msgpack(path, tree: Any) -> None:
    """Write `tree` (nested dicts / lists of tensors, numpy arrays and
    scalars) as flax msgpack bytes."""
    import msgpack

    os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
    data = msgpack.packb(_state_dict(tree), default=_ext_pack,
                         strict_types=True)
    with open(path, "wb") as f:
        f.write(data)


# ------------------------------------------------------- training checkpoints
class CheckpointManager:
    """Step-tagged snapshots of the whole training state in `directory`.

    save(step, state) writes `<dir>/step_<step>` unless the manager's
    latest step is that step or a later one (a silent no-op, as orbax's);
    force=True writes it regardless, replacing a snapshot of the same step
    (the preemption and stop saves: this state IS step `step` from now
    on). As orbax's manager does, it tracks its steps in the order they
    were saved, starting from the directory's steps sorted by number:
    `all_steps()` is that order, `latest_step()` its last entry, and a
    save evicts from the front until `keep` are left. So a forced save
    below stale later steps is the latest step and stays. `state` is
    anything with `state_dict()` (a `TrainState`) or a tree of tensors
    and scalars; restore(step, like) loads into `like` with its
    `load_state_dict` and returns it, or returns the saved tree (CPU
    tensors) without `like`."""

    _STEP_DIR = re.compile(r"^step_(\d+)$")

    def __init__(self, directory, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        steps = []
        for name in os.listdir(self.directory):
            m = self._STEP_DIR.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "state.pt")):
                steps.append(int(m.group(1)))
        self._steps = sorted(steps)

    def all_steps(self) -> list[int]:
        return list(self._steps)

    def latest_step(self) -> int | None:
        return self._steps[-1] if self._steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write the snapshot; returns False where a plain save no-ops."""
        latest = self.latest_step()
        if not force and latest is not None and latest >= step:
            return False
        tree = state.state_dict() if hasattr(state, "state_dict") else state
        tree = _to_cpu(tree)
        final = self._path(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, "state.pt"))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._steps = [s for s in self._steps if s != step] + [int(step)]
        while len(self._steps) > self.keep:
            shutil.rmtree(self._path(self._steps.pop(0)), ignore_errors=True)
        return True

    def restore(self, step: int | None = None, like: Any = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        tree = torch.load(os.path.join(self._path(step), "state.pt"),
                          map_location="cpu", weights_only=True)
        if like is None:
            return tree
        like.load_state_dict(tree)
        return like


def rank_checkpoint_manager(directory, group, keep: int = 5
                            ) -> CheckpointManager:
    """The manager of this rank's part of a data-parallel run's
    checkpoints, `<directory>/rank<r>-of-<n>`: each rank writes its own
    state, so a ZeRO-sharded optimizer (`parallel.zero.ZeroGhostAdam`)
    saves its own slices and no rank gathers another's. The replicated
    parts (G, D, the step, the EMA, the ratchets) are in every rank's
    file. Restore each rank from its own directory into a group of the
    same size; its next step equals the uninterrupted run's bit for bit."""
    import torch.distributed as dist

    rank, size = dist.get_rank(group), dist.get_world_size(group)
    return CheckpointManager(os.path.join(directory, f"rank{rank}-of-{size}"),
                             keep=keep)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree
