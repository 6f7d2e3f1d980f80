"""Device mesh and sharding helpers, mirroring `ghost_tpu/core/mesh.py`.

JAX's parallel layer is single-controller SPMD: one process owns a mesh
of devices and passes global arrays whose shards live on them. The port
keeps that contract for the schedules (`parallel.sp`, `parallel.pp`,
`parallel.ep`, the tiled enhancer): a `Mesh` is a numpy grid of
`torch.device`s with named axes, a device may appear more than once (four
logical shards on one card), and a sharded tensor is the list of its
per-shard pieces, each on its shard's device. Where two shards share a
device their pieces are plain tensors on it and a hop between them is a
copy on that device.

The data-parallel train step is the exception (`parallel.dp`): eager
torch takes global batch statistics only from ranks that run at the same
time, so it runs one process per rank over a `torch.distributed` group,
as the reference's apex DDP does.

Conventions:
  axis "data"  - batch / video-frame axis (DDP equivalent)
  axis "model" - channel/tensor axis for wide convs (optional TP)
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """Named axes over an array of `torch.device`s (repeats allowed).

    `shape` maps each axis name to its size, as JAX's `Mesh.shape` does;
    `devices` is the numpy object array itself."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = arr.reshape(-1)
        for i, d in enumerate(np.asarray(devices, dtype=object).reshape(-1)):
            flat[i] = torch.device(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str, batch_axis: str | None = None):
        """The devices along `axis`, one list per shard of `batch_axis`
        (one list without it); every other axis is replicated, so its
        first index stands for it."""
        names = self.axis_names
        order = [names.index(axis)] + ([names.index(batch_axis)]
                                       if batch_axis else [])
        rest = [i for i in range(len(names)) if i not in order]
        arr = np.transpose(self.devices, order + rest)
        arr = arr[(slice(None),) * len(order) + (0,) * len(rest)]
        if batch_axis is None:
            return [list(arr)]
        return [list(arr[:, j]) for j in range(arr.shape[1])]

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _default_devices():
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA card; pass CPU devices "
                           "explicitly to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Sequence | None = None, data: int | None = None,
              model: int = 1) -> Mesh:
    """A ("data", "model") mesh over the given devices (default: every
    card, cuda:0..n-1)."""
    devices = list(_default_devices() if devices is None else devices)
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(data, model), (DATA_AXIS, MODEL_AXIS))


def make_mesh_1d(axis: str, num_devices: int,
                 devices: Sequence | None = None) -> Mesh:
    """A 1-D (axis,) mesh over the first `num_devices` devices, the
    shared constructor behind parallel.{pp,sp,ep}'s named helpers."""
    devices = list(_default_devices() if devices is None else devices)
    if len(devices) < num_devices:
        raise ValueError(f"need {num_devices} devices, have {len(devices)}")
    arr = np.empty(num_devices, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:num_devices]]
    return Mesh(arr, (axis,))


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device` (itself where it lies there). A copy to a card is
    asynchronous; one to the host waits for it."""
    device = torch.device(device)
    return t.to(device, non_blocking=device.type == "cuda")


def split_leading(x: torch.Tensor, devices: Sequence) -> list:
    """`x`'s leading dim in len(devices) contiguous pieces, piece i on
    devices[i] (a view where it already lies there). The leading dim
    must divide."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by {n} "
                         f"shards")
    return [to_device(p, d) for p, d in zip(torch.chunk(x, n, dim=0), devices)]


def data_sharding(mesh: Mesh):
    """The devices that shard a leading (batch) dim over "data"."""
    return mesh.axis_devices(DATA_AXIS)[0]


def replicated_sharding(mesh: Mesh):
    """Each distinct device of the mesh once, in mesh order."""
    return list(dict.fromkeys(mesh.devices.flat))


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """A dict (or tensor) of batch tensors -> per-shard pieces, the
    leading dim split over "data"."""
    devices = data_sharding(mesh)
    if isinstance(batch, dict):
        return {k: split_leading(v, devices) for k, v in batch.items()}
    return split_leading(batch, devices)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def replicate(tree: Any, devices: Sequence) -> dict:
    """{device: the tree's tensors on it} for each distinct device: the
    tree itself where its tensors already lie, one copy elsewhere. Make
    it once and reuse it: shards on one device share one copy."""
    return {d: _map(tree, lambda t, d=d: t.to(d))
            for d in dict.fromkeys(torch.device(x) for x in devices)}


def replicate_module(module: torch.nn.Module, devices: Sequence) -> dict:
    """{device: module} for each distinct device: `module` itself on the
    device of its parameters, one deep copy on each other device."""
    import copy

    home = next(module.parameters()).device
    return {d: module if d == home else copy.deepcopy(module).to(d)
            for d in dict.fromkeys(torch.device(x) for x in devices)}


def tree_to(tree: Any, device) -> Any:
    """The tree's tensors on `device` (no copy where they lie there)."""
    return _map(tree, lambda t: to_device(t, device))
