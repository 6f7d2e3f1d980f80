"""Collectives over the shards of one mesh axis, and the data-parallel
group that the losses and BatchNorm reduce over.

JAX takes `ppermute`, `psum` and `all_gather` from `jax.lax` inside
`shard_map`. Here a sharded value is the list of its per-shard pieces
(`core/mesh.py`) and `axis` is the list of the axis's devices, one per
piece. Each collective is built from `.to(device, non_blocking=True)`
copies and sums, so autograd flows through it without a custom
backward: the transpose of a copy is a copy back. On one device the
copies are no-ops; across cards they are peer copies.

`data_parallel(group)` scopes the multi-process step (`parallel/dp.py`):
inside it `global_sum` all-reduces over the group with autograd (the
backward all-reduces the gradient, as
`torch.distributed.nn.functional.all_reduce` does), and `global_mean`
divides such a sum by the global count.
Outside it both are the local sum and mean, so single-process numerics
are untouched.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence

import torch

from ghost_tpu_torch.core.mesh import to_device

_GROUP = contextvars.ContextVar("ghost_tpu_torch_dp_group", default=None)


def ppermute(pieces: Sequence[torch.Tensor], axis: Sequence,
             perm: Sequence[tuple[int, int]]) -> list:
    """out[dst] = pieces[src] on axis[dst] for each (src, dst) of `perm`;
    a shard that receives nothing gets zeros, as `jax.lax.ppermute`. A
    None piece (a pipeline bubble) sends nothing and, unsent to, stays
    None."""
    out = [None] * len(pieces)
    for src, dst in perm:
        if pieces[src] is not None:
            out[dst] = to_device(pieces[src], axis[dst])
    return [torch.zeros_like(p) if o is None and p is not None else o
            for p, o in zip(pieces, out)]


def psum(pieces: Sequence[torch.Tensor], axis: Sequence) -> list:
    """The sum of the pieces, on every shard's device (summed in shard
    order on the first shard's device)."""
    total = pieces[0]
    for p in pieces[1:]:
        total = total + to_device(p, axis[0])
    return [to_device(total, d) for d in axis]


def all_gather(pieces: Sequence[torch.Tensor], axis: Sequence,
               dim: int = 0) -> list:
    """The pieces concatenated along `dim`, on every shard's device."""
    whole = torch.cat([to_device(p, axis[0]) for p in pieces], dim=dim)
    return [to_device(whole, d) for d in axis]


@contextlib.contextmanager
def data_parallel(group):
    """Reduce the losses' and synchronised BatchNorms' batch sums over
    `group` (a `torch.distributed` process group) for the duration."""
    token = _GROUP.set(group)
    try:
        yield group
    finally:
        _GROUP.reset(token)


def data_parallel_group():
    """The group of the enclosing `data_parallel`, or None."""
    return _GROUP.get()


def world_size() -> int:
    group = _GROUP.get()
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the incoming gradients over
    the group too (`torch.distributed.nn.functional.all_reduce`'s rule,
    which newer torch deprecates)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the data-parallel group, with autograd (`t` itself
    outside `data_parallel`)."""
    group = _GROUP.get()
    return t if group is None else _AllReduceSum.apply(t, group)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t`'s elements over every rank's `t` (equal shapes on
    every rank, as `dp._check_batch_sharding` makes the batches);
    `torch.mean(t)` outside `data_parallel`."""
    if _GROUP.get() is None:
        return torch.mean(t)
    return global_sum(torch.sum(t)) / (t.numel() * world_size())


def _flat_groups(tensors):
    """Indices of `tensors` grouped by (device, dtype)."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return groups.values()


def broadcast_tensors(tensors, group, src: int = 0) -> None:
    """Overwrite `tensors` in place with group rank `src`'s, one flat
    broadcast per (device, dtype)."""
    import torch.distributed as dist

    root = dist.get_global_rank(group, src)
    with torch.no_grad():
        for idx in _flat_groups(tensors):
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.broadcast(flat, root, group=group)
            for i, piece in zip(idx, torch.split(
                    flat, [tensors[i].numel() for i in idx])):
                tensors[i].copy_(piece.view_as(tensors[i]))


def average_gradients(grads):
    """Each gradient's mean over the data-parallel group (DDP's bucketed
    all-reduce, one flat all-reduce per (device, dtype)); the gradients
    themselves outside `data_parallel`.

    Under `data_parallel` every loss is the global batch's on every rank
    and the all-reduces inside it sum their gradients in the backward,
    so rank r's gradient is N times its samples' share of the global
    gradient; the mean over the N ranks is the global gradient."""
    group = _GROUP.get()
    if group is None:
        return list(grads)
    import torch.distributed as dist

    grads = list(grads)
    n = dist.get_world_size(group)
    out = list(grads)
    for idx in _flat_groups(grads):
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= n
        for i, piece in zip(idx, torch.split(
                flat, [grads[i].numel() for i in idx])):
            out[i] = piece.view_as(grads[i])
    return out
