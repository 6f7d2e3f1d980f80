"""Data-parallel train-step wiring, the apex DDP / SyncBN equivalent,
mirroring `ghost_tpu/parallel/dp.py`.

JAX's step is one program over a mesh: the batch is sharded on "data",
XLA inserts the gradient psum, and BatchNorm's mean over the global batch
axis is synchronised batch norm by construction. Eager torch can give a
shard the global statistics in the middle of the forward only if the
shards run at the same time, so the port follows PyTorch's idiom and the
reference's (apex DDP, SyncBatchNorm, DistributedFusedAdam): one process
per rank over a `torch.distributed` group.

  * `replicate_state` broadcasts the train state from rank 0 (DDP's
    parameter broadcast);
  * `shard_batch_on_mesh` gives each rank its contiguous slice of the
    global batch;
  * `shard_train_step` runs a step under `collectives.data_parallel`:
    the losses reduce over the group (global masked ratios and means),
    train-mode BatchNorms take the group's statistics, and the
    gradients are averaged over the group before the optimizer (ZeRO:
    `parallel/zero.py`). N ranks together take the single-process step
    on the global batch.

A stated departure: JAX's `_check_batch_sharding` also refuses a batch
leaf committed with another leading mesh axis. A rank's tensor here has
no such layout to read, so only the divisibility check (and, per step,
that every rank holds an equal shard) remains.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ghost_tpu_torch.parallel.collectives import (broadcast_tensors,
                                                  data_parallel)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def replicate_state(group, state: Any) -> Any:
    """Overwrite the train state on every rank with rank 0's: G's and D's
    parameters and buffers and the adversarial EMA (a `TrainState`), or
    every tensor of a module or a tree. Returns `state`."""
    if isinstance(state, torch.nn.Module):
        tensors = list(state.state_dict().values())
    elif hasattr(state, "g") and hasattr(state, "d"):
        tensors = [t for m in (state.g, state.d)
                   for t in m.state_dict().values()]
        tensors.append(state.loss_adv_accumulated)
    else:
        tensors = [t for _, t in _leaves(state) if torch.is_tensor(t)]
    broadcast_tensors(tensors, group, 0)
    return state


def _check_batch_sharding(group, batch: Any) -> None:
    """Refuse a global batch whose leading dims do not divide over the
    group: padding would train on duplicated samples."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    for name, leaf in _leaves(batch):
        ndim = getattr(leaf, "ndim", 0)
        if ndim and leaf.shape[0] % n:
            raise ValueError(
                f"batch leaf {name} has leading dim {leaf.shape[0]}, not "
                f"divisible by mesh 'data' size {n}")


def _slice_leaves(tree, rank, n):
    if isinstance(tree, dict):
        return {k: _slice_leaves(v, rank, n) for k, v in tree.items()}
    if getattr(tree, "ndim", 0):
        k = tree.shape[0] // n
        return tree[rank * k:(rank + 1) * k]
    return tree


def shard_batch_on_mesh(group, batch: Any) -> Any:
    """This rank's contiguous slice of every leaf's leading dim of the
    global batch (a dict of tensors or numpy arrays, or one of them)."""
    import torch.distributed as dist

    _check_batch_sharding(group, batch)
    return _slice_leaves(batch, dist.get_rank(group),
                         dist.get_world_size(group))


def _check_equal_shards(group, batch: Any) -> None:
    """Every rank's leading dims must agree: the global means weight each
    rank's samples by the global count."""
    import torch.distributed as dist

    leaf = next((x for _, x in _leaves(batch) if torch.is_tensor(x)
                 and x.ndim), None)
    if leaf is None:
        return
    b = float(leaf.shape[0])
    t = torch.tensor([1.0, b, b * b], device=leaf.device)
    dist.all_reduce(t, group=group)
    n, s, s2 = (float(v) for v in t.cpu())
    if s * s != n * s2:
        raise ValueError(f"ranks hold unequal batch shards (this rank "
                         f"{int(b)}, {s / n:g} on average)")


def shard_train_step(group, step_fn: Callable,
                     check_shardings: bool = True) -> Callable:
    """`step_fn(state, batch, ...)` (the port's `g_step` or `d_step`) as
    one rank's part of a data-parallel step over `group`: each rank
    passes its shard (`shard_batch_on_mesh`) and the ranks together take
    `step_fn`'s step on the global batch, with synchronised BatchNorm.
    The state must start equal on every rank (`replicate_state`)."""

    def step(state, batch, *args, **kwargs):
        if check_shardings:
            _check_equal_shards(group, batch)
        with data_parallel(group):
            return step_fn(state, batch, *args, **kwargs)

    step.step_fn = step_fn
    return step


def launch_multihost(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None):
    """Join the process group (apex.parallel.multiproc equivalent):
    NCCL for a CUDA device (default: cuda:process_id % cards), gloo only
    where the caller passes a CPU device. `coordinator` is "host:port";
    without it the env:// variables (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) are read. Returns the world group."""
    import torch.distributed as dist

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("launch_multihost: no CUDA card; pass "
                               "device='cpu' for a gloo group on the CPU")
        device = torch.device("cuda", (process_id or 0)
                              % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(init_method=f"tcp://{coordinator}",
                      world_size=num_processes, rank=process_id)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            **kwargs)
    return dist.group.WORLD
