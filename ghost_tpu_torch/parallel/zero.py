"""ZeRO-sharded optimizer state for the data-parallel step, mirroring
`ghost_tpu/parallel/zero.py` (the reference's DistributedFusedAdam).

Each parameter is split along the first dim that the group's size
divides (`_leaf_spec`, JAX's choice); a parameter with no such dim is
replicated. `ZeroGhostAdam` keeps, on each rank, `GhostAdam` over that
rank's slices only: the moments exist for the slice alone, and the
update writes the slice of the parameter in place (the slice is a view
of it). The updated slices then reach every rank by one broadcast per
rank and dtype: gloo takes broadcast and all-reduce on CUDA tensors, and
neither all-gather nor reduce-scatter. Adam is elementwise, so the
sharded step equals the unsharded one.
"""

from __future__ import annotations

from typing import Any

import torch

from ghost_tpu_torch.core.mesh import DATA_AXIS
from ghost_tpu_torch.parallel.collectives import broadcast_tensors
from ghost_tpu_torch.train.optimizers import GhostAdam


def _leaf_spec(x, axis_size: int) -> tuple:
    """JAX's PartitionSpec entries for a leaf: (None,) * dim + ("data",)
    for the first dim that `axis_size` divides, else () (replicated)."""
    for dim, size in enumerate(getattr(x, "shape", ())):
        if size % axis_size == 0 and size >= axis_size:
            return (None,) * dim + (DATA_AXIS,)
    return ()


def _shard_dim(x, axis_size: int) -> int | None:
    spec = _leaf_spec(x, axis_size)
    return len(spec) - 1 if spec else None


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _size(group) -> int:
    import torch.distributed as dist

    return group if isinstance(group, int) else dist.get_world_size(group)


def opt_state_shardings(group, opt_state: Any) -> Any:
    """Per-leaf specs (`_leaf_spec`) of an optimizer state tree over the
    group (or a size)."""
    n = _size(group)
    return _map(opt_state, lambda x: _leaf_spec(x, n))


def state_shardings(group, state, zero_fields=("g_opt", "d_opt")) -> dict:
    """Specs of a `TrainState`'s fields: the optimizers' moments sharded
    as `opt_state_shardings`, everything else replicated (())."""
    n = _size(group)
    sd = state.state_dict()
    return {name: (_map(tree, lambda x: _leaf_spec(x, n))
                   if name in zero_fields else _map(tree, lambda _: ()))
            for name, tree in sd.items()}


class ZeroGhostAdam:
    """`GhostAdam` with its state sharded over a `torch.distributed` group.

    Built from a `GhostAdam` (its hyperparameters, schedule, count and any
    moments it holds, sliced). `step()` reads each parameter's `.grad`,
    already averaged over the group, updates this rank's slices and
    broadcasts them. `state_dict()` is this rank's slice state; load it
    back into the same rank of a group of the same size."""

    def __init__(self, opt: GhostAdam, group):
        import torch.distributed as dist

        self.group = group
        self.rank, self.size = dist.get_rank(group), dist.get_world_size(group)
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.dims = [_shard_dim(p, self.size) for p in self.params]
        self.shards = [self._slice(p.detach(), d, self.rank)
                       for p, d in zip(self.params, self.dims)]
        g = opt.param_groups[0]
        self.inner = GhostAdam(self.shards, opt.schedule or g["lr"],
                               g["betas"][0], g["betas"][1],
                               g["weight_decay"], g["eps"])
        self.inner.count = opt.count
        for p, s, d in zip(self.params, self.shards, self.dims):
            if opt.state.get(p):
                self.inner.state[s] = {
                    k: (self._slice(v, d, self.rank).clone()
                        if torch.is_tensor(v) and v.shape == p.shape else v)
                    for k, v in opt.state[p].items()}

    def _slice(self, t, dim, rank):
        if dim is None:
            return t
        k = t.shape[dim] // self.size
        return t.narrow(dim, rank * k, k)

    def step(self):
        for p, s, d in zip(self.params, self.shards, self.dims):
            s.grad = None if p.grad is None else self._slice(p.grad, d,
                                                             self.rank)
        self.inner.step()
        for s in self.shards:
            s.grad = None
        # each rank's updated slices to every rank
        sharded = [(p.detach(), d) for p, d in zip(self.params, self.dims)
                   if d is not None]
        for src in range(self.size):
            broadcast_tensors([self._slice(p, d, src) for p, d in sharded],
                              self.group, src)

    def state_dict(self) -> dict:
        sd = self.inner.state_dict()
        sd["zero"] = {"rank": self.rank, "size": self.size}
        return sd

    def load_state_dict(self, sd: dict) -> None:
        sd = dict(sd)
        zero = sd.pop("zero")
        if (zero["rank"], zero["size"]) != (self.rank, self.size):
            raise ValueError(f"ZeRO state of rank {zero['rank']} of "
                             f"{zero['size']} loaded into rank {self.rank} "
                             f"of {self.size}")
        self.inner.load_state_dict(sd)


def zero_shard_opt_state(group, opt: GhostAdam) -> ZeroGhostAdam:
    """`opt` with its state ZeRO-sharded over `group`."""
    return ZeroGhostAdam(opt, group)
