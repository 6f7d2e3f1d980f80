"""Pipeline parallelism: a GPipe microbatch schedule over a "pipe" mesh
axis, mirroring `ghost_tpu/parallel/pp.py`.

N homogeneous blocks (RRDBNet's 23-block trunk is the case the JAX
module was written for) are split into S stages of ceil(N/S) blocks,
each on its stage's device; M microbatches stream through them, and
after each tick a hop moves every stage's output to the next stage's
device. Stage s works on microbatch t - s at tick t, so the schedule
takes M + S - 1 ticks and the last stage emits the M results in order.

JAX runs the schedule as one static program: every stage computes at
every tick and the bubbles are masked, and trailing slots past N hold
zero params masked to identity. Eager torch runs only the (tick, stage)
pairs that hold a microbatch and skips the identity slots; the output is
the same, the bubbles cost nothing. The schedule is differentiable end to
end (the hops are copies), and `remat=True` recomputes each block's
activations in the backward through `torch.utils.checkpoint`.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ghost_tpu_torch.core.mesh import Mesh, make_mesh_1d, to_device, tree_to
from ghost_tpu_torch.parallel.collectives import ppermute

PIPE_AXIS = "pipe"


def make_pipe_mesh(num_stages: int, devices: Sequence | None = None) -> Mesh:
    """A 1-D ("pipe",) mesh over the first `num_stages` devices."""
    return make_mesh_1d(PIPE_AXIS, num_stages, devices)


def _map2(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map2(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map2(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    return fn(trees)


def stack_block_params(blocks: Sequence[Any]) -> Any:
    """N per-block trees (tensors, state dicts, nested dicts or lists) ->
    one tree of (N, ...) leaves."""
    return _map2(torch.stack, list(blocks))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def unstack_block_params(stacked: Any) -> list:
    """Inverse of `stack_block_params` (views of the stacked leaves)."""
    n = _leaves(stacked)[0].shape[0]
    return [_map2(lambda ls, i=i: ls[0][i], [stacked]) for i in range(n)]


def _blocks_per_stage(n_blocks: int, num_stages: int) -> int:
    return -(-n_blocks // num_stages)  # ceil


def place_blocks(blocks: Sequence[Any], mesh: Mesh,
                 axis: str = PIPE_AXIS) -> list:
    """Block i's tree on the device of its stage, i // ceil(N/S). Pass the
    list to `pipeline_apply` to place the weights once for many calls."""
    devices = mesh.axis_devices(axis)[0]
    bps = _blocks_per_stage(len(blocks), len(devices))
    return [tree_to(b, devices[i // bps]) for i, b in enumerate(blocks)]


def _gpipe(apply_one, blocks, xm, devices):
    """The schedule over one row of stage devices; xm (M, Bm, ...)."""
    num_stages, m = len(devices), xm.shape[0]
    bps = _blocks_per_stage(len(blocks), num_stages)
    stages = [[tree_to(p, devices[s]) for p in blocks[s * bps:(s + 1) * bps]]
              for s in range(num_stages)]
    hop = [(s, s + 1) for s in range(num_stages - 1)]
    state = [None] * num_stages
    results = []
    for t in range(m + num_stages - 1):
        ys = [None] * num_stages
        for s in range(num_stages):
            if not 0 <= t - s < m:
                continue  # a bubble: no microbatch at this stage
            h = to_device(xm[t], devices[0]) if s == 0 else state[s]
            for p in stages[s]:  # slots past N are identity: absent
                h = apply_one(p, h)
            ys[s] = h
        if ys[-1] is not None:
            results.append(ys[-1])
        state = ppermute(ys, devices, hop)
    return torch.stack(results)


def pipeline_apply(
    block_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = PIPE_AXIS,
    num_microbatches: int | None = None,
    remat: bool = False,
    batch_axis: str | None = None,
) -> torch.Tensor:
    """Run x through N homogeneous blocks pipelined over `axis`.

    block_apply(params_one_block, h) -> h' of h's shape. stacked_params:
    a tree of (N, ...) leaves, or the list of N per-block trees (e.g.
    state dicts for `torch.func.functional_call`, or `place_blocks`'s
    list). Stage s owns blocks [s*ceil(N/S), (s+1)*ceil(N/S)). x (B, ...)
    with B divisible by num_microbatches (default: the stage count); the
    result on x's device equals applying the N blocks in turn.
    batch_axis splits each microbatch's batch dim over a second mesh
    axis (data x pipe): each row of stages runs its own stream."""
    blocks = (list(stacked_params) if isinstance(stacked_params, list)
              else unstack_block_params(stacked_params))
    rows = mesh.axis_devices(axis, batch_axis)
    m = num_microbatches or len(rows[0])
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{m} microbatches")
    xm = x.reshape((m, x.shape[0] // m) + x.shape[1:])
    if xm.shape[1] % len(rows):
        raise ValueError(f"microbatch {xm.shape[1]} not divisible by mesh "
                         f"'{batch_axis}' size {len(rows)}")
    if remat:
        def apply_one(p, h):
            return checkpoint(block_apply, p, h, use_reentrant=False)
    else:
        apply_one = block_apply
    outs = [to_device(_gpipe(apply_one, blocks, xr, devices), x.device)
            for devices, xr in zip(rows, torch.chunk(xm, len(rows), dim=1))]
    return torch.cat(outs, dim=1).reshape(x.shape)
