"""Expert parallelism: the MoE expert stack sharded over an "expert"
mesh axis, mirroring `ghost_tpu/parallel/ep.py`.

`nn/moe.py`'s output is linear in the expert axis, y = sum_e gate_e(x) *
f_e(x), so each shard holds E/n experts, computes its gate-weighted
partial sum for all tokens on its device, and one psum gives the dense
result. The router is small and runs on every shard. This is the
dense-dispatch variant (every shard sees every token): exact, no capacity
factor, no dropped tokens.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ghost_tpu_torch.core.mesh import Mesh, make_mesh_1d, to_device, tree_to
from ghost_tpu_torch.nn.moe import expert_contrib, gate_weights
from ghost_tpu_torch.parallel.collectives import psum

EXPERT_AXIS = "expert"
_EXPERT_KEYS = ("w1", "b1", "w2", "b2")


def make_expert_mesh(num_devices: int,
                     devices: Sequence | None = None) -> Mesh:
    """A 1-D ("expert",) mesh over the first `num_devices` devices."""
    return make_mesh_1d(EXPERT_AXIS, num_devices, devices)


def shard_expert_params(params: dict, mesh: Mesh,
                        axis: str = EXPERT_AXIS) -> list:
    """Shard i's params on its device: experts [i*E/n, (i+1)*E/n) and the
    router. Pass the list to `moe_apply_expert_parallel` in place of
    `params` to place the weights once for many calls."""
    devices = mesh.axis_devices(axis)[0]
    n = len(devices)
    num_experts = params["w1"].shape[0]
    if num_experts % n:
        raise ValueError(f"{num_experts} experts not divisible by "
                         f"{n} devices")
    eps = num_experts // n
    return [tree_to({"router": params["router"],
                     **{k: params[k][i * eps:(i + 1) * eps]
                        for k in _EXPERT_KEYS}}, d)
            for i, d in enumerate(devices)]


def moe_apply_expert_parallel(params, x: torch.Tensor, *, mesh: Mesh,
                              axis: str = EXPERT_AXIS, top_k: int = 2,
                              batch_axis: str | None = None) -> torch.Tensor:
    """`nn.moe.moe_apply` with the experts sharded over `axis`.

    params: as `init_moe_params` (num_experts divisible by the axis size),
    or `shard_expert_params`'s list for this mesh. x (..., D) on any
    device; the result (..., D) on x's device. batch_axis splits the
    tokens over a second mesh axis (data x expert); the psum stays on
    `axis`."""
    shards = (params if isinstance(params, list)
              else shard_expert_params(params, mesh, axis))
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    rows = mesh.axis_devices(axis, batch_axis)
    if xf.shape[0] % len(rows):
        raise ValueError(f"{xf.shape[0]} tokens not divisible by mesh "
                         f"'{batch_axis}' size {len(rows)}")
    outs = []
    for devices, xs in zip(rows, torch.chunk(xf, len(rows), dim=0)):
        gates = {}  # the replicated router, once per distinct device
        partial = []
        for i, (p, d) in enumerate(zip(shards, devices)):
            # a no-op on the devices the shards were placed on (row 0's)
            p, xd = tree_to(p, d), to_device(xs, d)
            if d not in gates:
                gates[d] = gate_weights(p, xd, top_k)
            e = p["w1"].shape[0]
            local = gates[d][:, i * e:(i + 1) * e]
            partial.append(expert_contrib(p, xd, local))
        outs.append(to_device(psum(partial, devices)[0], x.device))
    return torch.cat(outs, dim=0).reshape(shape)
