"""The parallel layer, mirroring `ghost_tpu/parallel/`: data parallelism
with synchronised BatchNorm (dp), ZeRO-sharded optimizer state (zero),
the GPipe schedule (pp), ring attention (sp) and expert-parallel MoE
(ep), over `core.mesh` meshes and `collectives`."""

from ghost_tpu_torch.parallel.dp import replicate_state, shard_train_step
from ghost_tpu_torch.parallel.ep import (make_expert_mesh,
                                         moe_apply_expert_parallel)
from ghost_tpu_torch.parallel.pp import (make_pipe_mesh, pipeline_apply,
                                         stack_block_params)
from ghost_tpu_torch.parallel.sp import make_seq_mesh, ring_attention
from ghost_tpu_torch.parallel.zero import (state_shardings,
                                           zero_shard_opt_state)

__all__ = [
    "shard_train_step",
    "replicate_state",
    "make_pipe_mesh",
    "pipeline_apply",
    "stack_block_params",
    "make_seq_mesh",
    "ring_attention",
    "make_expert_mesh",
    "moe_apply_expert_parallel",
    "zero_shard_opt_state",
    "state_shardings",
]
