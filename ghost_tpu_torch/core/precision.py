"""Mixed-precision policy, mirroring `ghost_tpu/core/precision.py`.

Params in float32, compute in bfloat16, outputs in float32. Every layer
takes its compute dtype from the `Policy` its model was built with; the
f32 parameters are cast to that dtype once after loading
(`nn.layers.cast_to_compute_dtype`), which gives the same numbers as
flax's cast on every call.

TF32: the port computes float32 convolutions and matrix products in
full float32. cuDNN would run f32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), which keeps ~3 decimal
digits and would break the f32 parity bounds, so entry points call
`disable_tf32()` before running anything on the card.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Casting policy for one model: params / compute / output dtypes."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = Policy()
FULL_PRECISION = Policy(
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
    output_dtype=torch.float32,
)


def disable_tf32() -> None:
    """Run float32 convolutions and matmuls on the card in full f32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
