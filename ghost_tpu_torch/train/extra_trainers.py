"""The SR upscaler behind the train CLI's `--teacher_upsample`, the part
of `ghost_tpu/train/extra_trainers.py:116-160` that the CLI reaches.

The reference routes the teacher's outputs through GFPGAN/RealESRGAN
(utils/training/upsampler.py:107-120); the JAX package, and so the port,
takes the LIPSPADE SR generator at inference (eval BatchNorm, the stored
spectral-norm pair, no power iteration). A torch module holds its own
weights, so where the JAX functions take a variables tree beside the
module, these fill the module: `load_lipspade_vars` loads it and
`sr_upscale_fn` (`sr_upscale_apply`) returns the one-argument upscale.
The D-pretrain, upsampler-finetune and mask trainers of the JAX module
are not ported here.
"""

from __future__ import annotations

import torch

from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.nn.layers import cast_to_compute_dtype, init_weights


def sr_upscale_apply(sr_mod):
    """`y_pm1 -> y_pm1` through the frozen SR module, (B,H,W,3) NHWC in
    [-1, 1], without autograd."""

    def upscale(y_pm1):
        with torch.no_grad():
            return sr_mod(y_pm1)

    return upscale


# JAX's two names: its apply takes the variables apart from the module
# and its `sr_upscale_fn` closes over them; a torch module holds its own
sr_upscale_fn = sr_upscale_apply


def load_lipspade_vars(sr_mod, sr_path: str, ngf: int,
                       warn_context: str = "SR"):
    """Fill the LIPSPADE generator `sr_mod` from a torch .pth (converted
    on load), a flax msgpack snapshot, or random weights with the JAX
    CLI's warning (a torch.Generator seeded with 2, not JAX's
    `jax.random.key(2)` values); frozen and cast to its compute dtype.
    Returns the module."""
    if sr_path and sr_path.endswith(".pth"):
        from ghost_tpu_torch.convert.torch_loader import (
            convert_spade_generator_state_dict, load_torch_checkpoint)

        load_flax_variables(sr_mod, convert_spade_generator_state_dict(
            load_torch_checkpoint(sr_path), ngf=ngf))
    elif sr_path:
        from ghost_tpu_torch.core.checkpoint import load_msgpack

        load_flax_variables(sr_mod, load_msgpack(sr_path))
    else:
        print(f"WARNING: random SR weights ({warn_context})")
        init_weights(sr_mod, torch.Generator().manual_seed(2))
    return cast_to_compute_dtype(sr_mod.eval().requires_grad_(False))
