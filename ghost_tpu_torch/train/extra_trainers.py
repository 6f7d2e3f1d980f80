"""Auxiliary training regimes, mirroring `ghost_tpu/train/extra_trainers.py`:
D pretrain, upsampler-in-the-loop and mask, and the SR upscaler behind
the train CLI's `--teacher_upsample`.

Parity targets (the reference's, through the JAX module):
  * `make_discriminator_pretrain_step` — train-discriminator.py:60-199:
    D alone learns real(Xs) vs fake(G's output), hinge, x1000 (:185);
  * `make_upsampler_finetune_step` — train-upsampler.py:45-225: G
    fine-tuned to match an upscaled version of its own output (MSE
    x30000, :110-135) plus the multiscale perceptual colour loss (:91);
    the upscaler is the LIPSPADE SR generator (eval BatchNorm, the stored
    spectral-norm pair, no power iteration);
  * `make_mask_train_step` — train-mask.py:236-324: AEI-Net repurposed
    to predict soft face masks, MSE x10000 against precomputed targets.

Each `make_*_step` returns (step, optimizer) over the modules it is given
(GhostAdam with the GAN's defaults, JAX's `ghost_adam`); the step updates
the modules in place (a train-mode G moves its BatchNorm statistics, as
JAX's mutable batch_stats) and returns its loss or metrics, detached.
A torch module holds its own weights, so where the JAX functions take a
variables tree beside the module, these take the module:
`load_lipspade_vars` fills it, `sr_upscale_apply` returns its
`y_pm1 -> y_pm1` upscale.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.models.sr.losses import multiscale_perceptual_color_loss
from ghost_tpu_torch.nn.layers import cast_to_compute_dtype, init_weights
from ghost_tpu_torch.train.optimizers import GhostAdam
from ghost_tpu_torch.train.train_step import _apply_grads


def make_discriminator_pretrain_step(disc_mod, lr: float = 4e-4,
                                     loss_mult: float = 1000.0):
    """step(fake, real) -> loss: hinge over D's scales, times
    `loss_mult`, and one update of D."""
    params = list(disc_mod.parameters())
    opt = GhostAdam(params, lr)

    def step(fake, real):
        d_fake, d_real = disc_mod(fake), disc_mod(real)
        loss = 0.0
        for df, dr in zip(d_fake, d_real):
            loss = loss + torch.mean(torch.clamp(1.0 + df[-1], min=0.0))
            loss = loss + torch.mean(torch.clamp(1.0 - dr[-1], min=0.0))
        loss = loss_mult * loss
        _apply_grads(loss, params, opt)
        return loss.detach()

    return step, opt


def make_upsampler_finetune_step(
    gen_mod,
    upscale_apply: Callable,
    vgg_apply: Optional[Callable] = None,
    lr: float = 4e-4,
    upsample_mult: float = 30000.0,
):
    """step(xt, embed) -> {"upsample", "color", "loss"}: G (train mode)
    against the upscaled copy of its own output, which takes no
    gradient: MSE times `upsample_mult` plus
    `multiscale_perceptual_color_loss`, and one update of G.
    upscale_apply: (B,256,256,3) pm1 -> the enhanced target, pm1."""
    params = list(gen_mod.parameters())
    opt = GhostAdam(params, lr)

    def step(xt, embed):
        y, _ = gen_mod(xt, embed)
        target = upscale_apply(y.detach()).detach()
        l_up = torch.mean(torch.square(y - target)) * upsample_mult
        l_color = multiscale_perceptual_color_loss(vgg_apply, y, target)
        loss = l_up + l_color
        _apply_grads(loss, params, opt)
        return {"upsample": l_up.detach(), "color": l_color.detach(),
                "loss": loss.detach()}

    return step, opt


def make_mask_train_step(gen_mod, lr: float = 4e-4,
                         mask_mult: float = 10000.0):
    """step(xt, embed, target_mask) -> loss: G (train mode) as a mask
    predictor, the channel mean of its [0, 1] output against the target
    (B,H,W,1), MSE times `mask_mult` (train-mask.py:300-308), and one
    update of G."""
    params = list(gen_mod.parameters())
    opt = GhostAdam(params, lr)

    def step(xt, embed, target_mask):
        y, _ = gen_mod(xt, embed)
        pred = torch.mean(y * 0.5 + 0.5, dim=-1, keepdim=True)
        loss = torch.mean(torch.square(pred - target_mask)) * mask_mult
        _apply_grads(loss, params, opt)
        return loss.detach()

    return step, opt


def sr_upscale_apply(sr_mod):
    """`y_pm1 -> y_pm1` through the frozen SR module, (B,H,W,3) NHWC in
    [-1, 1], without autograd."""

    def upscale(y_pm1):
        with torch.no_grad():
            return sr_mod(y_pm1)

    return upscale


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


def external_upsampler_available() -> bool:
    """The GFPGAN/RealESRGAN packages of the reference's upsampler path
    (reference upsampler.py); neither is a dependency of the port."""
    try:
        import gfpgan  # noqa: F401
        import realesrgan  # noqa: F401

        return True
    except ImportError:
        return False
