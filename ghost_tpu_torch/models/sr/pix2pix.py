"""Pix2Pix SR model: LIPSPADE G, multiscale D and their TTUR train steps,
mirroring `ghost_tpu/models/sr/pix2pix.py` (reference
models/pix2pix_model.py):

  * G objective: multiscale hinge GAN + GAN feature matching (x
    lambda_feat) + the weighted VGG L1 (x lambda_vgg) (:71-97);
  * D objective: hinge on the fake and real pairs, G's output detached;
  * D reads (degraded, image) pairs, fake and real in one joint batch,
    so batch-type norms would see both (:104-117);
  * TTUR optimizers: Adam(b1 0, b2 0.9) at lr / 2 for G and lr * 2 for D
    (:154-170), optax's `adam` (no weight decay, eps outside the root).

A torch module holds its own weights, so where the JAX wrapper carries a
functional `SRTrainState` of variable trees, `SRTrainState` here holds
the two modules and their optimizers: a G step updates G's parameters,
its BatchNorm running statistics and its spectral (u, v) in place, as
JAX's step returns the new `g_params` and `g_extra`. `generate` runs G
as JAX's does, in G's mode, and keeps every piece of G's state as it
was (JAX applies with `mutable=extra` and throws the updates away).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.models.discriminator import MultiscaleDiscriminator
from ghost_tpu_torch.models.sr.generator import LIPSPADEGenerator
from ghost_tpu_torch.models.sr.losses import (feature_matching_loss, gan_loss,
                                              vgg_loss)
from ghost_tpu_torch.nn.layers import frozen_batch_stats, init_weights
from ghost_tpu_torch.train.optimizers import GhostAdam
from ghost_tpu_torch.train.train_step import _apply_grads


@dataclasses.dataclass(frozen=True)
class SRConfig:
    ngf: int = 48
    ndf: int = 64
    lr: float = 2e-4  # base; TTUR splits to G lr/2, D lr*2
    gan_mode: str = "hinge"
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    no_ganFeat_loss: bool = False
    no_vgg_loss: bool = False


@dataclasses.dataclass
class SRTrainState:
    """G and D with their optimizers; `step` counts G steps."""

    gen: torch.nn.Module
    disc: torch.nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0


class Pix2PixSR:
    """LIPSPADE G (`train` runs its norms on batch statistics and its
    spectral convs' power iteration) + MultiscaleDiscriminator(ndf,
    n_layers 4, num_D 2, instance norm, intermediate features) on the
    6-channel pairs. `vgg_apply(x) -> 5 feature maps` feeds the VGG term
    (`models/sr/vgg.py`); without it the term is left out, as in JAX."""

    def __init__(self, cfg: SRConfig = SRConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 vgg_apply: Optional[Callable] = None, train: bool = False):
        self.cfg = cfg
        self.policy = policy
        self.vgg_apply = vgg_apply
        self.train = train

    def build(self, device="cuda"):
        """(G, D) on `device`, parameters uninitialised (`init` draws
        them; the bridge fills them from a flax tree)."""
        cfg = self.cfg
        gen = LIPSPADEGenerator(ngf=cfg.ngf, policy=self.policy,
                                train=self.train, device=device)
        disc = MultiscaleDiscriminator(
            ndf=cfg.ndf, n_layers=4, num_D=2, norm="instance",
            get_interm_feat=True, policy=self.policy, device=device,
            input_nc=6)
        return gen, disc

    def init(self, generator: torch.Generator, device="cuda",
             modules=None) -> SRTrainState:
        """A fresh train state: flax-style random weights from
        `generator` (a CPU torch.Generator), or the given (G, D) as they
        are; the TTUR optimizers over them."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Pix2PixSR.init: no CUDA card; pass "
                               "device='cpu' to build on the CPU")
        if modules is None:
            gen, disc = self.build("cpu")
            init_weights(gen, generator)
            init_weights(disc, generator)
            gen, disc = gen.to(device), disc.to(device)
        else:
            gen, disc = modules
        g_opt, d_opt = self.optimizers(gen, disc)
        return SRTrainState(gen, disc, g_opt, d_opt)

    def optimizers(self, gen, disc):
        """TTUR (pix2pix_model.py:154-170): G lr/2, D lr*2, betas (0, .9)."""
        g_opt = GhostAdam(list(gen.parameters()), self.cfg.lr / 2, b1=0.0,
                          b2=0.9, weight_decay=0.0)
        d_opt = GhostAdam(list(disc.parameters()), self.cfg.lr * 2, b1=0.0,
                          b2=0.9, weight_decay=0.0)
        return g_opt, d_opt

    # -------------------------------------------------------------- forward
    def generate(self, state_or_gen, degraded):
        """mode='inference'/'inference2' parity: G's output on `degraded`
        (NHWC, [-1, 1]), with G's running statistics and stored (u, v)
        left as they were."""
        gen = (state_or_gen.gen if isinstance(state_or_gen, SRTrainState)
               else state_or_gen)
        with torch.no_grad(), frozen_batch_stats(gen):
            return gen(degraded)

    def _discriminate(self, disc, degraded, generated, real):
        """Joint fake/real pass: D's outputs split back into the fake
        and real halves, per scale and feature."""
        fake_pair = torch.cat([degraded, generated.to(degraded.dtype)], -1)
        real_pair = torch.cat([degraded, real], -1)
        outs = disc(torch.cat([fake_pair, real_pair], 0))
        b = degraded.shape[0]
        fake = [[t[:b] for t in scale] for scale in outs]
        real_o = [[t[b:] for t in scale] for scale in outs]
        return fake, real_o

    # ---------------------------------------------------------- train steps
    def make_steps(self):
        """(g_step, d_step):
        g_step(state, degraded, real) -> (state, metrics, generated):
            one G update (GAN, GAN_Feat, VGG as configured);
        d_step(state, degraded, generated, real) -> (state, loss):
            one D update on the detached `generated`."""
        cfg = self.cfg

        def g_step(state: SRTrainState, degraded, real):
            generated = state.gen(degraded)
            fake_d, real_d = self._discriminate(state.disc, degraded,
                                                generated, real)
            loss = gan_loss(fake_d, True, cfg.gan_mode,
                            for_discriminator=False)
            metrics = {"GAN": loss}
            if not cfg.no_ganFeat_loss:
                lf = feature_matching_loss(fake_d, real_d) * cfg.lambda_feat
                loss = loss + lf
                metrics["GAN_Feat"] = lf
            if not cfg.no_vgg_loss and self.vgg_apply is not None:
                lv = vgg_loss(self.vgg_apply, generated, real) * cfg.lambda_vgg
                loss = loss + lv
                metrics["VGG"] = lv
            _apply_grads(loss, list(state.gen.parameters()), state.g_opt)
            state.step += 1
            return (state, {k: v.detach() for k, v in metrics.items()},
                    generated.detach())

        def d_step(state: SRTrainState, degraded, generated, real):
            fake_d, real_d = self._discriminate(state.disc, degraded,
                                                generated.detach(), real)
            loss = (gan_loss(fake_d, False, cfg.gan_mode, True)
                    + gan_loss(real_d, True, cfg.gan_mode, True))
            _apply_grads(loss, list(state.disc.parameters()), state.d_opt)
            return state, loss.detach()

        return g_step, d_step
