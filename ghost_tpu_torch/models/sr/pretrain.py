"""Self-supervised LIP-encoder pretraining (SubAdd / Contrasive),
mirroring `ghost_tpu/models/sr/pretrain.py` (reference
models/networks/generator.py:403-763):

  * `NoiseIntensityPredictor` / `NoiseClassPredictor`: small heads that
    read an encoder feature map and predict the corruption intensity /
    class (generator.py:403-489), with train-mode BatchNorm (batch
    statistics, flax's numerics, a 0.9/0.1 running update);
  * SubAdd (`SubAddGenerator.update_E/update_D`, generator.py:581-621):
    the encoder is trained so clean and noisy features collapse (L1 x
    l1_mult) while fooling an intensity adversary (MSE GAN); the
    adversary sees the feature ratio noisy/clean against the all-ones
    "clean" reference; TTUR lrs (encoder lr/2, D lr*2), and D's
    optimizer at D's lr / 2 again (generator.py:536-546), a quirk of the
    reference kept as JAX keeps it;
  * Contrasive (`ContrasiveGenerator.update_E`, generator.py:719-731):
    plain feature L1 between clean and noisy views.

Both heads flatten their last map in NHWC order (y, x, c) before the
dense layers, as JAX's `reshape(B, -1)`, so the bridged kernels fit.
flax infers input widths; here `in_ch` (the encoder's channels) and
`sw` (its map's side) give them.

Where the JAX functions take parameter trees and optimizer states beside
the modules, these steps take the modules: each updates its module in
place (`ghost_adam`, the GAN's Adam) and returns its metrics, detached.
The encoder step runs the adversary with its running statistics kept (JAX
throws that apply's batch_stats away); the adversary's step moves them
twice, on the real and then the fake batch, as JAX chains its updates.
"""

from __future__ import annotations

import torch
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import (BatchNorm, Conv, Dense,
                                       frozen_batch_stats, instance_norm,
                                       leaky_relu, to_nchw, to_nhwc)
from ghost_tpu_torch.train.optimizers import GhostAdam
from ghost_tpu_torch.train.train_step import _apply_grads


def _downs(sw: int) -> int:
    """The stride-2 downs that take a map of side sw to at most 4."""
    n = 0
    while sw > 4:
        sw //= 2
        n += 1
    return n


class _NoisePredictor(nn.Module):
    """The shared trunk: 1x1 conv to `bottleneck`, norm, LReLU(0.2), then
    stride-2 3x3 downs to 4x4 (each norm + LReLU), flatten, fc0, fc_bn
    (BatchNorm), LReLU, fc1. `batch_norm` picks the trunk's norm."""

    batch_norm = True

    def __init__(self, sw: int = 8, outdim: int = 1,
                 policy: Policy = DEFAULT_POLICY, train: bool = True,
                 bottleneck: int = 256, middim: int = 256, in_ch: int = 256,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.policy = policy
        self.outdim = outdim
        self.n_down = _downs(sw)
        side = sw
        bn = dict(dtype=cd, device=device, train=train)
        self.compact = Conv(in_ch, bottleneck, 1, dtype=cd, device=device)
        if self.batch_norm:
            self.bn0 = BatchNorm(bottleneck, **bn)
        for i in range(self.n_down):
            side = (side - 1) // 2 + 1
            setattr(self, f"down{i}", Conv(bottleneck, bottleneck, 3, 2,
                                           padding=1, dtype=cd,
                                           device=device))
            if self.batch_norm:
                setattr(self, f"bn{i + 1}", BatchNorm(bottleneck, **bn))
        self.fc0 = Dense(bottleneck * side * side, middim, dtype=cd,
                         device=device)
        self.fc_bn = BatchNorm(middim, **bn)
        self.fc1 = Dense(middim, outdim, dtype=cd, device=device)

    def _norm(self, x, name):
        """x NCHW (channels_last)."""
        if self.batch_norm:
            return getattr(self, name)(x)
        cd = self.policy.compute_dtype
        return to_nchw(instance_norm(to_nhwc(x).float()).to(cd))

    def forward(self, x):
        """x: (B, sw, sw, in_ch) NHWC."""
        cd = self.policy.compute_dtype
        x = self.compact(to_nchw(x.to(cd)))
        x = leaky_relu(self._norm(x, "bn0"), 0.2)
        for i in range(self.n_down):
            x = getattr(self, f"down{i}")(x)
            x = leaky_relu(self._norm(x, f"bn{i + 1}"), 0.2)
        x = to_nhwc(x).reshape(x.shape[0], -1)
        x = leaky_relu(self.fc_bn(self.fc0(x)), 0.2)
        return self.fc1(x)


class NoiseIntensityPredictor(_NoisePredictor):
    """Feature map -> scalar corruption intensity (B,) when outdim is 1
    (reference generator.py:445-489), BatchNorm throughout."""

    def forward(self, x):
        x = super().forward(x)
        return x.squeeze(-1) if self.outdim == 1 else x


class NoiseClassPredictor(_NoisePredictor):
    """Feature map -> corruption-class logits (reference
    generator.py:403-442): the trunk on f32 instance norms, BatchNorm
    only after fc0."""

    batch_norm = False

    def __init__(self, sw: int = 8, outdim: int = 2, **kw):
        super().__init__(sw, outdim, **kw)


def make_subadd_pretrain_steps(encoder: nn.Module, disc_mod: nn.Module,
                               lr: float = 2e-4, no_ttur: bool = False,
                               l1_mult: float = 10.0, noise_dim: int = 1):
    """SubAdd scheme (reference generator.py:536-546,581-621).

    encoder: x NHWC -> feature map NHWC (a LIPEncoder); disc_mod: a
    NoiseIntensityPredictor. Returns (e_step, d_step, e_opt, d_opt):

      e_step(clean, noisy) -> {l1, gan_E, sum}  (one encoder update)
      d_step(clean, noisy, noise_label) -> {gan_D_real, gan_D_fake}
          (one adversary update)
    """
    g_lr, d_lr = (lr, lr) if no_ttur else (lr / 2, lr * 2)
    e_params = list(encoder.parameters())
    d_params = list(disc_mod.parameters())
    e_opt = GhostAdam(e_params, g_lr)
    d_opt = GhostAdam(d_params, d_lr / 2)  # optimizer_D uses D_lr/2 (:545)

    def e_step(clean, noisy):
        feats = encoder(torch.cat([clean, noisy], 0))
        nb = clean.shape[0]
        f_real, f_fake = feats[:nb], feats[nb:]
        with frozen_batch_stats(disc_mod):
            pred_fake = disc_mod(f_fake)
        loss_l1 = torch.mean(torch.abs(f_fake - f_real))
        loss_gan = torch.mean(torch.square(pred_fake - 1.0))  # clean = 1
        loss = loss_l1 * l1_mult + loss_gan
        _apply_grads(loss, e_params, e_opt)
        return {"l1": loss_l1.detach(), "gan_E": loss_gan.detach(),
                "sum": loss.detach()}

    def d_step(clean, noisy, noise_label):
        with torch.no_grad():
            feats = encoder(torch.cat([clean, noisy], 0))
        nb = clean.shape[0]
        f_fake = feats[nb:] / (feats[:nb] + 1e-6)
        f_real = torch.ones_like(f_fake)
        pred_real = disc_mod(f_real)
        pred_fake = disc_mod(f_fake)
        loss_real = torch.mean(torch.square(pred_real - 1.0))
        loss_fake = torch.mean(torch.square(pred_fake - noise_label))
        loss = (loss_real + loss_fake * noise_dim) / 2.0
        _apply_grads(loss, d_params, d_opt)
        return {"gan_D_real": loss_real.detach(),
                "gan_D_fake": loss_fake.detach()}

    return e_step, d_step, e_opt, d_opt


def make_contrasive_pretrain_step(encoder: nn.Module, lr: float = 2e-4):
    """Contrasive scheme (reference generator.py:719-731): encoder-only
    feature L1 between clean and noisy views. Returns (e_step, e_opt);
    e_step(clean, noisy) -> loss, after one encoder update."""
    e_params = list(encoder.parameters())
    e_opt = GhostAdam(e_params, lr)

    def e_step(clean, noisy):
        feats = encoder(torch.cat([clean, noisy], 0))
        nb = clean.shape[0]
        loss = torch.mean(torch.abs(feats[nb:] - feats[:nb]))
        _apply_grads(loss, e_params, e_opt)
        return loss.detach()

    return e_step, e_opt
