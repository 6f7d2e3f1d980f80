"""SR training losses, mirroring `ghost_tpu/models/sr/losses.py`: the
GAN loss in its four modes over the per-scale lists, GAN feature
matching, the weighted VGG L1, KLD and the multiscale perceptual colour
loss.

Parity targets (the reference's, through the JAX module):
  * GANLoss ls/original/hinge/wgan with per-scale list handling
    (reference models/networks/loss.py:16-98);
  * VGGLoss with weights [1/32,1/16,1/8,1/4,1] (loss.py:102-116);
  * KLDLoss (loss.py:120-122);
  * GAN feature-matching L1 over intermediate D features
    (reference models/pix2pix_model.py:71-97);
  * MultiScalePerceptualColorLoss: 4-scale MSE + VGG feature MSE
    (reference models/MultiScalePerceptualColorLoss.py:6-37).

The sums run in f32 where the JAX module casts; a stop-gradient there is
a `detach` here. Images and feature maps are NHWC.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from ghost_tpu_torch.nn.layers import resize


def _gan_loss_single(logits, target_real: bool, mode: str, for_D: bool):
    x = logits.float()
    if mode == "ls":
        t = 1.0 if target_real else 0.0
        return torch.mean(torch.square(x - t))
    if mode == "original":
        t = torch.ones_like(x) if target_real else torch.zeros_like(x)
        return torch.mean(-(t * F.logsigmoid(x) + (1 - t) * F.logsigmoid(-x)))
    if mode == "hinge":
        if for_D:
            if target_real:
                return -torch.mean(torch.clamp(x - 1.0, max=0.0))
            return -torch.mean(torch.clamp(-x - 1.0, max=0.0))
        assert target_real, "hinge G loss expects target_real"
        return -torch.mean(x)
    if mode in ("w", "wgan"):
        return -torch.mean(x) if target_real else torch.mean(x)
    raise ValueError(mode)


def gan_loss(d_outputs, target_real: bool, mode: str = "hinge",
             for_discriminator: bool = True):
    """Multiscale-aware GAN loss (loss.py:79-98): d_outputs is a list
    over scales, each element a list whose last entry is the logits."""
    if isinstance(d_outputs, (list, tuple)):
        total = 0.0
        for out in d_outputs:
            pred = out[-1] if isinstance(out, (list, tuple)) else out
            total = total + _gan_loss_single(pred, target_real, mode,
                                             for_discriminator)
        return total / len(d_outputs)
    return _gan_loss_single(d_outputs, target_real, mode, for_discriminator)


def feature_matching_loss(d_fake_feats, d_real_feats):
    """L1 over intermediate D features (every entry but the logits),
    averaged over scales; the real features take no gradient."""
    total = 0.0
    for fake, real in zip(d_fake_feats, d_real_feats):
        for f, r in zip(fake[:-1], real[:-1]):
            total = total + torch.mean(torch.abs(f.float()
                                                 - r.detach().float()))
    return total / len(d_fake_feats)


VGG_SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_loss(vgg_apply: Callable, x, y):
    """Weighted L1 over the 5 VGG slices (loss.py:102-116); y's features
    take no gradient."""
    fx = vgg_apply(x)
    fy = vgg_apply(y)
    total = 0.0
    for w, a, b in zip(VGG_SLICE_WEIGHTS, fx, fy):
        total = total + w * torch.mean(torch.abs(a.float()
                                                 - b.detach().float()))
    return total


def kld_loss(mu, logvar):
    """-0.5 * sum(1 + logvar - mu^2 - exp(logvar)) (loss.py:120-122)."""
    return -0.5 * torch.sum(1 + logvar - torch.square(mu) - torch.exp(logvar))


def multiscale_perceptual_color_loss(vgg_apply: Callable | None, x, y,
                                     scales: Sequence[float] = (1.0, 0.5,
                                                                0.25, 0.125)):
    """The image MSE at 4 bilinear scales, averaged, plus the mean of the
    VGG slices' feature MSEs when `vgg_apply` is given (reference
    models/MultiScalePerceptualColorLoss.py:6-37)."""
    total = 0.0
    for s in scales:
        h = max(int(x.shape[1] * s), 1)
        w = max(int(x.shape[2] * s), 1)
        xs = resize(x, (h, w), method="bilinear")
        ys = resize(y, (h, w), method="bilinear")
        total = total + torch.mean(torch.square(xs.float() - ys.float()))
    total = total / len(scales)
    if vgg_apply is not None:
        fx = vgg_apply(x)
        fy = vgg_apply(y)
        feat = sum(torch.mean(torch.square(a.float() - b.float()))
                   for a, b in zip(fx, fy)) / len(fx)
        total = total + feat
    return total
