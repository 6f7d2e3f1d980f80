"""SPADE / LIPSPADE super-resolution generators, mirroring
`ghost_tpu/models/sr/generator.py`.

  * lip2d: local importance pooling, a weighted 3x3/s2 (pad 1) average
    sum(x e^logit) / sum(e^logit);
  * SimplifiedLIP: logit = sigmoid(affine IN(conv(x))) * 12, then lip2d;
  * LIPEncoder: conv stem + 5 x (LIP pool + conv + IN [+ relu]), channel
    ratios 2, 4, 8, 16, 16;
  * SPADEGenerator: fc conv on the 1/32 nearest-downsampled input, a
    head block, 2 middle blocks, 4 up blocks with x2 nearest upsampling,
    to_rgb + tanh;
  * LIPSPADEGenerator: the CLI's default SR seat (`--sr_model lipspade`),
    SPADEGenerator with the LIP encoder in place of the plain downsample;
  * ContentAdaptiveSuppressor: a conv head and 5 nested LIP stages, every
    stage reading the previous one's output, returning the 6 feature
    maps smallest first;
  * HiFaceGANGenerator: SPADEGenerator's decoder with each stage's norms
    reading the suppressor's map of its own scale in place of the image.

`train=True` runs every SPADE block in training mode (batch-statistics
norms, the spectral convs' power iteration), as the JAX modules' `train`.
NHWC in and out ([-1,1] images, the SR seat contract); the convs are
`F.conv2d` on the NCHW view, as the JAX package computes them with lax.
"""

from __future__ import annotations

import torch
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import (Conv, instance_norm, leaky_relu,
                                       resize, window_sum_3x3s2)

from .spade import SPADEResnetBlock, conv_nhwc


def lip2d(x, logit):
    """Local importance pooling of NHWC x with weights exp(logit):
    window sums over 3x3, stride 2, zero padding 1 (strided slices, not
    F.avg_pool2d, whose CUDA backward on channels_last input ignores
    divisor_override: the encoders train on the card)."""
    w = torch.exp(logit)
    return window_sum_3x3s2(x * w) / window_sum_3x3s2(w)


class SimplifiedLIP(nn.Module):
    """in_scale and in_bias are bare parameters of this module, as in
    the flax tree."""

    def __init__(self, ch, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.policy = policy
        self.logit_conv = Conv(ch, ch, 3, padding=1, use_bias=False,
                               dtype=policy.compute_dtype, device=device)
        self.in_scale = nn.Parameter(torch.empty(ch, device=device))
        self.in_bias = nn.Parameter(torch.empty(ch, device=device))

    def reset_parameters(self, generator):
        nn.init.ones_(self.in_scale)
        nn.init.zeros_(self.in_bias)

    def forward(self, x):
        logit = conv_nhwc(self.logit_conv, x)
        logit = instance_norm(logit.float()) * self.in_scale + self.in_bias
        logit = torch.sigmoid(logit) * 12.0
        return lip2d(x.float(), logit).to(self.policy.compute_dtype)


class LIPEncoder(nn.Module):
    def __init__(self, ngf: int = 48, n_2xdown: int = 5,
                 policy: Policy = DEFAULT_POLICY, in_ch: int = 3,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.policy = policy
        self.n_2xdown = n_2xdown
        self.stem = Conv(in_ch, ngf, 3, padding=1, use_bias=False, dtype=cd,
                         device=device)
        ratio = 1
        for i in range(n_2xdown):
            nxt = min(ratio * 2, 16)
            setattr(self, f"lip{i}", SimplifiedLIP(ngf * ratio, policy,
                                                   device=device))
            setattr(self, f"conv{i}", Conv(ngf * ratio, ngf * nxt, 3,
                                           padding=1, dtype=cd,
                                           device=device))
            ratio = nxt

    def forward(self, x):
        cd = self.policy.compute_dtype
        x = conv_nhwc(self.stem, x)
        x = torch.relu(instance_norm(x.float()).to(cd))
        for i in range(self.n_2xdown):
            x = getattr(self, f"lip{i}")(x)
            x = conv_nhwc(getattr(self, f"conv{i}"), x)
            x = instance_norm(x.float()).to(cd)
            if i < self.n_2xdown - 1:
                x = torch.relu(x)
        return x


class SPADEGenerator(nn.Module):
    """Input image in [-1,1] NHWC -> enhanced image, same size (a
    multiple of 32)."""

    # the segmentation map's channels for head_0, the middle blocks and
    # ups_0..ups_3, in units of ngf (None: the input image's)
    _SEG_MULT = (None,) * 7

    def __init__(self, ngf: int = 48, param_free: str = "syncbatch",
                 policy: Policy = DEFAULT_POLICY, in_ch: int = 3,
                 train: bool = False, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.ngf = ngf
        self.policy = policy
        self._build_encoder(in_ch, device)
        kw = dict(param_free=param_free, policy=policy, train=train,
                  device=device)
        seg = [in_ch if m is None else m * ngf for m in self._SEG_MULT]
        self.head_0 = SPADEResnetBlock(16 * ngf, 16 * ngf, label_nc=seg[0],
                                       **kw)
        self.G_middle_0 = SPADEResnetBlock(16 * ngf, 16 * ngf,
                                           label_nc=seg[1], **kw)
        self.G_middle_1 = SPADEResnetBlock(16 * ngf, 16 * ngf,
                                           label_nc=seg[2], **kw)
        plan = [(16 * ngf, 8 * ngf), (8 * ngf, 4 * ngf),
                (4 * ngf, 2 * ngf), (2 * ngf, 1 * ngf)]
        for i, (fin, fout) in enumerate(plan):
            setattr(self, f"ups_{i}", SPADEResnetBlock(
                fin, fout, label_nc=seg[3 + i], **kw))
        self.to_rgb = Conv(ngf, 3, 3, padding=1, dtype=cd, device=device)

    def _build_encoder(self, in_ch, device):
        self.fc = Conv(in_ch, 16 * self.ngf, 3, padding=1,
                       dtype=self.policy.compute_dtype, device=device)

    def encode(self, x):
        z = resize(x, (x.shape[1] // 32, x.shape[2] // 32), method="nearest")
        return conv_nhwc(self.fc, z)

    def forward(self, x):
        h = self.encode(x.to(self.policy.compute_dtype))
        return self._decode(h, [x] * 7)

    def _decode(self, h, segs):
        """segs: the segmentation map of each of the 7 blocks in order."""
        def up(t):
            return resize(t, (t.shape[1] * 2, t.shape[2] * 2),
                          method="nearest")

        h = up(self.head_0(h, segs[0]))
        h = self.G_middle_0(h, segs[1])
        h = self.G_middle_1(h, segs[2])
        for i in range(4):
            h = getattr(self, f"ups_{i}")(up(h), segs[3 + i])
        h = conv_nhwc(self.to_rgb, leaky_relu(h, 0.2))
        return torch.tanh(h).to(self.policy.output_dtype)


class LIPSPADEGenerator(SPADEGenerator):
    """The configured SR netG: SPADE decoder + LIP encoder."""

    def _build_encoder(self, in_ch, device):
        self.lip_encoder = LIPEncoder(self.ngf, 5, self.policy, in_ch,
                                      device=device)

    def encode(self, x):
        return self.lip_encoder(x)


class ContentAdaptiveSuppressor(nn.Module):
    """Nested encoder (`ghost_tpu/models/sr/generator.py:144-172`):
    forward(x) -> the 6 feature maps, smallest first (ngf * 16 at 1/32,
    ngf * 16 at 1/16, then ngf * 8, 4, 2 and 1 up to full size)."""

    def __init__(self, ngf: int = 48, n_2xdown: int = 5,
                 policy: Policy = DEFAULT_POLICY, in_ch: int = 3,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.policy = policy
        self.n_2xdown = n_2xdown
        self.head = Conv(in_ch, ngf, 3, padding=1, use_bias=False, dtype=cd,
                         device=device)
        ratio = 1
        for i in range(n_2xdown):
            nxt = min(ratio * 2, 16)
            setattr(self, f"lip{i}", SimplifiedLIP(ngf * ratio, policy,
                                                   device=device))
            setattr(self, f"conv{i}", Conv(ngf * ratio, ngf * nxt, 3,
                                           padding=1, dtype=cd,
                                           device=device))
            ratio = nxt

    def forward(self, x):
        cd = self.policy.compute_dtype
        h = conv_nhwc(self.head, x)
        feats = [torch.relu(instance_norm(h.float()).to(cd))]
        for i in range(self.n_2xdown):
            h = getattr(self, f"lip{i}")(feats[0])
            h = conv_nhwc(getattr(self, f"conv{i}"), h)
            h = instance_norm(h.float()).to(cd)
            if i < self.n_2xdown - 1:
                h = torch.relu(h)
            feats.insert(0, h)
        return feats


class HiFaceGANGenerator(SPADEGenerator):
    """SPADE decoder guided stage by stage by the ContentAdaptiveSuppressor
    (`ghost_tpu/models/sr/generator.py:175-202`): head_0 reads its 1/32
    map, both middle blocks the 1/16 map, ups_i the next larger one."""

    _SEG_MULT = (16, 16, 16, 8, 4, 2, 1)

    def __init__(self, ngf: int = 48, param_free: str = "syncbatch",
                 policy: Policy = DEFAULT_POLICY, in_ch: int = 3,
                 train: bool = False, device=None):
        super().__init__(ngf, param_free, policy, in_ch, train, device)
        self.encoder = ContentAdaptiveSuppressor(ngf, 5, policy, in_ch,
                                                 device=device)

    def forward(self, x):
        xs = self.encoder(x)
        h = self.encode(x.to(self.policy.compute_dtype))
        return self._decode(h, [xs[0], xs[1], xs[1], *xs[2:]])
