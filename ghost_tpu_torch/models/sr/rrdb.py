"""RRDBNet, the Real-ESRGAN x4plus background upsampler, mirroring
`ghost_tpu/models/sr/rrdb.py`: dense residual blocks with 0.2-scaled
residuals, an N-block trunk and two nearest-2x conv upsample stages.
`convert.torch_loader.convert_rrdbnet_state_dict` maps the official
checkpoint names (`conv_first`, `body.N.rdbM.convK`, ...).

NHWC in and out, as `SRVGGNetCompact` is, so the enhancer's tiler treats
both background models alike. The convs are `nn.layers.Conv` (cuDNN on
the card) on the NCHW view; the JAX package computes them with lax
outside any Pallas kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import Conv, leaky_relu

from .spade import conv_nhwc


def _lrelu(x):
    return leaky_relu(x, 0.2)


def nearest_up2(x):
    """F.interpolate(scale_factor=2, mode='nearest') parity, NHWC."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


def pixel_unshuffle(x, factor: int):
    """Space-to-depth (torch pixel_unshuffle parity): NHWC (B, H, W, C)
    -> (B, H/f, W/f, C*f*f) with torch's channel order (c, fy, fx)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // factor, w // factor, c * factor * factor)


def _conv3(cin, cout, cd, device):
    return Conv(cin, cout, 3, padding=1, dtype=cd, device=device)


class ResidualDenseBlock(nn.Module):
    """5-conv dense block: conv_k sees [x, y1..y_{k-1}]; 0.2 residual."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        for k in range(1, 5):
            setattr(self, f"conv{k}", _conv3(num_feat + (k - 1) * num_grow_ch,
                                             num_grow_ch, cd, device))
        self.conv5 = _conv3(num_feat + 4 * num_grow_ch, num_feat, cd, device)

    def forward(self, x):
        feats = [x]
        for k in range(1, 5):
            y = conv_nhwc(getattr(self, f"conv{k}"), torch.cat(feats, dim=-1))
            feats.append(_lrelu(y))
        y5 = conv_nhwc(self.conv5, torch.cat(feats, dim=-1))
        return y5 * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        for m in (1, 2, 3):
            setattr(self, f"rdb{m}", ResidualDenseBlock(
                num_feat, num_grow_ch, policy, device=device))

    def forward(self, x):
        out = self.rdb3(self.rdb2(self.rdb1(x)))
        return out * 0.2 + x


class RRDBNet(nn.Module):
    """x4 (default), x2, or x1 SR: sub-unit scales pixel-unshuffle the
    input so the trunk always runs at 1/4 output resolution. NHWC in
    (any dtype) and out, in the policy's compute dtype."""

    def __init__(self, num_out_ch: int = 3, num_feat: int = 64,
                 num_block: int = 23, num_grow_ch: int = 32, scale: int = 4,
                 policy: Policy = DEFAULT_POLICY, num_in_ch: int = 3,
                 device=None):
        super().__init__()
        if scale not in (1, 2, 4):
            raise ValueError(f"RRDBNet scale must be 1, 2 or 4, got {scale}")
        self.scale, self.num_block, self.policy = scale, num_block, policy
        cd = policy.compute_dtype
        cin = num_in_ch * {4: 1, 2: 4, 1: 16}[scale]
        self.conv_first = _conv3(cin, num_feat, cd, device)
        for i in range(num_block):
            setattr(self, f"body_{i}", RRDB(num_feat, num_grow_ch, policy,
                                            device=device))
        for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
            setattr(self, name, _conv3(num_feat, num_feat, cd, device))
        self.conv_last = _conv3(num_feat, num_out_ch, cd, device)

    def forward(self, x):
        x = x.to(self.policy.compute_dtype)
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = conv_nhwc(self.conv_first, x)
        body = feat
        for i in range(self.num_block):
            body = getattr(self, f"body_{i}")(body)
        feat = feat + conv_nhwc(self.conv_body, body)
        feat = _lrelu(conv_nhwc(self.conv_up1, nearest_up2(feat)))
        feat = _lrelu(conv_nhwc(self.conv_up2, nearest_up2(feat)))
        feat = _lrelu(conv_nhwc(self.conv_hr, feat))
        return conv_nhwc(self.conv_last, feat)


def rrdb_forward_pipelined(net: RRDBNet, x, *, mesh,
                           num_microbatches: int | None = None,
                           axis: str = "pipe", remat: bool = False,
                           batch_axis: str | None = None):
    """`net(x)` with the N-block trunk pipelined over `axis` of `mesh`
    (`parallel.pp.pipeline_apply`'s GPipe schedule: stage s holds blocks
    [s*ceil(N/S), ...), microbatches hop from stage to stage). The head
    and tail convs run once, on x's device. x's batch must divide by
    num_microbatches (default: the stage count). The same arithmetic as
    `net(x)` on microbatches of the batch: equal to it up to the convs'
    rounding at another batch size.

    The blocks' weights reach each stage's device through
    `pipeline_apply` on every call (no copy where they already lie, as
    with logical shards on one card); gradients flow back to `net`."""
    from torch.func import functional_call

    from ghost_tpu_torch.parallel.pp import pipeline_apply

    x = x.to(net.policy.compute_dtype)
    if net.scale == 2:
        x = pixel_unshuffle(x, 2)
    elif net.scale == 1:
        x = pixel_unshuffle(x, 4)
    feat = conv_nhwc(net.conv_first, x)
    template = net.body_0
    blocks = [getattr(net, f"body_{i}").state_dict(keep_vars=True)
              for i in range(net.num_block)]
    body = pipeline_apply(
        lambda p, h: functional_call(template, p, (h,)), blocks, feat,
        mesh=mesh, axis=axis, num_microbatches=num_microbatches,
        remat=remat, batch_axis=batch_axis)
    feat = feat + conv_nhwc(net.conv_body, body)
    feat = _lrelu(conv_nhwc(net.conv_up1, nearest_up2(feat)))
    feat = _lrelu(conv_nhwc(net.conv_up2, nearest_up2(feat)))
    feat = _lrelu(conv_nhwc(net.conv_hr, feat))
    return conv_nhwc(net.conv_last, feat)
