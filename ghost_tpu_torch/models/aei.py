"""AEI-Net, the GHOST one-shot swap generator, mirroring `ghost_tpu/models/aei.py`.

  * MLAttrEncoder: 7 conv4x4 s2 (BN, LeakyReLU 0.1) downs, 6 deconv4x4
    ups with unet skip-concat (or linknet skip-add), then a final 2x
    bilinear align_corners upsample: 8 attribute maps, 2x2 ... 256x256;
  * AADGenerator: z_id -> ConvTranspose(k2) to 2x2, then 8 AAD res-blocks
    each followed by a 2x bilinear upsample, tanh output;
  * AADLayer: attr gamma|beta from one 1x1 conv (2*c_x outputs), id
    gamma|beta from one dense layer, then the modulation: with
    `fused_aad=True` the fused AAD kernel (`ops/cuda/aad.py:aad_modulate`,
    the CUDA kernel for CUDA tensors; inference only, its backward
    raises), with `fused_aad=False` (the default, as in JAX) plain torch
    ops that train.

Inside, tensors are NCHW in channels_last memory, so a pixel's channels
are contiguous, the layout the AAD kernel reads; `AEINet.forward` takes
and returns NHWC like the JAX model. The resnet encoder is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import (BatchNorm, Conv, ConvTranspose, Dense,
                                       instance_norm, leaky_relu,
                                       resize_like_torch, to_nchw, to_nhwc)
from ghost_tpu_torch.ops.cuda.aad import aad_modulate

# channel plans (reference network/AEI_Net.py)
_DOWN_CH = (32, 64, 128, 256, 512, 1024, 1024)
_UP_OUT = (1024, 512, 256, 128, 64, 32)
_AAD_CIN = (1024, 1024, 1024, 1024, 512, 256, 128, 64)
_AAD_COUT = (1024, 1024, 1024, 512, 256, 128, 64, 3)


def _scaled(ch: int, width: float) -> int:
    """Scale a channel count, keeping it even (for gamma/beta splits)."""
    if width == 1.0:
        return ch
    return max(4, int(round(ch * width / 2)) * 2)


def _upsample2x(x):
    """2x bilinear align_corners upsample of an NCHW channels_last map."""
    return to_nchw(resize_like_torch(to_nhwc(x), 2.0, method="bilinear",
                                     align_corners=True))


class DownBlock(nn.Module):
    """conv4x4 stride-2 + BN + LeakyReLU(0.1)."""

    def __init__(self, cin, features, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.conv = Conv(cin, features, 4, 2, padding=1, use_bias=False,
                         dtype=cd, device=device)
        self.bn = BatchNorm(features, dtype=cd, device=device)

    def forward(self, x):
        return leaky_relu(self.bn(self.conv(x)), 0.1)


class UpBlock(nn.Module):
    """deconv4x4 stride-2 + BN + LeakyReLU(0.1), then skip concat (unet)
    or add (linknet)."""

    def __init__(self, cin, features, backbone="unet",
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.backbone = backbone
        self.deconv = ConvTranspose(cin, features, 4, 2, 1, use_bias=False,
                                    dtype=cd, device=device)
        self.bn = BatchNorm(features, dtype=cd, device=device)

    def forward(self, x, skip):
        x = leaky_relu(self.bn(self.deconv(x)), 0.1)
        if self.backbone == "linknet":
            return x + skip
        return torch.cat([x, skip], dim=1)


class MLAttrEncoder(nn.Module):
    """Multi-level attribute encoder: 8 NCHW maps coarse->fine."""

    def __init__(self, backbone="unet", policy: Policy = DEFAULT_POLICY,
                 width: float = 1.0, device=None):
        super().__init__()
        self.policy = policy
        down = [_scaled(c, width) for c in _DOWN_CH]
        cin = 3
        for i, ch in enumerate(down):
            self.add_module(f"down{i + 1}", DownBlock(cin, ch, policy, device))
            cin = ch
        attr_ch = [down[-1]]
        h_ch = down[-1]
        for i, ch in enumerate(_UP_OUT):
            ch = _scaled(ch, width)
            self.add_module(f"up{i + 1}", UpBlock(h_ch, ch, backbone, policy,
                                                  device))
            skip = down[-2 - i]
            h_ch = ch + skip if backbone == "unet" else ch
            attr_ch.append(h_ch)
        attr_ch.append(h_ch)
        self.attr_channels = tuple(attr_ch)

    def forward(self, xt):
        feats = []
        h = xt.to(self.policy.compute_dtype)
        for i in range(len(_DOWN_CH)):
            h = getattr(self, f"down{i + 1}")(h)
            feats.append(h)
        attrs = [feats[-1]]
        h = feats[-1]
        for i in range(len(_UP_OUT)):
            h = getattr(self, f"up{i + 1}")(h, feats[-2 - i])
            attrs.append(h)
        attrs.append(_upsample2x(h))
        return tuple(attrs)


class AADLayer(nn.Module):
    """Adaptive Attentional Denormalization.

    attr_upsample=2 takes z_attr at half the resolution of h and
    upsamples the 1x1 conv OUTPUT (the conv is per-pixel affine and the
    align_corners weights sum to 1, so conv(up(z)) == up(conv(z))).

    fused_aad picks the modulation at construction, as the JAX `fused`
    flag does: True runs the fused kernel (inference; its backward
    raises), False the unfused body of `ghost_tpu/models/aei.py:209-218`,
    which trains. Both read the same parameters."""

    def __init__(self, c_x, c_attr, c_id=512, policy: Policy = DEFAULT_POLICY,
                 attr_upsample: int = 1, fused_aad: bool = False,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.c_x = c_x
        self.compute_dtype = cd
        self.attr_upsample = attr_upsample
        self.fused_aad = fused_aad
        self.attr_gb = Conv(c_attr, 2 * c_x, 1, dtype=cd, device=device)
        self.id_gb = Dense(c_id, 2 * c_x, dtype=cd, device=device)
        # an f32 parameter: read in f32 by the fused kernel, cast to the
        # compute dtype by the unfused path (JAX's Conv(1, dtype=cd))
        self.mask = Conv(c_x, 1, 1, dtype=torch.float32, device=device)

    def forward(self, h_in, z_attr, z_id):
        ab_attr = self.attr_gb(z_attr)
        if self.attr_upsample > 1:
            ab_attr = to_nchw(resize_like_torch(
                to_nhwc(ab_attr), float(self.attr_upsample),
                method="bilinear", align_corners=True))
        ab = to_nhwc(ab_attr)  # (B,H,W,2C): gamma|beta halves share rows
        ab_id = self.id_gb(z_id)
        cd, c = self.compute_dtype, self.c_x
        h = to_nhwc(h_in.to(cd))
        if self.fused_aad:  # K1 reads h as contiguous NHWC rows
            return to_nchw(aad_modulate(h.contiguous(), ab[..., :c],
                                        ab[..., c:], ab_id, self.mask.weight,
                                        self.mask.bias))
        # f32 statistics over tensors in the compute dtype
        h = instance_norm(h)
        m = torch.sigmoid(to_nhwc(F.conv2d(
            to_nchw(h), self.mask.weight.to(cd), self.mask.bias.to(cd))))
        a = ab[..., :c] * h + ab[..., c:]
        i = ab_id[:, None, None, :c] * h + ab_id[:, None, None, c:]
        return to_nchw((1.0 - m) * a + m * i)


class AADResBlock(nn.Module):
    """num_blocks x (AAD -> ReLU -> conv3x3) + AAD shortcut when channels
    change."""

    def __init__(self, cin, cout, c_attr, c_id=512, num_blocks=2,
                 policy: Policy = DEFAULT_POLICY, attr_upsample: int = 1,
                 fused_aad: bool = False, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.num_blocks = num_blocks
        self.shortcut = cin != cout
        for i in range(num_blocks):
            out_ch = cin if i < num_blocks - 1 else cout
            self.add_module(f"aad{i}", AADLayer(cin, c_attr, c_id, policy,
                                                attr_upsample, fused_aad,
                                                device))
            self.add_module(f"conv{i}", Conv(cin, out_ch, 3, padding=1,
                                             use_bias=False, dtype=cd,
                                             device=device))
        if self.shortcut:
            self.aad_short = AADLayer(cin, c_attr, c_id, policy, attr_upsample,
                                      fused_aad, device)
            self.conv_short = Conv(cin, cout, 3, padding=1, use_bias=False,
                                   dtype=cd, device=device)

    def forward(self, h, z_attr, z_id):
        x = h
        for i in range(self.num_blocks):
            x = torch.relu(getattr(self, f"aad{i}")(x, z_attr, z_id))
            x = getattr(self, f"conv{i}")(x)
        if self.shortcut:
            s = torch.relu(self.aad_short(h, z_attr, z_id))
            return x + self.conv_short(s)
        return x + h


class AADGenerator(nn.Module):
    """8 AAD res-blocks with 2x bilinear upsampling between them, tanh out.

    blk8's attr map (unet/linknet) is a pure 2x upsample of z_attr7 and
    blk8 reads it only through 1x1 convs: it takes the 128-res map and
    upsamples the conv outputs instead (exact commute, 1/4 the pixels).

    fused_aad=True runs the fused AAD kernel in every AADLayer (JAX gates
    it on cin >= 128 and k >= 4, a TPU lowering choice)."""

    def __init__(self, attr_channels, backbone="unet", c_id=512, num_blocks=2,
                 policy: Policy = DEFAULT_POLICY, width: float = 1.0,
                 fused_aad: bool = False, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.policy = policy
        self.commute8 = backbone in ("unet", "linknet")
        self.up1 = ConvTranspose(c_id, _scaled(1024, width), 2, 1, 0,
                                 dtype=cd, device=device)
        for k in range(8):
            cin = _scaled(_AAD_CIN[k], width)
            cout = _AAD_COUT[k] if k == 7 else _scaled(_AAD_COUT[k], width)
            commute = k == 7 and self.commute8
            c_attr = attr_channels[6 if commute else k]
            self.add_module(f"blk{k + 1}", AADResBlock(
                cin, cout, c_attr, c_id, num_blocks, policy,
                2 if commute else 1, fused_aad, device))

    def forward(self, z_attrs, z_id):
        cd = self.policy.compute_dtype
        z_id = z_id.to(cd)
        m = self.up1(z_id[:, :, None, None])
        m = m.contiguous(memory_format=torch.channels_last)
        for k in range(8):
            za = z_attrs[6] if (k == 7 and self.commute8) else z_attrs[k]
            y = getattr(self, f"blk{k + 1}")(m, za.to(cd), z_id)
            if k < 7:
                m = _upsample2x(y)
        return torch.tanh(y).to(self.policy.output_dtype)


class AEINet(nn.Module):
    """forward(Xt (B,256,256,3) NHWC, z_id (B,512)) -> (Y NHWC, z_attrs NHWC).

    fused_aad: False (the default, as in JAX) trains; True runs the
    inference-only fused AAD kernel, as the swap pipeline does."""

    def __init__(self, backbone="unet", c_id=512, num_blocks=2,
                 policy: Policy = DEFAULT_POLICY, width: float = 1.0,
                 fused_aad: bool = False, device=None):
        super().__init__()
        if backbone not in ("unet", "linknet"):
            raise ValueError(f"backbone {backbone!r} is not ported "
                             "(unet and linknet are)")
        self.encoder = MLAttrEncoder(backbone, policy, width, device)
        self.generator = AADGenerator(self.encoder.attr_channels, backbone,
                                      c_id, num_blocks, policy, width,
                                      fused_aad, device)

    def forward(self, xt, z_id):
        attrs = self.encoder(to_nchw(xt.contiguous()))
        y = self.generator(attrs, z_id)
        return to_nhwc(y), tuple(to_nhwc(a) for a in attrs)

    def get_attr(self, xt):
        return tuple(to_nhwc(a)
                     for a in self.encoder(to_nchw(xt.contiguous())))
