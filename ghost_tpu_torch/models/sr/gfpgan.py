"""GFPGAN v1 'clean' face restorer, mirroring `ghost_tpu/models/sr/gfpgan.py`:
a U-Net degradation encoder that yields per-resolution SFT conditions
and a w-latent, and a StyleGAN2 decoder (clean variant) modulated by
both. NHWC in and out, [-1, 1] RGB.

ModulatedConv is computed as the JAX module writes it, not as torch's
per-sample grouped conv: the style `s = modulation(style)` in the
compute dtype, `x * s`, one dense conv shared by the batch, then the
demodulation factor, computed in f32 from `weight**2 * s**2` plus eps
and cast to the compute dtype. (A `groups=b` conv rounds differently in
bf16.) The 2x / 0.5x bilinear resamples are the dense-matrix
`nn.layers.resize`. The convs are `nn.layers.Conv` (cuDNN on the card)
on the NCHW view; the JAX package computes them with lax outside any
Pallas kernel.

Noise inputs default to none (deterministic serving). The official
checkpoint layout loads through `convert.torch_loader.
convert_gfpgan_state_dict`; `drop_unread_leaves` removes the converted
leaves that a module built for serving does not read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import (Conv, Dense, leaky_relu, resize,
                                       to_nchw, to_nhwc)

from .spade import conv_nhwc


def _lrelu(x):
    return leaky_relu(x, 0.2)


def _half(x):
    b, h, w, c = x.shape
    return resize(x, (h // 2, w // 2), method="bilinear", align_corners=False)


def _double(x):
    b, h, w, c = x.shape
    return resize(x, (2 * h, 2 * w), method="bilinear", align_corners=False)


def unet_channels(channel_multiplier: int = 2, narrow: float = 1.0):
    # GFPGAN halves the unet width vs the decoder
    return decoder_channels(channel_multiplier, narrow * 0.5)


def decoder_channels(channel_multiplier: int = 2, narrow: float = 1.0):
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow), 64: int(256 * channel_multiplier * narrow),
        128: int(128 * channel_multiplier * narrow),
        256: int(64 * channel_multiplier * narrow),
        512: int(32 * channel_multiplier * narrow),
        1024: int(16 * channel_multiplier * narrow),
    }


class CleanResBlock(nn.Module):
    """gfpgan clean ResBlock: conv1 -> resample -> conv2, + 1x1-skip of
    the resampled input. mode: 'down' (bilinear 0.5) or 'up' (2x)."""

    def __init__(self, cin: int, features: int, mode: str = "down",
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.resample = _half if mode == "down" else _double
        self.conv1 = Conv(cin, cin, 3, padding=1, dtype=cd, device=device)
        self.conv2 = Conv(cin, features, 3, padding=1, dtype=cd,
                          device=device)
        self.skip = Conv(cin, features, 1, use_bias=False, dtype=cd,
                         device=device)

    def forward(self, x):
        res = self.resample(_lrelu(conv_nhwc(self.conv1, x)))
        res = _lrelu(conv_nhwc(self.conv2, res))
        return res + conv_nhwc(self.skip, self.resample(x))


class ModulatedConv(nn.Module):
    """StyleGAN2 modulated conv (clean): x * (style scale) -> dense conv
    -> per-sample demodulation. `weight` is (cout, cin, k, k): the flax
    HWIO `weight` after transpose(3, 2, 0, 1)."""

    def __init__(self, cin: int, features: int, num_style_feat: int,
                 kernel_size: int = 3, demodulate: bool = True,
                 sample_mode: str | None = None, eps: float = 1e-8,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.demodulate, self.sample_mode, self.eps = demodulate, \
            sample_mode, eps
        self.dtype = policy.compute_dtype
        self.padding = kernel_size // 2
        self.modulation = Dense(num_style_feat, cin, dtype=self.dtype,
                                device=device)
        self.weight = nn.Parameter(torch.empty(
            features, cin, kernel_size, kernel_size, device=device))

    def reset_parameters(self, generator):
        cin, k = self.weight.shape[1], self.weight.shape[2]
        self.weight.normal_(0.0, 1.0 / math.sqrt(cin * k * k),
                            generator=generator)

    def forward(self, x, style):
        cd = self.dtype
        s = self.modulation(style.to(cd))  # (b, cin)
        if self.sample_mode == "upsample":
            x = _double(x)
        elif self.sample_mode == "downsample":
            x = _half(x)
        xw = x.to(cd) * s[:, None, None, :]
        y = to_nhwc(F.conv2d(to_nchw(xw), self.weight.to(cd),
                             padding=self.padding))
        if self.demodulate:
            # sum over (cin, kh, kw) of w^2 s^2 = s^2 @ (sum over kh, kw
            # of w^2)^T, in f32
            w2 = torch.square(self.weight.float()).sum(dim=(2, 3))
            demod = 1.0 / torch.sqrt(torch.square(s.float()) @ w2.T
                                     + self.eps)  # (b, cout)
            y = y * demod[:, None, None, :].to(cd)
        return y


class StyleConv(nn.Module):
    """ModulatedConv, the clean-arch gain sqrt(2), optional noise, bias
    and leaky ReLU. `noise_weight` (1,) and `bias` (cout,) are bare
    parameters of this module, as in the flax tree."""

    def __init__(self, cin: int, features: int, num_style_feat: int,
                 kernel_size: int = 3, sample_mode: str | None = None,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.modulated_conv = ModulatedConv(
            cin, features, num_style_feat, kernel_size, True, sample_mode,
            policy=policy, device=device)
        self.noise_weight = nn.Parameter(torch.empty(1, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator):
        nn.init.zeros_(self.noise_weight)
        nn.init.zeros_(self.bias)

    def forward(self, x, style, noise=None):
        cd = self.dtype
        y = self.modulated_conv(x, style) * math.sqrt(2.0)
        if noise is not None:
            y = y + self.noise_weight.to(cd) * noise.to(cd)
        return _lrelu(y + self.bias.to(cd))


class ToRGB(nn.Module):
    """A 1x1 ModulatedConv to RGB without demodulation, a bias (a bare
    parameter, as in the flax tree) and the (upsampled) skip."""

    def __init__(self, cin: int, num_style_feat: int, upsample: bool = True,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.upsample = upsample
        self.dtype = policy.compute_dtype
        self.modulated_conv = ModulatedConv(cin, 3, num_style_feat, 1, False,
                                            None, policy=policy,
                                            device=device)
        self.bias = nn.Parameter(torch.empty(3, device=device))

    def reset_parameters(self, generator):
        nn.init.zeros_(self.bias)

    def forward(self, x, style, skip=None):
        y = self.modulated_conv(x, style) + self.bias.to(self.dtype)
        if skip is not None:
            if self.upsample:
                skip = _double(skip)
            y = y + skip
        return y


class StyleGAN2CSFT(nn.Module):
    """StyleGAN2 clean decoder with channel-split SFT modulation.

    `constant_input` is a bare parameter in flax's NHWC layout
    (1, 4, 4, C). The z path's style MLP (`mlp_{j}`, after upstream's
    NormStyleCode) is built only when `input_is_latent` is False, the
    only case in which the JAX module reads it."""

    def __init__(self, out_size: int = 512, num_style_feat: int = 512,
                 num_mlp: int = 8, channel_multiplier: int = 2,
                 narrow: float = 1.0, sft_half: bool = True,
                 input_is_latent: bool = True,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.log_size = int(math.log2(out_size))
        self.num_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.num_mlp, self.sft_half = num_mlp, sft_half
        self.input_is_latent = input_is_latent
        self.dtype = policy.compute_dtype
        ch = decoder_channels(channel_multiplier, narrow)
        nsf = num_style_feat
        if not input_is_latent:
            for j in range(num_mlp):
                setattr(self, f"mlp_{j}", Dense(nsf, nsf, dtype=self.dtype,
                                                device=device))
        self.constant_input = nn.Parameter(torch.empty(1, 4, 4, ch[4],
                                                       device=device))
        self.style_conv1 = StyleConv(ch[4], ch[4], nsf, 3, None, policy,
                                     device=device)
        self.to_rgb1 = ToRGB(ch[4], nsf, False, policy, device=device)
        cin = ch[4]
        for s in range(self.log_size - 2):
            res = 2 ** (s + 3)
            setattr(self, f"style_convs_{2 * s}", StyleConv(
                cin, ch[res], nsf, 3, "upsample", policy, device=device))
            setattr(self, f"style_convs_{2 * s + 1}", StyleConv(
                ch[res], ch[res], nsf, 3, None, policy, device=device))
            setattr(self, f"to_rgbs_{s}", ToRGB(ch[res], nsf, True, policy,
                                                device=device))
            cin = ch[res]

    def reset_parameters(self, generator):
        self.constant_input.normal_(0.0, 1.0, generator=generator)

    def noise_shapes(self, batch: int):
        """The NHWC shape of each layer's noise input."""
        return [(batch, 2 ** ((j + 5) // 2), 2 ** ((j + 5) // 2), 1)
                for j in range(self.num_layers)]

    def forward(self, styles, conditions, noises=None):
        cd = self.dtype
        if not self.input_is_latent:
            # upstream prepends NormStyleCode to the style MLP
            w = styles.to(cd)
            w = w / torch.sqrt(torch.mean(torch.square(w), dim=-1,
                                          keepdim=True) + 1e-8)
            for j in range(self.num_mlp):
                w = _lrelu(getattr(self, f"mlp_{j}")(w))
            styles = w
        if styles.ndim == 2:  # broadcast one w over all layers
            latent = styles[:, None, :].expand(-1, self.num_latent, -1)
        else:
            latent = styles
        b = latent.shape[0]
        if noises is None:
            noises = [None] * self.num_layers

        out = self.constant_input.to(cd).expand(b, -1, -1, -1)
        out = self.style_conv1(out, latent[:, 0], noises[0])
        skip = self.to_rgb1(out, latent[:, 1])
        for s in range(self.log_size - 2):
            out = getattr(self, f"style_convs_{2 * s}")(
                out, latent[:, 2 * s + 1], noises[2 * s + 1])
            # CSFT: conditions[2s] = scale, [2s+1] = shift
            if len(conditions) > 2 * s + 1:
                sc = conditions[2 * s].to(cd)
                sh = conditions[2 * s + 1].to(cd)
                if self.sft_half:
                    half = out.shape[-1] // 2
                    out = torch.cat([out[..., :half],
                                     out[..., half:] * sc + sh], dim=-1)
                else:
                    out = out * sc + sh
            out = getattr(self, f"style_convs_{2 * s + 1}")(
                out, latent[:, 2 * s + 2], noises[2 * s + 2])
            skip = getattr(self, f"to_rgbs_{s}")(out, latent[:, 2 * s + 3],
                                                 skip)
        return skip


class GFPGANClean(nn.Module):
    """GFPGANv1Clean: U-Net encoder -> (latent, SFT conditions) ->
    StyleGAN2 CSFT decoder. Input (b, out_size, out_size, 3) in [-1, 1]
    RGB; output the same shape and range (clip at the call site).

    The per-resolution `toRGB_{i}` heads are built only with
    `rgb_heads=True`: the JAX module reads them only when called with
    `return_rgb=True`, and so does this one (it raises without them)."""

    def __init__(self, out_size: int = 512, num_style_feat: int = 512,
                 channel_multiplier: int = 2, num_mlp: int = 8,
                 narrow: float = 1.0, sft_half: bool = True,
                 different_w: bool = True, input_is_latent: bool = True,
                 rgb_heads: bool = False, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.dtype = cd
        self.out_size, self.num_style_feat = out_size, num_style_feat
        self.different_w, self.rgb_heads = different_w, rgb_heads
        self.input_is_latent = input_is_latent
        self.log_size = int(math.log2(out_size))
        num_latent = self.log_size * 2 - 2
        ch = unet_channels(channel_multiplier, narrow)

        self.conv_body_first = Conv(3, ch[out_size], 1, dtype=cd,
                                    device=device)
        cin = ch[out_size]
        for i in range(self.log_size - 2):
            res_out = 2 ** (self.log_size - 1 - i)
            setattr(self, f"conv_body_down_{i}", CleanResBlock(
                cin, ch[res_out], "down", policy, device=device))
            cin = ch[res_out]
        self.final_conv = Conv(cin, ch[4], 3, padding=1, dtype=cd,
                               device=device)
        out_dim = (num_latent * num_style_feat if different_w
                   else num_style_feat)
        self.final_linear = Dense(ch[4] * 16, out_dim, dtype=cd,
                                  device=device)
        cin = ch[4]
        for i in range(self.log_size - 2):
            c = ch[2 ** (i + 3)]
            setattr(self, f"conv_body_up_{i}", CleanResBlock(
                cin, c, "up", policy, device=device))
            # the second conv of each condition pair emits the width the
            # decoder modulates: its sft half (= unet c) under sft_half,
            # the full decoder width (= 2c) otherwise
            c_out = c if sft_half else 2 * c
            for kind in ("scale", "shift"):
                setattr(self, f"condition_{kind}_{i}_0",
                        Conv(c, c, 3, padding=1, dtype=cd, device=device))
                setattr(self, f"condition_{kind}_{i}_1",
                        Conv(c, c_out, 3, padding=1, dtype=cd,
                             device=device))
            if rgb_heads:
                setattr(self, f"toRGB_{i}", Conv(c, 3, 1, dtype=cd,
                                                 device=device))
            cin = c
        self.stylegan_decoder = StyleGAN2CSFT(
            out_size, num_style_feat, num_mlp, channel_multiplier, narrow,
            sft_half, input_is_latent, policy, device=device)

    def forward(self, x, noises=None, return_rgb: bool = False):
        if return_rgb and not self.rgb_heads:
            raise ValueError("return_rgb needs GFPGANClean(rgb_heads=True)")
        feat = _lrelu(conv_nhwc(self.conv_body_first, x.to(self.dtype)))
        skips = []
        for i in range(self.log_size - 2):
            feat = getattr(self, f"conv_body_down_{i}")(feat)
            skips.insert(0, feat)
        feat = _lrelu(conv_nhwc(self.final_conv, feat))

        b = feat.shape[0]
        # NHWC flatten; the converter permutes torch's NCHW-flat weight
        style = self.final_linear(feat.reshape(b, -1))
        if self.different_w:
            style = style.reshape(b, -1, self.num_style_feat)

        conditions, rgbs = [], []
        for i in range(self.log_size - 2):
            feat = getattr(self, f"conv_body_up_{i}")(feat + skips[i])
            for kind in ("scale", "shift"):
                y = conv_nhwc(getattr(self, f"condition_{kind}_{i}_0"), feat)
                conditions.append(conv_nhwc(
                    getattr(self, f"condition_{kind}_{i}_1"), _lrelu(y)))
            if return_rgb:
                rgbs.append(conv_nhwc(getattr(self, f"toRGB_{i}"), feat))

        image = self.stylegan_decoder(style, conditions, noises)
        return (image, rgbs) if return_rgb else (image, None)


def drop_unread_leaves(variables, module: GFPGANClean):
    """The converted tree without the leaves that `module` does not read,
    and the '/'-joined paths of those leaves.

    `convert_gfpgan_state_dict` keeps two groups that the official
    GFPGANv1.4 layout carries and a serving module never reads (flax
    ignores them; the port's bridge is strict and would refuse them):
      * `params/toRGB_{i}/Conv_0/{kernel,bias}`, unless the module was
        built with `rgb_heads=True`;
      * `params/stylegan_decoder/mlp_{j}/Dense_0/{kernel,bias}`, unless
        the module takes z (`input_is_latent=False`).
    Nothing else is dropped."""
    params = dict(variables["params"])
    dropped = []
    if not module.rgb_heads:
        for name in sorted(k for k in params if k.startswith("toRGB_")):
            dropped += [f"params/{name}/Conv_0/{leaf}"
                        for leaf in params.pop(name)["Conv_0"]]
    if module.input_is_latent:
        dec = dict(params["stylegan_decoder"])
        for name in sorted(k for k in dec if k.startswith("mlp_")):
            dropped += [f"params/stylegan_decoder/{name}/Dense_0/{leaf}"
                        for leaf in dec.pop(name)["Dense_0"]]
        params["stylegan_decoder"] = dec
    return {**variables, "params": params}, dropped
