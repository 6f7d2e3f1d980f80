"""SRVGGNetCompact (the realesr-general-x4v3 layout) and the swap
pipeline's SR-student seat, mirroring `ghost_tpu/models/sr/srvgg.py`.

The trunk is `num_conv + 2` dense 3x3 convs at constant `num_feat`
width with PReLU between them: each runs through S2
(`nn.layers.Conv3x3` -> `ops/cuda/conv3x3.py`, the CUDA kernel for CUDA
tensors) with its bias in S2's f32 epilogue. Pixel-shuffle and the
nearest-upsampled input skip are layout ops. Tensors are NHWC
throughout, the layout S2 reads.
"""

from __future__ import annotations

import torch
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import Conv3x3, resize

from .rrdb import nearest_up2


def pixel_shuffle(x, factor: int):
    """torch nn.PixelShuffle parity, NHWC: (B, H, W, C*f*f) ->
    (B, H*f, W*f, C) where input channel c*f*f + dy*f + dx feeds
    output channel c at spatial offset (dy, dx)."""
    b, h, w, cff = x.shape
    c = cff // (factor * factor)
    x = x.reshape(b, h, w, c, factor, factor)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * factor, w * factor, c)


def nearest_up(x, factor: int):
    """Integer-factor nearest upsample (F.interpolate parity for an
    integer scale_factor): repeated doubling for powers of two, a pixel
    repeat for other factors."""
    if factor & (factor - 1) == 0:
        for _ in range(factor.bit_length() - 1):
            x = nearest_up2(x)
        return x
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


class SRVGGNetCompact(nn.Module):
    """body = [conv, prelu] + num_conv x [conv, prelu] + [conv to
    out*upscale^2], then pixel-shuffle plus the nearest-upsampled input.

    The PReLU slopes are bare parameters `prelu_{i}` of this module, as
    in the flax tree. NHWC in and out, in the policy's compute dtype."""

    def __init__(self, num_out_ch: int = 3, num_feat: int = 64,
                 num_conv: int = 32, upscale: int = 4,
                 policy: Policy = DEFAULT_POLICY, num_in_ch: int = 3,
                 device=None):
        super().__init__()
        self.num_out_ch, self.num_feat = num_out_ch, num_feat
        self.num_conv, self.upscale = num_conv, upscale
        self.policy = policy
        cd = policy.compute_dtype
        for i in range(num_conv + 1):
            cin = num_in_ch if i == 0 else num_feat
            setattr(self, f"conv_{i}",
                    Conv3x3(cin, num_feat, dtype=cd, device=device))
            setattr(self, f"prelu_{i}",
                    nn.Parameter(torch.empty(num_feat, device=device)))
        self.conv_last = Conv3x3(num_feat, num_out_ch * upscale ** 2,
                                 dtype=cd, device=device)

    def reset_parameters(self, generator):
        for i in range(self.num_conv + 1):
            nn.init.constant_(getattr(self, f"prelu_{i}"), 0.25)

    def forward(self, x):
        cd = self.policy.compute_dtype
        x = x.to(cd).contiguous()
        out = x
        for i in range(self.num_conv + 1):
            out = getattr(self, f"conv_{i}")(out)
            alpha = getattr(self, f"prelu_{i}").to(cd)
            out = torch.where(out >= 0, out, alpha * out)
        out = pixel_shuffle(self.conv_last(out), self.upscale)
        return out + nearest_up(x, self.upscale)


def srvgg_from_variables(variables, policy: Policy = DEFAULT_POLICY,
                         num_out_ch: int = 3, device=None) -> SRVGGNetCompact:
    """The SRVGGNetCompact that fits a saved variables tree (e.g. the
    bundled student from `core.checkpoint.load_msgpack`), its
    hyperparameters read off the parameter shapes: num_feat from conv_0's
    output width, num_conv from the body conv count, upscale from
    conv_last's pixel-shuffle width. The module is returned unfilled:
    `convert.from_jax.load_flax_variables` fills it."""
    p = variables["params"] if "params" in variables else variables
    try:
        k0 = p["conv_0"]["Conv_0"]["kernel"]
        num_feat, num_in_ch = int(k0.shape[-1]), int(k0.shape[-2])
        body = [k for k in p if k.startswith("conv_") and k != "conv_last"]
        num_conv = len(body) - 1
        cff = int(p["conv_last"]["Conv_0"]["kernel"].shape[-1])
    except (KeyError, TypeError) as e:
        raise ValueError(
            "checkpoint is not an SRVGG student tree (missing "
            f"{e!s} — likely a wrong --sr_model/--sr_path pairing, "
            "e.g. a LIPSPADE checkpoint passed with srvgg_student)"
        ) from e
    upscale = int(round((cff // num_out_ch) ** 0.5))
    if num_out_ch * upscale * upscale != cff:
        raise ValueError(
            f"conv_last emits {cff} channels — not num_out_ch="
            f"{num_out_ch} x square upscale^2; not an SRVGG student tree")
    return SRVGGNetCompact(num_out_ch=num_out_ch, num_feat=num_feat,
                           num_conv=num_conv, upscale=upscale, policy=policy,
                           num_in_ch=num_in_ch, device=device)


class SRVGGStudentSeat(nn.Module):
    """The swap pipeline's SR seat serving an SRVGG student: [-1,1] in
    -> [-1,1] out at the generator's resolution (NHWC). The x`upscale`
    student works in [0,1], so the seat area-downscales the crop by the
    student's factor, super-resolves it back to native size and clips."""

    def __init__(self, student: SRVGGNetCompact):
        super().__init__()
        self.student = student

    def forward(self, y_pm1):
        h, w = int(y_pm1.shape[1]), int(y_pm1.shape[2])
        f = int(self.student.upscale)
        if h % f or w % f:
            raise ValueError(
                f"generator/SR resolution {h}x{w} not divisible by the "
                f"student's upscale={f}; the seat runs on the generator "
                "output (SwapConfig.gen_size, 256 by default), so train "
                "a student whose upscale divides it")
        y01 = y_pm1 * 0.5 + 0.5
        lq = resize(y01, (h // f, w // f), method="area")
        out = self.student(lq)
        return torch.clamp(out, 0.0, 1.0) * 2.0 - 1.0
