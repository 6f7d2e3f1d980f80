"""Bottleneck-ResNet attribute encoder (`--backbone resnet`), mirroring
`ghost_tpu/models/aei_resnet.py`.

Behavioral parity with reference network/resnet.py:81-149: two 7x7 stem
convs (stride 1 then 2), six Bottleneck stages of 2 blocks each with
stride-2 downsampling, returning the 8 feature maps in the order the AAD
generator consumes them (deepest first), i.e. (x7, x6, x5, x4, x3, x2,
x1, x0) for a 256x256 input. The encoder has no width knob: it is full
width at any generator width, as in JAX. `train=True` takes the
BatchNorms' batch statistics (`nn/layers.py:BatchNorm`). Maps are NCHW
in channels_last memory, as `models/aei.py:MLAttrEncoder` gives them.
"""

from __future__ import annotations

import torch
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import BatchNorm, Conv

_STAGE_PLANES = (32, 64, 128, 256, 512, 256)


class Bottleneck(nn.Module):
    """1x1(stride) -> 3x3 -> 1x1(x4) with BN/ReLU; torchvision-style
    except stride lives on the first conv (reference resnet.py:43-78)."""

    def __init__(self, cin, planes, stride=1, downsample=False,
                 policy: Policy = DEFAULT_POLICY, device=None,
                 train: bool = False):
        super().__init__()
        cd = policy.compute_dtype
        bn = dict(dtype=cd, device=device, train=train)
        self.conv1 = Conv(cin, planes, 1, stride, use_bias=False, dtype=cd,
                          device=device)
        self.bn1 = BatchNorm(planes, **bn)
        self.conv2 = Conv(planes, planes, 3, 1, padding=1, use_bias=False,
                          dtype=cd, device=device)
        self.bn2 = BatchNorm(planes, **bn)
        self.conv3 = Conv(planes, planes * 4, 1, use_bias=False, dtype=cd,
                          device=device)
        self.bn3 = BatchNorm(planes * 4, **bn)
        self.downsample = downsample
        if downsample:
            self.ds_conv = Conv(cin, planes * 4, 1, stride, use_bias=False,
                                dtype=cd, device=device)
            self.ds_bn = BatchNorm(planes * 4, **bn)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return torch.relu(out + identity)


class MLAttrEncoderResnet(nn.Module):
    """Returns 8 attr maps deepest-first (reference resnet.py:128-144)."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, device=None,
                 train: bool = False):
        super().__init__()
        cd = policy.compute_dtype
        bn = dict(dtype=cd, device=device, train=train)
        self.policy = policy
        self.conv0 = Conv(3, 64, 7, 1, padding=3, use_bias=False, dtype=cd,
                          device=device)
        self.bn0 = BatchNorm(64, **bn)
        self.conv1 = Conv(64, 64, 7, 2, padding=3, use_bias=False, dtype=cd,
                          device=device)
        self.bn1 = BatchNorm(64, **bn)
        inplanes = 64
        for stage, planes in enumerate(_STAGE_PLANES):
            for b in range(2):
                # the first block of every stage strides and downsamples
                self.add_module(f"layer{stage + 1}_block{b}", Bottleneck(
                    inplanes if b == 0 else planes * 4, planes,
                    2 if b == 0 else 1, b == 0, policy, device, train))
            inplanes = planes * 4
        feats = [64, 64] + [p * 4 for p in _STAGE_PLANES]
        self.attr_channels = tuple(reversed(feats))

    def forward(self, x):
        x0 = torch.relu(self.bn0(self.conv0(x.to(self.policy.compute_dtype))))
        x1 = torch.relu(self.bn1(self.conv1(x0)))
        feats = [x0, x1]
        for stage in range(len(_STAGE_PLANES)):
            h = feats[-1]
            for b in range(2):
                h = getattr(self, f"layer{stage + 1}_block{b}")(h)
            feats.append(h)
        # feats = [x0, x1, x2..x7]; return deepest first
        return tuple(reversed(feats))
