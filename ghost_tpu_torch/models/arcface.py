"""ArcFace iresnet identity encoder, mirroring `ghost_tpu/models/arcface.py`.

Improved-ResNet blocks (BN-Conv-BN-PReLU-Conv-BN, stride 2 in the second
conv), conv3x3 s1 stem, head BN -> flatten (NCHW order, as torch) ->
FC(512*7*7 -> 512) -> BN, from 112x112 crops in [-1, 1].
"""

from __future__ import annotations

import torch
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import BatchNorm, Conv, Dense, PReLU, to_nchw

_DEPTHS = {
    "iresnet34": (3, 4, 6, 3),
    "iresnet50": (3, 4, 14, 3),
    "iresnet100": (3, 13, 30, 3),
    "iresnet200": (6, 26, 60, 6),
}


class IBasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, downsample=False,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.bn1 = BatchNorm(cin, dtype=cd, device=device)
        self.conv1 = Conv(cin, planes, 3, 1, padding=1, use_bias=False,
                          dtype=cd, device=device)
        self.bn2 = BatchNorm(planes, dtype=cd, device=device)
        self.prelu = PReLU(planes, device=device)
        self.conv2 = Conv(planes, planes, 3, stride, padding=1, use_bias=False,
                          dtype=cd, device=device)
        self.bn3 = BatchNorm(planes, dtype=cd, device=device)
        self.downsample = downsample
        if downsample:
            self.ds_conv = Conv(cin, planes, 1, stride, use_bias=False,
                                dtype=cd, device=device)
            self.ds_bn = BatchNorm(planes, dtype=cd, device=device)

    def forward(self, x):
        out = self.conv1(self.bn1(x))
        out = self.prelu(self.bn2(out))
        out = self.bn3(self.conv2(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return out + identity


class IResNet(nn.Module):
    """(B,112,112,3) RGB in [-1,1] (NHWC) -> (B, 512) embedding."""

    def __init__(self, layers=(3, 13, 30, 3), num_features: int = 512,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.policy = policy
        self.stem_conv = Conv(3, 64, 3, 1, padding=1, use_bias=False,
                              dtype=cd, device=device)
        self.stem_bn = BatchNorm(64, dtype=cd, device=device)
        self.stem_prelu = PReLU(64, device=device)
        self.blocks = []
        cin = 64
        for stage, (p, n) in enumerate(zip((64, 128, 256, 512), layers)):
            for b in range(n):
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, IBasicBlock(cin, p, 2 if b == 0 else 1,
                                                  b == 0, policy, device))
                self.blocks.append(name)
                cin = p
        self.head_bn = BatchNorm(512, dtype=cd, device=device)
        self.fc = Dense(512 * 7 * 7, num_features, dtype=torch.float32,
                        device=device)
        self.features = BatchNorm(num_features, dtype=torch.float32,
                                  device=device)

    def forward(self, x):
        x = to_nchw(x.to(self.policy.compute_dtype).contiguous())
        x = self.stem_prelu(self.stem_bn(self.stem_conv(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = self.head_bn(x).flatten(1)  # NCHW (C,H,W) order, as torch
        x = self.features(self.fc(x.float()))
        return x.to(self.policy.output_dtype)


def iresnet34(**kw) -> IResNet:
    return IResNet(layers=_DEPTHS["iresnet34"], **kw)


def iresnet50(**kw) -> IResNet:
    return IResNet(layers=_DEPTHS["iresnet50"], **kw)


def iresnet100(**kw) -> IResNet:
    return IResNet(layers=_DEPTHS["iresnet100"], **kw)


def normalize_embedding(e, eps: float = 1e-12):
    """F.normalize parity: x / max(||x||_2, eps)."""
    norm = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return e / torch.clamp(norm, min=eps)
