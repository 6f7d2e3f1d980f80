"""FAN, the stacked-hourglass landmark network behind the eye-heatmap
loss, mirroring `ghost_tpu/models/fan.py`.

The reference takes a 4-stack hourglass FAN trained on WFLW-98
(WFLW_4HG.pth of the AdaptiveWingLoss project) and L2-compares the
eye-region heatmaps of Xt and Y (reference train.py:239-247,
utils/training/losses.py:40-42). Here:

  * ConvBlock: bn-relu-conv at c/2, c/4, c/4 (3x3, no bias),
    concatenated, plus the input (through a bn-relu-1x1 conv when the
    width changes);
  * Hourglass: recursive, depth 4: up1 on the input, a 2x2 average pool,
    low1, the next level (low2 at the bottom), low3, a nearest x2
    upsample added to up1;
  * FAN: a 7x7/2 stem conv, BatchNorm and ReLU, block1, a 2x2 average
    pool, block2, block3, then `num_stacks` stacks of hourglass, top
    block, 1x1 fc, BatchNorm, ReLU and a 1x1 head of `num_landmarks`
    channels, with the merges (1x1 convs of the features and of the
    heatmaps) into the next stack's input.

Input (B,256,256,3) NHWC in [0, 1]; output the list of `num_stacks`
(B,64,64,98) NHWC heatmaps in the policy's output dtype. The modules run
NCHW in channels_last memory inside; the names of the layers are the
flax ones (`{name}_bn`, `{name}_conv`, `fc_bn{s}`, `merge_feat{s}`, ...),
so `convert/from_jax.py` loads the JAX package's msgpack as it is.
BatchNorm is eval-mode (running statistics) unless built with
train=True.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import BatchNorm, Conv, to_nchw, to_nhwc

# WFLW-98 eye landmark channel groups (contours + pupils)
LEFT_EYE_CHANNELS = tuple(range(60, 68)) + (96,)
RIGHT_EYE_CHANNELS = tuple(range(68, 76)) + (97,)


def _avg_pool2(x):
    return F.avg_pool2d(x, 2, 2)


class ConvBlock(nn.Module):
    """FAN residual block: 3 convs at c/2, c/4, c/4 concatenated."""

    def __init__(self, cin, features, policy: Policy = DEFAULT_POLICY,
                 train: bool = False, device=None):
        super().__init__()
        cd = policy.compute_dtype
        c = features

        def bn_relu_conv(name, ci, co, k):
            setattr(self, f"{name}_bn", BatchNorm(ci, dtype=cd, device=device,
                                                  train=train))
            setattr(self, f"{name}_conv", Conv(ci, co, k, padding=k // 2,
                                               use_bias=False, dtype=cd,
                                               device=device))

        bn_relu_conv("b1", cin, c // 2, 3)
        bn_relu_conv("b2", c // 2, c // 4, 3)
        bn_relu_conv("b3", c // 4, c // 4, 3)
        self.downsample = cin != c
        if self.downsample:
            bn_relu_conv("ds", cin, c, 1)

    def _brc(self, name, h):
        h = torch.relu(getattr(self, f"{name}_bn")(h))
        return getattr(self, f"{name}_conv")(h)

    def forward(self, x):
        o1 = self._brc("b1", x)
        o2 = self._brc("b2", o1)
        o3 = self._brc("b3", o2)
        out = torch.cat([o1, o2, o3], dim=1)
        if self.downsample:
            x = self._brc("ds", x)
        return out + x


class Hourglass(nn.Module):
    def __init__(self, depth: int = 4, features: int = 256,
                 policy: Policy = DEFAULT_POLICY, train: bool = False,
                 device=None):
        super().__init__()
        self.depth = depth
        f = features

        def block(name):
            setattr(self, name, ConvBlock(f, f, policy, train, device))

        for level in range(depth, 0, -1):
            block(f"up1_{level}")
            block(f"low1_{level}")
            if level == 1:
                block("low2_1")
            block(f"low3_{level}")

    def _recurse(self, level, inp):
        up1 = getattr(self, f"up1_{level}")(inp)
        low = getattr(self, f"low1_{level}")(_avg_pool2(inp))
        if level > 1:
            low = self._recurse(level - 1, low)
        else:
            low = self.low2_1(low)
        low = getattr(self, f"low3_{level}")(low)
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._recurse(self.depth, x)


class FAN(nn.Module):
    """(B,256,256,3) in [0,1] -> list of num_stacks (B,64,64,98) heatmaps."""

    def __init__(self, num_stacks: int = 4, num_landmarks: int = 98,
                 features: int = 256, policy: Policy = DEFAULT_POLICY,
                 train: bool = False, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.policy = policy
        self.num_stacks = num_stacks
        f = features
        self.stem = Conv(3, 64, 7, 2, padding=3, dtype=cd, device=device)
        self.stem_bn = BatchNorm(64, dtype=cd, device=device, train=train)
        self.block1 = ConvBlock(64, 128, policy, train, device)
        self.block2 = ConvBlock(128, 128, policy, train, device)
        self.block3 = ConvBlock(128, f, policy, train, device)
        for s in range(num_stacks):
            setattr(self, f"hg{s}", Hourglass(4, f, policy, train, device))
            setattr(self, f"top{s}", ConvBlock(f, f, policy, train, device))
            setattr(self, f"fc{s}", Conv(f, f, 1, dtype=cd, device=device))
            setattr(self, f"fc_bn{s}", BatchNorm(f, dtype=cd, device=device,
                                                 train=train))
            setattr(self, f"head{s}", Conv(f, num_landmarks, 1, dtype=cd,
                                           device=device))
            if s < num_stacks - 1:
                setattr(self, f"merge_feat{s}", Conv(f, f, 1, dtype=cd,
                                                     device=device))
                setattr(self, f"merge_hm{s}", Conv(num_landmarks, f, 1,
                                                   dtype=cd, device=device))

    def forward(self, x):
        x = to_nchw(x.to(self.policy.compute_dtype).contiguous())
        x = torch.relu(self.stem_bn(self.stem(x)))
        x = self.block1(x)
        x = self.block3(self.block2(_avg_pool2(x)))
        outputs = []
        prev = x
        for s in range(self.num_stacks):
            ll = getattr(self, f"top{s}")(getattr(self, f"hg{s}")(prev))
            ll = torch.relu(getattr(self, f"fc_bn{s}")(
                getattr(self, f"fc{s}")(ll)))
            hm = getattr(self, f"head{s}")(ll)
            outputs.append(to_nhwc(hm).to(self.policy.output_dtype))
            if s < self.num_stacks - 1:
                prev = prev + getattr(self, f"merge_feat{s}")(ll) + getattr(
                    self, f"merge_hm{s}")(hm)
        return outputs


def eye_heatmaps(heatmaps):
    """(B,64,64,98) -> left (B,64,64,9), right (B,64,64,9) eye channels
    (reference utils/training/detector.py:18-28 behavior)."""
    left = heatmaps[..., list(LEFT_EYE_CHANNELS)]
    right = heatmaps[..., list(RIGHT_EYE_CHANNELS)]
    return left, right


def heatmaps_to_points(heatmaps):
    """(B,H,W,C) heatmaps -> (B,C,2) (x, y) points: the argmax (the first
    maximum in row-major order), then a quarter-pixel step along each
    axis by the sign of the difference of the two neighbours (clamped at
    the border), as get_preds_fromhm (reference
    utils/training/detector.py:6-16 lineage)."""
    b, h, w, c = heatmaps.shape
    flat = heatmaps.reshape(b, h * w, c)
    idx = torch.argmax(flat, dim=1)  # (B,C)
    ys, xs = idx // w, idx % w

    def at(y, x):
        return flat.gather(1, (y * w + x).unsqueeze(1)).squeeze(1)

    dx = at(ys, (xs + 1).clamp(0, w - 1)) - at(ys, (xs - 1).clamp(0, w - 1))
    dy = at((ys + 1).clamp(0, h - 1), xs) - at((ys - 1).clamp(0, h - 1), xs)
    return torch.stack([xs.float() + torch.sign(dx) * 0.25,
                        ys.float() + torch.sign(dy) * 0.25], dim=-1)
