"""AdaptiveWingLoss FAN, the exact WFLW_4HG.pth architecture, mirroring
`ghost_tpu/models/fan_awl.py`.

The reference's eye loss loads `WFLW_4HG.pth` from the AdaptiveWingLoss
project (reference download_models.sh:20, utils/training/detector.py;
the layer plan follows the public AdaptiveWingLoss `core/models.py` +
`core/coord_conv.py`): a CoordConv stem (x/y/r coordinate channels
appended before the 7x7 conv), three ConvBlocks, then `num_modules`
hourglasses whose 1x1 CoordConv also appends boundary-masked coordinate
channels derived from the previous stack's last (boundary) heatmap
channel. Each stack emits `num_landmarks + 1` heatmaps (98 WFLW points
+ 1 boundary).

`models/fan.py` stays the redesign the training loop uses by default;
this module is what the real checkpoint loads into
(`convert/torch_loader.py:convert_fan_awl_state_dict`, then the bridge;
the layer names are the flax ones). Input (B,256,256,3) NHWC in [0, 1];
the modules run NCHW in channels_last memory inside and return NHWC
heatmaps in the policy's output dtype. Eval-mode BatchNorm (running
statistics) unless built with train=True.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import BatchNorm, Conv, to_nchw, to_nhwc


def add_coords(x, with_r: bool, boundary_heatmap=None):
    """coord_conv.AddCoordsTh parity, NCHW: append xx (H-axis index,
    normalized to [-1,1]), yy (W-axis index), optional rr
    (sqrt(xx^2+yy^2)/max), and, when a boundary heatmap (NCHW) is given,
    xx/yy masked to where clamp(heatmap[:, -1], 0, 1) > 0.05. Each
    coordinate is computed in x's dtype, as the JAX function does.

    Orientation: AWL's AddCoordsTh is NOT the standard uber CoordConv: it
    documents its input as (batch, c, x_dim, y_dim) and permutes the
    (1, y_dim, x_dim, 1) matmul-built xx map with (0, 3, 2, 1), landing
    x_dim on the FIRST spatial axis: xx varies along H, then yy along W,
    which is what this function emits (`ghost_tpu/models/fan_awl.py:40-48`
    documents the same quirk)."""
    b, _, h, w = x.shape
    dt, dev = x.dtype, x.device
    xx = (torch.arange(h, dtype=dt, device=dev) / (h - 1) * 2 - 1)
    xx = xx.view(1, 1, h, 1).expand(b, 1, h, w)
    yy = (torch.arange(w, dtype=dt, device=dev) / (w - 1) * 2 - 1)
    yy = yy.view(1, 1, 1, w).expand(b, 1, h, w)
    chans = [x, xx, yy]
    if with_r:
        rr = torch.sqrt(xx * xx + yy * yy)
        chans.append(rr / torch.max(rr))
    if boundary_heatmap is not None:
        bc = torch.clamp(boundary_heatmap[:, -1:], 0.0, 1.0)
        keep = bc > 0.05
        zero = torch.zeros((), dtype=dt, device=dev)
        chans.append(torch.where(keep, xx, zero))
        chans.append(torch.where(keep, yy, zero))
    return torch.cat(chans, dim=1)


class CoordConv(nn.Module):
    """coord_conv.CoordConvTh parity: AddCoords then a conv (with bias).
    `cin` counts x's channels; the coordinate channels are added here."""

    def __init__(self, cin, features, kernel, stride=1, padding=0,
                 with_r: bool = True, with_boundary: bool = False,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.with_r = with_r
        extra = 2 + int(with_r) + (2 if with_boundary else 0)
        self.conv = Conv(cin + extra, features, kernel, stride,
                         padding=padding, dtype=policy.compute_dtype,
                         device=device)

    def forward(self, x, boundary_heatmap=None):
        return self.conv(add_coords(x, self.with_r, boundary_heatmap))


class ConvBlockAWL(nn.Module):
    """models.ConvBlock parity: bn-relu-conv chains at c/2, c/4, c/4,
    concatenated; bn-relu-1x1 downsample when widths differ."""

    def __init__(self, cin, features, policy: Policy = DEFAULT_POLICY,
                 train: bool = False, device=None):
        super().__init__()
        cd = policy.compute_dtype
        c = features

        def brc(name, ci, co, k):
            setattr(self, f"bn_{name}", BatchNorm(ci, dtype=cd, device=device,
                                                  train=train))
            setattr(self, f"conv_{name}", Conv(ci, co, k, padding=k // 2,
                                               use_bias=False, dtype=cd,
                                               device=device))

        brc("1", cin, c // 2, 3)
        brc("2", c // 2, c // 4, 3)
        brc("3", c // 4, c // 4, 3)
        self.downsample = cin != c
        if self.downsample:
            brc("ds", cin, c, 1)

    def _brc(self, name, h):
        h = torch.relu(getattr(self, f"bn_{name}")(h))
        return getattr(self, f"conv_{name}")(h)

    def forward(self, x):
        o1 = self._brc("1", x)
        o2 = self._brc("2", o1)
        o3 = self._brc("3", o2)
        out = torch.cat([o1, o2, o3], dim=1)
        if self.downsample:
            x = self._brc("ds", x)
        return out + x


class HourGlassAWL(nn.Module):
    """models.HourGlass parity: a 1x1 boundary-aware CoordConv, then the
    recursive b1/b2/b2_plus/b3 pyramid with nearest-x2 upsamples.
    `first_one` stacks get no boundary channels."""

    def __init__(self, depth: int = 4, features: int = 256,
                 first_one: bool = False, policy: Policy = DEFAULT_POLICY,
                 train: bool = False, device=None):
        super().__init__()
        self.depth = depth
        self.first_one = first_one
        f = features
        self.coordconv = CoordConv(f, f, 1, with_r=True,
                                   with_boundary=not first_one,
                                   policy=policy, device=device)
        for level in range(depth, 0, -1):
            for name in (f"b1_{level}", f"b2_{level}", f"b3_{level}"):
                setattr(self, name, ConvBlockAWL(f, f, policy, train, device))
        self.b2_plus_1 = ConvBlockAWL(f, f, policy, train, device)

    def _recurse(self, level, inp):
        up1 = getattr(self, f"b1_{level}")(inp)
        low = getattr(self, f"b2_{level}")(F.avg_pool2d(inp, 2, 2))
        if level > 1:
            low = self._recurse(level - 1, low)
        else:
            low = self.b2_plus_1(low)
        low = getattr(self, f"b3_{level}")(low)
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")

    def forward(self, x, heatmap=None):
        x = self.coordconv(x, None if self.first_one else heatmap)
        return self._recurse(self.depth, x)


class FANAWL(nn.Module):
    """(B,256,256,3) in [0,1] (NHWC) -> list of num_modules (B,64,64,
    num_landmarks+1) NHWC heatmaps (WFLW_4HG: 4 stacks, 98+1 channels)."""

    def __init__(self, num_modules: int = 4, num_landmarks: int = 98,
                 features: int = 256, mid_features: int = 128,
                 depth: int = 4, end_relu: bool = False,
                 policy: Policy = DEFAULT_POLICY, train: bool = False,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.policy = policy
        self.num_modules = num_modules
        self.end_relu = end_relu
        f, mid, nh = features, mid_features, num_landmarks + 1
        self.conv1 = CoordConv(3, 64, 7, 2, padding=3, with_r=True,
                               policy=policy, device=device)
        self.bn1 = BatchNorm(64, dtype=cd, device=device, train=train)
        self.conv2 = ConvBlockAWL(64, mid, policy, train, device)
        self.conv3 = ConvBlockAWL(mid, mid, policy, train, device)
        self.conv4 = ConvBlockAWL(mid, f, policy, train, device)
        for i in range(num_modules):
            setattr(self, f"m{i}", HourGlassAWL(depth, f, i == 0, policy,
                                                train, device))
            setattr(self, f"top_m_{i}", ConvBlockAWL(f, f, policy, train,
                                                     device))
            setattr(self, f"conv_last{i}", Conv(f, f, 1, dtype=cd,
                                                device=device))
            setattr(self, f"bn_end{i}", BatchNorm(f, dtype=cd, device=device,
                                                  train=train))
            setattr(self, f"l{i}", Conv(f, nh, 1, dtype=cd, device=device))
            if i < num_modules - 1:
                setattr(self, f"bl{i}", Conv(f, f, 1, dtype=cd,
                                             device=device))
                setattr(self, f"al{i}", Conv(nh, f, 1, dtype=cd,
                                             device=device))

    def forward(self, x):
        x = to_nchw(x.to(self.policy.compute_dtype).contiguous())
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.conv2(x)
        x = F.avg_pool2d(x, 2, 2)
        x = self.conv4(self.conv3(x))
        outputs = []
        prev, tmp_out = x, None
        for i in range(self.num_modules):
            hg = getattr(self, f"m{i}")(prev, tmp_out)
            ll = getattr(self, f"top_m_{i}")(hg)
            ll = torch.relu(getattr(self, f"bn_end{i}")(
                getattr(self, f"conv_last{i}")(ll)))
            tmp_out = getattr(self, f"l{i}")(ll)
            if self.end_relu:
                tmp_out = torch.relu(tmp_out)
            outputs.append(to_nhwc(tmp_out).to(self.policy.output_dtype))
            if i < self.num_modules - 1:
                prev = prev + getattr(self, f"bl{i}")(ll) + getattr(
                    self, f"al{i}")(tmp_out)
        return outputs
