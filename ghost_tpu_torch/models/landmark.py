"""106-point facial landmark network, mirroring `ghost_tpu/models/landmark.py`.

A depthwise-separable conv trunk (stride 2 down to 6x6) + global average
pool + FC(212) + tanh on a fixed 192x192 warp of each 224 crop; the
(B,106,2) outputs in [-1, 1] map back to crop coordinates through the
fixed inverse warp `LMK_IM`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import BatchNorm, Conv, Dense, PReLU, to_nchw
from ghost_tpu_torch.ops.warp import warp_affine

# fixed 224-crop -> 192 input warp and its inverse
LMK_M = np.array([[192.0 / 336.0, 0.0, 32.0], [0.0, 192.0 / 336.0, 32.0]],
                 dtype=np.float32)
LMK_IM = np.array([[1.75, 0.0, -56.0], [0.0, 1.75, -56.0]], dtype=np.float32)
NET_SIZE = 192
NUM_POINTS = 106


class SepBlock(nn.Module):
    """Depthwise 3x3 (stride s) + pointwise 1x1, BN + PReLU after each."""

    def __init__(self, cin, features, stride=1, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.dw = Conv(cin, cin, 3, stride, padding=1, use_bias=False,
                       groups=cin, dtype=cd, device=device)
        self.dw_bn = BatchNorm(cin, dtype=cd, device=device)
        self.dw_act = PReLU(cin, device=device)
        self.pw = Conv(cin, features, 1, use_bias=False, dtype=cd, device=device)
        self.pw_bn = BatchNorm(features, dtype=cd, device=device)
        self.pw_act = PReLU(features, device=device)

    def forward(self, x):
        x = self.dw_act(self.dw_bn(self.dw(x)))
        return self.pw_act(self.pw_bn(self.pw(x)))


class Landmark106(nn.Module):
    """(B,192,192,3) raw-pixel RGB (NHWC) -> (B,106,2) in [-1,1]."""

    def __init__(self, width: int = 64, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        w = width
        self.policy = policy
        self.stem = Conv(3, w // 2, 3, 2, padding=1, use_bias=False, dtype=cd,
                         device=device)
        self.stem_bn = BatchNorm(w // 2, dtype=cd, device=device)
        self.stem_act = PReLU(w // 2, device=device)
        plan = ((w // 2, w, 2), (w, w, 1), (w, 2 * w, 2), (2 * w, 2 * w, 1),
                (2 * w, 4 * w, 2), (4 * w, 4 * w, 1), (4 * w, 8 * w, 2))
        for i, (cin, cout, s) in enumerate(plan):
            self.add_module(f"b{i + 1}", SepBlock(cin, cout, s, policy, device))
        self.fc = Dense(8 * w, NUM_POINTS * 2, dtype=torch.float32,
                        device=device)

    def forward(self, x):
        x = to_nchw(x.to(self.policy.compute_dtype).contiguous())
        x = self.stem_act(self.stem_bn(self.stem(x)))
        for i in range(1, 8):
            x = getattr(self, f"b{i}")(x)
        x = torch.mean(x, dim=(2, 3))  # global average pool
        x = self.fc(x.float())
        return torch.tanh(x).reshape(-1, NUM_POINTS, 2)


def landmarks_from_crops(net, crops_rgb, crop_size: int = 224):
    """(B, crop, crop, 3) float RGB in [0, 255] -> (B,106,2) landmarks in
    crop coordinates: fixed warp to 192, net, (p+1)*96, inverse warp."""
    b = crops_rgb.shape[0]
    s = crop_size / 224.0
    m = LMK_M.copy()
    m[:, :2] = m[:, :2] / s
    im = LMK_IM.copy()
    im[:, :2] = im[:, :2] * s
    im[:, 2] = im[:, 2] * s
    dev = crops_rgb.device
    m_t = torch.from_numpy(m).to(dev).expand(b, 2, 3)
    net_in = warp_affine(crops_rgb, m_t, (NET_SIZE, NET_SIZE))
    pred = net(net_in)
    pts = (pred + 1.0) * (NET_SIZE // 2)
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    return torch.einsum("ij,bnj->bni", torch.from_numpy(im).to(dev), pts_h)
