"""mmdet-faithful SCRFD family (ResNetV1e + PAFPN + shared GN head),
mirroring `ghost_tpu/models/scrfd_v1e.py`.

The reference's production detectors are insightface SCRFD models
(scrfd_10g_bnkps.onnx at inference, reference
insightface_func/face_detect_crop_multi.py:22-93 + download_models.sh:6-8;
a torch SCRFD-2.5GF checkpoint ships at
coordinate_reg/model/SCRFD/model_25GF.pth). This module reproduces the
mmdet topology recorded in that checkpoint's embedded config so real
weights map on 1:1 (converter:
`convert/torch_loader.py:convert_scrfd_state_dict`, then the bridge):

  backbone ResNetV1e: deep 3-conv stem (base/2, base/2, base) stride 2
      + maxpool/2, BasicBlock stages with avgpool-downsample (V1e),
      strides (1,2,2,2)
  neck PAFPN: laterals (1x1) on stages 1..3, nearest top-down sum,
      3x3 fpn convs, stride-2 downsample convs bottom-up,
      3x3 pafpn convs on levels 1..2 (all linear convs w/ bias)
  head (cls_reg_share, strides_share): 2 stacked conv3x3(noBias)+GN16+
      ReLU towers shared across strides, 3x3 cls (NA), 3x3 reg (4*NA)
      scaled by a per-stride scalar, optional 3x3 kps (10*NA)

Outputs use the same [(score, bbox, kps) NHWC per stride] contract as
`models/scrfd.py:SCRFD`, so `decode_detections` and the swap pipeline
accept either detector. Inference only: BatchNorm takes its running
statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import (BatchNorm, Conv, GroupNorm, to_nchw,
                                       to_nhwc)


@dataclasses.dataclass(frozen=True)
class SCRFDArch:
    stage_blocks: Sequence[int] = (3, 5, 3, 2)
    stage_planes: Sequence[int] = (24, 48, 48, 80)
    base_channels: int = 24
    neck_out: int = 24
    feat_channels: int = 64
    stacked_convs: int = 2
    gn_groups: int = 16
    num_anchors: int = 2
    use_kps: bool = False
    start_level: int = 1  # neck consumes stages [start_level:]


# model_25GF.pth meta config
SCRFD_2_5GF = SCRFDArch()
# scrfd_10g_bnkps-class config (public insightface family; the exact
# stage plan is unverified against real weights)
SCRFD_10GF_KPS = SCRFDArch(stage_blocks=(3, 5, 2, 3),
                           stage_planes=(56, 88, 88, 224),
                           base_channels=56, neck_out=56, feat_channels=80,
                           use_kps=True)


class _ConvBN(nn.Module):
    def __init__(self, cin, features, stride=1,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.conv = Conv(cin, features, 3, stride, padding=1, use_bias=False,
                         dtype=cd, device=device)
        self.bn = BatchNorm(features, dtype=cd, device=device)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class BasicBlockV1e(nn.Module):
    """mmdet BasicBlock with the V1e avgpool downsample."""

    def __init__(self, cin, planes, stride=1, downsample=False,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.stride = stride
        self.conv1 = Conv(cin, planes, 3, stride, padding=1, use_bias=False,
                          dtype=cd, device=device)
        self.bn1 = BatchNorm(planes, dtype=cd, device=device)
        self.conv2 = Conv(planes, planes, 3, 1, padding=1, use_bias=False,
                          dtype=cd, device=device)
        self.bn2 = BatchNorm(planes, dtype=cd, device=device)
        self.downsample = downsample
        if downsample:
            self.ds_conv = Conv(cin, planes, 1, 1, use_bias=False, dtype=cd,
                                device=device)
            self.ds_bn = BatchNorm(planes, dtype=cd, device=device)

    def forward(self, x):
        h = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        if self.downsample:
            idn = F.avg_pool2d(x, 2) if self.stride == 2 else x
            idn = self.ds_bn(self.ds_conv(idn))
        else:
            idn = x
        return torch.relu(h + idn)


class ResNetV1e(nn.Module):
    def __init__(self, arch: SCRFDArch = SCRFD_2_5GF,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        half = arch.base_channels // 2
        self.stem0 = _ConvBN(3, half, 2, policy, device)
        self.stem1 = _ConvBN(half, half, 1, policy, device)
        self.stem2 = _ConvBN(half, arch.base_channels, 1, policy, device)
        self.plan = []
        cin = arch.base_channels
        for s, (planes, depth) in enumerate(zip(arch.stage_planes,
                                                arch.stage_blocks)):
            stride = 1 if s == 0 else 2
            names = []
            for b in range(depth):
                first = b == 0
                name = f"layer{s + 1}_block{b}"
                self.add_module(name, BasicBlockV1e(
                    cin, planes, stride if first else 1,
                    first and (stride != 1 or cin != planes), policy, device))
                names.append(name)
                cin = planes
            self.plan.append(names)

    def forward(self, x):
        x = self.stem2(self.stem1(self.stem0(x)))
        # 3x3/2 max pool; max_pool2d's implicit padding is -inf, as the
        # JAX reduce_window's
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for names in self.plan:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs


class PAFPNNeck(nn.Module):
    def __init__(self, arch: SCRFDArch = SCRFD_2_5GF,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        c = arch.neck_out
        self.start_level = arch.start_level
        ins = arch.stage_planes[arch.start_level:]
        self.n = len(ins)
        for i, cin in enumerate(ins):
            self.add_module(f"lateral{i}", Conv(cin, c, 1, dtype=cd,
                                                device=device))
            self.add_module(f"fpn{i}", Conv(c, c, 3, padding=1, dtype=cd,
                                            device=device))
        for i in range(self.n - 1):
            self.add_module(f"down{i}", Conv(c, c, 3, 2, padding=1, dtype=cd,
                                             device=device))
            self.add_module(f"pafpn{i}", Conv(c, c, 3, padding=1, dtype=cd,
                                              device=device))

    def forward(self, feats):
        feats = feats[self.start_level:]
        lat = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.n - 2, -1, -1):
            # nearest 2x by repetition, cropped to the finer level
            up = lat[i + 1].repeat_interleave(2, dim=2).repeat_interleave(
                2, dim=3)
            lat[i] = lat[i] + up[:, :, :lat[i].shape[2], :lat[i].shape[3]]
        inter = [getattr(self, f"fpn{i}")(t) for i, t in enumerate(lat)]
        for i in range(self.n - 1):
            inter[i + 1] = inter[i + 1] + getattr(self, f"down{i}")(inter[i])
        return [inter[0]] + [getattr(self, f"pafpn{i - 1}")(inter[i])
                             for i in range(1, self.n)]


class SCRFDHeadShared(nn.Module):
    """cls_reg_share + strides_share head with a per-stride scalar
    `scale{level}` on the bbox branch (bare parameters, as flax's)."""

    def __init__(self, arch: SCRFDArch = SCRFD_2_5GF,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.cd = cd
        na = arch.num_anchors
        self.na = na
        self.stacked = arch.stacked_convs
        feat = arch.feat_channels
        for i in range(arch.stacked_convs):
            self.add_module(f"tower{i}_conv", Conv(
                arch.neck_out if i == 0 else feat, feat, 3, padding=1,
                use_bias=False, dtype=cd, device=device))
            self.add_module(f"tower{i}_gn", GroupNorm(
                arch.gn_groups, feat, eps=1e-5, dtype=cd, device=device))
        self.cls = Conv(feat, na, 3, padding=1, dtype=cd, device=device)
        self.reg = Conv(feat, 4 * na, 3, padding=1, dtype=cd, device=device)
        self.kps = (Conv(feat, 10 * na, 3, padding=1, dtype=cd, device=device)
                    if arch.use_kps else None)
        self.n_levels = len(arch.stage_planes) - arch.start_level
        for level in range(self.n_levels):
            self.register_parameter(f"scale{level}", nn.Parameter(
                torch.empty((), device=device)))

    def reset_parameters(self, generator):
        for level in range(self.n_levels):
            nn.init.ones_(getattr(self, f"scale{level}"))

    def forward(self, pyr):
        outs = []
        for level, x in enumerate(pyr):
            h = x
            for i in range(self.stacked):
                h = torch.relu(getattr(self, f"tower{i}_gn")(
                    getattr(self, f"tower{i}_conv")(h)))
            score = self.cls(h)
            bbox = self.reg(h) * getattr(self, f"scale{level}").to(self.cd)
            if self.kps is not None:
                k = self.kps(h)
            else:
                k = torch.zeros((h.shape[0], 10 * self.na) + h.shape[2:],
                                dtype=h.dtype, device=h.device)
            outs.append((score, bbox, k))
        return outs


class SCRFDV1e(nn.Module):
    """Drop-in detector graph: (B,S,S,3) normalized -> per-stride
    (score, bbox, kps) raw NHWC maps for `models.scrfd.decode_detections`."""

    def __init__(self, arch: SCRFDArch = SCRFD_2_5GF,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.backbone = ResNetV1e(arch, policy, device)
        self.neck = PAFPNNeck(arch, policy, device)
        self.head = SCRFDHeadShared(arch, policy, device)

    def forward(self, x):
        pyr = self.neck(self.backbone(to_nchw(x.contiguous())))
        return [tuple(to_nhwc(o) for o in lvl) for lvl in self.head(pyr)]
