"""SCRFD-style face detector, mirroring `ghost_tpu/models/scrfd.py`.

  input : (B, S, S, 3) letterboxed frames, normalized (x-127.5)/128
  output: per stride (8, 16, 32) the head's (score, bbox, kps) maps,
          NHWC, decoded by `decode_detections` into fixed-capacity
          (B, max_faces) scores (padded with -1), boxes and 5-point kps.

Post-processing is fixed-capacity (per-stride top-k, matrix NMS, top
max_faces), so the shapes never depend on the data. Ties are frequent
(the letterbox's constant canvas gives equal scores), and jax's top_k
and stable argsort keep tied entries in index order: `_top_k` sorts
stably and slices to do the same.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import BatchNorm, Conv, resize, to_nchw, to_nhwc

STRIDES = (8, 16, 32)
NUM_ANCHORS = 2


class ConvBlock(nn.Module):
    def __init__(self, cin, features, kernel_size=3, stride=1,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.conv = Conv(cin, features, kernel_size, stride,
                         padding=kernel_size // 2, use_bias=False, dtype=cd,
                         device=device)
        self.bn = BatchNorm(features, dtype=cd, device=device)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class ResBlock(nn.Module):
    def __init__(self, cin, features, stride=1, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.c1 = ConvBlock(cin, features, 3, stride, policy, device)
        self.c2 = Conv(features, features, 3, 1, padding=1, use_bias=False,
                       dtype=cd, device=device)
        self.bn2 = BatchNorm(features, dtype=cd, device=device)
        self.has_ds = stride != 1 or cin != features
        if self.has_ds:
            self.ds = Conv(cin, features, 1, stride, use_bias=False, dtype=cd,
                           device=device)
            self.ds_bn = BatchNorm(features, dtype=cd, device=device)

    def forward(self, x):
        h = self.bn2(self.c2(self.c1(x)))
        if self.has_ds:
            x = self.ds_bn(self.ds(x))
        return torch.relu(h + x)


class SCRFDBackbone(nn.Module):
    """Residual backbone emitting stride-8/16/32 features."""

    def __init__(self, widths=(56, 88, 88, 224), depths=(3, 4, 2, 3),
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.stem0 = ConvBlock(3, 28, 3, 2, policy, device)
        self.stem1 = ConvBlock(28, 28, 3, 1, policy, device)
        self.plan = []
        cin = 28
        for s, (w, d) in enumerate(zip(widths, depths)):
            names = []
            for b in range(d):
                name = f"stage{s}_block{b}"
                self.add_module(name, ResBlock(cin, w, 2 if b == 0 else 1,
                                               policy, device))
                names.append(name)
                cin = w
            self.plan.append(names)
        self.out_channels = tuple(widths[1:])

    def forward(self, x):
        x = self.stem1(self.stem0(x))
        outs = []
        for s, names in enumerate(self.plan):
            for name in names:
                x = getattr(self, name)(x)
            if s >= 1:
                outs.append(x)
        return outs


def _resize_nearest_jax(x, size):
    """jax.image.resize(method='nearest') on NCHW spatial dims:
    src = floor((o + 0.5) * in / out)."""
    for dim, out_size in zip((2, 3), size):
        in_size = x.shape[dim]
        idx = np.minimum(np.floor((np.arange(out_size) + 0.5) * in_size
                                  / out_size), in_size - 1).astype(np.int64)
        x = torch.index_select(x, dim, torch.from_numpy(idx).to(x.device))
    return x


class PAFPN(nn.Module):
    """Top-down + bottom-up feature pyramid (SCRFD neck)."""

    def __init__(self, in_channels, out_ch=56, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"lat{i}", Conv(c, out_ch, 1, dtype=cd, device=device))
            self.add_module(f"td{i}", ConvBlock(out_ch, out_ch, 3, 1, policy, device))
        for i in range(1, n):
            self.add_module(f"bu{i}", ConvBlock(out_ch, out_ch, 3, 2, policy, device))
        self.n = n

    def forward(self, feats):
        lat = [getattr(self, f"lat{i}")(f) for i, f in enumerate(feats)]
        td = [None] * self.n
        td[-1] = lat[-1]
        for i in range(self.n - 2, -1, -1):
            td[i] = lat[i] + _resize_nearest_jax(td[i + 1], lat[i].shape[2:])
        td = [getattr(self, f"td{i}")(t) for i, t in enumerate(td)]
        bu = [td[0]]
        for i in range(1, self.n):
            bu.append(td[i] + getattr(self, f"bu{i}")(bu[-1]))
        return bu


class SCRFDHead(nn.Module):
    """Shared head: score(NA), bbox(4*NA), kps(10*NA) per location."""

    def __init__(self, cin=56, width=80, stacked=2,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.stacked = stacked
        for i in range(stacked):
            self.add_module(f"tower{i}", ConvBlock(cin if i == 0 else width,
                                                   width, 3, 1, policy, device))
        self.score = Conv(width, NUM_ANCHORS, 3, padding=1, dtype=cd, device=device)
        self.bbox = Conv(width, 4 * NUM_ANCHORS, 3, padding=1, dtype=cd,
                         device=device)
        self.kps = Conv(width, 10 * NUM_ANCHORS, 3, padding=1, dtype=cd,
                        device=device)

    def forward(self, x):
        for i in range(self.stacked):
            x = getattr(self, f"tower{i}")(x)
        return self.score(x), self.bbox(x), self.kps(x)


class SCRFD(nn.Module):
    """Full detector graph; forward(x NHWC) -> [(score, bbox, kps) NHWC
    per stride]."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.backbone = SCRFDBackbone(policy=policy, device=device)
        self.neck = PAFPN(self.backbone.out_channels, policy=policy,
                          device=device)
        self.head = SCRFDHead(policy=policy, device=device)

    def forward(self, x):
        feats = self.backbone(to_nchw(x.contiguous()))
        return [tuple(to_nhwc(o) for o in self.head(f))
                for f in self.neck(feats)]


def _anchor_centers(size: int, stride: int, device):
    n = size // stride
    g = torch.arange(n, dtype=torch.float32, device=device) * stride
    ys, xs = torch.meshgrid(g, g, indexing="ij")
    centers = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    return torch.repeat_interleave(centers, NUM_ANCHORS, dim=0)


def _top_k(x, k: int):
    """jax.lax.top_k over the last axis: descending, ties in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take_rows(x, idx):
    """x (B, N, ...) gathered along N by idx (B, K)."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.ndim - 2))
                        .expand(shape))


def decode_detections(outs, input_size: int = 640, score_thresh: float = 0.5,
                      max_faces: int = 16, pre_nms: int = 256,
                      iou_thresh: float = 0.4):
    """Raw head outputs -> fixed-capacity (scores, boxes, kps)."""
    batch = outs[0][0].shape[0]
    all_scores, all_boxes, all_kps = [], [], []
    for (score, bbox, kps), stride in zip(outs, STRIDES):
        centers = _anchor_centers(input_size, stride, score.device)
        s = torch.sigmoid(score.reshape(batch, -1).float())
        b = bbox.reshape(batch, -1, 4).float() * stride
        k = kps.reshape(batch, -1, 5, 2).float() * stride
        x1 = centers[None, :, 0] - b[..., 0]
        y1 = centers[None, :, 1] - b[..., 1]
        x2 = centers[None, :, 0] + b[..., 2]
        y2 = centers[None, :, 1] + b[..., 3]
        boxes = torch.stack([x1, y1, x2, y2], dim=-1)
        pts = centers[None, :, None, :] + k
        top_s, top_i = _top_k(s, min(pre_nms, s.shape[1]))
        all_scores.append(top_s)
        all_boxes.append(_take_rows(boxes, top_i))
        all_kps.append(_take_rows(pts, top_i))
    scores = torch.cat(all_scores, dim=1)
    boxes = torch.cat(all_boxes, dim=1)
    kps = torch.cat(all_kps, dim=1)
    scores = torch.where(scores >= score_thresh, scores,
                         torch.full((), -1.0, device=scores.device))
    return _batched_nms(scores, boxes, kps, max_faces, iou_thresh)


def _iou_matrix(boxes):
    """(..., N, 4) xyxy -> (..., N, N) IoU."""
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def _nms_single(scores, boxes, kps, max_faces: int, iou_thresh: float,
                exact_rounds: int = 4):
    """Matrix NMS over score-sorted candidates, batch dims written out:
    scores (B, N), boxes (B, N, 4), kps (B, N, 5, 2).

    Fast-NMS start, then `exact_rounds` fixed-point rounds of the greedy
    rule (suppress i iff a higher-scored survivor overlaps it)."""
    order = torch.sort(-scores, dim=-1, stable=True).indices
    scores = torch.gather(scores, -1, order)
    boxes = _take_rows(boxes, order)
    kps = _take_rows(kps, order)
    n = scores.shape[-1]
    iou = _iou_matrix(boxes)
    ar = torch.arange(n, device=scores.device)
    higher = ar[None, :] < ar[:, None]  # (i, j): j < i
    overlap = (iou > iou_thresh) & higher

    keep = scores > 0
    for _ in range(exact_rounds):
        suppressed = torch.any(overlap & keep[..., None, :], dim=-1)
        keep = (scores > 0) & ~suppressed

    kept = torch.where(keep, scores, torch.full((), -1.0, device=scores.device))
    top_s, top_i = _top_k(kept, max_faces)
    return top_s, _take_rows(boxes, top_i), _take_rows(kps, top_i)


def _batched_nms(scores, boxes, kps, max_faces: int, iou_thresh: float):
    return _nms_single(scores, boxes, kps, max_faces, iou_thresh)


def preprocess_frames(frames_rgb_uint8, det_size: int = 640):
    """(B,H,W,3) RGB uint8 -> (normalized (B,S,S,3) bf16, scale), with
    top-left aspect-preserving letterboxing."""
    b, h, w, _ = frames_rgb_uint8.shape
    scale = det_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = resize(frames_rgb_uint8.to(torch.bfloat16), (nh, nw), method="bilinear")
    canvas = torch.zeros((b, det_size, det_size, 3), dtype=torch.bfloat16,
                         device=frames_rgb_uint8.device)
    canvas[:, :nh, :nw, :] = x
    return (canvas - 127.5) / 128.0, scale
