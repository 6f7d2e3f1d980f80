"""Face-layout template injection for random-weight detector and
landmark nets, mirroring `ghost_tpu/utils/face_template.py`.

With random weights the landmark net's tanh head gives points near the
crop centre, the hull mask erodes to EMPTY and the paste-back blend does
nothing. `inject_landmark_template` rewrites the net's final dense layer
so it outputs a plausible 106-point face layout plus a small
input-dependent wiggle; `inject_detection_template` pins the detector
head's outputs to plausible faces everywhere. Both edit the modules in
place (before any cast to the compute dtype) and return them.
"""

from __future__ import annotations

import numpy as np
import torch

# index groups (must match ops/mask.py)
_EYE_TOP_L = np.array([35, 41, 40, 42, 39])
_EYE_TOP_R = np.array([89, 95, 94, 96, 93])
_BROW_L = np.array([43, 48, 49, 51, 50])
_BROW_R = np.array([102, 103, 104, 105, 101])


def face_template_106() -> np.ndarray:
    """(106, 2) layout in tanh space [-1, 1] (x right, y down)."""
    pts = np.zeros((106, 2), np.float32)
    th = np.linspace(0, 2 * np.pi, 33, endpoint=False)
    pts[:33, 0] = 0.62 * np.sin(th)
    pts[:33, 1] = 0.72 * np.cos(th)
    th2 = np.linspace(0, 2 * np.pi, 106 - 33, endpoint=False)
    pts[33:, 0] = 0.30 * np.sin(th2)
    pts[33:, 1] = 0.25 * np.cos(th2) + 0.15
    for idx, (cx, cy) in ((_EYE_TOP_L, (-0.30, -0.20)),
                          (_EYE_TOP_R, (0.30, -0.20)),
                          (_BROW_L, (-0.30, -0.38)),
                          (_BROW_R, (0.30, -0.38))):
        off = np.linspace(-0.12, 0.12, len(idx))
        pts[idx, 0] = cx + off
        pts[idx, 1] = cy
    return np.clip(pts, -0.9, 0.9)


def _rescale_(layer, wiggle_scale: float, bias: np.ndarray):
    with torch.no_grad():
        layer.weight.mul_(wiggle_scale)
        layer.bias.mul_(wiggle_scale).add_(
            torch.from_numpy(bias).to(layer.bias.device, layer.bias.dtype))


def inject_detection_template(det, d: float = 6.0, wiggle_scale: float = 0.05):
    """Pin an SCRFD head's score / bbox / kps convs: kps bias = a 5-point
    face constellation in stride units, bbox bias = a matching box,
    score bias = logit(0.7), kernels scaled down to a small wiggle."""
    kps5 = np.array([[-0.55, -0.30], [0.55, -0.30], [0.0, 0.35],
                     [-0.48, 0.85], [0.48, 0.85]], np.float32) * d
    box = np.array([d, 1.2 * d, d, 1.5 * d], np.float32)  # l,t,r,b
    head = det.head
    _rescale_(head.score, wiggle_scale,
              np.full((2,), np.log(0.7 / 0.3), np.float32))
    _rescale_(head.bbox, wiggle_scale, np.tile(box, 2))
    _rescale_(head.kps, wiggle_scale, np.tile(kps5.reshape(-1), 2))
    return det


def inject_landmark_template(lmk, wiggle_scale: float = 0.02):
    """Make a Landmark106's `fc` output atanh(face_template_106()) plus
    wiggle_scale * (its original output)."""
    bias = np.arctanh(face_template_106().reshape(-1)).astype(np.float32)
    _rescale_(lmk.fc, wiggle_scale, bias)
    return lmk
