"""Umeyama similarity alignment, mirroring `ghost_tpu/ops/umeyama.py`.

Closed-form least-squares similarity from the detector's 5 keypoints to
insightface's canonical templates, batched over keypoint sets.
"""

from __future__ import annotations

import numpy as np
import torch

# The canonical 5-point templates for a 112x112 crop, x then y, as
# published by insightface (deepinsight/insightface face_align.py, MIT):
# five head poses (left profile ... right profile); mode='None' selects
# the best-fitting one. Template index 2 is the frontal "arcface" set.
_SRC_112 = np.array(
    [
        [  # left profile
            [51.642, 50.115], [57.617, 49.990], [35.740, 69.007],
            [51.157, 89.050], [57.025, 89.702],
        ],
        [  # left
            [45.031, 50.118], [65.568, 50.872], [39.677, 68.111],
            [45.177, 86.190], [64.246, 86.758],
        ],
        [  # frontal (arcface_dst)
            [39.730, 51.138], [72.270, 51.138], [56.000, 68.493],
            [42.463, 87.010], [69.537, 87.010],
        ],
        [  # right
            [46.845, 50.872], [67.382, 50.118], [72.737, 68.111],
            [48.167, 86.758], [67.236, 86.190],
        ],
        [  # right profile
            [54.796, 49.990], [60.771, 50.115], [76.673, 69.007],
            [55.388, 89.702], [61.257, 89.050],
        ],
    ],
    dtype=np.float32,
)

ARCFACE_TEMPLATE = _SRC_112[2]


def umeyama_similarity(src, dst):
    """Least-squares similarity transform src -> dst.

    src, dst: (..., N, 2). Returns (..., 2, 3) affine matrices
    M = [[a, -b, tx], [b, a, ty]] (the proper-rotation Umeyama solution).
    """
    src = src.float()
    dst = dst.float()
    mu_s = src.mean(dim=-2, keepdim=True)
    mu_d = dst.mean(dim=-2, keepdim=True)
    sc = src - mu_s
    dc = dst - mu_d
    den = torch.clamp((sc * sc).sum(dim=(-2, -1)), min=1e-12)
    dot = (sc * dc).sum(dim=(-2, -1))
    cross = (sc[..., 0] * dc[..., 1] - sc[..., 1] * dc[..., 0]).sum(dim=-1)
    a = dot / den
    b = cross / den
    r = torch.stack([torch.stack([a, -b], dim=-1),
                     torch.stack([b, a], dim=-1)], dim=-2)  # (...,2,2)
    t = mu_d[..., 0, :] - torch.einsum("...ij,...j->...i", r, mu_s[..., 0, :])
    return torch.cat([r, t[..., :, None]], dim=-1)


def transform_points(pts, m):
    """Apply (..., 2, 3) affines to (..., N, 2) points."""
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    return torch.einsum("...ij,...nj->...ni", m, pts_h)


def estimate_norm(kps, crop_size: int = 224, mode: str = "None"):
    """insightface estimate_norm parity, batched.

    kps: (..., 5, 2). Returns (..., 2, 3) image -> crop matrices.
    mode='arcface': frontal template only; mode='None': best of the five
    pose templates by summed keypoint residual (first on ties)."""
    kps = kps.float()
    templates = (torch.from_numpy(_SRC_112).to(kps.device)
                 * (crop_size / 112.0))  # (5,5,2)
    tb = templates.view((5,) + (1,) * (kps.ndim - 2) + (5, 2))
    ms = umeyama_similarity(kps.unsqueeze(0).expand(tb.shape[:1] + kps.shape),
                            tb.expand((5,) + kps.shape))  # (5,...,2,3)
    if mode == "arcface":
        return ms[2]
    proj = transform_points(kps.unsqueeze(0), ms)
    errs = torch.linalg.vector_norm(proj - tb, dim=-1).sum(dim=-1)  # (5,...)
    best = torch.argmin(errs, dim=0)
    idx = best[None, ..., None, None].expand((1,) + ms.shape[1:])
    return torch.gather(ms, 0, idx)[0]
