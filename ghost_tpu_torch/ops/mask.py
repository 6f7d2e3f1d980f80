"""Soft face masks for the paste-back blend, mirroring `ghost_tpu/ops/mask.py`.

The convex-hull fill is a half-plane test: the signed distance to the
hull of the 106 landmarks (min over hull edges of the signed edge
distance) gives the fill and lets erosion be a threshold shift. The
Gaussian blur is a separable pair of 1-D blurs with cv2's
ksize-from-sigma rule. Everything is batched and static-shape.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# 106-landmark index groups (insightface 2d106det convention)
_EYE_TOP_L = np.array([35, 41, 40, 42, 39])
_EYE_TOP_R = np.array([89, 95, 94, 96, 93])
_BROW_L = np.array([43, 48, 49, 51, 50])
_BROW_R = np.array([102, 103, 104, 105, 101])


def expand_eyebrows(lmks, mod=1.0):
    """Push brow landmarks away from the eye tops by mod * 0.5 * (brow -
    eye). `mod` is a float or a tensor broadcastable to (..., 1, 1)."""
    lmks = lmks.float()
    top_l = lmks[..., _BROW_L, :]
    bot_l = lmks[..., _EYE_TOP_L, :]
    top_r = lmks[..., _BROW_R, :]
    bot_r = lmks[..., _EYE_TOP_R, :]
    out = lmks.clone()
    out[..., _BROW_L, :] = top_l + mod * 0.5 * (top_l - bot_l)
    out[..., _BROW_R, :] = top_r + mod * 0.5 * (top_r - bot_r)
    return out


def _signed_dist_to_hull(points, size: int):
    """Signed distance (px, + inside) from each pixel to the convex hull.

    points (..., N, 2) -> (..., size, size). An ordered pair i->j is a
    CCW hull edge iff every point lies on its left; each hull vertex
    keeps its first such successor."""
    pts = points
    d = pts[..., None, :, :] - pts[..., :, None, :]  # (...,N,N,2) i->j
    nx = -d[..., 1]
    ny = d[..., 0]
    norm = torch.sqrt(nx * nx + ny * ny)
    nx = nx / (norm + 1e-12)
    ny = ny / (norm + 1e-12)
    rel = pts[..., None, None, :, :] - pts[..., :, None, None, :]  # (...,N,1,N,2)
    side = nx[..., None] * rel[..., 0] + ny[..., None] * rel[..., 1]
    is_ccw_edge = torch.all(side >= -1e-5, dim=-1) & (norm > 1e-9)

    has_succ = torch.any(is_ccw_edge, dim=-1)
    succ = torch.argmax(is_ccw_edge.to(torch.int32), dim=-1, keepdim=True)
    enx = torch.gather(nx, -1, succ)[..., 0]
    eny = torch.gather(ny, -1, succ)[..., 0]

    idx = torch.arange(size, dtype=torch.float32, device=pts.device)
    dx = idx - pts[..., 0][..., None, None]            # (...,N,1,W)
    dy = idx[:, None] - pts[..., 1][..., None, None]   # (...,N,H,1)
    dist = enx[..., None, None] * dx + eny[..., None, None] * dy
    dist = torch.where(has_succ[..., None, None], dist,
                       torch.full((), 1e9, device=pts.device))
    return torch.amin(dist, dim=-3)


@functools.lru_cache(maxsize=32)
def _gauss_kernel(sigma: float):
    """cv2.GaussianBlur(ksize=0) kernel: ksize = 2*round(4*sigma)+1."""
    radius = max(int(round(sigma * 4)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _blur_axis(x, sigma: float, axis: int):
    """Zero-padded 1-D Gaussian blur along `axis`."""
    k = torch.from_numpy(_gauss_kernel(sigma)).to(x.device)
    pad = (k.shape[0] - 1) // 2
    x_m = torch.movedim(x, axis, -1)
    shape = x_m.shape
    out = F.conv1d(x_m.reshape(-1, 1, shape[-1]), k.view(1, 1, -1),
                   padding=pad)
    return torch.movedim(out.reshape(shape), -1, axis)


def soft_face_mask(landmarks, size: int = 224, erode: float = 5.0,
                   sigma_x: float = 5.0, sigma_y: float = 5.0,
                   eyebrow_mod: float = 2.0):
    """Single-face mask (H,W) in [0,1] with static parameters."""
    lm = expand_eyebrows(landmarks, eyebrow_mod)
    sd = _signed_dist_to_hull(lm, size)
    mask = (sd >= erode).float()
    clip = int(2 * sigma_y)
    if clip > 0:
        fade = torch.zeros((size, size), device=mask.device)
        fade[clip:-clip, clip:-clip] = 1.0
        mask = mask * fade
    mask = _blur_axis(mask, sigma_y, axis=-2)
    mask = _blur_axis(mask, sigma_x, axis=-1)
    return torch.clamp(mask, 0.0, 1.0)


def mask_params_from_offset(offset):
    """Shot-level (erode, sigma_x, sigma_y, eyebrow_mod) selection from
    the landmark x-offset statistic, as python floats."""
    offset = float(offset)
    if offset > 6:
        return 15.0, 15.0, 10.0, 2.7
    if offset > 3:
        return 10.0, 10.0, 8.0, 2.0
    if offset < -3:
        return -5.0, 5.0, 10.0, 0.5
    return 5.0, 5.0, 5.0, 2.0


def mask_params_from_offset_traced(offset):
    """Tensor twin of `mask_params_from_offset`: (...,) -> (..., 4)."""
    def row(v):
        return torch.tensor(v, dtype=torch.float32, device=offset.device)

    o = offset[..., None]
    return torch.where(o > 6, row((15.0, 15.0, 10.0, 2.7)),
                       torch.where(o > 3, row((10.0, 10.0, 8.0, 2.0)),
                                   torch.where(o < -3, row((-5.0, 5.0, 10.0, 0.5)),
                                               row((5.0, 5.0, 5.0, 2.0)))))


def face_mask_batch(landmarks, size: int = 224, params=(5.0, 5.0, 5.0, 2.0)):
    """Batched soft masks with static params: (B,106,2) -> (B,H,W,1)."""
    erode, sx, sy, mod = params
    return soft_face_mask(landmarks.float(), size, erode, sx, sy,
                          mod)[..., None]


# ---------------------------------------------------------------------------
# Per-face parameters as tensors
# ---------------------------------------------------------------------------


def _gauss_matrix_dynamic(sigma, size: int, radius: int):
    """(..., size, size) Gaussian blur matrices for per-face sigmas,
    truncated at |i-j| > radius and normalised by the full kernel mass
    (zero-padded conv semantics)."""
    idx = torch.arange(size, dtype=torch.float32, device=sigma.device)
    d = idx[:, None] - idx[None, :]
    s2 = (2.0 * torch.clamp(sigma, min=1e-3) ** 2)[..., None, None]
    w = torch.exp(-(d * d) / s2) * (torch.abs(d) <= radius)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    z = torch.sum(torch.exp(-(x * x) / s2[..., 0]), dim=-1)
    return w / z[..., None, None]


def soft_face_mask_dynamic(landmarks, size: int = 224, erode=5.0,
                           sigma_x=5.0, sigma_y=5.0, eyebrow_mod=2.0,
                           max_radius: int = 64):
    """Soft masks with per-face parameters.

    landmarks (B,106,2); erode, sigma_x, sigma_y, eyebrow_mod (B,)
    tensors (or floats). Returns (B, size, size). The Gaussian support is
    fixed at max_radius taps and the border fade is a distance threshold."""
    lm0 = landmarks.float()
    b = lm0.shape[0]

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=lm0.device).expand(b)

    erode, sigma_x, sigma_y, eyebrow_mod = map(
        vec, (erode, sigma_x, sigma_y, eyebrow_mod))
    lm = expand_eyebrows(lm0, eyebrow_mod[:, None, None])
    sd = _signed_dist_to_hull(lm, size)
    mask = (sd >= erode[:, None, None]).float()

    ys = torch.arange(size, dtype=torch.float32, device=lm0.device)
    border_dist = torch.minimum(ys, size - 1 - ys)
    clip = (2.0 * sigma_y)[:, None, None]
    fade = (border_dist[:, None] >= clip) & (border_dist[None, :] >= clip)
    mask = mask * fade.float()

    my = _gauss_matrix_dynamic(sigma_y, size, max_radius)  # (B,S,S)
    mx = _gauss_matrix_dynamic(sigma_x, size, max_radius)
    mask = torch.matmul(my, mask)                  # blur along y
    mask = torch.matmul(mask, mx.transpose(-1, -2))  # blur along x
    return torch.clamp(mask, 0.0, 1.0)


def mask_offset_from_landmarks(landmarks_swap, landmarks_tgt):
    """(..., 106, 2) pairs -> (...,) max of summed left/right x-offsets."""
    lm = landmarks_swap.float()
    lt = landmarks_tgt.float()
    left = ((lm[..., 1, 0] - lt[..., 1, 0]) + (lm[..., 2, 0] - lt[..., 2, 0])
            + (lm[..., 13, 0] - lt[..., 13, 0]))
    right = ((lt[..., 17, 0] - lm[..., 17, 0]) + (lt[..., 18, 0] - lm[..., 18, 0])
             + (lt[..., 29, 0] - lm[..., 29, 0]))
    return torch.maximum(left, right)
