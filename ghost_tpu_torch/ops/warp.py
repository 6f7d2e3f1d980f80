"""Batched affine warps and paste-back blends, mirroring `ghost_tpu/ops/warp.py`.

Matrices are FORWARD maps src->dst in cv2 convention (pixel centres at
integer coordinates); like cv2.warpAffine the warp inverts internally
and samples the source at M^-1 @ dst. Bilinear taps outside the source
take the border value ('constant') or the clamped edge ('replicate').

The 1080p paths are the similarity-decomposed variants: two dense
tent-matrix products for the axis-aligned part of the map and a small
rotation resample, instead of gathers over the full frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ghost_tpu_torch.nn.layers import resize


def invert_affine(m):
    """Invert (..., 2, 3) affine matrices (cv2.invertAffineTransform)."""
    a = m[..., :2]
    t = m[..., 2]
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv_det = 1.0 / det
    inv = torch.stack([
        torch.stack([a[..., 1, 1] * inv_det, -a[..., 0, 1] * inv_det], dim=-1),
        torch.stack([-a[..., 1, 0] * inv_det, a[..., 0, 0] * inv_det], dim=-1),
    ], dim=-2)
    new_t = -torch.einsum("...ij,...j->...i", inv, t)
    return torch.cat([inv, new_t[..., None]], dim=-1)


def _batch_index(b, ndim, device):
    return torch.arange(b, device=device).view((b,) + (1,) * (ndim - 1))


def _sample_bilinear_batch(imgs, xs, ys, border: str, border_value: float):
    """imgs (B,H,W,C); xs, ys (B, ...) source coords -> (B, ..., C)."""
    b, h_in, w_in, c = imgs.shape
    out_shape = xs.shape
    flat = imgs.reshape(b * h_in * w_in, c)
    bidx = _batch_index(b, xs.ndim, imgs.device)

    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    def tap(yi, xi):
        yc = yi.clamp(0, h_in - 1)
        xc = xi.clamp(0, w_in - 1)
        lin = (bidx * h_in + yc) * w_in + xc
        v = flat[lin.reshape(-1)].reshape(*out_shape, c)
        if border == "replicate":
            return v
        valid = (yi >= 0) & (yi < h_in) & (xi >= 0) & (xi < w_in)
        return torch.where(valid[..., None], v,
                           torch.tensor(border_value, dtype=v.dtype,
                                        device=v.device))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _pixel_grid(h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return ys, xs


def _apply_affine_grid(m, xs, ys):
    """(B,2,3) matrices on an (h,w) pixel grid -> (B,h,w) x and y."""
    px = (m[:, 0, 0, None, None] * xs + m[:, 0, 1, None, None] * ys
          + m[:, 0, 2, None, None])
    py = (m[:, 1, 0, None, None] * xs + m[:, 1, 1, None, None] * ys
          + m[:, 1, 2, None, None])
    return px, py


def warp_affine(img, m, out_hw, border: str = "constant",
                border_value: float = 0.0):
    """cv2.warpAffine parity, batched. img (B,H,W,C) or (H,W,C); m the
    matching (B,2,3) or (2,3) forward maps."""
    batched = img.ndim == 4
    if not batched:
        img, m = img[None], m[None]
    m = m.float()
    ys, xs = _pixel_grid(out_hw[0], out_hw[1], img.device)
    sx, sy = _apply_affine_grid(invert_affine(m), xs, ys)
    out = _sample_bilinear_batch(img, sx, sy, border, border_value)
    return out if batched else out[0]


def warp_and_blend(frame, swap, mask, m_crop, present=None):
    """Fused gather paste-back over the full frame.

    frame (B,H,W,C); swap (B,h,w,C); mask (B,h,w,1) in [0,1]; m_crop
    (B,2,3) frame->crop matrices; present optional (B,) bool (frames
    without a face pass through)."""
    h, w = frame.shape[1:3]
    ys, xs = _pixel_grid(h, w, frame.device)
    cx, cy = _apply_affine_grid(m_crop.float(), xs, ys)
    sm = torch.cat([swap, mask.to(swap.dtype)], dim=-1)
    sm_t = _sample_bilinear_batch(sm, cx, cy, "constant", 0.0)
    sw_t = sm_t[..., :3]
    mk_t = sm_t[..., 3:4]
    out = mk_t * sw_t + (1.0 - mk_t) * frame.to(sw_t.dtype)
    if present is not None:
        out = torch.where(present.reshape(-1, 1, 1, 1), out,
                          frame.to(out.dtype))
    return out


# ---------------------------------------------------------------------------
# Similarity-decomposed crops and paste-back
# ---------------------------------------------------------------------------


def _tent_matrix(positions, grid: int):
    """positions (B, N) -> (B, N, grid) linear-interp weights; positions
    outside [0, grid-1] decay to 0 like a zero border."""
    k = torch.arange(grid, dtype=torch.float32, device=positions.device)
    return torch.clamp(1.0 - torch.abs(positions[..., None] - k), min=0.0)


def _sample_nearest_batch(imgs, xs, ys):
    """Single-tap nearest sampling; round half to even like jnp.round,
    out-of-range taps are zero (`ghost_tpu/ops/warp.py:185-203`)."""
    b, h_in, w_in, c = imgs.shape
    out_shape = xs.shape
    flat = imgs.reshape(b * h_in * w_in, c)
    bidx = _batch_index(b, xs.ndim, imgs.device)
    rx = torch.round(xs)
    ry = torch.round(ys)
    xi = rx.long().clamp(0, w_in - 1)
    yi = ry.long().clamp(0, h_in - 1)
    lin = (bidx * h_in + yi) * w_in + xi
    v = flat[lin.reshape(-1)].reshape(*out_shape, c)
    valid = (rx >= 0) & (rx < w_in) & (ry >= 0) & (ry < h_in)
    return torch.where(valid[..., None], v, torch.zeros((), dtype=v.dtype,
                                                        device=v.device))


def warp_affine_similarity(frames, m, out_size: int, grid: int | None = None,
                           compute_dtype=torch.bfloat16, subpix: int = 1,
                           interp: str = "bilinear"):
    """Crop extraction for SIMILARITY matrices without gathers on the frame.

    M^-1 p = (1/s) R^T (p - t): the frame position is axis-aligned in
    q = pc + R^T (p - pc), so two tent-matrix products over the frame
    (bilinear interpolation) build a (grid*subpix)^2 intermediate, and a
    small rotation resample (nearest or bilinear taps) gives the crop.

    frames (B,H,W,C); m (B,T,2,3) or (B,2,3). Returns (B*T, out, out, C)
    float32 crops, frame-major."""
    b, h, w, c = frames.shape
    m = m.float()
    if m.ndim == 3:
        m = m[:, None]
    t_faces = m.shape[1]
    if grid is None:
        grid = int(np.ceil(out_size * np.sqrt(2) / 32.0)) * 32
    if grid / 2 < out_size / 2 * np.sqrt(2) - 1e-3:
        raise ValueError(f"grid {grid} does not cover a {out_size} crop")

    a = m[..., 0, 0]
    bb = m[..., 1, 0]
    t = m[..., :, 2]
    s = torch.sqrt(a * a + bb * bb)
    inv_s = 1.0 / torch.clamp(s, min=1e-12)
    cos = a * inv_s
    sin = bb * inv_s

    q0 = (out_size - grid) / 2.0
    pc = (out_size - 1) / 2.0
    t2x = ((cos * (pc - t[..., 0]) + sin * (pc - t[..., 1])) - pc) * inv_s
    t2y = ((-sin * (pc - t[..., 0]) + cos * (pc - t[..., 1])) - pc) * inv_s

    n_q = grid * subpix
    qs = torch.arange(n_q, dtype=torch.float32, device=frames.device) / subpix + q0
    row_pos = inv_s[..., None] * qs + t2y[..., None]
    col_pos = inv_s[..., None] * qs + t2x[..., None]
    row_w = _tent_matrix(row_pos, h).to(compute_dtype)  # (B,T,n_q,H)
    col_w = _tent_matrix(col_pos, w).to(compute_dtype)  # (B,T,n_q,W)

    fr = frames.to(compute_dtype)
    inter = torch.einsum("btkw,bhwc->bthkc", col_w, fr)
    inter = torch.einsum("btgh,bthkc->btgkc", row_w, inter)
    inter = inter.reshape(b * t_faces, n_q, n_q, c)

    ys, xs = _pixel_grid(out_size, out_size, frames.device)
    cosf = cos.reshape(-1)[:, None, None]
    sinf = sin.reshape(-1)[:, None, None]
    qx = (cosf * (xs - pc) + sinf * (ys - pc) + pc - q0) * subpix
    qy = (-sinf * (xs - pc) + cosf * (ys - pc) + pc - q0) * subpix
    if interp == "nearest":
        out = _sample_nearest_batch(inter, qx, qy)
    else:
        out = _sample_bilinear_batch(inter, qx, qy, "constant", 0.0)
    return out.float()


def warp_and_blend_similarity(frame, swap, mask, m_crop, present=None,
                              grid: int = 320, rot_subpix: int = 1,
                              rot_interp: str = "bilinear"):
    """Paste-back for SIMILARITY alignment matrices, gather-free on the frame.

    [swap|mask] is resampled under the pure rotation onto a centred
    (grid x grid) window (grid/2 >= crop/sqrt(2) covers every angle),
    then the axis-aligned scale+shift is two bf16 tent-matrix products
    to the full frame, and the result is blended in bf16. Frames,
    swap (B,crop,crop,3), mask (B,crop,crop,1), m_crop (B,2,3)."""
    b, h, w, _ = frame.shape
    crop = swap.shape[1]
    dev = frame.device
    m = m_crop.float()
    a = m[:, 0, 0]
    bb = m[:, 1, 0]
    t = m[:, :, 2]
    s = torch.sqrt(a * a + bb * bb)
    cos = a / torch.clamp(s, min=1e-12)
    sin = bb / torch.clamp(s, min=1e-12)

    u0 = (crop - grid) / 2.0
    pc = (crop - 1) / 2.0

    g = torch.arange(grid, dtype=torch.float32, device=dev) + u0 - pc
    uu, vv = torch.meshgrid(g, g, indexing="xy")
    xc = cos[:, None, None] * uu - sin[:, None, None] * vv + pc
    yc = sin[:, None, None] * uu + cos[:, None, None] * vv + pc
    sm = torch.cat([swap, mask.to(swap.dtype)], dim=-1)
    if rot_subpix > 1 or rot_interp == "nearest":
        if rot_subpix > 1:
            sm = resize(sm.to(torch.bfloat16),
                        (crop * rot_subpix, crop * rot_subpix),
                        method="bilinear")
            xc = (xc + 0.5) * rot_subpix - 0.5
            yc = (yc + 0.5) * rot_subpix - 0.5
        crop_rot = _sample_nearest_batch(sm, xc, yc)
    else:
        crop_rot = _sample_bilinear_batch(sm, xc, yc, "constant", 0.0)

    cx = cos * (t[:, 0] - pc) + sin * (t[:, 1] - pc) + pc
    cy = -sin * (t[:, 0] - pc) + cos * (t[:, 1] - pc) + pc
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    row_pos = s[:, None] * ys[None, :] + cy[:, None] - u0  # (B,H)
    col_pos = s[:, None] * xs[None, :] + cx[:, None] - u0  # (B,W)
    row_w = _tent_matrix(row_pos, grid).to(torch.bfloat16)  # (B,H,grid)
    col_w = _tent_matrix(col_pos, grid).to(torch.bfloat16)  # (B,W,grid)
    crop_rot16 = crop_rot.to(torch.bfloat16)

    tmp = torch.einsum("byj,bjic->byic", row_w, crop_rot16)
    warped = torch.einsum("byic,bxi->byxc", tmp, col_w)  # (B,H,W,4) bf16

    sw_t = warped[..., :3]
    mk_t = torch.clamp(warped[..., 3:4], 0.0, 1.0)
    out = mk_t * sw_t + (1.0 - mk_t) * frame.to(sw_t.dtype)
    if present is not None:
        out = torch.where(present.reshape(-1, 1, 1, 1), out,
                          frame.to(out.dtype))
    return out
