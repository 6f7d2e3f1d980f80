"""Color-space training helpers (reference utils/training/helpers.py),
mirroring `ghost_tpu/train/color.py`.

  * get_hsv / hsv_to_rgb / modify_images_with_hsv (:8-92): RGB<->HSV on
    pm1/01 NHWC batches, branchless (the reference's boolean-mask
    indexing becomes torch.where selects);
  * color_consistency_loss (:150-182): penalize center-vs-edge color
    shifts;
  * stuck_loss (:95-115): penalize high-frequency gradients inside a
    region (anti-artifact);
  * is_any_nan: the host-side NaN guard over a tree of tensors.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch


def get_hsv(img_pm1, eps: float = 1e-7):
    """pm1 RGB NHWC -> HSV NHWC with h,s,v in [0,1] (helpers.py:8-24)."""
    img = img_pm1 * 0.5 + 0.5
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = torch.amax(img, dim=-1)
    mn = torch.amin(img, dim=-1)
    rng = mx - mn + eps

    h_r = ((g - b) / rng) % 6.0
    h_g = (b - r) / rng + 2.0
    h_b = (r - g) / rng + 4.0
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    # priority order matches the reference's assignment sequence: the
    # LAST write wins there (b==max, then g==max, then r==max)
    hue = torch.where(b == mx, h_b, zero)
    hue = torch.where(g == mx, h_g, hue)
    hue = torch.where(r == mx, h_r, hue)
    hue = torch.where(mn == mx, zero, hue) / 6.0

    sat = torch.where(mx == 0, zero, (mx - mn) / (mx + eps))
    return torch.stack([hue, sat, mx], dim=-1)


def hsv_to_rgb(hsv):
    """HSV NHWC (01) -> RGB 01 NHWC (helpers.py:26-66)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    c = v * s
    h6 = h * 6.0
    x = c * (1.0 - torch.abs(h6 % 2.0 - 1.0))
    m = v - c
    k = torch.floor(h6)

    def sel(vals):
        out = torch.zeros_like(h)
        for idx, val in enumerate(vals):
            out = torch.where((k == idx) | ((idx == 0) & (k == 6)), val, out)
        return out

    z = torch.zeros_like(h)
    r = sel([c, x, z, z, x, c])
    g = sel([x, c, c, x, z, z])
    b = sel([z, z, x, c, c, x])
    return torch.stack([r + m, g + m, b + m], dim=-1)


def modify_images_with_hsv(batch_src_pm1, batch_dst_pm1):
    """Replace dst's HSV with src's (helpers.py:69-92) -> RGB 01."""
    return hsv_to_rgb(get_hsv(batch_src_pm1))


def color_consistency_loss(batch, center=(30, 30, 50, 50),
                           edge=(0, 0, 112, 112)):
    """Center-region color shift vs edge-region mean (helpers.py:150-182)."""
    cx, cy, cw, ch = center
    ex, ey, ew, eh = edge
    c = batch[:, cy:cy + ch, cx:cx + cw, :]
    e = batch[:, ey:ey + eh, ex:ex + ew, :]
    e_mean = torch.mean(e, dim=(1, 2), keepdim=True)
    c_mean = torch.mean(c, dim=(1, 2), keepdim=True)
    adjusted = c - (c_mean - e_mean)
    return torch.mean(torch.square(adjusted - c))


def stuck_loss(output, region, weight: float = 0.5):
    """Gradient-smoothness penalty in a region (helpers.py:95-115)."""
    x, y, h, w = region
    r = output[:, y:y + h, x:x + w, :]
    gx = torch.abs(r[:, :, 1:, :] - r[:, :, :-1, :])
    gy = torch.abs(r[:, 1:, :, :] - r[:, :-1, :, :])
    mh = min(gx.shape[1], gy.shape[1])
    mw = min(gx.shape[2], gy.shape[2])
    gx = gx[:, :mh, :mw]
    gy = gy[:, :mh, :mw]
    return weight * torch.mean(gx * gx + gy * gy)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def is_any_nan(tree) -> bool:
    """Host-side NaN guard (reference train-self.py:45-50): whether any
    leaf of a tree (dicts, lists, tuples) of tensors or arrays holds a
    non-finite value. One host read per leaf."""
    for leaf in _leaves(tree):
        if not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            return True
    return False
