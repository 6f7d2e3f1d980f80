"""Quality metrics for swap outputs: id-sim, PSNR, perceptual distance,
mirroring `ghost_tpu/utils/quality.py`.

  * id_similarity: cosine between ArcFace embeddings of two aligned
    face crops (the reference's own identity metric, train.py:311), the
    crops area-resized to 112 through `nn.layers.resize`;
  * psnr: pixel-space sanity metric;
  * perceptual_distance: LPIPS-style normalized-VGG-feature distance
    (Zhang et al. 2018), e.g. over `models/sr/vgg.py:VGG19Features`.
    With `lin_weights=None` it degrades to the unit-weighted variant
    (VGG-space distance); pass the published LPIPS linear weights for
    exact LPIPS.

Every metric is batched and runs on the device of its inputs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ghost_tpu_torch.nn.layers import resize


def _unit(x, eps):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def id_similarity(arc_apply: Callable, crop_a_pm1, crop_b_pm1):
    """Cosine similarity of ArcFace embeddings; crops (B,S,S,3) NHWC in
    [-1,1], any S (area-resized to 112 like the reference embed path)."""
    ea = arc_apply(resize(crop_a_pm1, (112, 112), method="area"))
    eb = arc_apply(resize(crop_b_pm1, (112, 112), method="area"))
    return torch.sum(_unit(ea, 1e-12) * _unit(eb, 1e-12), dim=-1)


def psnr(a_u8, b_u8):
    a = a_u8.float()
    b = b_u8.float()
    mse = torch.mean(torch.square(a - b), dim=tuple(range(1, a.ndim)))
    return 10.0 * torch.log10(255.0 ** 2 / torch.clamp(mse, min=1e-12))


def perceptual_distance(
    vgg_features: Callable,
    img_a_pm1,
    img_b_pm1,
    lin_weights: Optional[Sequence] = None,
):
    """LPIPS-style distance: unit-normalize each NHWC VGG feature map
    along channels, average squared differences spatially, weight per
    layer.

    vgg_features: imgs -> list of NHWC feature maps (e.g.
    models.sr.vgg.VGG19Features at the relu slices). lin_weights: per-
    layer (C,) weights (the published LPIPS 'lin' heads); None = 1/C.
    """
    fa = vgg_features(img_a_pm1)
    fb = vgg_features(img_b_pm1)
    total = 0.0
    for k, (a, b) in enumerate(zip(fa, fb)):
        d = torch.square(_unit(a, 1e-10) - _unit(b, 1e-10))
        if lin_weights is not None:
            d = d * torch.as_tensor(lin_weights[k], dtype=d.dtype,
                                    device=d.device).reshape(1, 1, 1, -1)
        else:
            d = d / a.shape[-1]
        total = total + torch.mean(torch.sum(d, dim=-1), dim=(1, 2))
    return total
