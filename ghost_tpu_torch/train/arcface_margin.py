"""ArcFace additive-angular-margin head (ArcMarginModel parity),
mirroring `ghost_tpu/train/arcface_margin.py`.

The reference carries an ArcFace training head in its SimSwap-lineage
dead code (reference models/models.py:150-181: normalized weights,
cos(theta+m) on the target class, easy-margin variant, scale s). The
parameter is `weight` (D, C), the JAX head's layout, xavier-uniform with
the same fans (D in, C out), so the bridge loads JAX's parameters as
they are.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ghost_tpu_torch.models.arcface import normalize_embedding


class ArcMarginHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int,
                 margin: float = 0.5, scale: float = 64.0,
                 easy_margin: bool = False, device=None):
        super().__init__()
        self.margin = margin
        self.scale = scale
        self.easy_margin = easy_margin
        self.weight = nn.Parameter(torch.empty(in_features, num_classes,
                                               device=device))

    def reset_parameters(self, generator):
        # flax xavier_uniform on (D, C): fan_in D, fan_out C
        d, c = self.weight.shape
        bound = math.sqrt(6.0 / (d + c))
        nn.init.uniform_(self.weight, -bound, bound, generator=generator)

    def forward(self, embeddings, labels):
        """embeddings (B, D), labels (B,) -> margin-adjusted logits (B, C)."""
        e = normalize_embedding(embeddings.float())
        w = self.weight
        wn = w / torch.clamp(torch.linalg.vector_norm(w, dim=0, keepdim=True),
                             min=1e-12)
        cos = e @ wn  # (B, C) cosine similarities
        sin = torch.sqrt(torch.clamp(1.0 - cos * cos, 0.0, 1.0))
        cos_m = math.cos(self.margin)
        sin_m = math.sin(self.margin)
        phi = cos * cos_m - sin * sin_m  # cos(theta + m)
        if self.easy_margin:
            phi = torch.where(cos > 0, phi, cos)
        else:
            th = math.cos(math.pi - self.margin)
            mm = math.sin(math.pi - self.margin) * self.margin
            phi = torch.where(cos > th, phi, cos - mm)
        onehot = torch.zeros_like(cos)
        onehot[torch.arange(cos.shape[0], device=cos.device), labels] = 1.0
        return self.scale * (onehot * phi + (1.0 - onehot) * cos)
