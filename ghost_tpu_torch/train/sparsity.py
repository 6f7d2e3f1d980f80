"""ASP-style 2:4 structured sparsity masks (apex.contrib.sparsity
parity), mirroring `ghost_tpu/train/sparsity.py`.

The reference ships Automatic SParsity: prune each weight matrix to 2:4
patterns and freeze the mask (reference apex/apex/contrib/sparsity/asp.py).
The JAX package's rule, kept: a leaf of the flax tree is pruned when its
path names a `kernel`, it has at least 2 dims and its LAST axis divides
by 4; in every group of 4 consecutive values along that last axis the 2
of largest magnitude are kept (ties keep index order: a stable sort).
For a Dense kernel (in, out) the last axis is the output features, for
an HWIO conv kernel the O axis.

The port's modules hold their weights in other layouts (`Dense` (out,
in), `Conv` OIHW, `Conv3x3` HWIO), so the rule is applied in the flax
layout of each parameter, found by the weight bridge's own path and
layout transform (`convert/from_jax.py:flax_leaf_path`, a transpose:
applied as a permuted view on the device), and the mask is carried back
into the parameter's layout. The masks are computed on the
parameters' device and are the JAX masks of `flax_variables(module)`,
element for element.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def mask_2to4_last_axis(w: torch.Tensor) -> torch.Tensor:
    """Keep the 2 largest-|w| of every 4 consecutive along the last axis."""
    shape = w.shape
    if shape[-1] % 4 != 0:
        return torch.ones_like(w, dtype=torch.bool)
    mag = torch.abs(w.reshape(*shape[:-1], shape[-1] // 4, 4))
    # rank within each group; keep top-2 (stable: ties keep index order)
    order = torch.argsort(-mag, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks < 2).reshape(shape)


def _prunable(path, shape) -> bool:
    """The JAX rule on a flax path (its collection first)."""
    name = "/".join(f"['{p}']" for p in path).lower()
    return len(shape) >= 2 and "kernel" in name and shape[-1] % 4 == 0


def _axes(fn, ndim: int):
    """The axis permutation a bridge layout fn applies (each is a
    transpose): read off the shape it gives an array of distinct dims."""
    if fn is None:
        return tuple(range(ndim))
    return tuple(d - 2 for d in fn(np.empty(tuple(range(2, ndim + 2)),
                                            np.int8)).shape)


def compute_masks(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: bool mask in the parameter's own layout, on its
    device}: 2:4 masks for the prunable kernels, True elsewhere."""
    from ghost_tpu_torch.convert.from_jax import flax_leaf_path

    masks = {}
    for key, p in module.named_parameters():
        collection, path, fn = flax_leaf_path(module, key)
        axes = _axes(fn, p.ndim)
        w = p.detach().permute(axes)  # the flax layout, a view
        if not _prunable([collection] + path, w.shape):
            masks[key] = torch.ones_like(p, dtype=torch.bool)
            continue
        back = tuple(np.argsort(axes))
        masks[key] = mask_2to4_last_axis(w).permute(back).contiguous()
    return masks


@torch.no_grad()
def apply_masks(module: nn.Module, masks: Dict[str, torch.Tensor]):
    """Zero the pruned weights of `module` in place; returns it."""
    params = dict(module.named_parameters())
    for key, m in masks.items():
        params[key].mul_(m.to(params[key].dtype))
    return module


def sparsity_ratio(masks: Dict[str, torch.Tensor]) -> float:
    total = 0
    kept = 0
    for m in masks.values():
        total += m.numel()
        kept += int(m.sum())
    return 1.0 - kept / max(total, 1)
