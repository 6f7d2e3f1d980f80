"""Dynamic loss scaling, mirroring `ghost_tpu/core/loss_scale.py` (the
apex.amp LossScaler rule): start at 2**16, halve on a non-finite
gradient (not below 1), double after `growth_interval` clean steps (not
above 2**24), and keep the old parameters on an overflowed step.

The state is functional, as in JAX: `update` and `apply_if_finite`
return new values and read the finiteness flag as a tensor, so a step
takes no host sync. Gradients are a list (or dict) of tensors.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


def _leaves(tree):
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return [fn(*xs) for xs in zip(*trees)]


class DynamicLossScale(NamedTuple):
    """Loss-scale state: `scale` an f32 scalar tensor, `growth_counter`
    an int32 scalar tensor."""

    scale: torch.Tensor
    growth_counter: torch.Tensor
    growth_interval: int = 2000
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    max_scale: float = 2.0**24

    @classmethod
    def init(cls, initial_scale: float = 2.0**16,
             growth_interval: int = 2000, device="cpu"):
        return cls(
            scale=torch.tensor(initial_scale, dtype=torch.float32,
                               device=device),
            growth_counter=torch.tensor(0, dtype=torch.int32, device=device),
            growth_interval=growth_interval,
        )

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.scale.to(loss.dtype)

    def unscale_grads(self, grads: Any) -> Any:
        inv = 1.0 / self.scale
        return _map(lambda g: g * inv.to(g.dtype), grads)

    def check_finite(self, grads: Any) -> torch.Tensor:
        finite = torch.ones((), dtype=torch.bool, device=self.scale.device)
        for g in _leaves(grads):
            finite = finite & torch.all(torch.isfinite(g))
        return finite

    def update(self, grads_finite: torch.Tensor) -> "DynamicLossScale":
        grew = self.growth_counter + 1 >= self.growth_interval
        new_scale = torch.where(
            grads_finite,
            torch.where(grew,
                        torch.clamp(self.scale * self.growth_factor,
                                    max=self.max_scale),
                        self.scale),
            torch.clamp(self.scale * self.backoff_factor, min=1.0),
        )
        new_counter = torch.where(grads_finite & ~grew,
                                  self.growth_counter + 1,
                                  torch.zeros_like(self.growth_counter))
        return self._replace(scale=new_scale, growth_counter=new_counter)

    def apply_if_finite(self, params: Any, new_params: Any,
                        grads_finite) -> Any:
        """The new parameters where the gradients were finite, else the
        old ones (apex's skipped step)."""
        return _map(lambda old, new: torch.where(grads_finite, new, old),
                    params, new_params)


def scaled_value_and_grad(loss_fn, loss_scale: DynamicLossScale):
    """Wrap loss_fn(params, *args) -> scalar: returns (loss, grads,
    finite), the gradients taken of the scaled loss with respect to
    `params` (a list or dict of tensors that require grad) and unscaled."""

    def wrapped(params, *args, **kwargs):
        scaled = loss_scale.scale_loss(loss_fn(params, *args, **kwargs))
        grads = torch.autograd.grad(scaled, _leaves(params))
        if isinstance(params, dict):
            grads = dict(zip(params, grads))
        grads = loss_scale.unscale_grads(grads)
        finite = loss_scale.check_finite(grads)
        return scaled.detach() / loss_scale.scale, grads, finite

    return wrapped
