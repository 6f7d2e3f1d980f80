"""Optimizers, mirroring `ghost_tpu/train/optimizers.py` (optax chains
there, small `torch.optim` optimizers here).

The reference trains with torch.optim.Adam(lr=4e-4, betas=(0, 0.999),
weight_decay=1e-4): L2 decay added to the gradient before the moments,
not decoupled AdamW. `ghost_adam` is that optimizer, with an optional
schedule (`step_lr`) evaluated at the update count like optax's
`scale_by_learning_rate`. `fused_lamb` follows the optax chain
scale_by_adam -> add_decayed_weights -> scale_by_trust_ratio -> -lr,
and `LARC` scales each parameter's gradient by its trust ratio before an
inner optimizer's step, as `optax.chain(larc(), ghost_adam())`.
"""

from __future__ import annotations

import torch


def step_lr(lr: float, step_size: int, gamma: float):
    """StepLR parity: the schedule count -> lr * gamma ** (count //
    step_size), where count is the optimizer's update count."""

    def schedule(count):
        return lr * gamma ** (count // step_size)

    return schedule


class GhostAdam(torch.optim.Adam):
    """torch.optim.Adam with the reference's settings; `lr` is a float or
    a schedule, read at the update count before each step."""

    def __init__(self, params, lr=4e-4, b1: float = 0.0, b2: float = 0.999,
                 weight_decay: float = 1e-4, eps: float = 1e-8):
        self.schedule = lr if callable(lr) else None
        self.count = 0
        super().__init__(params, lr=float(lr(0)) if callable(lr) else lr,
                         betas=(b1, b2), eps=eps, weight_decay=weight_decay)

    def step(self, closure=None):
        if self.schedule is not None:
            for group in self.param_groups:
                group["lr"] = float(self.schedule(self.count))
        self.count += 1
        return super().step(closure)


def _trust(num, den, coefficient, eps):
    """coefficient * ||num|| / (||den|| + eps), or 1 where a norm is 0."""
    pn, un = torch.linalg.vector_norm(num), torch.linalg.vector_norm(den)
    ratio = coefficient * pn / (un + eps)
    return torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)


class FusedLamb(torch.optim.Optimizer):
    """apex FusedLAMB equivalent: Adam direction plus decoupled decay,
    scaled per parameter by ||p|| / ||update||."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, weight_decay: float = 0.01,
                 eps: float = 1e-6):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2,
                                      weight_decay=weight_decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
                st["mu"].mul_(b1).add_(p.grad, alpha=1.0 - b1)
                st["nu"].mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
                mu_hat = st["mu"] / (1.0 - b1 ** st["count"])
                nu_hat = st["nu"] / (1.0 - b2 ** st["count"])
                update = (mu_hat / (torch.sqrt(nu_hat) + group["eps"])
                          + group["weight_decay"] * p)
                p.sub_(group["lr"] * _trust(p, update, 1.0, 0.0) * update)
        return loss


class LARC:
    """Layer-wise adaptive rate scaling around an inner optimizer (apex
    LARC parity): each gradient is scaled by trust * ||p|| / ||g||
    (clipped at 1 when `clip`) before the inner step."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8):
        self.optimizer = optimizer
        self.trust_coefficient, self.clip, self.eps = trust_coefficient, clip, eps

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        with torch.no_grad():
            for group in self.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    trust = _trust(p, p.grad, self.trust_coefficient, self.eps)
                    if self.clip:
                        trust = torch.clamp(trust, max=1.0)
                    p.grad.mul_(trust)
        return self.optimizer.step(closure)


# the JAX package's names for the three optimizers
ghost_adam, fused_lamb, larc = GhostAdam, FusedLamb, LARC
