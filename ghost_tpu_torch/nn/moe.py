"""Mixture-of-Experts MLP with top-k gating, mirroring
`ghost_tpu/nn/moe.py` (beyond the reference, which has no MoE).

A linear router, softmax top-k gate weights renormalised over the kept
experts, and E two-layer GELU MLPs whose outputs are summed with those
weights. The experts are stacked params (E, ...), as in JAX, so the
weight bridge maps leaf for leaf, and the dense path computes every
expert with batched einsums; selection is a multiply by the (N, E) gate
matrix, zero outside the top k. The layer is therefore linear in the
expert axis: sum_e gate_e * f_e(x) splits over any partition of the
experts, which `parallel/ep.py` sums back with one psum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_moe_params(generator: torch.Generator, d_model: int, d_hidden: int,
                    num_experts: int, dtype=torch.float32,
                    device=None) -> dict:
    """Stacked-expert params: router w (D, E) and b (E,), experts w1
    (E, D, H), b1 (E, H), w2 (E, H, D), b2 (E, D); normal weights scaled
    by fan-in ** -0.5, zero biases (JAX's init, from a torch.Generator)."""
    def normal(*shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * scale

    s1, s2 = d_model ** -0.5, d_hidden ** -0.5
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype,  # noqa: E731
                                       device=device)
    return {
        "router": {"w": normal(d_model, num_experts, scale=s1),
                   "b": zeros(num_experts)},
        "w1": normal(num_experts, d_model, d_hidden, scale=s1),
        "b1": zeros(num_experts, d_hidden),
        "w2": normal(num_experts, d_hidden, d_model, scale=s2),
        "b2": zeros(num_experts, d_model),
    }


def gate_weights(params: dict, x: torch.Tensor, top_k: int) -> torch.Tensor:
    """(N, E) f32 gate weights: softmax over experts, zeroed outside each
    token's top k (every expert tied with the k-th is kept, so ties keep
    more than k), renormalised over the kept ones."""
    logits = (x.float() @ params["router"]["w"].float()
              + params["router"]["b"].float())
    probs = torch.softmax(logits, dim=-1)
    if top_k < probs.shape[-1]:
        kth = torch.topk(probs, top_k, dim=-1).values[..., -1:]
        probs = torch.where(probs >= kth, probs, torch.zeros_like(probs))
    return probs / torch.sum(probs, dim=-1, keepdim=True)


def expert_contrib(params: dict, x: torch.Tensor,
                   gates: torch.Tensor) -> torch.Tensor:
    """sum_e gates[:, e] * f_e(x) over this (possibly partial) expert
    stack, for every token; `gates` has the stack's width. GELU is the
    tanh approximation, `jax.nn.gelu`'s default."""
    h = torch.einsum("nd,edh->neh", x, params["w1"]) + params["b1"]
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("neh,ehd->ned", h, params["w2"]) + params["b2"]
    return torch.einsum("ned,ne->nd", y, gates.to(y.dtype))


def moe_apply(params: dict, x: torch.Tensor, top_k: int = 2) -> torch.Tensor:
    """Dense single-device reference: every expert on every token.
    x (..., D) -> (..., D)."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    gates = gate_weights(params, xf, top_k)
    return expert_contrib(params, xf, gates).reshape(shape)
