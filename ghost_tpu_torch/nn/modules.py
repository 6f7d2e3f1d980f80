"""apex-parity NN modules, mirroring `ghost_tpu/nn/modules.py`: MLP,
multihead attention over the flash-attention kernels (K2), softmax
cross-entropy with label smoothing, and weight normalization.

Names follow the flax modules so the weight bridge maps leaf for leaf:
`dense{i}` in `MLP`; `q_proj`, `k_proj`, `v_proj`, `out_proj`,
`ln_scale` and `ln_bias` in `MultiheadAttention`; `v`, `g` and `bias` in
`WeightNormDense` (v in the flax (in, out) layout). flax infers input
widths at the first call; these modules take them as arguments.

Not ported here: `MultiheadAttention.seq_mesh` (ring attention across
devices, `ghost_tpu/parallel/sp.py`), which comes with the parallel
layer.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import Dense
from ghost_tpu_torch.ops.cuda.attention import (flash_attention,
                                                flash_attention_plain)
from ghost_tpu_torch.ops.cuda.layer_norm import layer_norm_plain


class MLP(nn.Module):
    """Dense chain with bias + activation between layers (mlp_cuda
    parity); computes in the policy's compute dtype."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = F.relu, use_bias: bool = True,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.activation = activation
        self.policy = policy
        self.n_layers = len(features)
        widths = [in_features, *features]
        for i in range(self.n_layers):
            self.add_module(f"dense{i}", Dense(
                widths[i], widths[i + 1], use_bias=use_bias,
                dtype=policy.compute_dtype, device=device))

    def forward(self, x):
        x = x.to(self.policy.compute_dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"dense{i}")(x)
            if i < self.n_layers - 1:
                x = self.activation(x)
        return x.to(self.policy.output_dtype)


class MultiheadAttention(nn.Module):
    """Self or encoder-decoder attention with a flash-attention core.

    `norm_add` reproduces apex's *_norm_add variants: an f32 LayerNorm
    on the query input and a residual add on the output. The core takes
    `flash_attention` (K2 on the card) for self-attention with
    s == sk and s % 128 == 0 when `use_kernel` is set, and the plain
    core for every other shape, as the JAX module sends those to its
    reference."""

    def __init__(self, in_features: int, num_heads: int, head_dim: int,
                 causal: bool = False, norm_add: bool = False,
                 use_kernel: bool = True, kv_features: int | None = None,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.causal, self.norm_add, self.use_kernel = causal, norm_add, use_kernel
        self.policy = policy
        d_model = num_heads * head_dim
        kv_features = in_features if kv_features is None else kv_features
        cd = policy.compute_dtype
        if norm_add:
            self.ln_scale = nn.Parameter(torch.ones(in_features, device=device))
            self.ln_bias = nn.Parameter(torch.zeros(in_features, device=device))
        self.q_proj = Dense(in_features, d_model, dtype=cd, device=device)
        self.k_proj = Dense(kv_features, d_model, dtype=cd, device=device)
        self.v_proj = Dense(kv_features, d_model, dtype=cd, device=device)
        self.out_proj = Dense(d_model, in_features, dtype=cd, device=device)

    def reset_parameters(self, generator):
        if self.norm_add:
            nn.init.ones_(self.ln_scale)
            nn.init.zeros_(self.ln_bias)

    def forward(self, q_in, kv_in=None):
        cd = self.policy.compute_dtype
        residual = q_in
        if self.norm_add:
            q_in = layer_norm_plain(q_in.float(), self.ln_scale, self.ln_bias)
        kv_in = q_in if kv_in is None else kv_in
        q = self.q_proj(q_in.to(cd))
        k = self.k_proj(kv_in.to(cd))
        v = self.v_proj(kv_in.to(cd))
        b, s, sk = q.shape[0], q.shape[1], k.shape[1]

        def split(t, sl):  # (B, S, H*D) -> (B, H, S, D) view, no copy
            return t.reshape(b, sl, self.num_heads, self.head_dim).transpose(1, 2)

        qh, kh, vh = split(q, s), split(k, sk), split(v, sk)
        if self.use_kernel and s == sk and s % 128 == 0:
            o = flash_attention(qh, kh, vh, self.causal)
        else:
            o = flash_attention_plain(qh, kh, vh, self.causal)
        o = o.transpose(1, 2).reshape(b, s, self.num_heads * self.head_dim)
        out = self.out_proj(o)
        if self.norm_add:
            out = out + residual.to(out.dtype)
        return out.to(self.policy.output_dtype)


def softmax_cross_entropy(logits, labels, label_smoothing: float = 0.0):
    """Log-softmax cross-entropy with label smoothing (xentropy_cuda
    parity). logits (N, V), labels (N,) int -> (N,) f32 losses."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    if label_smoothing > 0.0:
        smooth = -torch.mean(logp, dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def weight_norm(kernel, g, axis: int = -1, eps: float = 1e-12):
    """w = g * v / ||v||, the norm over every axis except `axis`, which
    carries one gain per output feature (torch weight_norm parity)."""
    axis = axis % kernel.ndim
    reduce_dims = tuple(i for i in range(kernel.ndim) if i != axis)
    norm = torch.sqrt(torch.sum(torch.square(kernel.float()), dim=reduce_dims,
                                keepdim=True) + eps)
    shape = [1] * kernel.ndim
    shape[axis] = -1
    return (kernel / norm.to(kernel.dtype)) * g.reshape(shape).to(kernel.dtype)


class WeightNormDense(nn.Module):
    """Dense layer with weight normalization; v is (in, out) as in flax."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.v = nn.Parameter(torch.empty(in_features, features,
                                          dtype=param_dtype, device=device))
        self.g = nn.Parameter(torch.ones(features, dtype=param_dtype,
                                         device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                              device=device))
                     if use_bias else None)

    def reset_parameters(self, generator):
        """lecun_normal v (std 1/sqrt(in)), unit gains, zero bias."""
        with torch.no_grad():
            self.v.normal_(0.0, 1.0 / math.sqrt(self.v.shape[0]),
                           generator=generator)
            self.g.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        w = weight_norm(self.v, self.g, axis=-1).to(self.dtype)
        y = x.to(self.dtype) @ w
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y
