"""Sequence parallelism: ring attention over a "seq" mesh axis, mirroring
`ghost_tpu/parallel/sp.py`.

Q, K and V are split on the sequence dim over the axis. Each shard keeps
its Q chunk and an online-softmax state (o, m, l) in f32 while the K/V
chunks rotate one hop per tick: after t hops shard i holds the chunk
born on shard (i - t) % n, which gives the causal mask from global
positions. n - 1 update-and-rotate ticks, then the last chunk's update
without the rotation, whose result nobody reads.

Each tick's products are `torch.einsum` in f32, as JAX computes them
outside any Pallas kernel, so `MultiheadAttention(seq_mesh=...)` bypasses
the flash-attention kernel as the JAX module does. One change of
schedule: a causal block that masks every pair (its keys all after its
queries) is not computed. JAX computes it, and the next real block's
correction exp(_NEG - m) = 0 wipes it, so skipping it leaves the result
bit for bit as it was.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ghost_tpu_torch.core.mesh import Mesh, make_mesh_1d, to_device
from ghost_tpu_torch.parallel.collectives import ppermute

SEQ_AXIS = "seq"
_NEG = -1e30  # finite "-inf": masked-row algebra stays NaN-free


def make_seq_mesh(num_devices: int, devices: Sequence | None = None) -> Mesh:
    """A 1-D ("seq",) mesh over the first `num_devices` devices."""
    return make_mesh_1d(SEQ_AXIS, num_devices, devices)


def _block_update(carry, q, k, v, scale, mask):
    """One online-softmax accumulation step (f32 state).

    carry = (o, m, l): o (B,Lq,H,D) unnormalised output, m (B,H,Lq)
    running row max, l (B,H,Lq) running row sum; q f32. mask (Lq,Lk)
    True = attend, or None."""
    o, m, l = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.float()) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG))
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    # rows still all masked keep m_new == _NEG: exp(s - m_new) is then 1
    # on masked lanes, but the first real block drives corr =
    # exp(_NEG - m_real) = 0, wiping the bogus o and l. Every causal row
    # meets its own diagonal block, so the final state is exact.
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float())
    return o, m_new, l


def _ring(q, k, v, devices, causal, scale):
    """The ring over one row of devices; q, k, v global (B, S, H, D)."""
    n = len(devices)
    qs = [to_device(c, d).float() for c, d in zip(torch.chunk(q, n, 1),
                                                 devices)]
    kc = [to_device(c, d) for c, d in zip(torch.chunk(k, n, 1), devices)]
    vc = [to_device(c, d) for c, d in zip(torch.chunk(v, n, 1), devices)]
    b, lq, h, dh = qs[0].shape
    lk = kc[0].shape[1]
    state = [(torch.zeros((b, lq, h, dh), dtype=torch.float32, device=d),
              torch.full((b, h, lq), _NEG, dtype=torch.float32, device=d),
              torch.zeros((b, h, lq), dtype=torch.float32, device=d))
             for d in devices]
    perm = [(i, (i + 1) % n) for i in range(n)]
    for t in range(n):
        for i, d in enumerate(devices):
            src = (i - t) % n  # the chunk this shard holds after t hops
            mask = None
            if causal:
                if src * lk > i * lq + lq - 1:
                    continue  # every key after every query: all masked
                q_pos = i * lq + torch.arange(lq, device=d)
                k_pos = src * lk + torch.arange(lk, device=d)
                mask = k_pos[None, :] <= q_pos[:, None]
            state[i] = _block_update(state[i], qs[i], kc[i], vc[i], scale,
                                     mask)
        if t < n - 1:  # the n-th hop's result is never read
            kc, vc = ppermute(kc, devices, perm), ppermute(vc, devices, perm)
    return torch.cat([to_device((o / l.transpose(1, 2)[..., None]).to(
        q.dtype), q.device) for o, _, l in state], dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Mesh, axis: str = SEQ_AXIS, causal: bool = False,
                   scale: float | None = None,
                   batch_axis: str | None = None) -> torch.Tensor:
    """Exact attention with Q/K/V sequence-sharded over `axis`.

    q, k, v: (B, S, H, D), S divisible by the axis size; the result
    (B, S, H, D) in q's dtype on q's device. Matches softmax(QK^T * scale
    [+ causal mask]) V to f32 accuracy. batch_axis splits the batch over
    a second mesh axis (data x seq); the ring stays on `axis`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    rows = mesh.axis_devices(axis, batch_axis)
    n = len(rows[0])
    if q.shape[1] % n:
        raise ValueError(f"seq {q.shape[1]} not divisible by {n} devices")
    if k.shape[1] % n:
        # cross-attention shards K/V the same way
        raise ValueError(f"kv seq {k.shape[1]} not divisible by {n} devices")
    if q.shape[0] % len(rows):
        raise ValueError(f"batch {q.shape[0]} not divisible by mesh "
                         f"'{batch_axis}' size {len(rows)}")
    parts = zip(rows, *(torch.chunk(t, len(rows), 0) for t in (q, k, v)))
    return torch.cat([_ring(qb, kb, vb, devices, causal, scale)
                      for devices, qb, kb, vb in parts], dim=0)


def attention_reference(q, k, v, *, causal: bool = False,
                        scale: float | None = None):
    """Materialising single-device attention (the tests' golden)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
