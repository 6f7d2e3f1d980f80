"""Flash attention: the port's plain versions and autograd Function
against ghost_tpu's, and (on a card) the three CUDA kernels against the
plain versions.

The JAX kernel runs as its own tests run it on the CPU: Pallas interpret
mode with 128/128 blocks (tests/test_pallas_kernels.py:89-118). Bounds:
f32 1e-4 absolute and relative: both sides compute in f32 from the same
inputs and differ only in the order of the sums (O(1) values, S <= 640
terms). In the 16-bit types the forward rounds p to the inputs' type
before p v, and (D <= 128) the backward rounds p and ds where they
enter a product (the tensor-core kernels and their plain versions
alike): bf16 outputs are within one bf16 ulp of JAX's forward with p
rounded at the same place (both round an f32 result once), and the
bounds against JAX's f32-p forward and gradients are derived term by
term in `test_16bit_forward_rounding_bound` and `_plain_grads_vs_jax`.
On the card the kernels sum in yet another order (tiles of 64 or 32):
f32 2e-4, 16-bit outputs two ulps plus 2e-3, against the plain versions
that round where the kernels round (p before p v in the forward, p and
ds in the backward).

The JAX twins are imported inside the tests that use them, so the card
tests run where jax is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_attention.py
"""

import numpy as np
import pytest
import torch

from ghost_tpu_torch.ops.cuda.attention import (
    _check, _flash_attention_tiles, _probs_and_ds, flash_attention,
    flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_bwd_dkv_plain, flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_fwd_plain,
    flash_attention_plain, attention_delta, on_tensor_cores)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(3)]


def _bf16_ulp(x, bits=8):
    """One bf16 ulp at each value's magnitude (8 significant bits; 11
    for float16)."""
    mag = np.maximum(np.abs(x), 1e-30)
    return 2.0 ** (np.floor(np.log2(mag)) - (bits - 1))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq,heads,dim", [(256, 2, 64), (128, 1, 128)])
def test_forward_matches_jax(causal, seq, heads, dim):
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.attention import flash_attention as j_flash
    from ghost_tpu.ops.pallas.attention import flash_attention_reference

    q, k, v = _qkv(seq + dim, (1, heads, seq, dim))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_kernel = np.asarray(j_flash(jq, jk, jv, causal, None, 128, 128, True))
    ref = np.asarray(flash_attention_reference(jq, jk, jv, causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = flash_attention_fwd.launches
    out = flash_attention(tq, tk, tv, causal).numpy()
    for got in (out, flash_attention_plain(tq, tk, tv, causal).numpy()):
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, ref_kernel, **TOL)
    assert flash_attention_fwd.launches == before  # CPU tensors never launch


def test_odd_seq_640_matches_jax_reference():
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.attention import flash_attention_reference

    q, k, v = _qkv(640, (1, 1, 640, 64))
    ref = flash_attention_reference(*(jnp.asarray(a) for a in (q, k, v)))
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _jax_fwd_p_rounded(q, k, v, causal):
    """JAX's forward with p rounded to the inputs' 16-bit type before
    p v, where FlashAttention-2, the tensor-core kernel and the port's
    plain forward round it: p = exp(s - rowmax) rounded, then
    o = (p v) / rowsum(p) in f32, cast once."""
    import jax.numpy as jnp

    f32 = jnp.float32
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(f32) * q.shape[-1] ** -0.5,
                   k.astype(f32))
    if causal:
        n = q.shape[2]
        s = jnp.where(jnp.tril(jnp.ones((n, n), bool)), s, -1e30)
    p = jnp.exp(s - s.max(-1, keepdims=True))
    o = jnp.einsum("bhqk,bhkd->bhqd", p.astype(q.dtype).astype(f32),
                   v.astype(f32)) / p.sum(-1, keepdims=True)
    return o.astype(q.dtype)


def test_bf16_within_one_ulp_of_jax():
    """The port's bf16 forward within one bf16 ulp of JAX's forward with
    p rounded where the port rounds it (both round an f32 result once);
    `test_16bit_forward_rounding_bound` bounds it against JAX's f32-p
    reference."""
    import jax.numpy as jnp

    q, k, v = _qkv(16, (1, 2, 256, 64))
    ref = _jax_fwd_p_rounded(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                            for a in (q, k, v)), True)
    assert out.dtype == torch.bfloat16
    diff = np.abs(out.float().numpy() - ref)
    assert (diff <= _bf16_ulp(ref)).all(), float(diff.max())


# twice the unit roundoff of each 16-bit type: a value rounded to it moves
# by at most half of this, relative
_ROUND = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -10}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_forward_rounding_bound(dtype):
    """The port's 16-bit forward (p rounded before p v) against the JAX
    reference, which keeps p in f32, on the same 16-bit values, causal.
    Bound per output element, from the f64 softmax: rounding each p term
    moves the sum by at most u sum_j p_j |v_j| (u = twice the type's unit
    roundoff), and each side rounds its f32 result once (u |ref|); 1e-5
    covers the f32 sums."""
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.attention import flash_attention_reference

    td, u = getattr(torch, dtype), _ROUND[dtype]
    q, k, v = (torch.from_numpy(a).to(td) for a in _qkv(31, (1, 2, 256, 64)))
    ref = flash_attention_reference(
        *(jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
          for t in (q, k, v)), True)
    ref = np.asarray(ref.astype(jnp.float32))
    assert on_tensor_cores(q, forward=True)
    out = flash_attention(q, k, v, True)
    assert out.dtype == td
    qd, kd, vd = (t.double().numpy()[0] for t in (q, k, v))
    s = np.where(np.tril(np.ones((256, 256), bool)),
                 qd @ kd.transpose(0, 2, 1) / 8.0, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    bound = u * p @ np.abs(vd) + u * np.abs(ref[0]) + 1e-5
    err = np.abs(out.float().numpy()[0] - ref[0])
    assert (err <= bound).all(), (float(err.max()), float((err / bound).max()))


@pytest.mark.parametrize("causal,shape", [(False, (1, 1, 128, 64)),
                                          (True, (1, 2, 256, 64))])
def test_grads_match_jax_kernel(causal, shape):
    import jax
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.attention import flash_attention as j_flash

    q, k, v = _qkv(sum(shape), shape)

    def loss(q, k, v):
        return jnp.sum(j_flash(q, k, v, causal, None, 128, 128, True) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    torch.sum(flash_attention(tq, tk, tv, causal) ** 2).backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == before


def _as_values(a, dtype):
    """a rounded to `dtype` values, kept in f32 (so JAX runs f32 on them)."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def _plain_grads_vs_jax(dtype, u):
    """The port's 16-bit backward on the CPU (the plain versions, which
    round p and ds to `dtype` as the tensor-core kernels do) against the
    JAX kernel's f32 gradients of the same values, causal. Bound per
    output element, from the f64 softmax terms: each p or ds term is
    rounded to `dtype` (relative error u / 2, taken as u: 2^-8 for bf16's
    8 significant bits, 2^-10 for float16's 11) before a sum of S terms,
    so the sum moves by at most u times the sum of the terms'
    magnitudes; delta = rowsum(dO O) comes from the rounded O, which
    moves each ds by p |delta error|; and the output is rounded once
    more (u |ref|). 1e-5 covers the f32 sums."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.attention import flash_attention as j_flash

    shape, causal = (1, 2, 256, 64), True
    q, k, v = (_as_values(a, dtype) for a in _qkv(21, shape))
    do = _as_values(_qkv(22, shape)[0], dtype)

    def fwd(q, k, v):
        return j_flash(q, k, v, causal, None, 128, 128, True)

    _, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    assert on_tensor_cores(tq)
    flash_attention(tq, tk, tv, causal).backward(
        torch.from_numpy(do).to(dtype))

    qd, kd, vd, dod = (a.astype(np.float64)[0] for a in (q, k, v, do))
    scale = shape[-1] ** -0.5
    s = np.where(np.tril(np.ones(shape[2:3] * 2, bool)),
                 qd @ kd.transpose(0, 2, 1) * scale, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = p @ vd
    ds = p * (dod @ vd.transpose(0, 2, 1)
              - (dod * o).sum(-1, keepdims=True))
    e_delta = u * (np.abs(dod) * np.abs(o)).sum(-1, keepdims=True)
    e_ds = u * np.abs(ds) + p * e_delta
    bounds = (scale * e_ds @ np.abs(kd),
              scale * e_ds.transpose(0, 2, 1) @ np.abs(qd),
              u * p.transpose(0, 2, 1) @ np.abs(dod))
    for name, got, want, bound in zip(("dq", "dk", "dv"),
                                      (tq.grad, tk.grad, tv.grad), ref,
                                      bounds):
        assert got.dtype == dtype
        err = np.abs(got.float().numpy()[0] - want[0])
        lim = bound + u * np.abs(want[0]) + 1e-5
        assert (err <= lim).all(), (name, float(err.max()),
                                    float((err / lim).max()))


def test_bf16_plain_grads_match_jax():
    """`_plain_grads_vs_jax` in bf16."""
    _plain_grads_vs_jax(torch.bfloat16, 2.0 ** -8)


def test_f16_plain_grads_match_jax():
    """`_plain_grads_vs_jax` in float16."""
    _plain_grads_vs_jax(torch.float16, 2.0 ** -10)


@pytest.mark.parametrize("dtype,dim,rounded", [
    ("float32", 32, False), ("bfloat16", 32, True), ("bfloat16", 160, False)])
def test_plain_backward_rounds_only_for_tensor_cores(dtype, dim, rounded):
    """The plain dq and dk/dv are the products of `_probs_and_ds`'s f32 p
    and ds, bit for bit: as they are in float32 and for D > 128 (the FMA
    kernels), rounded to bf16 first in bf16 with D <= 128 (the
    tensor-core kernels)."""
    td = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(td)
                   for a in _qkv(5, (1, 2, 96, dim)) + _qkv(6, (1, 2, 96, dim))[:1])
    out, lse = flash_attention_fwd_plain(q, k, v, True)
    args = (q, k, v, do, lse, attention_delta(out, do), True, dim ** -0.5)
    p, ds = _probs_and_ds(*args)
    assert on_tensor_cores(q) == rounded
    if rounded:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * args[-1]).to(td)
    dk = (torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * args[-1]).to(td)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float()).to(td)
    assert torch.equal(flash_attention_bwd_dq_plain(*args), dq)
    got_dk, got_dv = flash_attention_bwd_dkv_plain(*args)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_autograd_of_plain(causal):
    q, k, v = _qkv(3, (2, 2, 96, 16))
    do = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_plain(tq, tk, tv, causal)
    out.backward(torch.from_numpy(do))
    with torch.no_grad():
        o, lse = flash_attention_fwd_plain(tq, tk, tv, causal)
        got = flash_attention_bwd_plain(tq, tk, tv, o, lse,
                                        torch.from_numpy(do), causal)
    np.testing.assert_allclose(o.numpy(), out.detach().numpy(), **TOL)
    for g, want in zip(got, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(g.numpy(), want.numpy(), **TOL)


def test_kernels_check_what_they_take():
    """Shape, dtype and stride checks run before any launch (meta tensors
    reach them without a card); split heads pass with their strides."""
    b, s, h, d = 2, 128, 4, 16
    proj = torch.empty((b, s, h * d), device="meta")
    qh = proj.reshape(b, s, h, d).transpose(1, 2)
    strides = list(_check(qh, qh, qh))
    assert strides == [s * h * d, d, h * d] * 3
    lse = torch.empty((b, h, s, 1), device="meta")
    with pytest.raises(ValueError, match="unit stride"):
        _check(qh.transpose(2, 3), qh.transpose(2, 3), qh.transpose(2, 3))
    with pytest.raises(TypeError):
        _check(qh, qh.to(torch.bfloat16), qh)
    with pytest.raises(ValueError, match="shape"):
        _check(qh, qh[:, :, :64], qh[:, :, :64])
    with pytest.raises(ValueError, match="lse"):
        _check(qh, qh, qh, qh, lse.to(torch.bfloat16), lse)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.empty((1, 1, 128, 320), device="meta")
        _check(big, big, big)
    with pytest.raises(ValueError, match="block_q"):
        _check(qh.to(torch.bfloat16), qh.to(torch.bfloat16),
               qh.to(torch.bfloat16), block_q=48)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

# (shape, causal, dtype, block_q): the JAX tests' shapes, a ragged S
# (200), head dims 16 and 256 (padded tiles, split dk/dv) and S=2560
# causal with q tiles of 48 against k tiles of 64 (neither divides the
# other: the causal-bound bug of tests/test_pallas_kernels.py:57-86);
# in bf16 and float16 the tensor-core kernels at S=1000 (no multiple of
# any tile), D=128, D=36 (element copies: D % 8 != 0) and D=256 (the
# tensor-core forward, the FMA dq and dk/dv)
CARD_CASES = [
    ((1, 2, 256, 64), False, "float32", 64),
    ((1, 2, 256, 64), True, "float32", 64),
    ((1, 1, 128, 128), True, "float32", 64),
    ((2, 3, 200, 16), True, "float32", 64),
    ((1, 2, 192, 256), False, "float32", 64),
    ((1, 1, 2560, 64), True, "float32", 48),
    ((2, 2, 640, 64), True, "bfloat16", 64),
    ((2, 3, 1000, 64), False, "bfloat16", 64),
    ((2, 3, 1000, 64), True, "bfloat16", 64),
    ((1, 2, 384, 128), False, "bfloat16", 64),
    ((1, 2, 384, 128), True, "bfloat16", 64),
    ((1, 2, 136, 36), True, "bfloat16", 64),
    ((1, 2, 192, 256), True, "bfloat16", 64),
    ((2, 3, 1000, 64), True, "float16", 64),
    ((1, 2, 384, 128), False, "float16", 64),
    ((2, 3, 200, 16), True, "float16", 64),
    ((1, 2, 192, 256), True, "float16", 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,dtype,block_q", CARD_CASES)
def test_kernels_match_plain_on_card(shape, causal, dtype, block_q):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from ghost_tpu_torch.core.precision import disable_tf32

    disable_tf32()
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).cuda().to(td)
               for a in _qkv(1, shape, 0.5))
    do = torch.from_numpy(_qkv(2, shape)[0]).cuda().to(td)
    before = (flash_attention_fwd.tensor_core_launches,
              flash_attention_bwd_dq.tensor_core_launches)
    if block_q == 64:  # the wrappers' own tiles
        out, lse = flash_attention_fwd(q, k, v, causal)
        delta = attention_delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    else:
        out, lse, delta, dq, dk, dv = _flash_attention_tiles(q, k, v, do,
                                                             causal, block_q)
    # 16-bit types on the tensor cores (the forward up to D=256, dq and
    # dk/dv up to 128), all else on the FMA kernels
    assert (flash_attention_fwd.tensor_core_launches - before[0]
            == int(on_tensor_cores(q, forward=True)))
    assert (flash_attention_bwd_dq.tensor_core_launches - before[1]
            == int(on_tensor_cores(q)))
    _hold_to_plain(q, k, v, do, causal, (out, lse, delta, dq, dk, dv))


def _hold_to_plain(q, k, v, do, causal, results):
    """The kernels' (out, lse, delta, dq, dk, dv) against the plain
    versions on the same inputs (the backward from the kernels' lse and
    delta): f32 2e-4 absolute and relative, 16-bit types two ulps plus
    2e-3."""
    out, lse, delta, dq, dk, dv = results
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    # each backward kernel against its plain version on the same inputs
    args = (q, k, v, do, lse, delta, causal, 1 / q.shape[-1] ** 0.5)
    want = (flash_attention_bwd_dq_plain(*args),
            *flash_attention_bwd_dkv_plain(*args))
    for name, got, exp in (("out", out, ref), ("lse", lse, ref_lse),
                           ("dq", dq, want[0]), ("dk", dk, want[1]),
                           ("dv", dv, want[2])):
        got, exp = got.float().cpu().numpy(), exp.float().cpu().numpy()
        if q.dtype != torch.float32 and name != "lse":
            bits = 8 if q.dtype == torch.bfloat16 else 11
            bound = _bf16_ulp(exp, bits) * 2 + 2e-3
        else:
            bound = 2e-4 + 2e-4 * np.abs(exp)
        assert (np.abs(got - exp) <= bound).all(), \
            (name, float(np.abs(got - exp).max()))


def _card_bf16(seed, shape):
    return torch.from_numpy(_qkv(seed, shape, 0.5)[0]).cuda().to(
        torch.bfloat16)


def _run_kernels(q, k, v, do, causal):
    out, lse = flash_attention_fwd(q, k, v, causal)
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    return (out, lse, delta, dq,
            *flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_split_heads_on_card(causal):
    """q, k, v and dO as the split heads of (B, S, H*D) projections (no
    copy: strides (S*H*D, D, H*D, 1)) on the tensor-core kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    b, s, h, d = 2, 320, 4, 64
    q, k, v, do = (_card_bf16(i, (b, s, h * d)).view(b, s, h, d)
                   .transpose(1, 2) for i in range(4))
    assert q.stride() == (s * h * d, d, h * d, 1)
    before = flash_attention_bwd_dkv.tensor_core_launches
    results = _run_kernels(q, k, v, do, causal)
    assert flash_attention_bwd_dkv.tensor_core_launches == before + 1
    _hold_to_plain(q, k, v, do, causal, results)


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [64, 128])
def test_bf16_backward_is_deterministic_on_card(dim):
    """No atomics: two backward calls on the same inputs give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, do = (_card_bf16(i, (2, 3, 1000, dim)) for i in range(4))
    first = _run_kernels(q, k, v, do, True)
    second = _run_kernels(q, k, v, do, True)
    for a, b in zip(first[3:], second[3:]):
        assert torch.equal(a, b)
