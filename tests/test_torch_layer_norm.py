"""Fused LayerNorm: the port's plain versions and autograd Function
against ghost_tpu's, and (on a card) the CUDA kernels against the plain
versions.

The JAX kernel runs in Pallas interpret mode, as its own tests run it
(tests/test_pallas_kernels.py:121-160). Bound f32 1e-5 absolute and
relative: the same f32 two-pass statistics, sums in another order, O(1)
values over rows of <= 256. The gradients of the `sin` loss sum 32 rows
into dgamma/dbeta: 1e-5 there too. float16 against JAX: one f16 ulp
of |ref| plus 1e-3 (both round one f32 result to f16). On the card: f32
1e-5 (outputs) and 1e-4 (1 + |ref|) (dgamma/dbeta, up to 32768-row sums);
bf16 and float16 one ulp plus 1e-3; dgamma/dbeta in a 16-bit gamma dtype
one ulp of that type more.

Card tests, where jax is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_layer_norm.py
"""

import numpy as np
import pytest
import torch

from ghost_tpu_torch.ops.cuda.layer_norm import (
    fused_layer_norm, fused_layer_norm_bwd, fused_layer_norm_fwd,
    layer_norm_bwd_plain, layer_norm_fwd_plain, layer_norm_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    h = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(h).astype(np.float32),
            rng.standard_normal(h).astype(np.float32))


def test_forward_matches_jax_kernel():
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.layer_norm import fused_layer_norm as j_fused
    from ghost_tpu.ops.pallas.layer_norm import layer_norm_reference

    x, g, b = _inputs(0, (64, 256))
    ref = np.asarray(j_fused(*(jnp.asarray(a) for a in (x, g, b)), 1e-5, 32,
                             True))
    ref_plain = np.asarray(layer_norm_reference(*(jnp.asarray(a)
                                                  for a in (x, g, b))))
    t = [torch.from_numpy(a) for a in (x, g, b)]
    before = fused_layer_norm_fwd.launches
    for got in (fused_layer_norm(*t), layer_norm_plain(*t)):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
        np.testing.assert_allclose(got.numpy(), ref_plain, **TOL)
    assert fused_layer_norm_fwd.launches == before  # CPU never launches


def test_grads_match_jax_kernel():
    import jax
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.layer_norm import fused_layer_norm as j_fused

    x, g, b = _inputs(1, (32, 128))

    def loss(x, g, b):
        return jnp.sum(jnp.sin(j_fused(x, g, b, 1e-5, 16, True)))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, g, b)))
    t = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    torch.sum(torch.sin(fused_layer_norm(*t))).backward()
    for got, want in zip(t, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **TOL)


def test_float16_matches_jax_kernel():
    """float16 x, gamma and beta: the port's forward and its gradients
    against JAX's kernel (interpret mode) on the same f16 values."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.layer_norm import fused_layer_norm as j_fused

    x, g, b = (a.astype(np.float16) for a in _inputs(10, (64, 256)))

    def loss(x, g, b):
        return jnp.sum(jnp.sin(j_fused(x, g, b, 1e-5, 32, True)))

    j_in = [jnp.asarray(a) for a in (x, g, b)]
    ref_y = np.asarray(j_fused(*j_in, 1e-5, 32, True))
    ref = jax.grad(loss, argnums=(0, 1, 2))(*j_in)
    t = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    y = fused_layer_norm(*t)
    torch.sum(torch.sin(y)).backward()
    for got, want in zip((y, *(a.grad for a in t)),
                         (ref_y, *(np.asarray(r) for r in ref))):
        assert got.dtype == torch.float16 and want.dtype == np.float16
        got, want = got.detach().float().numpy(), want.astype(np.float32)
        bound = np.abs(want) * 2 ** -10 + 1e-3
        assert (np.abs(got - want) <= bound).all(), \
            float(np.abs(got - want).max())


def test_nd_input_matches_jax():
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.layer_norm import fused_layer_norm as j_fused

    x = np.random.default_rng(2).standard_normal((2, 8, 8, 64)).astype(
        np.float32)
    g, b = np.ones(64, np.float32), np.zeros(64, np.float32)
    ref = j_fused(*(jnp.asarray(a) for a in (x, g, b)), 1e-5, 128, True)
    got = fused_layer_norm(*(torch.from_numpy(a) for a in (x, g, b)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_noncontiguous_input_matches_jax():
    """x as a transposed view (no unit row stride): the output equals
    JAX's on the same values and the gradient comes back in x's shape."""
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.layer_norm import fused_layer_norm as j_fused

    x, g, b = _inputs(6, (96, 40))
    xt = torch.from_numpy(x).t()  # (40, 96) with strides (1, 40)
    g, b = _inputs(7, (96,))[1:]
    ref = j_fused(*(jnp.asarray(a) for a in (xt.numpy(), g, b)), 1e-5, 8,
                  True)
    xt.requires_grad_()
    y = fused_layer_norm(xt, torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **TOL)
    y.sum().backward()
    assert xt.grad.shape == xt.shape


def test_bwd_plain_matches_autograd_of_plain():
    x, g, b = _inputs(3, (3, 5, 48))
    dy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    t = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    layer_norm_plain(*t).backward(torch.from_numpy(dy))
    with torch.no_grad():
        _, mean, rstd = layer_norm_fwd_plain(*t)
        got = layer_norm_bwd_plain(t[0], t[1], mean, rstd,
                                   torch.from_numpy(dy))
    for g_, want in zip(got, t):
        np.testing.assert_allclose(g_.numpy(), want.grad.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_kernel_checks_what_it_takes():
    x = torch.empty((4, 8, 32), device="meta")
    g = torch.empty(32, device="meta")
    from ghost_tpu_torch.ops.cuda.layer_norm import _check

    assert _check(x, g, g) == (32, 32, 0, 0)
    h16 = torch.float16
    assert _check(x.to(h16), g.to(torch.bfloat16), g.to(torch.bfloat16)) \
        == (32, 32, 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        _check(x.transpose(0, 1), g, g)
    with pytest.raises(ValueError, match="gamma/beta"):
        _check(x, g[:16], g)
    with pytest.raises(TypeError):
        _check(x.to(torch.int32), g, g)


# (rows, h) on the card: the JAX shapes, ragged rows, a wide row (h=8192)
CARD_SHAPES = [(64, 256), (1000, 768), (37, 8192), (8192, 1024)]
# the kernels' other routes: h no multiple of the 16-byte vector (element
# accesses), the widest row (h=16384) and a wide one (h=4096, a block per
# row), one row, and rows no multiple of the 4 rows of a forward block
ROUTE_SHAPES = [(64, 1000), (33, 1023), (5, 16384), (9, 4096), (1, 1024),
                (1, 7), (7, 1024), (4099, 512)]
CARD_DTYPES = ["float32", "bfloat16", "float16"]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _bound(name, exp, dtype, gdtype):
    """One ulp of a 16-bit y/dx plus 1e-3; f32 1e-5 (1 + |ref|);
    dgamma/dbeta 1e-4 (1 + |ref|), plus one ulp of a 16-bit gamma dtype."""
    ulp = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}
    if name in ("dgamma", "dbeta"):
        return 1e-4 * (1 + np.abs(exp)) + ulp.get(gdtype, 0) * np.abs(exp)
    if name in ("y", "dx") and dtype in ulp:
        return np.abs(exp) * ulp[dtype] + 1e-3
    return 1e-5 * (1 + np.abs(exp))


def _hold_to_plain(x, g, b, dy):
    """Both kernels on (x, g, b, dy), each launching once, against the
    plain versions on the same values; returns the kernels' outputs."""
    before = (fused_layer_norm_fwd.launches, fused_layer_norm_bwd.launches)
    y, mean, rstd = fused_layer_norm_fwd(x, g, b)
    dx, dg, db = fused_layer_norm_bwd(x, g, mean, rstd, dy)
    torch.cuda.synchronize()
    assert (fused_layer_norm_fwd.launches, fused_layer_norm_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    ref = layer_norm_fwd_plain(x, g, b)
    want = layer_norm_bwd_plain(x, g, ref[1], ref[2], dy)
    outs = (("y", y, ref[0]), ("mean", mean, ref[1]), ("rstd", rstd, ref[2]),
            ("dx", dx, want[0]), ("dgamma", dg, want[1]),
            ("dbeta", db, want[2]))
    for name, got, exp in outs:
        assert got.dtype == exp.dtype and got.shape == exp.shape, name
        bound = _bound(name, exp.float().cpu().numpy(), x.dtype, g.dtype)
        got, exp = got.float().cpu().numpy(), exp.float().cpu().numpy()
        assert (np.abs(got - exp) <= bound).all(), \
            (tuple(x.shape), name, float(np.abs(got - exp).max()))
    return y, mean, rstd, dx, dg, db


def _card_inputs(seed, shape, dtype, gdtype=torch.float32):
    x, g, b = (torch.from_numpy(a).cuda() for a in _inputs(seed, shape))
    dy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        shape).astype(np.float32)).cuda()
    return x.to(dtype), g.to(gdtype), b.to(gdtype), dy.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_kernels_match_plain_on_card(dtype):
    _needs_card()
    for shape in CARD_SHAPES:
        _hold_to_plain(*_card_inputs(5, shape, getattr(torch, dtype)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_kernel_routes_match_plain_on_card(dtype):
    """Ragged h (element accesses), the wide route up to h = 16384, one
    row and rows no multiple of a block's: the kernels launch and match."""
    _needs_card()
    for shape in ROUTE_SHAPES:
        _hold_to_plain(*_card_inputs(11, shape, getattr(torch, dtype)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_unaligned_pointers_on_card(dtype):
    """x, dy, gamma and beta as views one element into their storage (not
    16-byte aligned): the kernels still launch (element accesses) and
    match the plain versions."""
    _needs_card()
    td = getattr(torch, dtype)
    for rows, h in ((96, 1024), (3, 4096)):
        x, g, b, dy = _card_inputs(12, (rows * h + 1,), td)
        x, dy = x[1:].view(rows, h), dy[1:].view(rows, h)
        g, b = g[1:h + 1], b[1:h + 1]
        assert all(t.data_ptr() % 16 for t in (x, dy, g, b))
        _hold_to_plain(x, g, b, dy)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gdtype", ["bfloat16", "float16"])
def test_16bit_gamma_needs_no_cast_on_card(dtype, gdtype):
    """gamma and beta in a 16-bit dtype are read as they are: the wrappers
    run no torch op but allocations (no cast kernel), the kernels match the
    plain versions and dgamma/dbeta come back in gamma's dtype."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _needs_card()

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    x, g, b, dy = _card_inputs(13, (1000, 768), getattr(torch, dtype),
                               getattr(torch, gdtype))
    with Ops() as ops:
        _, mean, rstd = fused_layer_norm_fwd(x, g, b)
        fused_layer_norm_bwd(x, g, mean, rstd, dy)
    assert set(ops.seen) <= {"empty", "empty_like", "new_empty",
                             "empty_strided"}, ops.seen
    _hold_to_plain(x, g, b, dy)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_backward_is_deterministic_on_card(dtype):
    """No atomics: dx, dgamma and dbeta come out bit for bit the same on
    two backward calls over the same inputs, at every route."""
    _needs_card()
    for shape in ((8192, 1024), (64, 1000), (5, 16384)):
        x, g, b, dy = _card_inputs(14, shape, getattr(torch, dtype))
        _, mean, rstd = fused_layer_norm_fwd(x, g, b)
        first = fused_layer_norm_bwd(x, g, mean, rstd, dy)
        second = fused_layer_norm_bwd(x, g, mean, rstd, dy)
        for a, c in zip(first, second):
            assert torch.equal(a, c), shape


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_noncontiguous_input_on_card(dtype):
    """A transposed x on the card: the wrappers copy it into rows, the
    kernels run (one forward and one backward launch) and match the plain
    versions on the same values; dx comes back in x's shape."""
    _needs_card()
    td = getattr(torch, dtype)
    x = torch.from_numpy(_inputs(8, (768, 1000))[0]).cuda()
    g, b = (torch.from_numpy(a).cuda() for a in _inputs(9, (768,))[1:])
    xt = x.to(td).t()  # (1000, 768), strides (1, 1000)
    assert not xt.is_contiguous()
    xt.requires_grad_()
    dy = torch.randn(xt.shape, device="cuda").to(td)
    before = (fused_layer_norm_fwd.launches, fused_layer_norm_bwd.launches)
    y = fused_layer_norm(xt, g, b)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (fused_layer_norm_fwd.launches, fused_layer_norm_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    assert xt.grad.shape == xt.shape
    xc = xt.detach().contiguous()
    ref, mean, rstd = layer_norm_fwd_plain(xc, g, b)
    dx = layer_norm_bwd_plain(xc, g, mean, rstd, dy)[0]
    for name, got, exp in (("y", y.detach(), ref), ("dx", xt.grad, dx)):
        got, exp = got.float().cpu().numpy(), exp.float().cpu().numpy()
        assert (np.abs(got - exp) <= _bound(name, exp, td, g.dtype)).all()
