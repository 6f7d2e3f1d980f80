"""Fused LayerNorm: the port's plain versions and autograd Function
against ghost_tpu's, and (on a card) the CUDA kernels against the plain
versions.

The JAX kernel runs in Pallas interpret mode, as its own tests run it
(tests/test_pallas_kernels.py:121-160). Bound f32 1e-5 absolute and
relative: the same f32 two-pass statistics, sums in another order, O(1)
values over rows of <= 256. The gradients of the `sin` loss sum 32 rows
into dgamma/dbeta: 1e-5 there too. On the card: f32 1e-5 (outputs) and
1e-4 (dgamma/dbeta, 8192-row sums); bf16 one ulp plus 1e-3.

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

    assert _check(x, g, g) == (32, 32)
    with pytest.raises(ValueError, match="contiguous"):
        _check(x.transpose(0, 1), g, g)
    with pytest.raises(ValueError, match="gamma/beta"):
        _check(x, g[:16], g)
    with pytest.raises(TypeError):
        _check(x.to(torch.float16), g, g)


# (rows, h) on the card: the JAX shapes, ragged rows, a wide row (h=8192)
CARD_SHAPES = [(64, 256), (1000, 768), (37, 8192), (8192, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    td = getattr(torch, dtype)
    for shape in CARD_SHAPES:
        x, g, b = (torch.from_numpy(a).cuda() for a in _inputs(5, shape))
        x = x.to(td)
        dy = torch.randn(shape, device="cuda").to(td)
        y, mean, rstd = fused_layer_norm_fwd(x, g, b)
        dx, dg, db = fused_layer_norm_bwd(x, g, mean, rstd, dy)
        torch.cuda.synchronize()
        ref = layer_norm_fwd_plain(x, g, b)
        want = layer_norm_bwd_plain(x, g, ref[1], ref[2], dy)
        for name, got, exp in (("y", y, ref[0]), ("mean", mean, ref[1]),
                               ("rstd", rstd, ref[2]), ("dx", dx, want[0]),
                               ("dgamma", dg, want[1]), ("dbeta", db, want[2])):
            got, exp = got.float().cpu().numpy(), exp.float().cpu().numpy()
            if dtype == "bfloat16" and name in ("y", "dx"):
                bound = np.abs(exp) * 2 ** -7 + 1e-3
            elif name in ("dgamma", "dbeta"):
                bound = 1e-4 * (1 + np.abs(exp))
            else:
                bound = 1e-5 * (1 + np.abs(exp))
            assert (np.abs(got - exp) <= bound).all(), \
                (shape, name, float(np.abs(got - exp).max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncontiguous_input_on_card(dtype):
    """A transposed x on the card: the wrappers copy it into rows, the
    kernels run (one forward and one backward launch) and match the plain
    versions on the same values; dx comes back in x's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
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
    for got, exp in ((y.detach(), ref), (xt.grad, dx)):
        got, exp = got.float().cpu().numpy(), exp.float().cpu().numpy()
        bound = (np.abs(exp) * 2 ** -7 + 1e-3 if dtype == "bfloat16"
                 else 1e-5 * (1 + np.abs(exp)))
        assert (np.abs(got - exp) <= bound).all()
