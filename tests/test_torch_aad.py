"""AAD modulate: the port's plain version and AADLayer (fused and
unfused) against ghost_tpu, and (on a card) the CUDA kernel against the
plain version, the unfused AEI-Net's gradients against the CPU's and the
fused one's raising backward.

The JAX kernel runs as its own tests run it on the CPU: Pallas interpret
mode (`ghost_tpu/ops/pallas/aad.py:88-89`). Bounds: f32 1e-5 (the same
math, sums in another order); bf16 0.1 absolute, the JAX kernel test's
bound (tests/test_pallas_kernels.py:200-210): outputs are O(1-10), so
one bf16 ulp after a different rounding of the stats is up to ~0.06.

The JAX twins are imported inside the tests that use them, so the card
test runs where jax is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_aad.py
"""

import numpy as np
import pytest
import torch

from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import FULL_PRECISION
from ghost_tpu_torch.models.aei import AADLayer
from ghost_tpu_torch.nn.layers import to_nchw, to_nhwc
from ghost_tpu_torch.ops.cuda.aad import aad_modulate, aad_modulate_plain


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(rng, b, h, w, c):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(b, h, w, c) * 2 + 1, f(b, h, w, c), f(b, h, w, c), f(b, 2 * c),
            f(1, 1, c, 1) * 0.3, f(1))


# (2,8,16,8): the JAX test's shape; (1,48,32,8): rows the block does not
# divide; (3,2,2,40): blk1-like 2x2 maps with C not a multiple of 32
@pytest.mark.parametrize("shape", [(2, 8, 16, 8), (1, 48, 32, 8),
                                   (3, 2, 2, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_plain_matches_jax(rng, shape, dtype):
    import jax.numpy as jnp

    from ghost_tpu.ops.pallas.aad import aad_modulate as j_aad_modulate
    from ghost_tpu.ops.pallas.aad import aad_modulate_reference

    h, ga, bb, idgb, mk, mb = _inputs(rng, *shape)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    j_in = [jnp.asarray(a).astype(jd) for a in (h, ga, bb, idgb)]
    ref_kernel = j_aad_modulate(*j_in, jnp.asarray(mk), jnp.asarray(mb),
                                block_rows=32)
    ref_plain = aad_modulate_reference(*j_in, jnp.asarray(mk), jnp.asarray(mb))
    t_in = [torch.from_numpy(a).to(td) for a in (h, ga, bb, idgb)]
    before = aad_modulate.launches
    out = aad_modulate(*t_in, torch.from_numpy(mk), torch.from_numpy(mb))
    assert out.dtype == td and tuple(out.shape) == shape
    tol = 1e-5 if dtype == "float32" else 0.1
    for ref in (ref_kernel, ref_plain):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)
    assert aad_modulate.launches == before  # CPU tensors never launch


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("attr_upsample", [1, 2])
def test_aad_layer_matches_jax(rng, fused, attr_upsample):
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.aei import AADLayer as JAADLayer

    b, hw, c, ca = 2, 8, 16, 12
    ha = hw // attr_upsample
    h = rng.standard_normal((b, hw, hw, c)).astype(np.float32)
    za = rng.standard_normal((b, ha, ha, ca)).astype(np.float32)
    zid = rng.standard_normal((b, 512)).astype(np.float32)
    jmod = JAADLayer(c, JFULL, attr_upsample, fused)
    variables = jmod.init(jax.random.key(0), jnp.asarray(h), jnp.asarray(za),
                          jnp.asarray(zid))
    variables = jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype),
        variables)
    ref = jmod.apply(variables, jnp.asarray(h), jnp.asarray(za),
                     jnp.asarray(zid))
    tmod = load_flax_variables(
        AADLayer(c, ca, 512, FULL_PRECISION, attr_upsample, fused_aad=fused),
        variables)
    with torch.no_grad():
        out = to_nhwc(tmod(to_nchw(torch.from_numpy(h)),
                           to_nchw(torch.from_numpy(za)),
                           torch.from_numpy(zid)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_kernel_rejects_what_it_does_not_take():
    """Layout and dtype checks run before any launch (meta tensors reach
    them without a card)."""
    from ghost_tpu_torch.ops.cuda.aad import _check

    h = torch.empty((2, 4, 4, 8), device="meta")
    packed = torch.empty((2, 4, 4, 16), device="meta")
    ga, bb = packed[..., :8], packed[..., 8:]
    idgb = torch.empty((2, 16), device="meta")
    mk = torch.empty((1, 8, 1, 1), device="meta")
    mb = torch.empty((1,), device="meta")
    assert _check(h, ga, bb, idgb, mk, mb) == (0, 16, 16)
    # float16 is taken; a set of mixed 16-bit dtypes is refused
    f16 = [t.to(torch.float16) for t in (h, packed, idgb)]
    assert _check(f16[0], f16[1][..., :8], f16[1][..., 8:], f16[2], mk,
                  mb) == (2, 16, 16)
    with pytest.raises(TypeError, match="must be h's"):
        _check(f16[0], f16[1][..., :8], f16[1][..., 8:],
               idgb.to(torch.bfloat16), mk, mb)
    with pytest.raises(TypeError, match="float16"):
        _check(h.to(torch.float64), ga, bb, idgb, mk, mb)
    with pytest.raises(ValueError, match="contiguous"):
        _check(h.permute(0, 2, 1, 3), ga, bb, idgb, mk, mb)
    with pytest.raises(ValueError, match="unit channel stride"):
        _check(h, ga.permute(0, 2, 1, 3), bb, idgb, mk, mb)
    with pytest.raises(TypeError):
        _check(h, ga.to(torch.bfloat16), bb, idgb, mk, mb)
    with pytest.raises(ValueError, match="mask_kernel"):
        _check(h, ga, bb, idgb, mk[:, :4], mb)
    with pytest.raises(ValueError, match="mask_bias"):
        _check(h, ga, bb, idgb, mk, mb.to(torch.bfloat16))
    with pytest.raises(ValueError, match="id_gb"):
        _check(h, ga, bb, idgb[:, :8], mk, mb)
    with pytest.raises(ValueError, match="device"):
        _check(h, ga, bb, idgb, torch.empty(8), mb)


def test_backward_raises_and_no_grad_is_plain(rng):
    """With an input that requires grad, the call goes through the
    autograd Function and its backward raises; with none (or under
    no_grad) it returns the plain version's values, with no graph."""
    args = [torch.from_numpy(a) for a in _inputs(rng, 2, 4, 8, 8)]
    want = aad_modulate_plain(*args)
    out = aad_modulate(*args)
    assert out.grad_fn is None and torch.equal(out, want)
    args[1].requires_grad_()
    with torch.no_grad():
        out = aad_modulate(*args)
    assert out.grad_fn is None and torch.equal(out, want)
    out = aad_modulate(*args)
    assert out.grad_fn is not None and torch.equal(out.detach(), want)
    with pytest.raises(RuntimeError, match="fused_aad=False"):
        out.sum().backward()


# (B, H, W, C, pad): pad > 0 takes gamma/beta from a (B,H,W,2C+pad)
# tensor at channel offset pad, so neither half is 16-byte aligned and
# the pixel stride is odd: the element route. (1,48,32,8): rows no block
# divides; (2,8,8,20): C not a multiple of a 16-bit vector (in f32, 5
# vectors a row); (2,64,64,64): generator-like C; (1,16,16,1024) wide
# rows. Maps of at most aad.SMALL_ROWS pixels take the one-launch route,
# and the card test runs each of them through the split route too.
CARD_SHAPES = [(2, 8, 16, 8, 0), (1, 48, 32, 8, 0), (3, 2, 2, 40, 0),
               (2, 8, 8, 20, 0), (2, 4, 4, 64, 1), (2, 64, 64, 64, 0),
               (2, 16, 16, 64, 1), (1, 16, 16, 1024, 0),
               (1, 16, 16, 1024, 3)]


def _card_args(rng, dtype, b, hh, ww, c, pad):
    h, ga, bb, idgb, mk, mb = _inputs(rng, b, hh, ww, c)
    packed = np.concatenate([np.zeros((b, hh, ww, pad), np.float32), ga, bb],
                            axis=-1)
    h_d, p_d, id_d, mk_d, mb_d = (torch.from_numpy(a).cuda()
                                  for a in (h, packed, idgb, mk, mb))
    p_d = p_d.to(dtype)
    return (h_d.to(dtype), p_d[..., pad:pad + c], p_d[..., pad + c:],
            id_d.to(dtype), mk_d, mb_d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_matches_plain_on_card(dtype, monkeypatch):
    """Every route (one-launch, split: register and wide, each with
    vector and element accesses; the one-launch route's maps also through
    the split route) against the plain version: bf16 and float16 within
    0.1 + 2^-6 |ref| (the JAX kernel test's bf16 bound plus two bf16
    ulps), f32 within 1e-4 + 1e-5 |ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from ghost_tpu_torch.core.precision import disable_tf32
    from ghost_tpu_torch.ops.cuda import aad

    disable_tf32()
    rng = np.random.default_rng(0)
    td = getattr(torch, dtype)
    for shape in CARD_SHAPES:
        args = _card_args(rng, td, *shape)
        ref = aad_modulate_plain(*args)
        bound = (1e-4 + 1e-5 * ref.float().abs() if dtype == "float32"
                 else 0.1 + 2 ** -6 * ref.float().abs())
        small = shape[1] * shape[2] <= aad.SMALL_ROWS
        for small_rows in ((aad.SMALL_ROWS, 0) if small else
                           (aad.SMALL_ROWS,)):
            monkeypatch.setattr(aad, "SMALL_ROWS", small_rows)
            before = aad_modulate.launches
            out = aad_modulate(*args)
            torch.cuda.synchronize()
            assert aad_modulate.launches == before + 1
            assert out.dtype == td and out.shape == args[0].shape
            err = (out.float() - ref.float()).abs()
            assert bool((err <= bound).all()), (shape, small_rows,
                                                float(err.max()))
        monkeypatch.undo()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_is_deterministic_on_card(dtype):
    """The statistics' partial sums are added in a fixed order (no
    atomics): two calls on the same inputs give the same bits, on a shape
    whose rows are split over many blocks, on the wide route and on the
    one-launch route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(1)
    for shape in [(4, 128, 128, 64, 0), (2, 32, 32, 1024, 0),
                  (8, 8, 8, 1024, 0)]:
        args = _card_args(rng, getattr(torch, dtype), *shape)
        first = aad_modulate(*args)
        second = aad_modulate(*args)
        assert torch.equal(first, second), shape


def _tiny_aeinet(fused_aad):
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.nn.layers import init_weights

    return init_weights(AEINet("unet", num_blocks=1, policy=FULL_PRECISION,
                               width=1 / 16, fused_aad=fused_aad),
                        torch.Generator().manual_seed(0))


@pytest.mark.gpu
def test_aeinet_grads_on_card():
    """AEINet(fused_aad=False) trains on the card: f32 gradients of Xt and
    every parameter on CUDA tensors (TF32 off) against the same model on
    the CPU, within 2e-2 of each tensor's largest gradient plus 1e-6 of
    the model's (the f32 conditioning of tests/test_torch_models.py::
    test_aeinet_grads_match_jax). With fused_aad=True the forward runs
    K1 in every AADLayer and the backward raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    xt = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 256, 3)).astype(
        np.float32))
    zid = torch.from_numpy(rng.normal(0, 1, (1, 512)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (1, 256, 256, 3)).astype(
        np.float32))
    cpu = _tiny_aeinet(False)
    grads = {}
    for dev, mod in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).cuda())):
        x = xt.detach().to(dev).requires_grad_()
        y, _ = mod(x, zid.to(dev))
        torch.sum(y * w.to(dev)).backward()
        grads[dev] = {n: p.grad.cpu() for n, p in mod.named_parameters()}
        grads[dev]["xt"] = x.grad.cpu()
    floor = 1e-6 * max(float(g.abs().max()) for g in grads["cpu"].values())
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert bool(torch.isfinite(got).all()), name
        err = float((got - want).abs().max())
        assert err <= 2e-2 * float(want.abs().max()) + floor, (name, err)

    fused = _tiny_aeinet(True).cuda()
    before = aad_modulate.launches
    y, _ = fused(xt.cuda(), zid.cuda())
    layers = sum(isinstance(m, AADLayer) for m in fused.modules())
    assert aad_modulate.launches - before == layers == 13
    with pytest.raises(RuntimeError, match="fused_aad=False"):
        y.sum().backward()
