"""S2, the 3x3 stride-1 SAME conv: the port's plain version (and
`conv3x3` on CPU tensors, which takes it) against the scripts' golden,
`lax.conv_general_dilated(x, k, (1,1), ((1,1),(1,1)), ("NHWC", "HWIO",
"NHWC"))`, and (on a card) the CUDA kernel against the plain version.

Bounds, with their reason: f32 |d| <= 1e-5 + 1e-5 |ref| (the same f32
sums in another order); bf16 inputs, compared in f32, within 2^-7 |ref|
(between one and two bf16 ulp of |ref|: both sides sum the exact bf16
products in f32 and round once, so they part by at most one rounding
step) plus 1e-6.

On the card, kernel against plain at up to 70 input channels, the f32
sums of 9*Cin products in another order part by ~1e-5 of the sums' scale
even where a result is near 0, so both dtypes add 1e-5 max|ref| to their
relative term (2^-7 or 1e-5 of |ref|).

Gradients (`conv3x3_fn`, whose dx runs S2 on the turned kernel): f32
against jax.grad of the golden, 1e-5 plus 1e-5 of the tensor's largest
gradient (f32 sums in another order); bf16 against the plain version's
autograd on the same values, each within one rounding step (2^-7 |ref|)
plus 1e-5 of the tensor's largest gradient: both sum exact bf16
products in f32 and round once.

The JAX golden is imported inside the tests that use it, so the card
test runs where jax is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_conv3x3.py
"""

import numpy as np
import pytest
import torch

from ghost_tpu_torch.ops.cuda.conv3x3 import (_check, conv3x3, conv3x3_fn,
                                              conv3x3_reference)

# (B, H, W, Cin, Cout): odd H and W, Cin 3, Cout 12, C 5, the test widths
SHAPES = [(2, 9, 7, 4, 4), (1, 11, 13, 8, 8), (2, 7, 9, 3, 12),
          (1, 5, 11, 5, 5), (3, 1, 1, 1, 2)]


def _inputs(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, k, bias


def _bound(ref, dtype):
    if dtype == "bfloat16":
        return 2.0 ** -7 * np.abs(ref) + 1e-6
    return 1e-5 + 1e-5 * np.abs(ref)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_lax(shape, dtype, with_bias):
    import jax.numpy as jnp
    from jax import lax

    x, k, bias = _inputs(shape, seed=sum(shape))
    jdt = getattr(jnp, dtype)
    ref = lax.conv_general_dilated(
        jnp.asarray(x, jdt), jnp.asarray(k, jdt), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    if with_bias:
        ref = ref + jnp.asarray(bias)
    ref = np.asarray(ref.astype(jdt).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tx, tk = torch.from_numpy(x).to(tdt), torch.from_numpy(k).to(tdt)
    tb = torch.from_numpy(bias) if with_bias else None
    for fn in (conv3x3_reference, conv3x3):
        got = fn(tx, tk, tb)
        assert got.dtype == tdt and got.is_contiguous()
        assert tuple(got.shape) == shape[:3] + (shape[4],)
        err = np.abs(got.float().numpy() - ref)
        assert (err <= _bound(ref, dtype)).all(), (fn.__name__,
                                                   float(err.max()))


def test_kernel_rejects_what_it_does_not_take():
    """Layout and dtype checks run before any launch (meta tensors reach
    them without a card)."""
    x = torch.empty((2, 8, 8, 4), device="meta")
    k = torch.empty((3, 3, 4, 6), device="meta")
    b = torch.empty((6,), device="meta")
    _check(x, k, b)
    _check(x, k, None)
    with pytest.raises(ValueError, match="contiguous"):
        _check(x.permute(0, 2, 1, 3), k, b)
    with pytest.raises(ValueError, match=r"\(3,3,4,Cout\)"):
        _check(x, torch.empty((3, 3, 5, 6), device="meta"), b)
    with pytest.raises(TypeError):
        _check(x, k.to(torch.bfloat16), b)
    with pytest.raises(TypeError):
        _check(x.to(torch.float16), k.to(torch.float16), b)
    with pytest.raises(ValueError, match="bias"):
        _check(x, k, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="bias"):
        _check(x, k, b[:5])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from ghost_tpu_torch.core.precision import disable_tf32

    disable_tf32()
    tdt = getattr(torch, dtype)
    for i, shape in enumerate(SHAPES + [(2, 37, 53, 5, 7),
                                        (4, 64, 64, 32, 32),
                                        (2, 33, 40, 70, 40)]):
        x, k, bias = _inputs(shape, seed=i)
        args = [torch.from_numpy(a).cuda() for a in (x, k)]
        tx, tk = (a.to(tdt) for a in args)
        tb = torch.from_numpy(bias).cuda() if i % 2 else None
        before = conv3x3.launches
        got = conv3x3(tx, tk, tb)
        torch.cuda.synchronize()
        assert conv3x3.launches == before + 1
        ref = conv3x3_reference(tx, tk, tb).float().cpu().numpy()
        err = np.abs(got.float().cpu().numpy() - ref)
        rel = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
        bound = rel * np.abs(ref) + 1e-5 * np.abs(ref).max()
        assert (err <= bound).all(), (shape, float(err.max()))


def _stack(xs, ks, bs, conv):
    """Two convs with a ReLU between them."""
    return conv(torch.relu(conv(xs, ks[0], bs[0])), ks[1], bs[1])


def _stack_inputs(dtype, seed=7, shape=(2, 9, 11, 3), widths=(5, 4)):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    ks, bs = [], []
    for cout in widths:
        ks.append((rng.standard_normal((3, 3, cin, cout))
                   / np.sqrt(9 * cin)).astype(np.float32))
        bs.append((rng.standard_normal(cout) * 0.1).astype(np.float32))
        cin = cout
    w = rng.standard_normal(shape[:3] + (widths[-1],)).astype(np.float32)
    td = getattr(torch, dtype)
    return ([torch.from_numpy(a).to(td) for a in [x] + ks],
            [torch.from_numpy(b) for b in bs], w)


def _grads(conv, dtype, device="cpu"):
    (x, *ks), bs, w = _stack_inputs(dtype)
    leaves = [t.to(device).requires_grad_() for t in [x, *ks, *bs]]
    x, k0, k1, b0, b1 = leaves
    out = _stack(x, (k0, k1), (b0, b1), conv)
    torch.sum(out.float() * torch.from_numpy(w).to(device)).backward()
    return [t.grad for t in leaves]


def _close(got, want, rel):
    for i, (g, r) in enumerate(zip(got, want)):
        g, r = g.float().cpu(), r.float().cpu()
        bound = rel * r.abs() + 1e-5 * float(r.abs().max())
        assert g.dtype == r.dtype and g.shape == r.shape
        assert bool(((g - r).abs() <= bound).all()), (
            i, float((g - r).abs().max()))


def test_conv3x3_stack_grads_match_jax():
    """f32 gradients of x, both kernels and both biases of a two-conv
    stack (3 -> 5 -> 4 channels, Cin not a multiple of 8) through
    `conv3x3_fn` against jax.grad of the golden conv on the same values."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    (x, *ks), bs, w = _stack_inputs("float32")

    def conv(x, k, b):
        return lax.conv_general_dilated(
            x, k, (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b

    def loss(x, k0, k1, b0, b1):
        return jnp.sum(conv(jax.nn.relu(conv(x, k0, b0)), k1, b1) * w)

    want = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(t.numpy()) for t in [x, *ks, *bs]))
    got = _grads(conv3x3_fn, "float32")
    for i, (g, r) in enumerate(zip(got, want)):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape, i
        err = np.abs(g.numpy() - r)
        assert (err <= 1e-5 + 1e-5 * np.abs(r).max()).all(), (i, err.max())


def test_conv3x3_bf16_grads_match_plain():
    """bf16 gradients through `conv3x3_fn` (dx by S2 on the turned
    kernel, dk and dbias in f32) against autograd of the plain version
    (an f32 conv of the bf16 values, cast once) on the same stack: dx
    and dk in bf16, dbias in f32."""
    got = _grads(conv3x3_fn, "bfloat16")
    want = _grads(conv3x3_reference, "bfloat16")
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    _close(got, want, 2.0 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_match_plain_on_card(dtype):
    """The stack's gradients on the card (S2 forward and dx, TF32 off)
    against the plain version's autograd on the card, and S2's launches:
    two forward convs and two dx convs (the first conv's x takes a
    gradient too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = conv3x3.launches
    got = _grads(conv3x3_fn, dtype, "cuda")
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 4
    want = _grads(conv3x3_reference, dtype, "cuda")
    _close(got, want, 2.0 ** -7 if dtype == "bfloat16" else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_srvgg_grads_match_plain_on_card(dtype, monkeypatch):
    """A narrow SRVGG (8 features, 2 body convs, x2) trains on the card:
    the gradients of x and every parameter through S2 (forward and dx)
    against the same model with every conv on the plain version, both on
    CUDA tensors (TF32 off). f32: 1e-5 |ref| plus 1e-5 of the tensor's
    largest gradient (sums in another order). bf16: each path's error
    against the f32 plain gradient at most twice the plain bf16 path's
    plus 1e-3 of the tensor's largest gradient (both round each conv's
    output and dx once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact
    from ghost_tpu_torch.nn import layers
    from ghost_tpu_torch.nn.layers import init_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 40, 36, 3)).astype(
        np.float32)).cuda()
    w = torch.from_numpy(rng.standard_normal((2, 80, 72, 3)).astype(
        np.float32)).cuda()

    def grads(policy, plain):
        model = init_weights(SRVGGNetCompact(num_feat=8, num_conv=2,
                                             upscale=2, policy=policy),
                             torch.Generator().manual_seed(2)).cuda()
        with monkeypatch.context() as m:
            if plain:
                m.setattr(layers, "conv3x3_fn", conv3x3_reference)
            xg = x.clone().requires_grad_()
            torch.sum(model(xg).float() * w).backward()
        out = {n: p.grad.float() for n, p in model.named_parameters()}
        out["x"] = xg.grad.float()
        return out

    before = conv3x3.launches
    if dtype == "float32":
        got = grads(FULL_PRECISION, False)
        assert conv3x3.launches == before + 8  # 4 forward, 4 dx
        want = grads(FULL_PRECISION, True)
        assert conv3x3.launches == before + 8
        _close(list(got.values()), list(want.values()), 1e-5)
        return
    got = grads(DEFAULT_POLICY, False)
    assert conv3x3.launches == before + 8
    plain = grads(DEFAULT_POLICY, True)
    ref = grads(FULL_PRECISION, True)
    for name, r in ref.items():
        top = float(r.abs().max())
        e_kernel = float((got[name] - r).abs().max())
        e_plain = float((plain[name] - r).abs().max())
        assert bool(torch.isfinite(got[name]).all()), name
        assert e_kernel <= 2 * e_plain + 1e-3 * top, (name, e_kernel,
                                                      e_plain)
