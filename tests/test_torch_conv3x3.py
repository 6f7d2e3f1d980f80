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

The JAX golden is imported inside the tests that use it, so the card
test runs where jax is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_conv3x3.py
"""

import numpy as np
import pytest
import torch

from ghost_tpu_torch.ops.cuda.conv3x3 import (_check, conv3x3,
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
