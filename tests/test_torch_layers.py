"""ghost_tpu_torch.nn.layers against ghost_tpu.nn.layers on the CPU.

Same seeded numpy inputs through both; f32 within 1e-5. bf16 bounds:
each resize axis is one bf16 matmul whose f32 accumulation is rounded
once to bf16, and the two frameworks may sum in another order, so an
output can land one bf16 ulp (2^-8 relative) away per axis: 2^-6
relative plus 2^-6 absolute covers two axes with margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghost_tpu.nn import layers as jl
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.nn import layers as tl

BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -6)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method,size,align", [
    ("bilinear", (24, 20), False),
    ("bilinear", (5, 7), False),
    ("bilinear", (23, 9), True),
    ("area", (6, 5), False),
    ("area", (5, 3), False),
    ("nearest", (7, 13), False),
])
def test_resize_matches_jax(rng, dtype, method, size, align):
    x = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    ref = jl.resize(jnp.asarray(x).astype(jd), size, method=method,
                    align_corners=align)
    out = tl.resize(torch.from_numpy(x).to(td), size, method=method,
                    align_corners=align)
    assert out.dtype == td and tuple(out.shape) == (2, *size, 3)
    tol = BF16_TOL if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)


def test_resize_like_torch_hwc(rng):
    x = rng.standard_normal((9, 6, 4)).astype(np.float32)
    ref = jl.resize_like_torch(jnp.asarray(x), 2.0)
    out = tl.resize_like_torch(torch.from_numpy(x), 2.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_jax(rng, dtype):
    # an offset mean makes the centring-in-input-dtype step matter
    x = (rng.standard_normal((2, 9, 7, 5)) * 3 + 2).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jl.instance_norm(jnp.asarray(x).astype(jd))
    out = tl.instance_norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    # bf16: the normalized values are O(3), so 2^-6 relative is ~1 ulp
    tol = BF16_TOL if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (2, 1, 0), (3, 2, 0)])
def test_conv_transpose_through_bridge(rng, k, s, p):
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    jmod = jl.ConvTranspose(4, kernel_size=k, stride=s, padding=p)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    # a non-zero bias so the bias path is checked too
    variables = {"params": dict(variables["params"],
                                bias=jnp.arange(4, dtype=jnp.float32))}
    ref = jmod.apply(variables, jnp.asarray(x))
    tmod = load_flax_variables(tl.ConvTranspose(3, 4, k, s, p), variables)
    out = tl.to_nhwc(tmod(tl.to_nchw(torch.from_numpy(x))))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [1, 4])
def test_conv_bn_prelu_through_bridge(rng, groups):
    """Conv (incl. depthwise HWIO (3,3,1,C)) + BatchNorm with batch_stats
    + PReLU, each bridged from its flax twin."""
    import flax.linen as fnn

    class Block(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = jl.Conv(4, 3, 2, padding=1, feature_group_count=groups,
                        name="conv")(x)
            x = jl.BatchNorm(name="bn")(x)
            return jl.PReLU(name="act")(x)

    class TBlock(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = tl.Conv(4, 4, 3, 2, padding=1, groups=groups)
            self.bn = tl.BatchNorm(4)
            self.act = tl.PReLU(4)

        def forward(self, x):
            return self.act(self.bn(self.conv(x)))

    x = rng.standard_normal((2, 9, 8, 4)).astype(np.float32)
    variables = Block().init(jax.random.key(0), jnp.asarray(x))
    variables = jax.tree.map(
        lambda a: a + jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
        variables)
    ref = Block().apply(variables, jnp.asarray(x))
    tmod = load_flax_variables(TBlock(), variables)
    out = tl.to_nhwc(tmod(tl.to_nchw(torch.from_numpy(x))))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_bridge_is_strict():
    jmod = jl.ConvTranspose(4, kernel_size=4)
    variables = jmod.init(jax.random.key(0), jnp.zeros((1, 3, 3, 2)))
    with pytest.raises(KeyError, match="unfilled"):
        load_flax_variables(tl.ConvTranspose(2, 4, 4, 2, 1),
                            {"params": {"kernel": variables["params"]["kernel"]}})
    with pytest.raises(KeyError, match="has no"):
        load_flax_variables(tl.ConvTranspose(2, 4, 4, 2, 1),
                            {"params": dict(variables["params"], extra=1.0)})
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_variables(tl.ConvTranspose(3, 4, 4, 2, 1), variables)


def test_resize_matrix_from_inference_joins_autograd():
    """A resize matrix first built under inference mode (the swap
    pipeline) serves a later training step: the cached matrix is a normal
    tensor, and the gradient of the resize is the matrix's transpose."""
    x = torch.rand(1, 5, 7, 2)
    tl.resize_matrix.cache_clear()
    with torch.inference_mode():
        tl.resize(x, (9, 11))
    xg = x.clone().requires_grad_()
    tl.resize(xg, (9, 11)).sum().backward()
    mh = tl.resize_matrix("bilinear", 5, 9, False, x.device, x.dtype)
    mw = tl.resize_matrix("bilinear", 7, 11, False, x.device, x.dtype)
    want = torch.outer(mh.sum(0), mw.sum(0))[None, :, :, None].expand_as(x)
    torch.testing.assert_close(xg.grad, want)
