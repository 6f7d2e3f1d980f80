"""The port's mmdet SCRFD (`models/scrfd_v1e.py:SCRFDV1e`) and its
`nn.layers.GroupNorm` against ghost_tpu's: GroupNorm against flax's, and
`SCRFDV1e` at both archs (`SCRFD_2_5GF`, `SCRFD_10GF_KPS`) at 160 px on
a seeded mmdet state dict (`tests/torch_route_inputs.py`) converted by
both packages' `convert_scrfd_state_dict`.

Bounds, with their reason: GroupNorm f32 1e-6 (the same statistics in
the same order); bf16 one bf16 ulp of the output (2^-7 relative: only
the final rounding may differ). The converted trees are equal leaf for
leaf. SCRFDV1e f32 1e-4 (25-40 conv layers at 160 px); its bf16 maps
within 5% of each map's largest value (bf16 rounds each of ~30 layers'
outputs to 2^-9 relative, and the frameworks may round the same value to
neighbouring bf16 numbers; 3.7% is the largest seen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
from ghost_tpu_torch.nn.layers import GroupNorm, cast_to_compute_dtype
from torch_route_inputs import scrfd_mmdet_state_dict

SIZE = 160


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------- GroupNorm
def _flax_gn(x_nhwc, scale, bias, dtype=jnp.float32):
    import flax.linen as fnn

    gn = fnn.GroupNorm(num_groups=16, epsilon=1e-5, dtype=dtype)
    return np.asarray(gn.apply({"params": {"scale": scale, "bias": bias}},
                               jnp.asarray(x_nhwc)).astype(jnp.float32))


def _port_gn(x_nhwc, scale, bias, dtype=torch.float32):
    gn = GroupNorm(16, x_nhwc.shape[-1], eps=1e-5, dtype=dtype)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        x = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)
        return gn(x).permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 7, 64)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_port_gn(x, scale, bias),
                                   _flax_gn(x, scale, bias), rtol=1e-6,
                                   atol=1e-6)
        return
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ref = _flax_gn(jnp.asarray(xb, jnp.bfloat16), scale, bias, jnp.bfloat16)
    got = _port_gn(xb, scale, bias, torch.bfloat16)
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)


def test_group_norm_takes_flax_fast_variance():
    """Groups of 3 integers near 1000: every sum is exact, so each step
    rounds the same in both; E[x^2] - E[x]^2 cancels to 1.5 where the
    two-pass variance is 1.5556. The port equals flax to the bit, and
    torch's group_norm (two-pass) is 2.4e-2 away."""
    x = np.concatenate([np.asarray([1000., 1001., 1003.]) + 7 * i
                        for i in range(16)]).reshape(1, 1, 1, 48)
    x = x.astype(np.float32)
    ones, zeros = np.ones(48, np.float32), np.zeros(48, np.float32)
    ref = _flax_gn(x, ones, zeros)
    np.testing.assert_array_equal(_port_gn(x, ones, zeros), ref)
    two_pass = F.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2), 16,
                            eps=1e-5).permute(0, 2, 3, 1).numpy()
    assert np.abs(two_pass - ref).max() > 1e-2


# ---------------------------------------------------------------- SCRFDV1e
def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module", params=["SCRFD_2_5GF", "SCRFD_10GF_KPS"])
def v1e(request):
    """The arch's seeded mmdet dict converted by both packages, and both
    models' f32 outputs on the same normalized 160 px input."""
    from ghost_tpu.convert.torch_loader import \
        convert_scrfd_state_dict as jconvert
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import scrfd_v1e as jv1e
    from ghost_tpu_torch.convert.torch_loader import convert_scrfd_state_dict
    from ghost_tpu_torch.models import scrfd_v1e as tv1e

    name = request.param
    jarch, tarch = getattr(jv1e, name), getattr(tv1e, name)
    sd = scrfd_mmdet_state_dict(np.random.default_rng(1), tarch)
    jtree, ttree = jconvert(sd, arch=jarch), convert_scrfd_state_dict(
        sd, arch=tarch)
    x = np.random.default_rng(2).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    jmod = jv1e.SCRFDV1e(jarch, policy=JFULL)
    ref = jax.jit(jmod.apply)(jax.tree.map(jnp.asarray, jtree),
                              jnp.asarray(x))
    tmod = load_flax_variables(tv1e.SCRFDV1e(tarch, policy=FULL_PRECISION),
                               ttree).eval()
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x))
    return dict(arch=(jarch, tarch), trees=(jtree, ttree), x=x, sd=sd,
                ref=ref, got=got, name=name)


def test_scrfd_v1e_trees_equal(v1e):
    """The converters give the same tree, leaf for leaf."""
    jtree, ttree = v1e["trees"]
    jl, tl = dict(_flatten(jtree)), dict(_flatten(ttree))
    assert sorted(jl) == sorted(tl) and len(jl) > 100
    for k in jl:
        np.testing.assert_array_equal(np.asarray(tl[k]), np.asarray(jl[k]),
                                      err_msg="/".join(k))


def test_scrfd_v1e_matches_jax_f32(v1e):
    _, tarch = v1e["arch"]
    assert len(v1e["got"]) == 3
    for level, (g, r) in enumerate(zip(v1e["got"], v1e["ref"])):
        for kind, gm, rm in zip(("score", "bbox", "kps"), g, r):
            assert tuple(gm.shape) == tuple(rm.shape), (level, kind)
            np.testing.assert_allclose(gm.numpy(), np.asarray(rm),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{level} {kind}")
    kps = v1e["got"][0][2]
    assert bool((kps != 0).any()) == tarch.use_kps


def test_scrfd_v1e_matches_jax_bf16(v1e):
    from ghost_tpu.core.precision import DEFAULT_POLICY as JDEFAULT
    from ghost_tpu.models import scrfd_v1e as jv1e
    from ghost_tpu_torch.models import scrfd_v1e as tv1e

    jarch, tarch = v1e["arch"]
    jtree, ttree = v1e["trees"]
    ref = jax.jit(jv1e.SCRFDV1e(jarch, policy=JDEFAULT).apply)(
        jax.tree.map(jnp.asarray, jtree), jnp.asarray(v1e["x"]))
    tmod = cast_to_compute_dtype(load_flax_variables(
        tv1e.SCRFDV1e(tarch, policy=DEFAULT_POLICY), ttree).eval())
    with torch.inference_mode():
        got = tmod(torch.from_numpy(v1e["x"]))
    for g, r in zip(got, ref):
        for gm, rm in zip(g, r):
            if not tarch.use_kps and gm is g[2]:
                continue
            rm = np.asarray(rm.astype(jnp.float32))
            assert gm.dtype == torch.bfloat16
            err = np.abs(gm.float().numpy() - rm).max()
            assert err <= 0.05 * np.abs(rm).max(), err
