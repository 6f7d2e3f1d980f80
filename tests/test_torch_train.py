"""The training core's building blocks against ghost_tpu's, on the CPU.

Train-mode BatchNorm (output and the moved running statistics, against
flax), `avg_pool_3x3s2`, the multiscale discriminator (every norm, the
intermediate features, and through `convert_discriminator_state_dict` on
a synthetic state dict with the reference's key names), every loss
function, the ratchet, `DynamicLossScale` / `scaled_value_and_grad`,
GhostAdam over several steps against `ghost_adam` (and the StepLR clocks
of G and D), `save_msgpack` read back by JAX, the checkpoint manager,
`PreemptionGuard` and the grid helpers. The whole G/D steps and the loop
are in tests/test_torch_train_step.py.

JAX runs on small arrays (the discriminator on 64-px inputs, jitted:
one small compile costs less than the eager first calls), so no test
compiles a large program. Bounds are stated at each
test; f32 parity is held to 1e-5 relative unless the test says why not.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ghost_tpu.core import checkpoint as jckpt
from ghost_tpu.core import loss_scale as jls
from ghost_tpu.core.precision import DEFAULT_POLICY as JBF16
from ghost_tpu.core.precision import FULL_PRECISION as JFULL
from ghost_tpu.convert.torch_loader import \
    convert_discriminator_state_dict as jconvert_disc
from ghost_tpu.models import discriminator as jdisc
from ghost_tpu.nn import layers as jlayers
from ghost_tpu.train import losses as jL
from ghost_tpu.train import preempt as jpreempt
from ghost_tpu.train import viz as jviz
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.convert.torch_loader import \
    convert_discriminator_state_dict
from ghost_tpu_torch.core import checkpoint as tckpt
from ghost_tpu_torch.core import loss_scale as tls
from ghost_tpu_torch.core.precision import DEFAULT_POLICY as TBF16
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models import discriminator as tdisc
from ghost_tpu_torch.nn import layers as tlayers
from ghost_tpu_torch.train import losses as tL
from ghost_tpu_torch.train import preempt as tpreempt
from ghost_tpu_torch.train import viz as tviz
from tests.test_torch_pipeline import _variables
from torch_train_cli_inputs import \
    disc_state_dict as _reference_disc_state_dict


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


# ------------------------------------------------------------- BatchNorm
def _flax_bn_train(x, scale, bias, mean, var, dtype):
    mod = jlayers.BatchNorm(use_running_average=False, dtype=dtype)
    v = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
         "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
    y, upd = mod.apply(v, jnp.asarray(x, dtype), mutable=["batch_stats"])
    s = upd["batch_stats"]["BatchNorm_0"]
    return y, s["mean"], s["var"]


def _port_bn_train(x, scale, bias, mean, var, dtype):
    bn = tlayers.BatchNorm(x.shape[-1], dtype=dtype, train=True)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(_t(v))
    y = bn(_t(x, dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return y, bn.running_mean, bn.running_var


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_flax(dtype):
    """Batch statistics, normalisation and the running-stat update
    ra <- 0.9 ra + 0.1 batch with the biased variance, against flax's
    BatchNorm(use_running_average=False) on a (4,6,5,16) batch whose
    channels have means up to 3 and spreads from 0.5 to 3 (a conv
    output's; the cancellation of E[x^2] - E[x]^2 is pinned on exact
    sums in the next test). f32: 1e-5 relative; bf16: the output
    to 1 bf16 ulp (2^-7 relative), the f32 statistics to 1e-5."""
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 1, (4, 6, 5, 16)) * rng.uniform(0.5, 3, 16)
         + rng.uniform(-3, 3, 16)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 16), rng.normal(0, 0.5, 16)
    mean, var = rng.normal(0, 1, 16), rng.uniform(0.5, 2, 16)
    jdt = getattr(jnp, dtype)
    ref = _flax_bn_train(x, scale, bias, mean, var, jdt)
    out = _port_bn_train(x, scale, bias, mean, var, getattr(torch, dtype))
    assert out[0].dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(out[0], ref[0], rtol=1e-5, atol=1e-5)
    else:
        _close(out[0], ref[0], rtol=2 ** -7, atol=2 ** -7)
    _close(out[1], ref[1], rtol=1e-5, atol=1e-6)
    _close(out[2], ref[2], rtol=1e-5, atol=1e-6)
    # the biased batch variance went into the update: unbiased would put
    # 0.1 * var * (1/(n-1)) more into every channel
    xs = _np(_t(x, getattr(torch, dtype))).reshape(-1, 16).astype(np.float64)
    np.testing.assert_allclose(_np(out[2]), 0.9 * var + 0.1 * xs.var(0),
                               rtol=1e-4)


def test_batch_norm_takes_flax_fast_variance():
    """Channels of 3 integers near 1000 repeated over the batch: every
    sum is exact, so E[x^2] - E[x]^2 cancels to 1.5 where the two-pass
    variance is 1.5556. The port's output and running variance equal
    flax's to the bit; torch's F.batch_norm (two-pass, unbiased update)
    lands > 1e-2 away in both."""
    base = np.asarray([1000., 1001., 1003.])
    x = np.stack([base + 7 * c for c in range(8)], -1)  # (3, 8)
    x = np.tile(x[:, None, None, :], (1, 2, 2, 1)).astype(np.float32)
    ones, zeros = np.ones(8, np.float32), np.zeros(8, np.float32)
    ref = _flax_bn_train(x, ones, zeros, zeros, ones, jnp.float32)
    out = _port_bn_train(x, ones, zeros, zeros, ones, torch.float32)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(_np(a), _np(b))
    rm, rv = torch.zeros(8), torch.ones(8)
    two_pass = torch.nn.functional.batch_norm(
        _t(x).permute(0, 3, 1, 2), rm, rv, training=True, momentum=0.1)
    assert np.abs(_np(two_pass.permute(0, 2, 3, 1)) - _np(ref[0])).max() > 1e-2
    assert np.abs(_np(rv) - _np(ref[2])).max() > 1e-2


def test_frozen_batch_stats_keeps_running_stats():
    """Inside frozen_batch_stats a train-mode BN still normalises with
    the batch statistics but leaves its running ones as they were."""
    bn = tlayers.BatchNorm(4, train=True)
    bn.reset_parameters(None)
    x = torch.randn(3, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    with tlayers.frozen_batch_stats(bn):
        y_frozen = bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(bn.running_var, torch.ones(4))
    assert torch.equal(bn(x), y_frozen)
    assert not torch.equal(bn.running_mean, torch.zeros(4))


# ------------------------------------------------------------ avg pool
@pytest.mark.parametrize("dtype,shape", [("float32", (2, 9, 8, 3)),
                                         ("float32", (1, 64, 64, 4)),
                                         ("bfloat16", (2, 9, 8, 3))])
def test_avg_pool_3x3s2_matches_jax(dtype, shape):
    """AvgPool2d(3, 2, 1, count_include_pad=False) on odd and even sizes
    (the corner windows count 4 real taps, the edges 6), and its
    gradient: f32 to 1e-6,
    bf16 to 1 ulp (2^-7 relative), since the two frameworks may sum the
    window in another order before the rounding to bf16."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, shape).astype(np.float32)
    ref, vjp = jax.vjp(jlayers.avg_pool_3x3s2,
                       jnp.asarray(x, getattr(jnp, dtype)))
    tx = _t(x, getattr(torch, dtype)).requires_grad_(True)
    out = tlayers.avg_pool_3x3s2(tx)
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    _close(out, ref, rtol=tol, atol=tol)
    # the gradient: each input pixel gets its windows' upstream values
    # divided by their counts (f32 to 1e-6; bf16 to 1 ulp)
    g = rng.normal(0, 1, out.shape).astype(np.float32)
    tg, = torch.autograd.grad(out, tx, _t(g, getattr(torch, dtype)))
    _close(tg, vjp(jnp.asarray(g, getattr(jnp, dtype)))[0], rtol=tol,
           atol=tol)


def test_embed112_joins_autograd_after_inference_mode():
    """The ArcFace input of the G step, an area resize 256 -> 112: its
    matrix first built under inference mode (as a swap call would) still
    joins a later autograd graph, and the gradient equals JAX's vjp of
    its resize (f32, 1e-6)."""
    from ghost_tpu_torch.train.train_step import _embed112

    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    g = rng.normal(0, 1, (2, 112, 112, 3)).astype(np.float32)
    with torch.inference_mode():
        tlayers.resize(_t(x), (112, 112), method="area")
    tx = _t(x).requires_grad_(True)
    out = _embed112(lambda z: z, tx)
    tg, = torch.autograd.grad(out, tx, _t(g))
    ref, vjp = jax.vjp(lambda z: jlayers.resize(z, (112, 112),
                                                 method="area"),
                       jnp.asarray(x))
    _close(out, ref, rtol=1e-6, atol=1e-6)
    _close(tg, vjp(jnp.asarray(g))[0], rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- discriminator
def _disc_pair(norm, interm, policy=("f32",), n_layers=3, num_D=2, seed=2):
    jpol, tpol = (JFULL, TFULL) if policy[0] == "f32" else (JBF16, TBF16)
    jd = jdisc.MultiscaleDiscriminator(ndf=8, n_layers=n_layers, num_D=num_D,
                                       norm=norm, get_interm_feat=interm,
                                       policy=jpol)
    v = _variables(jd, np.random.default_rng(seed), (1, 64, 64, 3))
    td = tdisc.MultiscaleDiscriminator(ndf=8, n_layers=n_layers, num_D=num_D,
                                       norm=norm, get_interm_feat=interm,
                                       policy=tpol, device="cpu")
    return jd, v, load_flax_variables(td, v)


@pytest.mark.parametrize("norm,interm", [("instance", False),
                                         ("instance", True),
                                         ("batch", False), ("none", True)])
def test_discriminator_matches_jax(norm, interm):
    """Every scale's logits (and with get_interm_feat every stage's
    features) on a 2x64x64 input, f32, to 1e-4 relative of each map's
    largest value; the scale naming and the pyramid follow JAX's tree
    (the strict bridge fills every tensor)."""
    jd, v, td = _disc_pair(norm, interm)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 64, 64, 3))
    ref = jax.jit(jd.apply)(v, jnp.asarray(x, jnp.float32))
    out = td(_t(x))
    assert len(out) == len(ref) == 2
    for o_scale, r_scale in zip(out, ref):
        assert len(o_scale) == len(r_scale) == (5 if interm else 1)
        for o, r in zip(o_scale, r_scale):
            assert tuple(o.shape) == tuple(r.shape)
            scale = float(np.abs(_np(r)).max())
            _close(o, r, rtol=1e-4, atol=1e-4 * scale)


def test_discriminator_bf16_matches_jax():
    """bf16 compute with f32 instance-norm statistics: the logits within
    2e-2 of each map's largest value (bf16 activations through 5 convs;
    the two frameworks' conv accumulation orders differ)."""
    jd, v, td = _disc_pair("instance", False, policy=("bf16",))
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3))
    ref = jax.jit(jd.apply)(v, jnp.asarray(x, jnp.float32))
    out = td(_t(x))
    for o, r in zip(out, ref):
        assert o[-1].dtype == torch.bfloat16
        scale = float(np.abs(_np(r[-1])).max())
        _close(o[-1], r[-1], rtol=0, atol=2e-2 * scale)


def test_discriminator_converter_matches_jax():
    """The port's converter gives JAX's tree on the same reference-named
    state dict (leaf for leaf, exactly), and the bridged port module
    gives JAX's logits on it (f32, 1e-4 of each map's largest value)."""
    sd = _reference_disc_state_dict(np.random.default_rng(5))
    jt, tt = jconvert_disc(sd, num_D=2, n_layers=3), \
        convert_discriminator_state_dict(sd, num_D=2, n_layers=3)
    jl, tl = (jax.tree_util.tree_leaves_with_path(t) for t in (jt, tt))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jd = jdisc.MultiscaleDiscriminator(ndf=8, n_layers=3, num_D=2,
                                       policy=JFULL)
    td = load_flax_variables(tdisc.MultiscaleDiscriminator(
        ndf=8, n_layers=3, num_D=2, policy=TFULL), tt)
    x = np.random.default_rng(6).uniform(-1, 1, (1, 64, 64, 3))
    for o, r in zip(td(_t(x)),
                    jax.jit(jd.apply)(jt, jnp.asarray(x, jnp.float32))):
        _close(o[-1], r[-1], rtol=1e-4,
               atol=1e-4 * float(np.abs(_np(r[-1])).max()))


# --------------------------------------------------------------- losses
def _loss_inputs(rng):
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    d = lambda: [[u(2, 5, 5, 1)], [u(2, 3, 3, 1)]]  # noqa: E731
    return {
        "hinge_g_loss": (d(), np.asarray([1.0, 0.0], np.float32)),
        "hinge_d_loss": (d(), d(), np.asarray([1.0, 1.0], np.float32)),
        "id_cosine_loss": (u(2, 512), u(2, 512)),
        "attr_loss": ([u(2, 4, 4, 6), u(2, 8, 8, 3)],
                      [u(2, 4, 4, 6), u(2, 8, 8, 3)]),
        "reconstruction_loss": (u(2, 8, 8, 3), u(2, 8, 8, 3),
                                np.asarray([1.0, 0.0], np.float32)),
        "eye_heatmap_loss": (u(2, 6, 6), u(2, 6, 6), u(2, 6, 6),
                             u(2, 6, 6)),
        "teacher_residual_loss": (u(2, 8, 8, 3), u(2, 8, 8, 3),
                                  u(2, 8, 8, 3)),
        "multi_round_loss": (u(2, 8, 8, 3), u(2, 8, 8, 3)),
        "round_trip_loss": (u(2, 8, 8, 3), u(2, 8, 8, 3)),
        "to_grayscale": (u(2, 8, 8, 3),),
        "structural_loss": (u(2, 8, 8, 3), u(2, 8, 8, 3)),
        "edge_loss": (u(2, 12, 12, 3), u(2, 12, 12, 3)),
        "emboss_loss": (u(2, 12, 12, 3), u(2, 12, 12, 3)),
        "masked_color_consistency_loss": (
            u(2, 8, 8, 3), (rng.uniform(0, 1, (2, 8, 8, 1)) > 0.5)
            .astype(np.float32)),
    }


def _tree(fn, x):
    if isinstance(x, (list, tuple)):
        return [_tree(fn, v) for v in x]
    return fn(x)


@pytest.mark.parametrize("name", sorted(_loss_inputs(
    np.random.default_rng(0))))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_jax(name, dtype):
    """Each of the 14 loss functions on the same seeded inputs, f32 to
    1e-5 relative; in bf16 (inputs cast, as a bf16 model hands them
    over) to 1e-2 relative: both cast to f32 at the same places, and
    what stays bf16 rounds to 2^-8. emboss_loss convolves with an f32
    kernel, so JAX refuses bf16 images there, and so does the port."""
    args = _loss_inputs(np.random.default_rng(0))[name]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if name == "emboss_loss" and dtype == "bfloat16":
        with pytest.raises(TypeError):
            jL.emboss_loss(*_tree(lambda a: jnp.asarray(a, jdt), args))
        with pytest.raises(RuntimeError):
            tL.emboss_loss(*_tree(lambda a: _t(a, tdt), args))
        return
    ref = getattr(jL, name)(*_tree(lambda a: jnp.asarray(a, jdt), args))
    out = getattr(tL, name)(*_tree(lambda a: _t(a, tdt), args))
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    _close(out, ref, rtol=tol, atol=tol * 1e-1)


def test_ratchet_and_weights_match_jax():
    """The ratchet's multiplier sequence over values that cross, sit at
    and stay below the floor, and the default loss weights."""
    m_j = m_t = 3.5
    for value in (0.001, 0.01, 0.5, 0.0, -1.0, 3.0, 1e-9):
        m_j = jL.ratchet_multiplier(value, m_j, 200.0)
        m_t = tL.ratchet_multiplier(value, m_t, 200.0)
        assert m_j == m_t
    assert jL.GeneratorLossWeights().__dict__ == \
        tL.GeneratorLossWeights().__dict__


# ---------------------------------------------------------- loss scale
def test_dynamic_loss_scale_matches_jax():
    """Growth after `growth_interval` clean steps, backoff on inf/nan
    (not below 1), the cap at 2^24, and apply_if_finite, step for step
    against JAX (exact: powers of two)."""
    js = jls.DynamicLossScale.init(2.0 ** 22, growth_interval=2)
    ts = tls.DynamicLossScale.init(2.0 ** 22, growth_interval=2)
    grads = [np.ones(3, np.float32), np.asarray([1.0, np.inf], np.float32)]
    for step, finite in enumerate([True, True, True, True, True, False,
                                   True, False, False, True, True]):
        g = [grads[0] * (step + 1), grads[0 if finite else 1]]
        jf = js.check_finite([jnp.asarray(a) for a in g])
        tf = ts.check_finite([_t(a) for a in g])
        assert bool(jf) == bool(tf) == finite
        js, ts = js.update(jf), ts.update(tf)
        assert float(js.scale) == float(ts.scale)
        assert int(js.growth_counter) == int(ts.growth_counter)
        old, new = [np.zeros(2, np.float32)], [np.ones(2, np.float32)]
        _close(ts.apply_if_finite([_t(a) for a in old],
                                  [_t(a) for a in new], tf)[0],
               js.apply_if_finite([jnp.asarray(a) for a in old],
                                  [jnp.asarray(a) for a in new], jf)[0])
    assert float(ts.scale) <= 2.0 ** 24
    tiny = tls.DynamicLossScale.init(1.0)
    assert float(tiny.update(torch.tensor(False)).scale) == 1.0


def test_scaled_value_and_grad_matches_jax():
    """Loss and unscaled gradients of sum(w^2 x) under scale 2^16 equal
    JAX's (f32, 1e-6 relative); a loss of ~1e20 under scale 2^100
    overflows f32 and reports non-finite gradients in both."""
    rng = np.random.default_rng(7)
    w, x = rng.normal(0, 1, 5).astype(np.float32), \
        rng.normal(0, 1, 5).astype(np.float32)
    for scale, big, finite in ((2.0 ** 16, 1.0, True),
                               (2.0 ** 100, 1e20, False)):
        js = jls.DynamicLossScale.init(scale)
        ts = tls.DynamicLossScale.init(scale)
        jv, jg, jf = jls.scaled_value_and_grad(
            lambda p, xx: big * jnp.sum(p["w"] ** 2 * xx), js)(
                {"w": jnp.asarray(w)}, jnp.asarray(x))
        tw = _t(w).requires_grad_(True)
        tv, tg, tf = tls.scaled_value_and_grad(
            lambda p, xx: big * torch.sum(p["w"] ** 2 * xx), ts)(
                {"w": tw}, _t(x))
        assert bool(jf) == bool(tf) == finite
        if finite:
            _close(tv, jv, rtol=1e-6)
            _close(tg["w"], jg["w"], rtol=1e-6)


# ---------------------------------------------------------- optimizers
@pytest.mark.parametrize("schedule", [None, "g", "d"])
def test_ghost_adam_matches_optax_over_steps(schedule):
    """GhostAdam (torch.optim.Adam, coupled L2 decay, b1=0) against
    `ghost_adam` over 6 steps of a quadratic; with StepLR every 2 updates
    (gamma 0.5) on G's clock (update count) and on D's (count *
    d_interval, d_interval 3, as `train_step._make_txs` builds it).
    Parameters to 1e-6 relative or 1e-6 absolute (8 f32 ulps at 1: the
    two update formulas round in another order), the moments to 1e-5
    relative (the first: the gradient, taken at parameters that far
    apart) and 2e-5 (the second, its square), each step."""
    from ghost_tpu.train.train_step import TrainStepConfig as JCfg
    from ghost_tpu.train.train_step import _make_txs as jtxs
    from ghost_tpu_torch.train.train_step import TrainStepConfig as TCfg
    from ghost_tpu_torch.train.train_step import _make_txs as ttxs

    rng = np.random.default_rng(8)
    p0 = rng.normal(0, 1, (4, 3)).astype(np.float32)
    target = rng.normal(0, 1, (4, 3)).astype(np.float32)
    kw = dict(scheduler=schedule is not None, scheduler_step=2,
              scheduler_gamma=0.5, d_interval=3, lr_g=1e-2, lr_d=2e-2)
    pick = 1 if schedule == "d" else 0
    jtx = jtxs(JCfg(**kw))[pick]
    tp = torch.nn.Parameter(_t(p0))
    topt_ = ttxs(TCfg(**kw), [tp], [tp])[pick]
    @jax.jit
    def jstep(jp, jstate):
        jg = jax.grad(lambda q: jnp.sum((q - target) ** 2 * q))(jp)
        upd, jstate = jtx.update(jg, jstate, jp)
        return optax.apply_updates(jp, upd), jstate

    jp = jnp.asarray(p0)
    jstate = jtx.init(jp)
    for _ in range(6):
        jp, jstate = jstep(jp, jstate)
        loss = torch.sum((tp - _t(target)) ** 2 * tp)
        tp.grad, = torch.autograd.grad(loss, [tp])
        topt_.step()
        _close(tp, jp, rtol=1e-6, atol=1e-6)
        adam = next(s for s in jstate if hasattr(s, "mu"))
        st = topt_.state[tp]
        _close(st["exp_avg"], adam.mu, rtol=1e-5, atol=1e-7)
        _close(st["exp_avg_sq"], adam.nu, rtol=2e-5, atol=1e-9)
    assert topt_.count == 6 and topt_.state_dict()["count"] == 6


def test_ghost_adam_deepcopy_keeps_schedule_and_count():
    """A deep copy of GhostAdam (as of a whole TrainState) keeps its
    schedule and update count, and its next step equals the original's
    (torch's Optimizer copies only defaults, state and param_groups)."""
    import copy

    from ghost_tpu_torch.train.optimizers import GhostAdam, step_lr

    p = torch.nn.Parameter(torch.ones(3))
    opt = GhostAdam([p], lr=step_lr(1e-2, 1, 0.5))
    for _ in range(2):
        p.grad = torch.full((3,), 0.5)
        opt.step()
    p2, opt2 = copy.deepcopy((p, opt))
    assert opt2.count == 2 and opt2.schedule is opt.schedule
    for q, o in ((p, opt), (p2, opt2)):
        q.grad = torch.full((3,), 0.25)
        o.step()
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"] == 2.5e-3
    assert torch.equal(p2, p) and opt2.count == 3


# ---------------------------------------------------------- checkpoints
def test_save_msgpack_reads_back_in_jax(tmp_path):
    """A tree of f32/bf16/int tensors, numpy arrays, numpy and Python
    scalars, a list and a tuple: JAX's load_msgpack reads the port's file
    as flax wrote it (flax's own bytes for the same tree), and the port's
    load_msgpack reads it back."""
    rng = np.random.default_rng(9)
    a = rng.normal(0, 1, (3, 4)).astype(np.float32)
    b16 = torch.from_numpy(a).to(torch.bfloat16)
    tree = {"params": {"w": torch.from_numpy(a), "half": b16,
                       "i": torch.arange(5, dtype=torch.int32)},
            "np": np.arange(6, dtype=np.int64).reshape(2, 3),
            "scalar": np.float32(2.5), "n": 7, "x": 0.25,
            "seq": [np.ones(2, np.float32), (3, 4)]}
    path = tmp_path / "t.msgpack"
    tckpt.save_msgpack(path, tree)
    flax_tree = {"params": {"w": a, "half": jnp.asarray(a, jnp.bfloat16),
                            "i": np.arange(5, dtype=np.int32)},
                 "np": np.arange(6, dtype=np.int64).reshape(2, 3),
                 "scalar": np.float32(2.5), "n": 7, "x": 0.25,
                 "seq": [np.ones(2, np.float32), (3, 4)]}
    from flax import serialization
    assert path.read_bytes() == serialization.to_bytes(flax_tree)
    back = jckpt.load_msgpack(str(path))
    assert back["params"]["half"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["params"]["half"], np.float32), _np(b16))
    np.testing.assert_array_equal(back["params"]["w"], a)
    assert back["n"] == 7 and back["seq"]["1"] == {"0": 3, "1": 4}
    mine = tckpt.load_msgpack(path)
    np.testing.assert_array_equal(mine["np"], flax_tree["np"])
    assert mine["scalar"] == np.float32(2.5)


def test_save_msgpack_chunks_large_leaves(tmp_path, monkeypatch):
    """A leaf above the chunk size (flax's 2^30 bytes, 64 here) is written
    as flax's chunked-array map, and both readers join it back."""
    monkeypatch.setattr(tckpt, "_MAX_CHUNK", 64)
    a = np.arange(100, dtype=np.float32).reshape(4, 25)
    tckpt.save_msgpack(tmp_path / "c.msgpack", {"big": torch.from_numpy(a)})
    raw = jckpt.load_msgpack(str(tmp_path / "c.msgpack"))
    np.testing.assert_array_equal(raw["big"], a)
    np.testing.assert_array_equal(
        tckpt.load_msgpack(tmp_path / "c.msgpack")["big"], a)


def test_checkpoint_manager_keep_force_and_restore(tmp_path):
    """Orbax's semantics: a plain save at or below the latest step is a
    no-op; force=True replaces a same-step snapshot; the newest `keep`
    stay; restore(like=...) loads into an object in place; nothing is
    left under a temporary name."""
    mgr = tckpt.CheckpointManager(tmp_path / "ck", keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 2, 3):
        assert mgr.save(step, {"w": torch.full((2,), float(step)), "s": step})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not mgr.save(3, {"w": torch.zeros(2), "s": -1})
    assert not mgr.save(2, {"w": torch.zeros(2), "s": -1})
    assert mgr.restore()["s"] == 3
    assert mgr.save(3, {"w": torch.zeros(2), "s": 33}, force=True)
    assert mgr.restore(3)["s"] == 33 and mgr.restore(2)["s"] == 2
    assert sorted(os.listdir(mgr.directory)) == ["step_2", "step_3"]

    class Holder:
        got = None

        def load_state_dict(self, sd):
            self.got = sd

    h = mgr.restore(2, like=Holder())
    assert torch.equal(h.got["w"], torch.full((2,), 2.0))


def test_checkpoint_manager_forced_save_below_stale_steps_matches_orbax(
        tmp_path):
    """A fresh run in a directory that holds an older run's later steps,
    at the default keep: a forced save below them is the latest step, is
    not evicted and restores; a later plain save then goes through. At
    each point the steps kept, in their order, and the latest step are
    those of JAX's orbax manager on the same saves. One difference is
    pinned: a plain save of a stale step above the latest replaces it,
    where orbax raises."""
    def tree(step, xp=torch):
        return {"w": xp.full((2,), float(step)), "s": step}

    def both(make):
        return (make(tckpt.CheckpointManager, tmp_path / "port"),
                make(jckpt.CheckpointManager, tmp_path / "jax"))

    def steps(t, j):
        assert t.all_steps() == list(j.manager.all_steps())
        assert t.latest_step() == j.latest_step()
        return t.all_steps()

    old_t, old_j = both(lambda cls, d: cls(d))
    for step in range(3, 10):
        old_t.save(step, tree(step))
        old_j.save(step, tree(step, np))
    assert steps(old_t, old_j) == [5, 6, 7, 8, 9]
    t, j = both(lambda cls, d: cls(d))
    assert steps(t, j) == [5, 6, 7, 8, 9]
    assert not t.save(1, tree(1))
    j.save(1, tree(1, np))
    assert steps(t, j) == [5, 6, 7, 8, 9]
    for step in (1, 7):
        assert t.save(step, tree(-step), force=True)
        j.save(step, tree(-step, np), force=True)
    assert steps(t, j) == [6, 8, 9, 1, 7]
    assert t.restore(1)["s"] == -1 and t.restore(7)["s"] == -7
    # a plain save of a stale step above the latest: orbax refuses to
    # overwrite it; the port replaces it (it is this run's step now)
    with pytest.raises(Exception, match="already exists"):
        j.save(8, tree(8, np))
    assert t.save(8, tree(8)) and t.restore(8)["s"] == 8
    assert t.all_steps() == [6, 9, 1, 7, 8] and t.latest_step() == 8
    assert steps(*both(lambda cls, d: cls(d))) == [1, 6, 7, 8, 9]


# ---------------------------------------------------------- preemption
@pytest.mark.parametrize("guard_cls", [jpreempt.PreemptionGuard,
                                       tpreempt.PreemptionGuard])
def test_preemption_guard_latches_and_chains(guard_cls):
    """SIGTERM sets the flag and reaches the handler it replaced; the
    old handler is back after the block (the JAX guard beside the
    port's: the same behaviour)."""
    seen = []
    old = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with guard_cls() as guard:
            assert not guard.triggered
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.triggered
        assert seen == [signal.SIGTERM]
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM] * 2
    finally:
        signal.signal(signal.SIGTERM, old)


# --------------------------------------------------------------- viz
def test_viz_helpers_match_jax():
    """tensor_to_image and make_image_list give JAX's uint8 grid."""
    rng = np.random.default_rng(10)
    bs = [rng.uniform(-1.2, 1.2, (n, 8, 6, 3)).astype(np.float32)
          for n in (5, 6, 5)]
    np.testing.assert_array_equal(tviz.tensor_to_image(_t(bs[0][0])),
                                  jviz.tensor_to_image(bs[0][0]))
    np.testing.assert_array_equal(
        tviz.make_image_list([_t(b) for b in bs]), jviz.make_image_list(bs))
