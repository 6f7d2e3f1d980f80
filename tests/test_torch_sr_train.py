"""The port's SR-training library (`models/sr/spade.py`'s training side,
`generator.py`'s HiFaceGAN and ContentAdaptiveSuppressor, `encoder.py`,
`registry.py`, `pix2pix.py`, `pretrain.py`) against ghost_tpu's, on the
CPU in f32, at the JAX tests' narrow configs (`SRConfig(ngf=4, ndf=4)`
at 64 px, `LIPEncoder(ngf=4, n_2xdown=3)` at 32 px).

JAX's modules get seeded variables (`tests/test_torch_pipeline.py:
_variables`) or their own `init`, which the weight bridge copies into
the port. Bounds, with their reason:

  * SpectralConv: the output, the stored (u, v) after two train-mode
    calls and the kernel's gradient within 1e-5 (a few f32 products);
    the gradient through the power iteration differs from the one with
    the iteration detached (what `torch.nn.utils.spectral_norm` gives);
  * forwards (HiFaceGAN, the suppressor, ConvEncoder, the noise
    predictors): 1e-4 of the output's largest value (f32 convs summed in
    another order);
  * train steps, each from a shared state (the port re-synced to JAX's
    parameters, statistics and Adam moments before each): the loss
    terms 1e-4 relative; the module's whole gradient (Adam's first
    moment, b1 = 0) within 5e-3 relative L2 of JAX's, the second moment
    within twice that. Not per element: ReLU's gradient jumps at 0, and
    a forward that differs from JAX's by f32 rounding (1e-6) moves the
    few pre-activations that sit near 0 across it, which the instance
    norm behind spreads over the channel (measured: 7e-6 at the first
    step, 1.2e-3 at the second, all of it in the LIP encoder; a conv
    bias ahead of a norm has an exact gradient of 0 and only noise).
    The parameters within 1e-6 + lr * c * min(2, 2 d / |g|), d the
    larger of `grad_bound` (1e-2 of each tensor's largest gradient +
    1e-6 of the largest over all, `tests/test_torch_train_step.py`) and
    the element's own gradient difference: Adam with b1 = 0 moves each
    element by about lr * sign(g), times c = sqrt((1 - b2^t) / (1 - b2))
    at step t, so an element whose gradient sign is left open may go
    either way. The spectral (u, v) within 1e-5 and the BatchNorm
    running statistics within 1e-5 of each tensor's largest value +
    1e-6;
  * SubAdd's adversary reads the ratio of noisy to clean features
    (`ghost_tpu/models/sr/pretrain.py:104`): its loss terms within 1e-4
    + 1e-6 max|f| / min|f_clean| relative, its running statistics within
    that of each tensor's largest value + 1e-6 (a feature near 0 in the
    denominator magnifies its f32 rounding; measured 2.5e-4 at a ratio
    of 1.7e3);
  * `Pix2PixSR.generate` leaves G's running statistics and stored (u, v)
    exactly as they were.

The VGG term runs on a small conv stand-in for `vgg_apply` (5 ReLU
conv features) written in both packages on the same numpy weights.
JAX is imported inside the fixtures and tests that use it.
"""

import copy
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ghost_tpu_torch.convert.from_jax import (flax_variables,
                                              load_flax_variables)
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models.sr import encoder as tenc
from ghost_tpu_torch.models.sr import generator as tgen
from ghost_tpu_torch.models.sr import pix2pix as tp2p
from ghost_tpu_torch.models.sr import pretrain as tpre
from ghost_tpu_torch.models.sr import registry as treg
from ghost_tpu_torch.models.sr import spade as tspade
from ghost_tpu_torch.nn.layers import frozen_batch_stats
from torch_train_parity import grad_bound

P2P_HW = 64
PRE_HW = 32
# a module's whole gradient (Adam's first moment), relative L2 to JAX's
GRAD_REL_L2 = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.detach().cpu().numpy()


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


def _variables(jmod, rng, *shapes):
    from tests.test_torch_pipeline import _variables as seeded

    return seeded(jmod, rng, *shapes)


# ------------------------------------------------------------ SpectralConv


def _spectral_pair(rng):
    """A seeded JAX SpectralConv (6 out, 3x3, train mode) and the port's
    on the bridged variables, with an input and a cotangent."""
    from ghost_tpu.models.sr import spade as jspade

    jm = jspade.SpectralConv(6, 3, update_stats=True)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    v = _variables(jm, rng, x.shape)
    tm = load_flax_variables(tspade.SpectralConv(4, 6, 3, 1,
                                                 update_stats=True), v)
    r = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    return jm, v, tm, x, r


def test_spectral_conv_power_iteration_matches_jax():
    """Two train-mode calls: each output and the stored (u, v) after it
    within 1e-5; then in eval mode (no iteration) on the stored pair."""
    import jax.numpy as jnp

    jm, v, tm, x, _ = _spectral_pair(np.random.default_rng(0))
    for _ in range(2):
        jy, upd = jm.apply(v, jnp.asarray(x), mutable=["spectral"])
        v = {**v, **upd}
        ty = tm(_t(x))
        _close(_np(ty), jy, 1e-5)
        assert np.abs(_np(tm.u) - np.asarray(upd["spectral"]["u"])).max() \
            <= 1e-5
        assert np.abs(_np(tm.v) - np.asarray(upd["spectral"]["v"])).max() \
            <= 1e-5
    tm.power_iteration = False
    jy = jm.clone(update_stats=False).apply(v, jnp.asarray(x))
    u0 = tm.u.clone()
    _close(_np(tm(_t(x))), jy, 1e-5)
    assert torch.equal(tm.u, u0)


def test_spectral_conv_gradient_flows_through_the_power_iteration():
    """d sum(y r) / d kernel within 1e-5 of JAX's (whose fresh u, v are
    not stop-gradiented before sigma), and away from the gradient with
    the iteration detached."""
    import jax
    import jax.numpy as jnp

    jm, v, tm, x, r = _spectral_pair(np.random.default_rng(1))

    def loss(k):
        params = {**v["params"], "kernel": k}
        y, _ = jm.apply({**v, "params": params}, jnp.asarray(x),
                        mutable=["spectral"])
        return jnp.sum(y * r)

    jg = np.asarray(jax.grad(loss)(v["params"]["kernel"])).transpose(
        3, 2, 0, 1)
    u0, v0 = tm.u.clone(), tm.v.clone()
    (g,) = torch.autograd.grad((tm(_t(x)) * _t(r)).sum(), tm.weight)
    _close(_np(g), jg, 1e-5)

    w = tm.weight.detach().clone().requires_grad_(True)
    w_mat = w.reshape(6, -1)
    with torch.no_grad():
        vd = F.normalize(w_mat.T @ u0, dim=0)
        ud = F.normalize(w_mat @ vd, dim=0)
    y = F.conv2d(_t(x).permute(0, 3, 1, 2), w / (ud @ (w_mat @ vd)),
                 tm.bias, 1, 1)
    (gd,) = torch.autograd.grad((y.permute(0, 2, 3, 1) * _t(r)).sum(), w)
    diff = float((gd - g).abs().max()) / float(g.abs().max())
    assert diff > 1e-2, diff


def test_spade_block_train_mode_matches_jax():
    """A SPADEResnetBlock with a learned shortcut in train mode: the
    output, the three spectral pairs and the three BatchNorms' running
    statistics after one call."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr import spade as jspade

    rng = np.random.default_rng(2)
    jm = jspade.SPADEResnetBlock(8, 4, train=True, policy=JFULL)
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    seg = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    v = _variables(jm, rng, x.shape, seg.shape)
    tm = load_flax_variables(tspade.SPADEResnetBlock(8, 4, train=True,
                                                     policy=TFULL), v)
    jy, upd = jax.jit(lambda v, x, seg: jm.apply(
        v, x, seg, mutable=["spectral", "batch_stats"]))(
            v, jnp.asarray(x), jnp.asarray(seg))
    _close(_np(tm(_t(x), _t(seg))), jy, 1e-4)
    want = copy.deepcopy(tm)
    load_flax_variables(want, {"params": v["params"], **upd})
    for (k, a), b in zip(tm.named_buffers(), want.buffers()):
        assert np.abs(_np(a) - _np(b)).max() <= _stat_tol(_np(b)), k


# ------------------------------------------------------------ generators


def _hifacegan(rng, train):
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr import generator as jgen

    jm = jgen.HiFaceGANGenerator(ngf=4, train=train, policy=JFULL)
    x = rng.uniform(-1, 1, (2, P2P_HW, P2P_HW, 3)).astype(np.float32)
    v = _variables(jm, rng, x.shape)
    # a small to_rgb keeps tanh off its saturated tails
    v["params"]["to_rgb"]["Conv_0"]["kernel"] = \
        v["params"]["to_rgb"]["Conv_0"]["kernel"] * 0.02
    tm = load_flax_variables(tgen.HiFaceGANGenerator(ngf=4, train=train,
                                                     policy=TFULL), v)
    return jm, v, tm, x


@pytest.mark.parametrize("train", [False, True])
def test_hifacegan_matches_jax(train):
    """HiFaceGAN at ngf 4 on 64 px, within 1e-4: in train mode the image
    (batch statistics keep it off tanh's flat tails) and every BatchNorm
    statistic and spectral pair after the call; in eval mode, where the
    seeded running statistics and (u, v) let the activations grow block
    by block until tanh saturates, the last block's output."""
    import jax
    import jax.numpy as jnp

    jm, v, tm, x = _hifacegan(np.random.default_rng(3), train)
    mutable = ["spectral", "batch_stats"] if train else ["intermediates"]
    jy, upd = jax.jit(lambda v, x: jm.apply(
        v, x, mutable=mutable,
        capture_intermediates=lambda m, _: m.name == "ups_3"))(
            v, jnp.asarray(x))
    seen = []
    hook = tm.ups_3.register_forward_hook(lambda m, i, o: seen.append(o))
    ty = tm(_t(x))
    hook.remove()
    if not train:
        jy, ty = upd["intermediates"]["ups_3"]["__call__"][0], seen[0]
    else:
        assert float(np.asarray(jy).std()) < 0.5  # not saturated
    _close(_np(ty), jy, 1e-4)
    if train:
        want = copy.deepcopy(tm)
        load_flax_variables(want, {"params": v["params"], **upd})
        for (k, a), b in zip(tm.named_buffers(), want.buffers()):
            assert np.abs(_np(a) - _np(b)).max() <= _stat_tol(_np(b)), k


def test_content_adaptive_suppressor_matches_jax():
    """The suppressor's 6 maps, smallest first, each within 1e-4."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr import generator as jgen

    rng = np.random.default_rng(4)
    jm = jgen.ContentAdaptiveSuppressor(ngf=4, policy=JFULL)
    x = rng.uniform(-1, 1, (2, P2P_HW, P2P_HW, 3)).astype(np.float32)
    v = _variables(jm, rng, x.shape)
    tm = load_flax_variables(tgen.ContentAdaptiveSuppressor(
        ngf=4, policy=TFULL), v)
    jf = jax.jit(jm.apply)(v, jnp.asarray(x))
    tf = tm(_t(x))
    assert [tuple(t.shape) for t in tf] == [a.shape for a in jf]
    assert [t.shape[1] for t in tf] == [2, 4, 8, 16, 32, 64]
    for a, b in zip(jf, tf):
        _close(_np(b), a, 1e-4)


def test_conv_encoder_matches_jax():
    """ConvEncoder (ndf 8, z 16) on 64 px: mu and logvar within 1e-4;
    the dense heads read the NHWC flatten."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr.encoder import ConvEncoder

    rng = np.random.default_rng(5)
    jm = ConvEncoder(ndf=8, z_dim=16, policy=JFULL)
    x = rng.uniform(-1, 1, (2, P2P_HW, P2P_HW, 3)).astype(np.float32)
    v = _variables(jm, rng, x.shape)
    tm = load_flax_variables(tenc.ConvEncoder(ndf=8, z_dim=16, policy=TFULL,
                                              image_size=P2P_HW), v)
    jmu, jlv = jax.jit(jm.apply)(v, jnp.asarray(x))
    tmu, tlv = tm(_t(x))
    assert tmu.shape == tlv.shape == (2, 16)
    _close(_np(tmu), jmu, 1e-4)
    _close(_np(tlv), jlv, 1e-4)


@pytest.mark.parametrize("kind", ["g", "d", "e"])
def test_registry_tables_and_errors_match_jax(kind):
    """The same names in each table, a name looked up case-blind, and an
    unknown name's KeyError word for word."""
    from ghost_tpu.models.sr import registry as jreg

    table = {"g": "GENERATORS", "d": "DISCRIMINATORS", "e": "ENCODERS"}[kind]
    assert sorted(getattr(treg, table)) == sorted(getattr(jreg, table))
    define_t, define_j = (getattr(m, f"define_{kind}") for m in (treg, jreg))
    with pytest.raises(KeyError) as tj:
        define_j("NoSuch")
    with pytest.raises(KeyError) as tt:
        define_t("NoSuch")
    assert str(tt.value) == str(tj.value)
    first = sorted(getattr(treg, table))[0]
    built = define_t(first.upper(), policy=TFULL)
    assert type(built) is getattr(treg, table)[first]


# ----------------------------------------------------------- Pix2PixSR


VGG_PLAN = ((3, 4, 1), (4, 4, 2), (4, 8, 2), (8, 8, 2), (8, 8, 2))


def _vgg_standin():
    """(JAX vgg_apply, port vgg_apply): 5 ReLU 3x3 conv features (the
    strides of VGG_PLAN) on the same seeded weights."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(40)
    ws = [rng.normal(0, 0.4, (3, 3, a, b)).astype(np.float32)
          for a, b, _ in VGG_PLAN]

    def japply(x):
        feats = []
        for w, (_, _, s) in zip(ws, VGG_PLAN):
            x = jax.nn.relu(jax.lax.conv_general_dilated(
                x, jnp.asarray(w), (s, s), ((1, 1), (1, 1)),
                dimension_numbers=("NHWC", "HWIO", "NHWC")))
            feats.append(x)
        return feats

    tws = [_t(w.transpose(3, 2, 0, 1)) for w in ws]

    def tapply(x):
        feats, h = [], x.permute(0, 3, 1, 2)
        for w, (_, _, s) in zip(tws, VGG_PLAN):
            h = torch.relu(F.conv2d(h, w, None, s, 1))
            feats.append(h.permute(0, 2, 3, 1))
        return feats

    return japply, tapply


def _params_of(template, tree, extra=None):
    """A flax params tree in the port's layout, by parameter name."""
    mod = copy.deepcopy(template)
    load_flax_variables(mod, {"params": tree, **(extra or {})})
    return {k: p.detach().clone() for k, p in mod.named_parameters()}


def _sync(state, jstate, model):
    """The port's train state set to JAX's: G's and D's variables, both
    Adam states (moments and count)."""
    load_flax_variables(state.gen, {"params": jstate.g_params,
                                    **jstate.g_extra})
    load_flax_variables(state.disc, {"params": jstate.d_params})
    for mod, opt, jopt, extra in ((state.gen, state.g_opt, jstate.g_opt,
                                   jstate.g_extra),
                                  (state.disc, state.d_opt, jstate.d_opt,
                                   None)):
        adam = _adam_state(jopt)
        opt.state.clear()
        if int(adam.count) == 0:
            continue
        mu, nu = (_params_of(mod, t, extra) for t in (adam.mu, adam.nu))
        for k, p in mod.named_parameters():
            opt.state[p] = {"step": torch.tensor(float(adam.count)),
                            "exp_avg": mu[k].clone(),
                            "exp_avg_sq": nu[k].clone()}


def _adam_state(opt_state):
    """optax's Adam state (its moments), wherever the chain nests it."""
    import jax

    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))


def _rel_l2(got, want):
    num = sum(float(np.square(got[k] - w).sum()) for k, w in want.items())
    return math.sqrt(num / sum(float(np.square(w).sum())
                               for w in want.values()))


def _check_adam(opt, mod, jopt, jparams, extra, lr, t, b2=0.9):
    """Moments and parameters after Adam's step t + 1 (b1 = 0: the first
    moment is the gradient, and the decay where there is one): the
    module docstring's bounds."""
    adam = _adam_state(jopt)
    names = {id(p): n for n, p in mod.named_parameters()}
    got_mu = {names[id(p)]: _np(s["exp_avg"]) for p, s in opt.state.items()}
    got_nu = {names[id(p)]: _np(s["exp_avg_sq"])
              for p, s in opt.state.items()}
    grad = {k: _np(v) for k, v in _params_of(mod, adam.mu, extra).items()}
    nu = {k: _np(v) for k, v in _params_of(mod, adam.nu, extra).items()}
    assert _rel_l2(got_mu, grad) <= GRAD_REL_L2
    assert _rel_l2(got_nu, nu) <= 2 * GRAD_REL_L2
    bound = grad_bound(grad)
    c = math.sqrt((1 - b2 ** (t + 1)) / (1 - b2))
    want = _params_of(mod, jparams, extra)
    for k, p in mod.named_parameters():
        d = np.maximum(bound[k], np.abs(got_mu[k] - grad[k]))
        allowed = 1e-6 + lr * c * np.minimum(
            2.0, 2.0 * d / (np.abs(grad[k]) + 1e-30))
        assert (np.abs(_np(p) - _np(want[k])) <= allowed).all(), k


def _check_g_extra(gen, extra):
    """G's spectral pairs (1e-5) and running statistics (1e-5 relative +
    1e-7) against JAX's updated collections."""
    want = copy.deepcopy(gen)
    load_flax_variables(want, {"params": flax_variables(gen)["params"],
                               **extra})
    wb = dict(want.named_buffers())
    for k, b in gen.named_buffers():
        w = _np(wb[k])
        tol = 1e-5 if k.endswith((".u", ".v")) else _stat_tol(w)
        assert (np.abs(_np(b) - w) <= tol).all(), k


def _stat_tol(w):
    """A running statistic's bound: 1e-5 of the tensor's largest value +
    1e-6 (its f32 error scales with the data it averages, not with
    itself: a mean near 0 of values near 1)."""
    return 1e-5 * float(np.abs(w).max()) + 1e-6


@pytest.fixture(scope="module")
def p2p():
    """JAX's Pix2PixSR(SRConfig(ngf=4, ndf=4), train=True) at 64 px with
    the VGG stand-in: two jitted G + D steps from seeded variables on
    seeded batches; every state kept."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr import pix2pix as jp2p

    japply, tapply = _vgg_standin()
    cfg = dict(ngf=4, ndf=4)
    jmodel = jp2p.Pix2PixSR(jp2p.SRConfig(**cfg), policy=JFULL,
                            vgg_apply=japply, train=True)
    # seeded variables in the state `init` builds (flax's own init would
    # compile G and D once more)
    rng = np.random.default_rng(41)
    shape = (2, P2P_HW, P2P_HW, 3)
    g_vars = _variables(jmodel.gen, rng, shape)
    d_params = _variables(jmodel.disc, rng, shape[:3] + (6,))["params"]
    g_tx, d_tx = jmodel.optimizers()
    s = jp2p.SRTrainState(
        step=jnp.int32(0), g_params=g_vars["params"],
        g_extra={k: v for k, v in g_vars.items() if k != "params"},
        d_params=d_params, g_opt=g_tx.init(g_vars["params"]),
        d_opt=d_tx.init(d_params))
    g_step, d_step = (jax.jit(f) for f in jmodel.make_steps())
    batches = [tuple(rng.uniform(-1, 1, shape).astype(np.float32)
                     for _ in range(2)) for _ in range(2)]
    steps = []
    for deg, real in batches:
        s1, m, gen = g_step(s, jnp.asarray(deg), jnp.asarray(real))
        s2, ld = d_step(s1, jnp.asarray(deg), gen, jnp.asarray(real))
        steps.append((s, s1, m, gen, s2, ld))
        s = s2
    model = tp2p.Pix2PixSR(tp2p.SRConfig(**cfg), policy=TFULL,
                           vgg_apply=tapply, train=True)
    return dict(steps=steps, batches=batches, model=model)


def _port_state(model, jstate):
    state = model.init(None, "cpu", modules=model.build("cpu"))
    _sync(state, jstate, model)
    return state


@pytest.mark.parametrize("t", [0, 1])
def test_pix2pix_steps_match_jax(p2p, t):
    """G step t and D step t, each from JAX's state before it: the loss
    terms, `generated`, G's update with its spectral pairs and running
    statistics, D's update and loss."""
    model = p2p["model"]
    s, s1, jm, jgen, s2, jld = p2p["steps"][t]
    deg, real = (_t(a) for a in p2p["batches"][t])
    state = _port_state(model, s)
    g_step, d_step = model.make_steps()
    state, met, gen = g_step(state, deg, real)
    assert set(met) == set(jm) == {"GAN", "GAN_Feat", "VGG"}
    for k in jm:
        assert _rel(met[k], jm[k]) <= 1e-4, k
    _close(_np(gen), jgen, 1e-4)
    assert state.step == 1
    _check_adam(state.g_opt, state.gen, s1.g_opt, s1.g_params, s1.g_extra,
                model.cfg.lr / 2, t)
    _check_g_extra(state.gen, s1.g_extra)
    _sync(state, s1, model)
    state, ld = d_step(state, deg, _t(np.asarray(jgen)), real)
    assert _rel(ld, jld) <= 1e-4
    _check_adam(state.d_opt, state.disc, s2.d_opt, s2.d_params, None,
                model.cfg.lr * 2, t)


def test_pix2pix_generate_keeps_g_state(p2p):
    """`generate` in train mode: JAX's output within 1e-4 (JAX's
    `generate` is the G apply of its step with the updates thrown away,
    so the first step's `generated`), and every running statistic and
    spectral pair of G exactly as before it."""
    model = p2p["model"]
    s, _, _, jgen, _, _ = p2p["steps"][0]
    state = _port_state(model, s)
    before = {k: b.clone() for k, b in state.gen.named_buffers()}
    out = model.generate(state, _t(p2p["batches"][0][0]))
    _close(_np(out), jgen, 1e-4)
    for k, b in state.gen.named_buffers():
        assert torch.equal(b, before[k]), k
    # the same call outside generate moves them
    with torch.no_grad():
        state.gen(_t(p2p["batches"][0][0]))
    assert any(not torch.equal(b, before[k])
               for k, b in state.gen.named_buffers())
    with frozen_batch_stats(state.gen):
        assert all(not getattr(m, "update_stats", False)
                   for m in state.gen.modules())


# ------------------------------------------------------------ pretraining


@pytest.fixture(scope="module")
def pre():
    """JAX's LIPEncoder(ngf=4, n_2xdown=3) at 32 px and a
    NoiseIntensityPredictor on its maps, seeded, with a batch."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr.generator import LIPEncoder
    from ghost_tpu.models.sr.pretrain import NoiseIntensityPredictor

    rng = np.random.default_rng(50)
    enc = LIPEncoder(ngf=4, n_2xdown=3, policy=JFULL)
    x = (2, PRE_HW, PRE_HW, 3)
    e_vars = _variables(enc, rng, x)
    fshape = jax.eval_shape(enc.apply, e_vars, jnp.zeros(x)).shape
    disc = NoiseIntensityPredictor(sw=fshape[1], policy=JFULL)
    d_vars = _variables(disc, rng, fshape)
    clean = rng.uniform(-1, 1, x).astype(np.float32)
    noisy = (clean + 0.3 * rng.standard_normal(x)).astype(np.float32)
    label = np.asarray([0.5, 0.25], np.float32)
    return dict(enc=enc, e_vars=e_vars, disc=disc, d_vars=d_vars,
                fshape=fshape, clean=clean, noisy=noisy, label=label)


def _port_encoder(e_vars):
    return load_flax_variables(tgen.LIPEncoder(ngf=4, n_2xdown=3,
                                               policy=TFULL), e_vars)


def _port_predictor(cls, fshape, d_vars, **kw):
    return load_flax_variables(cls(sw=fshape[1], policy=TFULL,
                                   in_ch=fshape[-1], **kw), d_vars)


@pytest.mark.parametrize("kind", ["intensity", "class"])
def test_noise_predictors_match_jax(pre, kind):
    """Train-mode heads on the encoder's map: the output within 1e-4 and
    the BatchNorm running statistics after the call."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr import pretrain as jpre

    rng = np.random.default_rng(51)
    fshape = (4, 8, 8, 32)  # one stride-2 down to 4x4
    f = rng.normal(size=fshape).astype(np.float32)
    jcls, tcls, kw = {
        "intensity": (jpre.NoiseIntensityPredictor,
                      tpre.NoiseIntensityPredictor, {}),
        "class": (jpre.NoiseClassPredictor, tpre.NoiseClassPredictor,
                  {"outdim": 3})}[kind]
    jm = jcls(sw=8, policy=JFULL, **kw)
    v = _variables(jm, rng, fshape)
    tm = _port_predictor(tcls, fshape, v, **kw)
    jy, upd = jax.jit(lambda v, f: jm.apply(v, f, mutable=["batch_stats"]))(
        v, jnp.asarray(f))
    ty = tm(_t(f))
    assert tuple(ty.shape) == jy.shape
    _close(_np(ty), jy, 1e-4)
    want = copy.deepcopy(tm)
    load_flax_variables(want, {"params": v["params"], **upd})
    for (k, a), b in zip(tm.named_buffers(), want.buffers()):
        assert (np.abs(_np(a) - _np(b)) <= _stat_tol(_np(b))).all(), k


def test_subadd_steps_match_jax(pre):
    """One encoder step, then one adversary step from the encoder JAX's
    step gave: the metrics, both Adam updates (the encoder at lr / 2,
    the adversary at lr * 2 / 2) and the adversary's statistics, moved
    twice."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.models.sr.pretrain import make_subadd_pretrain_steps

    enc, disc = pre["enc"], pre["disc"]
    e_step, d_step, e_tx, d_tx = make_subadd_pretrain_steps(
        lambda p, x: enc.apply({"params": p}, x), disc)
    e_params, d_vars = pre["e_vars"]["params"], pre["d_vars"]
    c, n, lab = (jnp.asarray(pre[k]) for k in ("clean", "noisy", "label"))
    e2, e_opt, em = jax.jit(e_step)(e_params, e_tx.init(e_params), d_vars,
                                    c, n)
    d2, d_opt, dm = jax.jit(d_step)(d_vars, d_tx.init(d_vars["params"]), e2,
                                    c, n, lab)

    tenc_ = _port_encoder(pre["e_vars"])
    tdisc = _port_predictor(tpre.NoiseIntensityPredictor, pre["fshape"],
                            d_vars)
    stats0 = {k: b.clone() for k, b in tdisc.named_buffers()}
    te, td, te_opt, td_opt = tpre.make_subadd_pretrain_steps(tenc_, tdisc)
    assert (te_opt.param_groups[0]["lr"], td_opt.param_groups[0]["lr"]) \
        == (1e-4, 2e-4)
    tc, tn, tl = (_t(pre[k]) for k in ("clean", "noisy", "label"))
    met = te(tc, tn)
    assert set(met) == set(em)
    for k in em:
        assert _rel(met[k], em[k]) <= 1e-4, k
    for k, b in tdisc.named_buffers():
        assert torch.equal(b, stats0[k]), k  # the encoder step keeps them
    # GhostAdam: b2 0.999, decay 1e-4 added to the gradient before the
    # moments, as optax's `ghost_adam` chain adds it
    _check_adam(te_opt, tenc_, e_opt, e2, None, 1e-4, t=0, b2=0.999)
    load_flax_variables(tenc_, {"params": e2})
    met = td(tc, tn, tl)
    assert set(met) == set(dm)
    # the adversary reads noisy / (clean + 1e-6) features: a feature's
    # f32 rounding (1e-6 of the largest) grows by max|f| / min|f_clean|
    feats = np.asarray(jax.jit(enc.apply)({"params": e2},
                                          jnp.concatenate([c, n])))
    cond = np.abs(feats).max() / np.abs(feats[:c.shape[0]]).min()
    for k in dm:
        assert _rel(met[k], dm[k]) <= 1e-4 + 1e-6 * cond, k
    _check_adam(td_opt, tdisc, d_opt, d2["params"],
                {"batch_stats": d2["batch_stats"]}, 2e-4, t=0, b2=0.999)
    want = copy.deepcopy(tdisc)
    load_flax_variables(want, d2)
    for (k, a), b in zip(tdisc.named_buffers(), want.buffers()):
        tol = (1e-4 + 1e-6 * cond) * float(b.abs().max()) + 1e-6
        assert (np.abs(_np(a) - _np(b)) <= tol).all(), k


def test_contrasive_step_matches_jax(pre):
    """One contrasive step: the loss 1e-4 relative, the encoder's Adam
    update; identical views give a zero loss."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.models.sr.pretrain import make_contrasive_pretrain_step

    enc = pre["enc"]
    step, tx = make_contrasive_pretrain_step(
        lambda p, x: enc.apply({"params": p}, x))
    p0 = pre["e_vars"]["params"]
    p1, opt, loss = jax.jit(step)(p0, tx.init(p0), jnp.asarray(pre["clean"]),
                                  jnp.asarray(pre["noisy"]))
    tenc_ = _port_encoder(pre["e_vars"])
    tstep, topt = tpre.make_contrasive_pretrain_step(tenc_)
    got = tstep(_t(pre["clean"]), _t(pre["noisy"]))
    assert _rel(got, loss) <= 1e-4
    _check_adam(topt, tenc_, opt, p1, None, 2e-4, t=0, b2=0.999)
    same = tpre.make_contrasive_pretrain_step(_port_encoder(pre["e_vars"]))[0]
    assert float(same(_t(pre["clean"]), _t(pre["clean"]))) < 1e-6
