"""The port's G/D train steps and loop against ghost_tpu's, on the CPU.

Config: JAX's own narrow one (tests/test_train_step.py): AEINet unet,
num_blocks=1, width 1/16, train=True; MultiscaleDiscriminator(ndf=8,
n_layers=3, num_D=2, instance norm); ArcFace (1,1,1,1); f32; B=2 at
256 px; seeded numpy weights (shapes by eval_shape) bridged into the port
with `convert/from_jax.py`, and seeded numpy batches.

The JAX side compiles three programs, once each, in the module fixture:
the canonical and the round_trip G steps and the D step (the loop test's
`train_loop` jits the same functions on the same shapes and reuses
them, as does its re-synced step). Of the distillation switches' totals,
teacher_inner_crop's and self_distill's come from one jitted program of
JAX's `g_loss_fn`s (forward only), the other three from the round_trip
step's terms.

Bounds, with their reason. Every loss term and total: 1e-4 relative (an
f32 forward through ~60 layers; measured <= 1e-6). BN running statistics:
1e-5 relative. Gradients, read as Adam's moments (b1 = 0: the first
moment is the decayed gradient): within 1e-2 of each leaf's largest value
plus 1e-6 of the largest over all leaves. That is JAX's own f32 error: at
D's full-resolution scale, whose first convs feed an instance norm over
65x65 pixels, JAX's f32 gradient sits 8.9e-3 of the leaf's largest from a
float64 run of the port (the port's f32 one 2e-6); in G the largest gap
measured is 8.9e-3 of a leaf's largest (the AAD mask biases in
round_trip, whose total is 1.5e6), and the biases in front of a norm have
a gradient that vanishes analytically, which f32 gives as rounding noise
(the global term). The second moment, the squared gradient: twice that.
Parameters after one Adam step, which moves each by lr * g / (|g| + eps)
(b1 = 0): within 1e-6 + lr * min(2, 2 * d / |g|), d the gradient's bound.
Where |g| is far above d the step is settled to rounding; where the sign
of g is not settled (|g| <= d, ~1e-4 of G's elements) the step can go
either way. Adam's step t moves an element by at most lr * c, c =
sqrt((1 - b2^t) / (1 - b2)), and a gradient error d by at most
lr * c * d / |g|: after step t the bound is c times step 1's. The loop test's later steps inherit those elements: see its
docstring.
"""

import copy
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghost_tpu.core.precision import FULL_PRECISION as JFULL
from ghost_tpu.models import aei as jaei
from ghost_tpu.models import arcface as jarc
from ghost_tpu.models import discriminator as jdisc
from ghost_tpu.train import loop as jloop
from ghost_tpu.train import losses as jL
from ghost_tpu.train import train_step as jts
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.checkpoint import CheckpointManager
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models import aei as taei
from ghost_tpu_torch.models import arcface as tarc
from ghost_tpu_torch.models import discriminator as tdisc
from ghost_tpu_torch.train import loop as tloop
from ghost_tpu_torch.train import train_step as tts
from ghost_tpu_torch.train.preempt import PreemptionGuard
from tests.test_torch_pipeline import _variables
from torch_train_parity import grad_bound, moments, state_tensors

B = 2
LR = 4e-4
SWITCHES = ("teacher_inner_crop", "teacher_fine_tune", "teacher_lower_signal",
            "without_teacher_loss", "self_distill")


def _batch(rng):
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    return {"xs": u(B, 256, 256, 3), "xt": u(B, 256, 256, 3),
            "embed": rng.standard_normal((B, 512)).astype(np.float32),
            "same_person": np.asarray([1.0, 0.0], np.float32),
            "teacher_y": u(B, 256, 256, 3)}


def _jmults():
    return {k: jnp.float32(v) for k, v in jts.default_distill_mults().items()}


@pytest.fixture(scope="module")
def models():
    """JAX modules, their seeded variables, and the port's twins."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    rng = np.random.default_rng(11)
    jg = jaei.AEINet(backbone="unet", num_blocks=1, policy=JFULL, train=True,
                     width=1 / 16)
    jd = jdisc.MultiscaleDiscriminator(ndf=8, n_layers=3, num_D=2,
                                       policy=JFULL)
    ja = jarc.IResNet(layers=(1, 1, 1, 1), policy=JFULL)
    gv = _variables(jg, rng, (1, 256, 256, 3), (1, 512))
    dv = _variables(jd, rng, (1, 256, 256, 3))
    av = _variables(ja, rng, (1, 112, 112, 3))
    arc = load_flax_variables(tarc.IResNet((1, 1, 1, 1), policy=TFULL,
                                           device="cpu"), av)
    arc.requires_grad_(False)
    teacher = load_flax_variables(taei.AEINet(
        "unet", num_blocks=1, policy=TFULL, width=1 / 16, device="cpu"), gv)
    teacher.requires_grad_(False)
    yield {"jg": jg, "jd": jd, "gv": gv, "dv": dv,
           "arc_apply": lambda x: ja.apply(av, x), "arc": arc,
           "teacher": lambda xt, z: teacher(xt, z)[0],
           "batches": [_batch(rng) for _ in range(6)]}
    torch.set_num_threads(prev)


def _port_state(m, cfg):
    g = load_flax_variables(taei.AEINet("unet", num_blocks=1, policy=TFULL,
                                        width=1 / 16, train=True,
                                        device="cpu"), m["gv"])
    d = load_flax_variables(tdisc.MultiscaleDiscriminator(
        ndf=8, n_layers=3, num_D=2, policy=TFULL, device="cpu"), m["dv"])
    return tts.init_train_state(g, d, cfg, device="cpu")


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_steps(models):
    """JAX's G step then D step from the initial state, per mode; the
    round_trip step functions (jitted) for the loop test."""
    m = models
    out = {}
    d_jit = None
    for mode in ("round_trip", "canonical"):
        cfg = jts.TrainStepConfig(mode=mode, d_interval=2)
        g_step, d_step = jts.make_train_steps(m["jg"], m["jd"], m["arc_apply"],
                                              cfg)
        if d_jit is None:
            # D's step reads no mode: one compile serves both
            out["rt_steps"] = (g_step, d_step)
            d_jit = jax.jit(d_step)
        s0 = jts.init_train_state(m["gv"], m["dv"], cfg)
        b = _jbatch(m["batches"][0])
        s1, metrics, y = jax.jit(g_step)(s0, b, _jmults())
        s2, loss_d = d_jit(s1, y, b["xs"])
        out[mode] = (s0, s1, metrics, s2, loss_d)
    return out


def _adam(opt_state):
    return next(s for s in opt_state if hasattr(s, "mu"))


def _as_port(template, params, stats=None):
    """A flax params (and stats) tree in the port's layout, by name."""
    mod = copy.deepcopy(template)
    v = {"params": params}
    if stats is not None:
        v["batch_stats"] = stats
    load_flax_variables(mod, v)
    return {k: t.detach().numpy() for k, t in mod.state_dict().items()}


def _moments(opt, module):
    return [{k: v.numpy() for k, v in moments(opt, module, key).items()}
            for key in ("exp_avg", "exp_avg_sq")]


def _bound(want, scale, spread):
    """grad_bound, or per leaf 5x the port's own spread where larger."""
    bound = grad_bound(want, scale)
    for k, e in (spread or {}).items():
        bound[k] = max(bound[k], 5 * e)
    return bound


def _check_moments(got, want, scale, what, spread=None):
    bound = _bound(want, scale, spread)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= bound[k], (what, k, err, bound[k])


def _check_params(got, want, grad, what, spread=None, t=1):
    """Parameters after Adam's step t; see the module docstring."""
    bound = _bound(grad, 1.0, spread)
    c = ((1 - 0.999 ** t) / (1 - 0.999)) ** 0.5
    for k, w in want.items():
        g = np.abs(grad[k])
        allowed = 1e-6 + LR * c * np.minimum(2.0,
                                             2.0 * bound[k] / (g + 1e-30))
        err = np.abs(got[k] - w)
        assert (err <= allowed).all(), (what, k, float(err.max()))


def _check_g_step(st, metrics, s0, s1, jm, spread=None):
    """The port's state and metrics after a G step against JAX's (s0
    before the step, s1 after): every loss term, the adversarial EMA,
    both Adam moments, G's parameters and BN running statistics, with
    the module docstring's bounds; `spread`, the port's state after the
    same step on the batch's samples in the other order, widens a
    leaf's gradient bound to 5x the port's own spread where that is
    larger."""
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(st.loss_adv_accumulated),
                               float(s1.loss_adv_accumulated), rtol=1e-5)
    g_want = _as_port(st.g, s1.g_params, s1.g_stats)
    g_got = {k: t.detach().numpy() for k, t in st.g.state_dict().items()}
    adam = _adam(s1.g_opt)
    mu_want = _as_port(st.g, adam.mu, s1.g_stats)
    nu_want = _as_port(st.g, adam.nu, s1.g_stats)
    mu, nu = _moments(st.g_opt, st.g)
    mu_want = {k: mu_want[k] for k in mu}
    e_mu = e_nu = None
    if spread is not None:
        s_mu, s_nu = _moments(spread.g_opt, spread.g)
        e_mu = {k: float(np.abs(s_mu[k] - v).max()) for k, v in mu.items()}
        e_nu = {k: float(np.abs(s_nu[k] - v).max()) for k, v in nu.items()}
    _check_moments(mu, mu_want, 1.0, "G mu", e_mu)
    _check_moments(nu, {k: nu_want[k] for k in nu}, 2.0, "G nu", e_nu)
    _check_params(g_got, {k: g_want[k] for k in mu}, mu_want, "G params",
                  e_mu, int(adam.count))
    stats = [k for k in g_want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(g_got[k], g_want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    before = _as_port(st.g, s0.g_params, s0.g_stats)
    assert any(np.abs(g_got[k] - before[k]).max() > 0 for k in stats)


@pytest.mark.parametrize("mode", ["canonical", "round_trip"])
def test_g_and_d_step_match_jax(models, jax_steps, mode):
    """One G step then one D step from the same state and batch: every
    loss term, G's parameters and BN running statistics, both Adam
    moments, the adversarial EMA; then lossD, D's parameters and moments.
    round_trip computes every distillation term as well."""
    m = models
    s0, s1, jm, s2, jloss_d = jax_steps[mode]
    cfg = tts.TrainStepConfig(mode=mode, d_interval=2)
    g_step, d_step = tts.make_train_steps(m["arc"], cfg)
    st = _port_state(m, cfg)
    b = _tbatch(m["batches"][0])
    st, metrics, y = g_step(st, b)
    assert st.step == 1 and int(s1.step) == 1
    _check_g_step(st, metrics, s0, s1, jm)

    st, loss_d = d_step(st, y, b["xs"])
    np.testing.assert_allclose(float(loss_d), float(jloss_d), rtol=1e-4)
    d_want = _as_port(st.d, s2.d_params)
    d_got = {k: t.detach().numpy() for k, t in st.d.state_dict().items()}
    adam = _adam(s2.d_opt)
    mu_want, nu_want = _as_port(st.d, adam.mu), _as_port(st.d, adam.nu)
    mu, nu = _moments(st.d_opt, st.d)
    _check_moments(mu, mu_want, 1.0, "D mu")
    _check_moments(nu, nu_want, 2.0, "D nu")
    _check_params(d_got, d_want, mu_want, "D params")


def test_round_trip_teacher_apply_matches_jax(models, jax_steps):
    """round_trip with the frozen teacher G given to the step, as the
    port's CLI gives it in `--mode roundtrip`: the port's `g_step` takes
    teacher_y from `teacher_apply` on (xt, embed); JAX's round_trip step
    reads it from the batch, filled here by JAX's frozen teacher (the
    same variables, eval mode) on the same (xt, embed). One G step from
    the same state, held with `_check_g_step`'s bounds."""
    m = models
    jt = jaei.AEINet(backbone="unet", num_blocks=1, policy=JFULL,
                     train=False, width=1 / 16)
    b = dict(m["batches"][0])
    b["teacher_y"] = np.asarray(jax.jit(
        lambda xt, z: jt.apply(m["gv"], xt, z)[0])(b["xt"], b["embed"]))
    cfg = tts.TrainStepConfig(mode="round_trip", d_interval=2)
    s0 = jts.init_train_state(m["gv"], m["dv"], cfg)
    s1, jm, _ = jax.jit(jax_steps["rt_steps"][0])(s0, _jbatch(b), _jmults())
    g_step, _ = tts.make_train_steps(m["arc"], cfg,
                                     teacher_apply=m["teacher"])
    st, metrics, _ = g_step(_port_state(m, cfg), _tbatch(
        {k: v for k, v in b.items() if k != "teacher_y"}))
    assert "L_teacher" in metrics
    _check_g_step(st, metrics, s0, s1, jm)


@pytest.fixture(scope="module")
def jax_switch_totals(models, jax_steps):
    """JAX's G objective for each distillation switch (mode distill) and
    for self_distill, on the round_trip step's batch and initial state,
    with the id multiplier ratcheted to 5.

    teacher_inner_crop and self_distill compute terms of their own (the
    cropped residual; the teacher G's output and its embedding): their
    g_loss_fns run in one jitted program (forward only). The other three
    switches only recombine terms that the round_trip step's g_loss_fn
    already computed (its aux: distill's terms on the same teacher_y, Y
    and G(Y)), by JAX's formula (ghost_tpu/train/train_step.py g_loss_fn,
    the distill branch)."""
    m = models
    mults = _jmults()
    mults["id"] = jnp.float32(5.0)  # a ratcheted multiplier
    fns = []
    for name in ("teacher_inner_crop", "self_distill"):
        if name == "self_distill":
            cfg = jts.TrainStepConfig(mode="self_distill")
            t_gen = jaei.AEINet(backbone="unet", num_blocks=1, policy=JFULL,
                                train=False, width=1 / 16)
            teacher = lambda xt, z: t_gen.apply(m["gv"], xt, z)[0]  # noqa
        else:
            cfg = jts.TrainStepConfig(mode="distill", **{name: True})
            teacher = None
        g_step, _ = jts.make_train_steps(m["jg"], m["jd"], m["arc_apply"],
                                         cfg, teacher_apply=teacher)
        # JAX's make_train_steps keeps g_loss_fn in g_step's closure
        cells = dict(zip(g_step.__code__.co_freevars,
                         (c.cell_contents for c in g_step.__closure__)))
        fns.append(cells["g_loss_fn"])
    state = jts.init_train_state(m["gv"], m["dv"], jts.TrainStepConfig())

    def totals(state, batch, mults):
        return [f(state.g_params, state, batch, mults)[0] for f in fns]

    out = dict(zip(("teacher_inner_crop", "self_distill"),
                   (float(t) for t in jax.jit(totals)(
                       state, _jbatch(m["batches"][0]), mults))))
    t = {k: float(v) for k, v in jax_steps["round_trip"][2].items()}
    mu = {k: float(v) for k, v in mults.items()}
    u = jL.GeneratorLossWeights().universal
    rest = (mu["id"] * t["L_id"] + mu["attr"] * t["L_attr"]
            + mu["adv"] * t["L_adv"])
    out["teacher_fine_tune"] = mu["teacher"] * 1000.0 * t["L_teacher"]
    out["teacher_lower_signal"] = u * (
        rest + 0.1 * t["L_id_hq"] + 0.5 * t["L_teacher"]
        + 50.0 * t["L_multi_round"])
    out["without_teacher_loss"] = u * (
        rest + mu["multi_round"] * t["L_multi_round"])
    return out


@pytest.mark.parametrize("name", SWITCHES)
def test_distill_switch_totals_match_jax(models, jax_switch_totals, name):
    """The G objective's total with each distillation switch (mode
    distill, teacher_y from the batch) and in self_distill (the frozen
    teacher G on Xt), as g_step computes it under the state's
    multipliers, the id one ratcheted to 5: 1e-4 relative of JAX's (the
    fixture says how each is had)."""
    m = models
    if name == "self_distill":
        cfg = tts.TrainStepConfig(mode="self_distill")
    else:
        cfg = tts.TrainStepConfig(mode="distill", **{name: True})
    g_step, _ = tts.make_train_steps(m["arc"], cfg,
                                     teacher_apply=m["teacher"])
    st = _port_state(m, cfg)
    st.mults = dict(tts.default_distill_mults(), id=5.0)
    _, metrics, _ = g_step(st, _tbatch(m["batches"][0]))
    np.testing.assert_allclose(float(metrics["lossG"]),
                               jax_switch_totals[name], rtol=1e-4)


class _SaveLog:
    """Records the loop's save calls; forwards them to a real manager."""

    def __init__(self, inner=None):
        self.inner, self.calls = inner, []

    def save(self, step, state, force=False):
        self.calls.append((step, force))
        if self.inner is not None:
            self.inner.save(step, state, force=force)


def test_train_loop_matches_jax(models, jax_steps, tmp_path):
    """train_loop for 3 steps, d_interval=2 (D at iterations 0 and 2),
    round_trip with the ratchets (distill=True), save_interval=2 and
    save_on_stop: the metrics seen at every step, the
    multipliers after every ratchet (equal: the ratchet compares the
    weighted terms with floors they are not near), the checkpoint calls
    (step 2, then step 2 forced at the stop) and the steps on disk, the
    grid files, and G's parameters at the end.

    After the first step the two runs hold G parameters that differ where
    a gradient's sign was not settled (measured: 16 elements, 1.5e-5 of
    G's, each by 2 * lr; see the module docstring), and Adam's next steps
    carry that through every gradient: unsynced, 37% of the elements part
    by more than 1e-5 after step 2, 87% after step 3. So the metrics of
    steps 1 and 2 are held to 1e-2 relative (measured: up to 3.5e-3,
    L_attr at step 2), step 0's to 1e-4. Step 2 is then held element by
    element: the port's state set to JAX's after iteration 0 (JAX's G and
    D steps on batch 0: the loop's first iteration) takes iteration 1
    with the loop's multipliers, under the single step's bounds (every
    loss term, the EMA, both moments, G's parameters and BN statistics),
    each leaf's gradient bound widened to 5x the port's own spread (the
    same synced step on the batch's samples in the other order) where
    that is larger: at step 2 f32 leaves the round_trip AAD mask weights'
    gradient (the total is 1.6e6) open by more than 1e-2 of the leaf's
    largest (measured 1.2e-2 from JAX's).
    """
    m = models
    g_step, d_step = jax_steps["rt_steps"]
    jcfg = jts.TrainStepConfig(mode="round_trip", d_interval=2)
    lcfg = dict(d_interval=2, print_interval=1, show_step=2, save_interval=2,
                distill=True, save_on_stop=True)
    seen = {"jax": [], "port": []}
    jlog = _SaveLog()
    js, _ = jloop.train_loop(
        jts.init_train_state(m["gv"], m["dv"], jcfg), g_step, d_step,
        m["batches"][:3],
        jloop.LoopConfig(output_dir=str(tmp_path / "jax"), **lcfg),
        checkpoint_manager=jlog, max_steps=3,
        on_step=lambda i, met, mu: seen["jax"].append((i, met, mu)))
    cfg = tts.TrainStepConfig(mode="round_trip", d_interval=2)
    tg, td = tts.make_train_steps(m["arc"], cfg)
    mgr = CheckpointManager(tmp_path / "ck")
    tlog = _SaveLog(mgr)
    ts, _ = tloop.train_loop(
        _port_state(m, cfg), tg, td, m["batches"][:3],
        tloop.LoopConfig(output_dir=str(tmp_path / "port"), **lcfg),
        checkpoint_manager=tlog, max_steps=3,
        on_step=lambda i, met, mu: seen["port"].append((i, met, mu)))

    assert [s[0] for s in seen["port"]] == [s[0] for s in seen["jax"]] \
        == [0, 1, 2]
    for (i, pm, pmu), (_, jmet, jmu) in zip(seen["port"], seen["jax"]):
        assert set(pm) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(pm[k], jmet[k], rtol=1e-4 if i == 0
                                       else 1e-2, err_msg=k)
        assert pmu == pytest.approx(jmu, rel=1e-6)
    assert "lossD" in seen["port"][0][1] and "lossD" in seen["port"][2][1]
    assert "lossD" not in seen["port"][1][1]
    assert seen["port"][-1][2]["id_hq"] > 3.0  # a ratchet fired
    assert tlog.calls == jlog.calls == [(2, False), (2, True)]
    assert mgr.all_steps() == [2]
    for side in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / side / "images")) == [
            "generated_ghost_0_000000.jpg", "generated_ghost_0_000002.jpg"]
    assert ts.step == 3 and int(js.step) == 3

    s2 = jax_steps["round_trip"][3]
    mults = seen["jax"][1][2]
    synced = []
    for batch in (m["batches"][1], {k: v[::-1].copy()
                                    for k, v in m["batches"][1].items()}):
        sync = _port_state(m, cfg)
        _load_jax_state(sync, s2, mults)
        synced.append(tg(sync, _tbatch(batch))[:2])
    (sync, metrics), (spread, _) = synced
    s3, jm, _ = jax.jit(g_step)(s2, _jbatch(m["batches"][1]),
                                {k: jnp.float32(v) for k, v in mults.items()})
    assert sync.step == int(s3.step) == 2
    _check_g_step(sync, metrics, s2, s3, jm, spread)


def _load_jax_state(st, js, mults):
    """Set the port's TrainState to JAX's: G's and D's parameters, G's BN
    statistics, Adam's moments and update counts, the step, the EMA; and
    the multipliers."""
    load_flax_variables(st.g, {"params": js.g_params,
                               "batch_stats": js.g_stats})
    load_flax_variables(st.d, {"params": js.d_params})
    for opt, mod, jopt, stats in ((st.g_opt, st.g, js.g_opt, js.g_stats),
                                  (st.d_opt, st.d, js.d_opt, None)):
        adam = _adam(jopt)
        mu, nu = _as_port(mod, adam.mu, stats), _as_port(mod, adam.nu, stats)
        opt.count = int(adam.count)
        for n, p in mod.named_parameters():
            opt.state[p] = {"step": torch.tensor(float(adam.count)),
                            "exp_avg": torch.from_numpy(mu[n].copy()),
                            "exp_avg_sq": torch.from_numpy(nu[n].copy())}
    st.step = int(js.step)
    st.loss_adv_accumulated = torch.tensor(float(js.loss_adv_accumulated))
    st.mults = dict(mults)


def _run(m, cfg, batches, lcfg, **kw):
    g_step, d_step = tts.make_train_steps(m["arc"], cfg)
    st = _port_state(m, cfg)
    return tloop.train_loop(st, g_step, d_step, batches, lcfg, **kw)[0]


def test_resume_from_step_3_is_bit_exact(models, tmp_path):
    """A distill run (ratchets on) of 5 iterations (D at 0, 2, 4) saves at
    step 3; a fresh state
    restored from it takes iteration 4 on the same batch: every parameter,
    BN statistic, Adam moment and step count, the EMA, the ratchets and
    the optimizers' update counts equal the uninterrupted run's, bit for
    bit."""
    m = models
    cfg = tts.TrainStepConfig(mode="distill", d_interval=2)
    lcfg = tloop.LoopConfig(d_interval=2, print_interval=100, show_step=10**9,
                            save_interval=3, distill=True)
    mgr = CheckpointManager(tmp_path / "ck")
    full = _run(m, cfg, m["batches"][:5], lcfg, checkpoint_manager=mgr,
                max_steps=5)
    assert mgr.all_steps() == [3]
    g_step, d_step = tts.make_train_steps(m["arc"], cfg)
    st = mgr.restore(3, like=_port_state(m, cfg))
    assert st.step == 4 and st.mults == mgr.restore(3)["mults"]
    resumed, _ = tloop.train_loop(st, g_step, d_step, m["batches"][4:5],
                                  lcfg, start_iteration=4, max_steps=5)
    assert resumed.step == full.step == 5
    assert resumed.mults == full.mults and full.mults["id_hq"] > 3.0
    assert resumed.g_opt.count == full.g_opt.count == 5
    assert resumed.d_opt.count == full.d_opt.count == 3
    a, b = state_tensors(full), state_tensors(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_preemption_saves_and_stops(models, tmp_path, capsys):
    """SIGTERM during iteration 1 (sent from the step observer): the loop
    saves a forced checkpoint of step 1 over a stale one of the same
    step, prints that it stopped, and returns after 2 G steps."""
    m = models
    cfg = tts.TrainStepConfig(mode="canonical", d_interval=2)
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, {"stale": True})
    mgr.save(7, {"stale": True})

    def kill_at_1(i, metrics, mults):
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    with PreemptionGuard() as guard:
        st = _run(m, cfg, m["batches"][:4],
                  tloop.LoopConfig(d_interval=2, print_interval=100,
                                   show_step=10**9, save_interval=100),
                  checkpoint_manager=mgr, preemption=guard,
                  on_step=kill_at_1)
    assert guard.triggered and st.step == 2
    assert "preemption signal; saved step 1" in capsys.readouterr().out
    saved = mgr.restore(1)
    assert "stale" not in saved and saved["step"] == 2
    assert mgr.all_steps() == [7, 1] and mgr.latest_step() == 1
    for k, v in st.g.state_dict().items():
        assert torch.equal(saved["g"][k], v), k


def test_no_batches_guard_and_factory(models, capsys):
    """A one-shot generator ends the run after its first pass with the
    guard's message; a zero-arg factory gives every epoch its batches."""
    m = models
    cfg = tts.TrainStepConfig(mode="canonical", d_interval=2)
    lcfg = tloop.LoopConfig(d_interval=2, print_interval=100,
                            show_step=10**9, max_epochs=3)
    st = _run(m, cfg, (b for b in m["batches"][:1]), lcfg)
    assert st.step == 1
    assert "no batches in epoch 1; stopping" in capsys.readouterr().out
    st = _run(m, cfg, lambda: iter(m["batches"][:1]), lcfg, max_steps=2)
    assert st.step == 2
