"""The port's enhancer distillation (`models/sr/losses.py`,
`models/sr/vgg.py`, `train/distill_enhancer.py`,
`cli/distill_enhancer.py`) against ghost_tpu's, on the CPU in f32.

Inputs are made with numpy from a seed; JAX's modules get seeded
variables (`tests/test_torch_pipeline.py:_variables`) which the weight
bridge copies into the port. Bounds, with their reason:

  * the losses: 1e-6 relative (a few f32 sums);
  * VGG19Features: each slice within 1e-5 of its largest value (16 f32
    convs of up to 4608 products each, summed in another order);
  * `degrade`'s body on JAX's own draws (recomputed from the key as
    `ghost_tpu/train/distill_enhancer.py:93-122` splits it): 1e-6
    absolute on [0, 1] images, for every wobble branch and both final
    resizes; `_gaussian_blur` alone the same;
  * one distill step from a shared student: the loss terms 1e-5
    relative; Adam's moments within `grad_bound` (1e-2 of each
    tensor's largest value + 1e-6 of the largest over all: JAX's own
    f32 error, `tests/test_torch_train_step.py`), the second moment
    twice that; the parameters within 1e-6 + lr * min(2, 2 d / |g|)
    (Adam's first step moves each by lr * g / (|g| + eps), so an
    element whose gradient sign f32 leaves open may go either way);
  * both CLIs' `main` on the same seeded files in f32 (a `.pth`
    RealESRGAN_x4plus teacher at full size for background; for face a
    GFPGAN at out_size 64 as a converted msgpack, since the JAX CLI
    converts a `.pth` at 512 only), the student from JAX's init through
    --student_path, and JAX's degradation draws replayed into the port
    (a test-side patch of `degrade_draws`): step 0's l1 1e-5 relative;
    step 1's within 5x the port's own spread (its run with each batch's
    samples, and their draws, in the other order) + 1e-5; each CLI's
    student msgpack served by both packages within 1e-5.

JAX is imported inside the tests and fixtures that use it.
"""

import contextlib
import functools
import glob
import io

import numpy as np
import pytest
import torch

from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models.sr import losses as tlosses
from ghost_tpu_torch.models.sr.srvgg import (SRVGGNetCompact,
                                             srvgg_from_variables)
from ghost_tpu_torch.models.sr.vgg import (VGG19Features,
                                           convert_vgg19_features,
                                           imagenet_normalize_pm1)
from ghost_tpu_torch.train import distill_enhancer as tde
from torch_cli_inputs import gfpgan_state_dict, rrdb_state_dict, save_pth

STEP_LR = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# ---------------------------------------------------------------- losses


def _logit_lists(seed):
    rng = np.random.default_rng(seed)
    # two scales, each a list of features whose last entry is the logits
    return [[rng.normal(0, 1, (2, 6, 6, 4)).astype(np.float32),
             rng.normal(0, 1, (2, 5, 5, 1)).astype(np.float32)]
            for _ in range(2)]


@pytest.mark.parametrize("mode", ["ls", "original", "hinge", "wgan"])
def test_gan_loss_matches_jax(mode):
    """gan_loss on the per-scale lists and on a bare logits map, real and
    fake, for D and (where the mode has one) for G: 1e-6 relative."""
    import jax.numpy as jnp

    from ghost_tpu.models.sr import losses as jlosses

    outs = _logit_lists(1)
    cases = [(True, True), (False, True), (True, False)]
    for real, for_d in cases:
        want = jlosses.gan_loss([[jnp.asarray(a) for a in o] for o in outs],
                                real, mode, for_d)
        got = tlosses.gan_loss([[_t(a) for a in o] for o in outs], real,
                               mode, for_d)
        assert _rel(got, want) <= 1e-6, (mode, real, for_d)
        bare = tlosses.gan_loss(_t(outs[0][-1]), real, mode, for_d)
        assert _rel(bare, jlosses.gan_loss(jnp.asarray(outs[0][-1]), real,
                                           mode, for_d)) <= 1e-6
    with pytest.raises(ValueError):
        tlosses.gan_loss(_t(outs[0][-1]), True, "nope")


def test_feature_matching_vgg_and_kld_losses_match_jax():
    """feature_matching_loss over the intermediate features, vgg_loss over
    five feature maps with VGG_SLICE_WEIGHTS (the real features take no
    gradient in both), kld_loss: 1e-6 relative."""
    import jax.numpy as jnp

    from ghost_tpu.models.sr import losses as jlosses

    fake, real = _logit_lists(2), _logit_lists(3)
    want = jlosses.feature_matching_loss(
        [[jnp.asarray(a) for a in o] for o in fake],
        [[jnp.asarray(a) for a in o] for o in real])
    fx = [[_t(a).requires_grad_() for a in o] for o in fake]
    fr = [[_t(a).requires_grad_() for a in o] for o in real]
    got = tlosses.feature_matching_loss(fx, fr)
    assert _rel(got.detach(), want) <= 1e-6
    got.backward()
    assert fr[0][0].grad is None and fx[0][0].grad is not None

    rng = np.random.default_rng(4)
    x, y = (rng.normal(0, 1, (2, 8, 8, 3)).astype(np.float32)
            for _ in range(2))

    def jfeats(v):
        return [v * (i + 1) + jnp.sin(v) * i for i in range(5)]

    def tfeats(v):
        return [v * (i + 1) + torch.sin(v) * i for i in range(5)]

    want = jlosses.vgg_loss(jfeats, jnp.asarray(x), jnp.asarray(y))
    assert tlosses.VGG_SLICE_WEIGHTS == jlosses.VGG_SLICE_WEIGHTS
    assert _rel(tlosses.vgg_loss(tfeats, _t(x), _t(y)), want) <= 1e-6
    mu, logvar = (rng.normal(0, 0.5, (3, 16)).astype(np.float32)
                  for _ in range(2))
    assert _rel(tlosses.kld_loss(_t(mu), _t(logvar)),
                jlosses.kld_loss(jnp.asarray(mu), jnp.asarray(logvar))) <= 1e-6


@pytest.mark.parametrize("with_vgg", [False, True])
def test_multiscale_perceptual_color_loss_matches_jax(with_vgg):
    """The 4 bilinear scales (37x29: sizes that do not halve evenly) and,
    with a feature extractor, the mean feature MSE: 1e-6 relative."""
    import jax.numpy as jnp

    from ghost_tpu.models.sr import losses as jlosses

    rng = np.random.default_rng(5)
    x, y = (rng.uniform(-1, 1, (2, 37, 29, 3)).astype(np.float32)
            for _ in range(2))
    jv = (lambda v: [v * 2.0, jnp.tanh(v)]) if with_vgg else None
    tv = (lambda v: [v * 2.0, torch.tanh(v)]) if with_vgg else None
    want = jlosses.multiscale_perceptual_color_loss(jv, jnp.asarray(x),
                                                    jnp.asarray(y))
    got = tlosses.multiscale_perceptual_color_loss(tv, _t(x), _t(y))
    assert _rel(got, want) <= 1e-6


# ------------------------------------------------------------------- VGG


def _vgg19_state_dict(rng):
    """torchvision vgg19 `features.N.weight|bias` (convs at the indices
    that skip the ReLUs and pools), std 1/sqrt(fan_in)."""
    sd, cin, idx = {}, 3, 0
    for item in (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"):
        if item == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = (
            rng.standard_normal((item, cin, 3, 3), dtype=np.float32)
            / np.float32(np.sqrt(9 * cin)))
        sd[f"features.{idx}.bias"] = rng.normal(0, 0.05, item).astype(
            np.float32)
        cin, idx = item, idx + 2
    return sd


@pytest.fixture(scope="module")
def vgg():
    """The seeded VGG19 through both converters: JAX's apply, the
    port's module."""
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr import vgg as jvgg

    sd = _vgg19_state_dict(np.random.default_rng(6))
    jtree = jvgg.convert_vgg19_features(sd)
    ttree = convert_vgg19_features(sd)
    jmod = jvgg.VGG19Features(policy=JFULL)
    tmod = load_flax_variables(VGG19Features(policy=TFULL), ttree)
    return {"japply": lambda x: jmod.apply(jtree, x), "port": tmod,
            "jtree": jtree, "ttree": ttree}


def test_vgg19_features_match_jax(vgg):
    """Both converters give the same tree; the five relu slices of a 32x32
    imagenet-normalized batch within 1e-5 of each slice's largest."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.models.sr import vgg as jvgg

    jl = jax.tree_util.tree_leaves_with_path(vgg["jtree"])
    tl = jax.tree_util.tree_leaves_with_path(vgg["ttree"])
    assert [p for p, _ in jl] == [p for p, _ in tl] and len(jl) == 32
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), str(p))
    x = np.random.default_rng(7).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    xn = jvgg.imagenet_normalize_pm1(jnp.asarray(x))
    txn = imagenet_normalize_pm1(_t(x))
    assert float(np.abs(txn.numpy() - np.asarray(xn)).max()) <= 1e-6
    want = jax.jit(vgg["japply"])(xn)
    with torch.no_grad():
        got = vgg["port"](txn)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256), (2, 4, 4, 512),
        (2, 2, 2, 512)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * np.abs(w).max()


# ------------------------------------------------------------- degrade


def _jax_draws(key, shape, n_wobble=3):
    """JAX's draws of `degrade(key, ...)`, as
    ghost_tpu/train/distill_enhancer.py:93-122 makes them, in the port's
    DegradeDraws."""
    import jax

    b = shape[0]
    k_sig, k_wob, k_std, k_noise, k_method = jax.random.split(key, 5)
    return tde.DegradeDraws(
        sigma=_t(jax.random.uniform(k_sig, (b,), np.float32, 0.1, 2.5)),
        wobble=int(jax.random.randint(k_wob, (), 0, n_wobble)),
        std=_t(jax.random.uniform(k_std, (b, 1, 1, 1), np.float32, 0.0,
                                  0.06)),
        noise=_t(jax.random.normal(k_noise, shape, np.float32)),
        area=bool(jax.random.bernoulli(k_method, 0.5)))


def _keys_for_every_branch():
    """The first seeds whose keys take each (wobble, area) pair."""
    import jax

    found = {}
    for seed in range(400):
        d = _jax_draws(jax.random.key(seed), (1, 8, 8, 1))
        found.setdefault((d.wobble, d.area), seed)
        if len(found) == 6:
            return found
    raise AssertionError(f"branches found: {sorted(found)}")


def test_degrade_body_matches_jax_on_its_draws():
    """degrade_with on the draws JAX makes from a key against JAX's
    jitted degrade of that key, for each of the three wobble branches
    (1.0, 0.75 -> 24, 0.5 -> 16 of 32) with each final resize (area,
    bilinear to 8x8): 1e-6 absolute; and degrade's own draws from a
    torch.Generator give a different LQ for another seed, in [0, 1]."""
    import jax

    from ghost_tpu.train import distill_enhancer as jde

    hq = np.random.default_rng(8).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    fn = jax.jit(lambda k, x: jde.degrade(k, x, (8, 8)))
    for branch, seed in sorted(_keys_for_every_branch().items()):
        key = jax.random.key(seed)
        want = np.asarray(fn(key, hq))
        got = tde.degrade_with(_t(hq), _jax_draws(key, hq.shape), (8, 8))
        assert got.shape == want.shape == (2, 8, 8, 3)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-6, branch
    a, b = (tde.degrade(torch.Generator().manual_seed(s), _t(hq), (8, 8))
            for s in (0, 1))
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert float((a - b).abs().max()) > 1e-4


def test_gaussian_blur_matches_jax():
    """Per-image sigma (one below the 1e-3 floor), 11 taps, edge padding:
    1e-6 absolute."""
    import jax.numpy as jnp

    from ghost_tpu.train import distill_enhancer as jde

    x = np.random.default_rng(9).uniform(0, 1, (3, 12, 20, 3)).astype(
        np.float32)
    sigma = np.asarray([0.0, 0.7, 2.4], np.float32)
    want = np.asarray(jde._gaussian_blur(jnp.asarray(x), jnp.asarray(sigma)))
    got = tde._gaussian_blur(_t(x), _t(sigma)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6
    np.testing.assert_allclose(got[0], x[0], atol=1e-6)  # the floor


# ------------------------------------------------- teachers and students


def _student(num_feat, num_conv, upscale, seed, lq_hw=8):
    """A JAX SRVGG with seeded variables, and the port's twin."""
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr.srvgg import SRVGGNetCompact as JSRVGG
    from tests.test_torch_pipeline import _variables

    jmod = JSRVGG(num_feat=num_feat, num_conv=num_conv, upscale=upscale,
                  policy=JFULL)
    v = _variables(jmod, np.random.default_rng(seed), (1, lq_hw, lq_hw, 3))
    tmod = load_flax_variables(SRVGGNetCompact(
        num_feat=num_feat, num_conv=num_conv, upscale=upscale,
        policy=TFULL), v)
    return jmod, v, tmod


def test_face_wrapper_and_teacher_fn_match_jax():
    """face_student_wrapper (pm1 crop -> area to h/2 -> student -> pm1)
    within 1e-5 of the output's largest; make_teacher_fn
    unwraps a tuple output and clips to the teacher's range (pm1 here),
    with no gradient."""
    import jax.numpy as jnp

    from ghost_tpu.train import distill_enhancer as jde

    jmod, v, tmod = _student(8, 1, 2, seed=10)
    crop = np.random.default_rng(11).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jde.face_student_wrapper(jmod).apply(
        v, jnp.asarray(crop)))
    with torch.no_grad():
        got = tde.face_student_wrapper(tmod)(_t(crop)).numpy()
    assert got.shape == want.shape == crop.shape
    assert float(np.abs(got - want).max()) <= 1e-5 * np.abs(want).max()

    class JGfp:
        def apply(self, variables, x):
            return x * 3.0 - 1.5, None

    x = np.linspace(0, 1, 16, dtype=np.float32).reshape(1, 2, 8, 1)
    want = np.asarray(jde.make_teacher_fn(JGfp(), {}, out_range=(-1.0, 1.0))(
        jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    got = tde.make_teacher_fn(lambda t: (t * 3.0 - 1.5, None),
                              out_range=(-1.0, 1.0))(xt)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert float(got.min()) == -1.0 and float(got.max()) == 1.0


def test_self_distill_batch_fn_shapes():
    """HQ -> (lq, target): the degraded LQ and the teacher's output."""
    sample = tde.make_self_distill_batch_fn(
        lambda lq: torch.repeat_interleave(
            torch.repeat_interleave(lq, 2, 1), 2, 2), (8, 8))
    hq = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    lq, target = sample(torch.Generator().manual_seed(1), hq)
    assert lq.shape == (1, 8, 8, 3) and target.shape == (1, 16, 16, 3)


def _check_adam_step(opt, tmod, params0, jparams, jopt, lr):
    """The port's student and Adam state after one step against JAX's:
    the module docstring's bounds."""
    from tests.test_torch_train_step import (_adam, _as_port,
                                             _check_moments, _moments)
    from torch_train_parity import grad_bound

    adam = _adam(jopt)
    mu_want, nu_want = _as_port(tmod, adam.mu), _as_port(tmod, adam.nu)
    mu, nu = _moments(opt, tmod)
    _check_moments(mu, mu_want, 1.0, "mu")
    _check_moments(nu, nu_want, 2.0, "nu")
    want = _as_port(tmod, jparams)
    got = {k: v.detach().numpy() for k, v in tmod.state_dict().items()}
    # mu = (1 - b1) g: the gradient and its bound, from the moment
    grad = {k: w / 0.1 for k, w in mu_want.items()}
    bound = grad_bound(grad)
    for k, w in want.items():
        allowed = 1e-6 + lr * np.minimum(
            2.0, 2.0 * bound[k] / (np.abs(grad[k]) + 1e-30))
        assert (np.abs(got[k] - w) <= allowed).all(), k
        assert not np.array_equal(got[k], params0[k]), k  # it moved


@pytest.mark.parametrize("perceptual", [False, True])
def test_distill_step_matches_jax(perceptual, vgg):
    """One make_enhancer_distill_step step (Adam b1 0.9, no decay) from a
    shared SRVGG (8 features, 1 body conv, x2) on the same lq and target,
    plain L1 and with a VGG perceptual term (vgg_loss over the seeded
    VGG19, x0.1): the loss terms 1e-5 relative, moments and parameters
    as the module docstring says."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.models.sr import losses as jlosses
    from ghost_tpu.train import distill_enhancer as jde

    jmod, v, tmod = _student(8, 1, 2, seed=12)
    rng = np.random.default_rng(13)
    lq = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    kw = {}
    tkw = {}
    if perceptual:
        kw = dict(perceptual_fn=functools.partial(jlosses.vgg_loss,
                                                  vgg["japply"]),
                  perceptual_mult=0.1)
        tkw = dict(perceptual_fn=functools.partial(tlosses.vgg_loss,
                                                   vgg["port"]),
                   perceptual_mult=0.1)
    step, tx = jde.make_enhancer_distill_step(jmod, lr=STEP_LR, **kw)
    jparams, jopt, jmet = jax.jit(step)(v["params"], tx.init(v["params"]),
                                        jnp.asarray(lq), jnp.asarray(target))
    params0 = {k: t.detach().numpy().copy()
               for k, t in tmod.state_dict().items()}
    tstep, opt = tde.make_enhancer_distill_step(tmod, lr=STEP_LR, **tkw)
    met = tstep(_t(lq), _t(target))
    assert set(met) == set(jmet) == ({"l1", "loss", "perceptual"}
                                     if perceptual else {"l1", "loss"})
    for k in jmet:
        assert _rel(met[k], jmet[k]) <= 1e-5, k
    _check_adam_step(opt, tmod, params0, jparams, jopt, STEP_LR)


# ------------------------------------------------------------------ CLI


def _write_images(d, rng, n, size):
    import cv2

    d.mkdir()
    for i in range(n):
        cv2.imwrite(str(d / f"{i}.png"),
                    rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
    return str(d)


TASKS = {"background": dict(hq=32, upscale=4, lq=8),
         "face": dict(hq=64, upscale=2, lq=32)}


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """Seeded files: 3 pngs per task at its hq size; a full-size
    RealESRGAN_x4plus `.pth`; GFPGAN at out_size 64 as a `.pth` and as
    the converted msgpack; each task's student (4 features, 1 body conv)
    from JAX's init."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.convert.torch_loader import convert_gfpgan_state_dict
    from ghost_tpu.core.checkpoint import save_msgpack as jsave
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr.srvgg import SRVGGNetCompact as JSRVGG

    d = tmp_path_factory.mktemp("distill_cli")
    rng = np.random.default_rng(14)
    f = {"dir": d}
    for task, c in TASKS.items():
        f[f"{task}_images"] = _write_images(d / task, rng, 3, c["hq"])
        s = JSRVGG(num_feat=4, num_conv=1, upscale=c["upscale"],
                   policy=JFULL).init(jax.random.key(0),
                                      jnp.zeros((1, c["lq"], c["lq"], 3)))
        f[f"{task}_student"] = str(d / f"{task}_student.msgpack")
        jsave(f[f"{task}_student"], s)
    f["rrdb"] = str(d / "RealESRGAN_x4plus.pth")
    save_pth(f["rrdb"], rrdb_state_dict(rng), wrapper="params_ema")
    gfp = gfpgan_state_dict(rng, out_size=64)
    f["gfpgan_pth"] = str(d / "GFPGANv1.4_64.pth")
    save_pth(f["gfpgan_pth"], gfp, wrapper="params_ema")
    f["gfpgan"] = str(d / "gfpgan_64.msgpack")
    jsave(f["gfpgan"], convert_gfpgan_state_dict(gfp, out_size=64))
    return f


def _argv(files, task, out, steps=2):
    c = TASKS[task]
    teacher = files["rrdb"] if task == "background" else files["gfpgan"]
    return ["--task", task, "--dataset_path", files[f"{task}_images"],
            "--teacher_path", teacher, "--student_path",
            files[f"{task}_student"], "--out", str(out), "--steps",
            str(steps), "--hq_size", str(c["hq"]), "--batch_size", "2",
            "--student_feats", "4", "--student_convs", "1", "--save_every",
            "1", "--log_every", "1", "--bf16", "false"]


@contextlib.contextmanager
def _stdout():
    """The lines a block prints (filled when it ends)."""
    buf, lines = io.StringIO(), []
    with contextlib.redirect_stdout(buf):
        yield lines
    lines += buf.getvalue().splitlines()


def _jax_cli(files, task, out):
    """JAX's CLI `main`; every step's metrics through a spy on the jitted
    student step (the one jitted with donate_argnums=(0, 1)), and the
    draws its degrade made from the keys it split."""
    import jax

    from ghost_tpu.cli import distill_enhancer as jcli

    real_jit, metrics = jax.jit, []

    def spy_jit(fun, **kw):
        jf = real_jit(fun, **kw)
        if kw.get("donate_argnums") != (0, 1):
            return jf

        def call(*a):
            out = jf(*a)
            metrics.append({k: float(v) for k, v in out[2].items()})
            return out

        return call

    with pytest.MonkeyPatch.context() as mp, _stdout() as lines:
        mp.setattr(jax, "jit", spy_jit)
        jcli.main(_argv(files, task, out))
    c = TASKS[task]
    key, draws = jax.random.key(0), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, (2, c["hq"], c["hq"], 3)))
    return metrics, draws, lines


def _port_cli(files, task, out, draws, swap=False):
    """The port's CLI `main` on the CPU with JAX's draws replayed; every
    step's metrics through a spy on the step. With `swap`, each batch's
    samples (and their draws) in the other order."""
    from ghost_tpu_torch.cli import distill_enhancer as tcli

    draws, metrics = list(draws), []
    real_make, real_batches = tde.make_enhancer_distill_step, \
        tcli._image_batches

    def make(*a, **kw):
        step, opt = real_make(*a, **kw)

        def spy(lq, target):
            m = step(lq, target)
            metrics.append({k: float(v) for k, v in m.items()})
            return m

        return spy, opt

    def replay(generator, shape, *a, **kw):
        d = draws.pop(0)
        if swap:
            d = tde.DegradeDraws(d.sigma.flip(0), d.wobble, d.std.flip(0),
                                 d.noise.flip(0), d.area)
        return d

    def batches(*a):
        for b in real_batches(*a):
            yield b[::-1].copy() if swap else b

    with pytest.MonkeyPatch.context() as mp, _stdout() as lines:
        mp.setattr(tde, "degrade_draws", replay)
        mp.setattr(tde, "make_enhancer_distill_step", make)
        mp.setattr(tcli, "_image_batches", batches)
        tcli.main(_argv(files, task, out), device="cpu")
    assert not draws
    return metrics, lines


@pytest.fixture(scope="module")
def cli_runs(cli_files):
    out = {}
    for task in TASKS:
        d = cli_files["dir"]
        jm, draws, jl = _jax_cli(cli_files, task, d / f"{task}_jax.msgpack")
        tm, tl = _port_cli(cli_files, task, d / f"{task}_port.msgpack",
                           draws)
        sm, _ = _port_cli(cli_files, task, d / f"{task}_spread.msgpack",
                          draws, swap=True)
        out[task] = (jm, tm, sm, jl, tl)
    return out


@pytest.mark.parametrize("task", list(TASKS))
def test_cli_steps_match_jax(cli_runs, task):
    """Both CLIs' two steps on the same files and draws: step 0's l1 and
    loss within 1e-5 relative, step 1's within 5x the port's own spread
    + 1e-5; the same printed lines (the l1 values as 5 decimals within
    one unit of the last, the saved path aside)."""
    jm, tm, sm, jl, tl = cli_runs[task]
    assert len(jl) == len(tl) == 3
    for a, b in zip(jl[:2], tl[:2]):
        (ha, va), (hb, vb) = a.split("="), b.split("=")
        assert ha == hb and abs(float(va) - float(vb)) <= 1.01e-5, (a, b)
    assert jl[2].replace("_jax.", ".") == tl[2].replace("_port.", ".")
    assert len(jm) == len(tm) == len(sm) == 2
    for i, (j, t, s) in enumerate(zip(jm, tm, sm)):
        assert set(t) == set(j) == {"l1", "loss"}
        for k in j:
            bound = 1e-5 if i == 0 else 5 * _rel(s[k], t[k]) + 1e-5
            assert _rel(t[k], j[k]) <= bound, (i, k, t[k], j[k])


@pytest.mark.parametrize("task", list(TASKS))
def test_cli_students_load_in_both_packages(cli_files, cli_runs, task):
    """Each CLI's student msgpack, served by JAX (`load_msgpack` +
    SRVGGNetCompact.apply) and by the port (`srvgg_from_variables` +
    the bridge), on the same input: within 1e-5 of the output's largest;
    the port's file holds JAX's keys, shapes and dtypes."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.checkpoint import load_msgpack as jload
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr.srvgg import SRVGGNetCompact as JSRVGG
    from ghost_tpu_torch.core.checkpoint import load_msgpack as tload

    c, d = TASKS[task], cli_files["dir"]
    x = np.random.default_rng(15).uniform(0, 1, (1, 12, 12, 3)).astype(
        np.float32)
    trees = {}
    for side in ("jax", "port"):
        path = str(d / f"{task}_{side}.msgpack")
        jv = jload(path)
        want = np.asarray(JSRVGG(num_feat=4, num_conv=1, upscale=c["upscale"],
                                 policy=JFULL).apply(jv, jnp.asarray(x)))
        tv = tload(path)
        mod = load_flax_variables(srvgg_from_variables(tv, policy=TFULL), tv)
        assert mod.upscale == c["upscale"]
        with torch.no_grad():
            got = mod(_t(x)).numpy()
        assert float(np.abs(got - want).max()) <= 1e-5 * np.abs(want).max()
        trees[side] = jax.tree_util.tree_leaves_with_path(jv)
    assert [(p, a.shape, a.dtype) for p, a in trees["port"]] == \
        [(p, a.shape, a.dtype) for p, a in trees["jax"]]


def test_image_batches_match_jax(cli_files):
    """The host sampler: JAX's batches for the same seed bit for bit, on
    images larger than the patch (random crops) and equal to it
    (resized)."""
    from ghost_tpu.cli.distill_enhancer import _image_batches as jbatches
    from ghost_tpu_torch.cli.distill_enhancer import _image_batches

    for task, size in (("face", 48), ("background", 32)):
        paths = sorted(glob.glob(cli_files[f"{task}_images"] + "/*.png"))
        a, b = _image_batches(paths, size, 3, 5), jbatches(paths, size, 3, 5)
        for _ in range(3):
            x, y = next(a), next(b)
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_face_pth_teacher_reads_like_the_msgpack(cli_files):
    """The face task's `.pth` GFPGAN, converted at --hq_size, fills the
    teacher as its converted msgpack does, bit for bit."""
    from ghost_tpu_torch.cli.distill_enhancer import _load_teacher_vars
    from ghost_tpu_torch.convert.torch_loader import (
        convert_gfpgan_state_dict)
    from ghost_tpu_torch.models.sr.gfpgan import GFPGANClean

    conv = functools.partial(convert_gfpgan_state_dict, out_size=64)
    a, b = (_load_teacher_vars(cli_files[k], GFPGANClean(out_size=64,
                                                         policy=TFULL),
                               conv, False)
            for k in ("gfpgan_pth", "gfpgan"))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k


def test_parser_matches_jax():
    """Flag for flag: the same options, defaults, choices and parses."""
    from ghost_tpu.cli import distill_enhancer as jcli
    from ghost_tpu_torch.cli import distill_enhancer as tcli

    jp, tp = jcli.build_parser(), tcli.build_parser()
    key = lambda a: (tuple(a.option_strings), a.dest, a.default,  # noqa: E731
                     a.choices, a.required, a.nargs)
    assert [key(a) for a in tp._actions] == [key(a) for a in jp._actions]
    argv = ["--dataset_path", "d", "--out", "o", "--bf16", "0", "--task",
            "face", "--allow_random_weights", "--steps", "7"]
    assert vars(tp.parse_args(argv)) == vars(jp.parse_args(argv))


@pytest.mark.parametrize("case", ["missing_path", "no_opt_in", "no_card"])
def test_cli_refuses(cli_files, tmp_path, case, capsys):
    """An explicit missing --teacher_path exits even under
    --allow_random_weights; no teacher without the opt-in exits; the
    command line needs a card (where there is none); the random teacher
    warns as JAX's does."""
    from ghost_tpu_torch.cli import distill_enhancer as tcli

    argv = _argv(cli_files, "background", tmp_path / "s.msgpack", steps=1)
    i = argv.index("--teacher_path")
    if case == "missing_path":
        argv[i + 1] = str(tmp_path / "nope.pth")
        with pytest.raises(SystemExit, match="does not exist"):
            tcli.main(argv + ["--allow_random_weights"], device="cpu")
    elif case == "no_opt_in":
        del argv[i:i + 2]
        with pytest.raises(SystemExit, match="missing --teacher_path"):
            tcli.main(argv, device="cpu")
        tcli.main(argv + ["--allow_random_weights"], device="cpu")
        assert "WARNING: random teacher weights (smoke mode)" in \
            capsys.readouterr().out
    else:
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tcli.main(argv)


@pytest.mark.gpu
def test_distill_step_launches_s2_on_card():
    """One bf16 distill step of a narrow SRVGG (8 features, 2 body convs,
    x4) on the card: 4 S2 launches forward and 3 dx (the first conv reads
    the data, which needs no gradient), finite metrics, every student
    tensor moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from ghost_tpu_torch.core.precision import DEFAULT_POLICY
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.ops.cuda.conv3x3 import conv3x3

    student = init_weights(SRVGGNetCompact(num_feat=8, num_conv=2, upscale=4,
                                           policy=DEFAULT_POLICY),
                           torch.Generator().manual_seed(0)).cuda()
    before = {k: v.clone() for k, v in student.state_dict().items()}
    step, _ = tde.make_enhancer_distill_step(student)
    g = torch.Generator(device="cuda").manual_seed(0)
    lq = torch.rand(2, 16, 16, 3, generator=g, device="cuda")
    target = torch.rand(2, 64, 64, 3, generator=g, device="cuda")
    n0 = conv3x3.launches
    y = student(lq)
    torch.cuda.synchronize()
    assert conv3x3.launches - n0 == 4 and y.dtype == torch.bfloat16
    n0 = conv3x3.launches
    met = step(lq, target)
    torch.cuda.synchronize()
    assert conv3x3.launches - n0 == 4 + 3
    assert all(bool(torch.isfinite(v)) for v in met.values())
    for k, v in student.state_dict().items():
        assert v.dtype == torch.float32 and not torch.equal(v, before[k]), k
