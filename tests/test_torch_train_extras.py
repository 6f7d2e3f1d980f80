"""The port's auxiliary trainers (`train/extra_trainers.py`,
`cli/train_extras.py`) and the weight bridge's inverse
(`convert/from_jax.py:flax_variables`) against ghost_tpu's, on the CPU
in f32.

The inverse bridge: seeded flax trees (`tests/test_torch_pipeline.py:
_variables`) of SRVGG, AEINet (params and batch_stats), the multiscale
discriminator, RRDBNet, LIPSPADE (spectral, SPADE's bare flax layers),
IResNet and Landmark106 (a bare BatchNorm, a bare Dense) go through
`load_flax_variables` and back, bit for bit, with the keys, shapes and
dtypes of JAX's `init` tree.

The CLIs: both `main`s in each mode with `tests/test_train_extras_cli.py`'s
flags (batch 2, 1 step, AEI-Net unet width 1/16 with 1 block, tiny
ArcFace, f32) on the same seeded files: a narrow G `.pth`, a tiny
ArcFace as a converted msgpack (the JAX CLI's `.pth` route converts at
full depth), a narrow D `.pth` and a LIPSPADE ngf 4 `.pth`. Both CLIs
build the full-width discriminator (n_layers 5 x 3 scales), whose JAX
compile alone takes over a minute on a CPU; the discriminator mode
narrows it on both sides to the tier-1 tests' D (ndf 8, 3 layers, 2
scales) by a test-side patch of the class and its converter's depth.
JAX's jitted step is spied on (its inputs and outputs), the port's
steps too: step 0's loss terms within 1e-5 relative; each CLI's
msgpack loads in the other package, and the two give the same output
within 1e-5 relative (L2); per element D's logits within 1e-5 of their
largest, G's image within 1e-4 (AEI-Net's f32 forward).

One step of each trainer from a shared state: the port's step on the
inputs JAX's CLI gave its step (its starting parameters, BN statistics,
batch, fakes, upscaler variables), against JAX's outputs: the loss
terms 1e-5 relative; Adam's moments, the parameters after the step and
the BN statistics with `tests/test_torch_train_step.py`'s bounds
(`grad_bound`: 1e-2 of each tensor's largest value + 1e-6 of the
largest over all, JAX's own f32 error; the parameters within 1e-6 +
lr * min(2, 2 d / |g|); the statistics 1e-5 relative + 1e-7).

JAX is imported inside the tests and fixtures that use it.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from ghost_tpu_torch.cli import train_extras as tcli
from ghost_tpu_torch.convert.from_jax import (flax_variables,
                                              load_flax_variables)
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models.aei import AEINet
from ghost_tpu_torch.models.discriminator import MultiscaleDiscriminator
from ghost_tpu_torch.models.sr.generator import LIPSPADEGenerator
from ghost_tpu_torch.models.sr.rrdb import RRDBNet
from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact
from ghost_tpu_torch.train import extra_trainers as textra
from torch_cli_inputs import aei_state_dict, arcface_state_dict, save_pth
from torch_train_cli_inputs import disc_state_dict, spade_state_dict

NARROW_D = dict(ndf=8, n_layers=3, num_D=2)
MODES = ("discriminator", "upsampler", "mask")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# ---------------------------------------------------------- the inverse


def _round_trip_case(name):
    """(JAX module, port module, init input shapes)."""
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import aei as jaei
    from ghost_tpu.models import discriminator as jdisc
    from ghost_tpu.models.sr import generator as jgen
    from ghost_tpu.models.sr import rrdb as jrrdb
    from ghost_tpu.models.sr import srvgg as jsrvgg

    if name == "srvgg":
        return (jsrvgg.SRVGGNetCompact(num_feat=8, num_conv=2, upscale=4,
                                       policy=JFULL),
                SRVGGNetCompact(num_feat=8, num_conv=2, upscale=4,
                                policy=TFULL), [(1, 16, 16, 3)])
    if name == "aei":
        return (jaei.AEINet(backbone="unet", num_blocks=1, width=1 / 16,
                            train=True, policy=JFULL),
                AEINet("unet", num_blocks=1, width=1 / 16, train=True,
                       policy=TFULL), [(1, 256, 256, 3), (1, 512)])
    if name == "disc":
        return (jdisc.MultiscaleDiscriminator(**NARROW_D, policy=JFULL),
                MultiscaleDiscriminator(**NARROW_D, policy=TFULL),
                [(1, 256, 256, 3)])
    if name == "rrdb":
        return (jrrdb.RRDBNet(policy=JFULL), RRDBNet(policy=TFULL),
                [(1, 16, 16, 3)])
    if name == "arcface":  # a bare flax BatchNorm ("features")
        from ghost_tpu.models import arcface as jarc
        from ghost_tpu_torch.models.arcface import IResNet

        return (jarc.IResNet(layers=(1, 1, 1, 1), policy=JFULL),
                IResNet((1, 1, 1, 1), policy=TFULL), [(1, 112, 112, 3)])
    if name == "landmark":  # a bare flax Dense ("fc")
        from ghost_tpu.models import landmark as jlmk
        from ghost_tpu_torch.models.landmark import Landmark106

        return (jlmk.Landmark106(width=16, policy=JFULL),
                Landmark106(width=16, policy=TFULL), [(1, 192, 192, 3)])
    return (jgen.LIPSPADEGenerator(ngf=4, policy=JFULL),
            LIPSPADEGenerator(ngf=4, policy=TFULL), [(1, 256, 256, 3)])


@pytest.mark.parametrize("name", ["srvgg", "aei", "disc", "rrdb", "lipspade",
                                  "arcface", "landmark"])
def test_flax_variables_inverts_the_bridge(name):
    """flax_variables(load_flax_variables(m, tree)) is the tree: the same
    collections, paths, shapes and float32 dtypes as JAX's init tree,
    every value bit for bit; and it loads back into a fresh module."""
    import jax

    from tests.test_torch_pipeline import _variables

    jmod, tmod, shapes = _round_trip_case(name)
    want = jax.tree.map(np.asarray, _variables(
        jmod, np.random.default_rng(20), *shapes))
    got = flax_variables(load_flax_variables(tmod, want))
    assert set(got) == set(want)
    flat = {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_leaves_with_path(got)}
    wflat = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_leaves_with_path(want)}
    assert set(flat) == set(wflat)
    for k, w in wflat.items():
        assert flat[k].dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(flat[k], w, err_msg=k)
    again = load_flax_variables(_round_trip_case(name)[1], got)
    for (k, a), b in zip(tmod.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


# --------------------------------------------------------------- the CLIs


def _write_images(d, rng, n, shape, ext):
    import cv2

    d.mkdir()
    for i in range(n):
        cv2.imwrite(str(d / f"{i}.{ext}"),
                    rng.integers(0, 255, shape, dtype=np.uint8))
    return str(d)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The seeded files: 4 crops and 4 masks (64 px), the narrow G and D
    `.pth`, LIPSPADE ngf 4 `.pth`, the tiny ArcFace msgpack."""
    from ghost_tpu.convert.torch_loader import convert_arcface_state_dict
    from ghost_tpu_torch.core.checkpoint import save_msgpack

    d = tmp_path_factory.mktemp("train_extras")
    rng = np.random.default_rng(21)
    f = {"dir": d,
         "crops": _write_images(d / "crops", rng, 4, (64, 64, 3), "jpg"),
         "masks": _write_images(d / "masks", rng, 4, (64, 64), "png"),
         "G": str(d / "G_unet_1blocks.pth"), "D": str(d / "D_narrow.pth"),
         "sr": str(d / "10_net_G.pth"), "arc": str(d / "arc_tiny.msgpack")}
    save_pth(f["G"], aei_state_dict(rng, "unet", 1, 1 / 16))
    save_pth(f["D"], disc_state_dict(rng, **NARROW_D))
    save_pth(f["sr"], spade_state_dict(rng, ngf=4))
    save_msgpack(f["arc"], convert_arcface_state_dict(
        arcface_state_dict(rng, (1, 1, 1, 1)), layers=(1, 1, 1, 1)))
    return f


def _argv(files, mode, run):
    argv = ["--mode", mode, "--dataset_path", files["crops"], "--run_name",
            str(run), "--G_path", files["G"], "--arcface_path", files["arc"],
            "--batch_size", "2", "--max_steps", "1", "--width", "0.0625",
            "--arcface_depth", "tiny", "--bf16", "", "--num_blocks", "1",
            "--num_workers", "1", "--max_epochs", "1"]
    extra = {"discriminator": ["--D_path", files["D"]],
             "upsampler": ["--sr_path", files["sr"], "--sr_ngf", "4"],
             "mask": ["--mask_source", files["masks"]]}[mode]
    return argv + extra


def _narrow_discriminator(mp):
    """Both packages' multiscale discriminator, and their converters of
    D_*.pth, at the narrow depth and width."""
    from ghost_tpu.convert import torch_loader as jload
    from ghost_tpu.models import discriminator as jdisc
    from ghost_tpu_torch.convert import torch_loader as tload
    from ghost_tpu_torch.models import discriminator as tdisc

    for mod, conv in ((jdisc, jload), (tdisc, tload)):
        real = mod.MultiscaleDiscriminator
        mp.setattr(mod, "MultiscaleDiscriminator",
                   lambda *a, real=real, **kw: real(*a, **{**kw, **NARROW_D}))
        real_conv = conv.convert_discriminator_state_dict
        mp.setattr(conv, "convert_discriminator_state_dict",
                   lambda sd, real=real_conv, **kw: real(
                       sd, num_D=NARROW_D["num_D"],
                       n_layers=NARROW_D["n_layers"]))


@pytest.fixture(scope="module")
def runs(files):
    """Each mode through both CLIs. JAX: the jitted `step`'s inputs and
    outputs (a spy on jax.jit). The port: each step's loss terms (a spy on
    the step makers)."""
    import jax

    from ghost_tpu.cli import train_extras as jcli

    out = {}
    for mode in MODES:
        rec = {"jax": [], "port": []}
        real_jit = jax.jit

        def spy_jit(fun, *a, **kw):
            jf = real_jit(fun, *a, **kw)
            if getattr(fun, "__name__", "") != "step":
                return jf

            def call(*args):
                res = jf(*args)
                rec["jax"].append((args, res))
                return res

            return call

        def spy_make(make):
            def wrapped(*a, **kw):
                step, opt = make(*a, **kw)

                def spy(*args):
                    res = step(*args)
                    rec["port"].append(res)
                    return res

                return spy, opt

            return wrapped

        with pytest.MonkeyPatch.context() as mp:
            if mode == "discriminator":
                _narrow_discriminator(mp)
            mp.setattr(jax, "jit", spy_jit)
            mp.chdir(files["dir"])
            with _stdout() as rec["jax_lines"]:
                jcli.main(_argv(files, mode, f"jax_{mode}"))
            mp.setattr(jax, "jit", real_jit)
            for name in ("make_discriminator_pretrain_step",
                         "make_upsampler_finetune_step",
                         "make_mask_train_step"):
                mp.setattr(textra, name, spy_make(getattr(textra, name)))
            with _stdout() as rec["port_lines"]:
                tcli.main(_argv(files, mode, f"port_{mode}"), device="cpu")
        out[mode] = rec
    return out


@contextlib.contextmanager
def _stdout():
    """The lines a block prints (filled when it ends)."""
    buf, lines = io.StringIO(), []
    with contextlib.redirect_stdout(buf):
        yield lines
    lines += buf.getvalue().splitlines()


def _same_lines(got, want):
    """Printed lines with the same words and numbers within 1e-5
    relative (+ the printed digits' last unit); run names aside."""
    assert len(got) == len(want), (got, want)
    for a, b in zip(got, want):
        a, b = a.replace("port_", "jax_").split(), b.split()
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y, (a, b)
                continue
            assert abs(fx - fy) <= 1e-5 * abs(fy) + 1.01e-4, (a, b)


def _jax_loss_terms(mode, res):
    if mode == "upsampler":
        return {k: float(v) for k, v in res[3].items()}
    return {"loss": float(res[2] if mode == "discriminator" else res[3])}


def _port_loss_terms(res):
    if isinstance(res, dict):
        return {k: float(v) for k, v in res.items()}
    return {"loss": float(res)}


@pytest.mark.parametrize("mode", MODES)
def test_cli_step_and_files_match_jax(files, runs, mode):
    """One step of each CLI: the same printed lines and loss terms within
    1e-5 relative;
    each CLI's `{run_name}_{mode}.msgpack` holds the same keys, shapes and
    dtypes, the port reads either file bit for bit, and served by either
    package the outputs agree within 1e-5 relative (L2) and per element
    D's logits within 1e-5 of their largest, G's output in eval mode
    within 1e-4 (AEI-Net's own f32 forward error, the bound of
    tests/test_torch_models.py; measured 3.0e-5 on a CPU)."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.checkpoint import load_msgpack as jload
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import aei as jaei
    from ghost_tpu.models import discriminator as jdisc
    from ghost_tpu_torch.core.checkpoint import load_msgpack as tload

    rec = runs[mode]
    assert len(rec["jax"]) == len(rec["port"]) == 1
    _same_lines(rec["port_lines"], rec["jax_lines"])
    want = _jax_loss_terms(mode, rec["jax"][0][1])
    got = _port_loss_terms(rec["port"][0])
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, (k, got[k], want[k])

    rng = np.random.default_rng(22)
    x = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    z = rng.standard_normal((2, 512)).astype(np.float32)
    trees = {}
    for side in ("jax", "port"):
        path = str(files["dir"] / f"{side}_{mode}_{mode}.msgpack")
        jv, tv = jload(path), tload(path)
        if mode == "discriminator":
            jmod = jdisc.MultiscaleDiscriminator(**NARROW_D, policy=JFULL)
            w = [np.asarray(o[-1]) for o in jax.jit(jmod.apply)(
                jv, jnp.asarray(x))]
            tmod = load_flax_variables(MultiscaleDiscriminator(
                **NARROW_D, policy=TFULL), tv)
            with torch.no_grad():
                g = [o[-1].numpy() for o in tmod(torch.from_numpy(x))]
        else:
            jmod = jaei.AEINet(backbone="unet", num_blocks=1, width=1 / 16,
                               policy=JFULL)
            w = [np.asarray(jax.jit(
                lambda v, a, b: jmod.apply(v, a, b)[0])(jv, x, z))]
            tmod = load_flax_variables(AEINet("unet", num_blocks=1,
                                              width=1 / 16, policy=TFULL), tv)
            with torch.no_grad():
                g = [tmod(torch.from_numpy(x), torch.from_numpy(z))[0]
                     .numpy()]
        bound = 1e-5 if mode == "discriminator" else 1e-4
        for a, b in zip(g, w):
            assert float(np.abs(a - b).max()) <= bound * np.abs(b).max()
            rel = float(np.linalg.norm((a - b).ravel())
                        / np.linalg.norm(b.ravel()))
            assert rel <= 1e-5, rel
        trees[side] = [(jax.tree_util.keystr(p), v.shape, v.dtype) for p, v
                       in jax.tree_util.tree_leaves_with_path(jv)]
        back = dict(jax.tree_util.tree_leaves_with_path(flax_variables(tmod)))
        for p, v in jax.tree_util.tree_leaves_with_path(jv):
            if mode != "discriminator" or p[0].key == "params":
                np.testing.assert_array_equal(back[p], v, str(p))
    assert sorted(trees["port"]) == sorted(trees["jax"])


def _port_module(mode, variables, train):
    if mode == "discriminator":
        mod = MultiscaleDiscriminator(**NARROW_D, policy=TFULL)
    else:
        mod = AEINet("unet", num_blocks=1, width=1 / 16, train=train,
                     policy=TFULL)
    return load_flax_variables(mod, variables)


@pytest.mark.parametrize("mode", MODES)
def test_trainer_step_matches_jax_from_a_shared_state(runs, mode):
    """The port's step on the inputs JAX's CLI gave its jitted step:
    the loss terms, Adam's moments, the parameters after the step and
    (for G) the BN running statistics against JAX's outputs, with the
    module docstring's bounds."""
    from tests.test_torch_train_step import (_adam, _as_port,
                                             _check_moments, _check_params,
                                             _moments)

    args, res = runs[mode]["jax"][0]
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    if mode == "discriminator":
        params, stats, opt_in = args[0], None, args[1]
        mod = _port_module(mode, {"params": params}, train=False)
        step, opt = textra.make_discriminator_pretrain_step(mod)
        got = _port_loss_terms(step(t(args[2]), t(args[3])))
        new_params, new_stats, jopt = res[0], None, res[1]
    else:
        params, stats, opt_in = args[0], args[1], args[2]
        mod = _port_module(mode, {"params": params, "batch_stats": stats},
                           train=True)
        if mode == "upsampler":
            sr = load_flax_variables(LIPSPADEGenerator(ngf=4, policy=TFULL),
                                     args[3]).eval().requires_grad_(False)
            step, opt = textra.make_upsampler_finetune_step(
                mod, textra.sr_upscale_apply(sr))
            got = _port_loss_terms(step(t(args[4]), t(args[5])))
        else:
            step, opt = textra.make_mask_train_step(mod)
            got = _port_loss_terms(step(t(args[3]), t(args[4]), t(args[5])))
        new_params, new_stats, jopt = res[0], res[1], res[2]
    assert int(_adam(opt_in).count) == 0
    want = _jax_loss_terms(mode, res)
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k
    adam = _adam(jopt)
    mu_want, nu_want = (_as_port(mod, m, new_stats)
                        for m in (adam.mu, adam.nu))
    mu, nu = _moments(opt, mod)
    mu_want = {k: mu_want[k] for k in mu}
    _check_moments(mu, mu_want, 1.0, f"{mode} mu")
    _check_moments(nu, {k: nu_want[k] for k in nu}, 2.0, f"{mode} nu")
    after = _as_port(mod, new_params, new_stats)
    got_sd = {k: v.detach().numpy() for k, v in mod.state_dict().items()}
    _check_params(got_sd, {k: after[k] for k in mu}, mu_want,
                  f"{mode} params")
    for k, w in after.items():
        if "running" in k:
            assert (np.abs(got_sd[k] - w) <= np.abs(w) * 1e-5 + 1e-7).all(), k
    assert any("running" in k for k in after) == (mode != "discriminator")


@pytest.mark.parametrize("case", ["mask_source", "random", "missing_G",
                                  "no_params", "missing_arcface", "no_card"])
def test_cli_refuses_like_jax(files, tmp_path, case):
    """--mode mask without --mask_source, random G without the opt-in, a
    missing explicit --G_path, a G msgpack without `params` and a missing
    non-default --arcface_path exit as JAX's CLI does (`SystemExit` with
    its message); the command line needs a card (where there is none)."""
    from ghost_tpu_torch.core.checkpoint import save_msgpack

    argv = _argv(files, "discriminator", tmp_path / "t")
    g = argv.index("--G_path")
    if case == "mask_source":
        argv = _argv(files, "mask", tmp_path / "t")
        i = argv.index("--mask_source")
        del argv[i:i + 2]
        match = "mask_source"
    elif case == "random":
        del argv[g:g + 2]
        match = "random G"
    elif case == "missing_G":
        argv[g + 1] = str(tmp_path / "nope_G.msgpack")
        match = "does not exist"
    elif case == "no_params":
        save_msgpack(tmp_path / "g.msgpack", {"batch_stats": {}})
        argv[g + 1] = str(tmp_path / "g.msgpack")
        match = "no 'params'"
    elif case == "missing_arcface":
        argv = _argv(files, "mask", tmp_path / "t")
        argv[argv.index("--arcface_path") + 1] = str(tmp_path / "arc.pth")
        match = "does not exist"
    else:
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tcli.main(argv)
        return
    with pytest.raises(SystemExit, match=match):
        tcli.main(argv, device="cpu")


def test_loop_saves_and_stops(files, tmp_path, capsys):
    """The trainers' loop: a snapshot every --save_interval steps and one
    at the end; a latched SIGTERM saves and stops after the step it came
    in, with the JAX CLI's message."""
    from ghost_tpu_torch.core import checkpoint
    from ghost_tpu_torch.train import preempt

    saved = []
    real_save = checkpoint.save_msgpack

    class Latched(preempt.PreemptionGuard):
        triggered = True

    argv = _argv(files, "mask", tmp_path / "m")
    argv[argv.index("--max_steps") + 1] = "2"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(checkpoint, "save_msgpack",
                   lambda path, tree: saved.append(path) or
                   real_save(path, tree))
        tcli.main(argv + ["--save_interval", "1"], device="cpu")
        assert saved == [f"{tmp_path / 'm'}_mask.msgpack"] * 3
        saved.clear()
        mp.setattr(preempt, "PreemptionGuard", Latched)
        tcli.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert len(saved) == 1 and out.count("step 0 mask loss") == 2
    assert "preemption signal latched" in out and "step 1" not in out


def test_parser_matches_jax():
    """Flag for flag: the same options, defaults, choices and parses."""
    from ghost_tpu.cli import train_extras as jcli

    jp, tp = jcli.build_parser(), tcli.build_parser()
    key = lambda a: (tuple(a.option_strings), a.dest, a.default,  # noqa: E731
                     a.choices, a.required, a.nargs)
    assert [key(a) for a in tp._actions] == [key(a) for a in jp._actions]
    argv = ["--mode", "mask", "--dataset_path", "d", "--bf16", "0",
            "--allow_random_weights", "1", "--max_steps", "3"]
    assert vars(tp.parse_args(argv)) == vars(jp.parse_args(argv))
    assert not textra.external_upsampler_available()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_trainer_step_on_card_matches_cpu(mode):
    """Each trainer's step (narrow models, f32, TF32 off) on the card
    against the same step on the CPU from the same seeded state: the loss
    within 1e-4 relative, and no kernel of the table launched (the path
    runs none, as in JAX: AEI-Net trains with fused_aad=False)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy

    from ghost_tpu_torch.core.precision import disable_tf32
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.ops.cuda import attention, layer_norm
    from ghost_tpu_torch.ops.cuda.aad import aad_modulate
    from ghost_tpu_torch.ops.cuda.conv3x3 import conv3x3

    wrappers = (aad_modulate, conv3x3, attention.flash_attention_fwd,
                attention.flash_attention_bwd_dq,
                attention.flash_attention_bwd_dkv,
                layer_norm.fused_layer_norm_fwd,
                layer_norm.fused_layer_norm_bwd)
    disable_tf32()
    g = torch.Generator().manual_seed(23)
    rng = np.random.default_rng(23)
    xt, mask = (torch.from_numpy(rng.uniform(lo, 1, (2, 256, 256, c)).astype(
        np.float32)) for lo, c in ((-1, 3), (0, 1)))
    z = torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32))
    if mode == "discriminator":
        base = MultiscaleDiscriminator(**NARROW_D, policy=TFULL)
    else:
        base = AEINet("unet", num_blocks=1, width=1 / 16, train=True,
                      policy=TFULL)
    init_weights(base, g)
    sr = init_weights(LIPSPADEGenerator(ngf=4, policy=TFULL), g).eval()
    losses = []
    for dev in ("cuda", "cpu"):
        mod = copy.deepcopy(base).to(dev)
        a, b, m = xt.to(dev), z.to(dev), mask.to(dev)
        before = [f.launches for f in wrappers]
        if mode == "discriminator":
            step, _ = textra.make_discriminator_pretrain_step(mod)
            loss = step(a * 0.5, a)
        elif mode == "upsampler":
            step, _ = textra.make_upsampler_finetune_step(
                mod, textra.sr_upscale_apply(copy.deepcopy(sr).to(dev)))
            loss = step(a, b)["loss"]
        else:
            step, _ = textra.make_mask_train_step(mod)
            loss = step(a, b, m)
        losses.append(float(loss))
        assert [f.launches for f in wrappers] == before
    assert _rel(losses[0], losses[1]) <= 1e-4, losses
