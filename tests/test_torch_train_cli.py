"""The port's train CLI (`ghost_tpu_torch/cli/train.py`) against
ghost_tpu's: the parser flag for flag, what each `main` builds in every
mode and switch, and one training run end to end, on the CPU.

Files (module fixture): seeded jpgs, flat and in identity folders; a
narrow `.pth` G (unet, 1 block, width 1/16) and a teacher G, and the
CLI's full-width `D_*.pth` (n_layers 5 x 3 scales: the CLIs build no
other), with the reference's names (`tests/torch_cli_inputs.py`,
`tests/torch_train_cli_inputs.py`); an inswapper-signature graph, a
LIPSPADE `10_net_G.pth` (ngf 4) and a FAN msgpack (1 stack x 256).
ArcFace is the tiny one (1,1,1,1) on both sides from the same seeded
tree: each CLI's random init is patched to it, since the `.pth` route
reads through the full-depth converter.

What each `main` builds is captured by patching `make_train_steps`,
`PrefetchLoader` and `train_loop`, so the config tests compile no JAX
step. The end-to-end run (canonical, f32, batch 2, `--d_interval 1`,
2 steps, `--save_interval 1`) spies on `train_loop` in both CLIs
(`train_loop_spy`): the starting states, every batch the loop reads and
every step's metrics. Its bounds are those of
`tests/test_torch_train_step.py` (see its docstring): the loss terms of
step 0 1e-4 relative, of step 1 1e-2 (Adam with b1 = 0 turns an
unsettled gradient sign into a full step, so two f32 runs part after one
step); per element only a single step from a shared state: iteration 0
from the CLIs' starting state, and iteration 1 from JAX's state after
iteration 0 loaded into the port. G's step is held to JAX's, each
leaf's bound widened to 5x the port's own spread (the batch's samples in
the other order) where that is larger (f32 leaves a cancelling scalar
such as an AAD mask's bias open by a few % of itself). D's step takes
JAX's Y and is held, with the fixed bounds, to JAX's D step in float64
(`_check_d`). JAX's steps are re-run through `jax.jit` of the functions
the CLI's loop jitted (the same compiled programs) and must give the
CLI's end state bit for bit; so must the port's.

JAX is imported inside the tests that use it.
"""

import copy
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from ghost_tpu_torch.cli import train as tcli
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.checkpoint import CheckpointManager, save_msgpack
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models.arcface import IResNet
from torch_cli_inputs import aei_state_dict, save_pth
from torch_train_parity import LR
from torch_train_cli_inputs import (disc_state_dict, fan_variables,
                                    inswapper_graph, spade_state_dict,
                                    train_loop_spy, write_faces)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The module's seeded files; their paths, and the tiny ArcFace's
    seeded flax tree as "arc"."""
    import jax

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import arcface as jarc
    from tests.test_torch_pipeline import _variables

    d = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(31)
    f = {"faces": write_faces(str(d / "faces"), rng, 6, 96),
         "vgg": write_faces(str(d / "vgg"), rng, 6, 96, identities=2),
         "G": str(d / "G_unet_1blocks.pth"), "T": str(d / "teacher.pth"),
         "D": str(d / "D_unet_1blocks.pth"), "onnx": str(d / "swapper.onnx"),
         "sr": str(d / "10_net_G.pth"), "fan": str(d / "fan.msgpack"),
         "no_arc": str(d / "no_backbone.pth"), "dir": d}
    save_pth(f["G"], aei_state_dict(rng, "unet", 1, 1 / 16))
    save_pth(f["T"], aei_state_dict(rng, "unet", 1, 1 / 16))
    save_pth(f["D"], disc_state_dict(rng, num_D=3, n_layers=5, ndf=64))
    with open(f["onnx"], "wb") as fh:
        fh.write(inswapper_graph(rng))
    save_pth(f["sr"], spade_state_dict(rng, ngf=4))
    save_msgpack(f["fan"], fan_variables(rng, num_stacks=1, features=256))
    arc = _variables(jarc.IResNet(layers=(1, 1, 1, 1), policy=JFULL), rng,
                     (1, 112, 112, 3))
    f["arc"] = jax.tree.map(np.asarray, arc)
    return f


def _argv(f, run, *extra):
    return ["--dataset_path", f["faces"], "--G_path", f["G"],
            "--D_path", f["D"], "--arcface_path", f["no_arc"],
            "--arcface_depth", "tiny", "--width", "0.0625",
            "--num_blocks", "1", "--batch_size", "2", "--bf16", "",
            "--num_workers", "1", "--run_name", str(run),
            "--output_dir", f"{run}_out", "--show_step", "100000",
            "--save_interval", "100000", "--max_steps", "2", *extra]


def _seeded_arcface(mp, tree):
    """Both CLIs' random ArcFace init gives `tree` (a flax variables
    tree of the tiny IResNet)."""
    import jax.numpy as jnp

    from ghost_tpu.models import arcface as jarc

    class SeededIResNet(jarc.IResNet):
        def init(self, *args, **kwargs):
            return {k: {**v} for k, v in jax_tree(tree).items()}

    def jax_tree(t):
        return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
                for k, v in t.items()}

    real = tcli._seeded

    def seeded(model, seed):
        if isinstance(model, IResNet):
            return load_flax_variables(model, tree)
        return real(model, seed)

    mp.setattr(jarc, "IResNet", SeededIResNet)
    mp.setattr(tcli, "_seeded", seeded)


def _modules(side):
    """(main, train_step module, loop module, loader module) of a CLI;
    the CLIs import these names inside main, so patching them works."""
    if side == "jax":
        from ghost_tpu.cli import train as jcli
        from ghost_tpu.data import loader
        from ghost_tpu.train import loop, train_step
        return jcli.main, train_step, loop, loader
    from ghost_tpu_torch.data import loader
    from ghost_tpu_torch.train import loop, train_step
    return (lambda argv: tcli.main(argv, device="cpu")), train_step, loop, \
        loader


def _capture(side, argv, mp, f):
    """What `main(argv)` builds: the step config and weights, the
    teacher and FAN it gives the steps, the dataset and loader, and the
    loop's config and arguments; the loop itself does not run."""
    main, ts, loop, loader = _modules(side)
    rec = {}
    real_steps = ts.make_train_steps

    def make_train_steps(*args, **kwargs):
        rec["step_cfg"], rec["weights"] = args[-2], args[-1]
        rec["teacher_apply"] = kwargs.get("teacher_apply")
        rec["fan_apply"] = kwargs.get("fan_apply")
        return real_steps(*args, **kwargs)

    class Loader(loader.PrefetchLoader):
        def __init__(self, dataset, *args, **kwargs):
            super().__init__(dataset, *args, **kwargs)
            rec["loader"] = self

    def train_loop(state, g_step, d_step, batches, cfg, **kwargs):
        rec["loop"], rec["loop_kw"] = cfg, kwargs
        return state, {}

    with mp.context() as m:
        _seeded_arcface(m, f["arc"])
        m.setattr(ts, "make_train_steps", make_train_steps)
        m.setattr(loader, "PrefetchLoader", Loader)
        m.setattr(loop, "train_loop", train_loop)
        main(argv)
    return rec


_DATASET_ATTRS = ("files", "flat", "images", "by_folder", "same_prob",
                  "same_identity", "normalize_pm1", "jitter",
                  "fine_tune_list", "into_images", "bgr_aug_prob")
_LOADER_ATTRS = ("batch_size", "num_workers", "prefetch", "shuffle", "seed",
                 "drop_last")


def _dataset_view(ds):
    out = {a: getattr(ds, a) for a in _DATASET_ATTRS if hasattr(ds, a)}
    out["type"] = type(ds).__name__
    out["rng"] = ds.rng.getstate()
    return out


CONFIG_CASES = {
    "canonical": (),
    "roundtrip": ("--mode", "roundtrip"),
    "self": ("--mode", "self"),
    "self_teacher_path": ("--mode", "self", "--teacher_path", "T"),
    "distill": ("--mode", "distill", "--teacher_onnx", "onnx"),
    "distill_upsample": ("--mode", "distill", "--teacher_onnx", "onnx",
                         "--teacher_upsample", "1", "--sr_path", "sr",
                         "--sr_ngf", "4"),
    "teacher_inner_crop": ("--mode", "distill", "--teacher_onnx", "onnx",
                           "--teacher_inner_crop", "1"),
    "teacher_fine_tune": ("--mode", "distill", "--teacher_onnx", "onnx",
                          "--teacher_fine_tune", "yes"),
    "teacher_lower_signal": ("--mode", "distill", "--teacher_onnx", "onnx",
                             "--teacher_lower_signal", "True"),
    "without_teacher_loss": ("--mode", "distill", "--teacher_onnx", "onnx",
                             "--without_teacher_loss", "on"),
    "eye_loss": ("--eye_detector_loss", "1", "--weight_eyes", "2.5",
                 "--fan_path", "fan", "--fan_stacks", "1"),
    "celeba": ("--celeba", "1", "--fine_tune_filter", "00001",
               "--into_data_path", "vgg", "--only_attractive", "1",
               "--normalize_training_images", "1"),
    "vgg": ("--dataset_path", "vgg", "--vgg_dataset", "x",
            "--same_identity", "False", "--same_person", "0.3"),
    "knobs": ("--scheduler", "1", "--scheduler_step", "7",
              "--scheduler_gamma", "0.5", "--lr_G", "1e-4", "--lr_D", "2e-4",
              "--b1", "0.5", "--b2", "0.99", "--weight_decay", "0",
              "--weight_adv", "2", "--weight_attr", "3", "--weight_id", "4",
              "--weight_rec", "5", "--d_interval", "3", "--verbose_output",
              "1", "--max_epochs", "5", "--show_step", "7",
              "--save_interval", "9", "--max_steps", "11", "--bf16", "1"),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_main_builds_what_jax_builds(files, tmp_path, monkeypatch, case):
    """Each mode, distillation switch, dataset switch and knob: the
    TrainStepConfig, GeneratorLossWeights and LoopConfig equal JAX's, as
    do the loop's max_steps, start iteration and checkpoint directory,
    the dataset (class, file lists, pairing parameters, its generator's
    state) and the loader's arguments; a teacher G or FAN goes to the
    steps where JAX gives one. roundtrip departs: the port gives it the
    frozen teacher G of self, where JAX gives none (and JAX's step then
    stops on the batch's missing teacher_y)."""
    extra = [files.get(a, a) if a in ("T", "onnx", "sr", "fan", "vgg")
             else a for a in CONFIG_CASES[case]]
    recs = {side: _capture(side, _argv(files, tmp_path / "run", *extra),
                           monkeypatch, files) for side in ("jax", "port")}
    j, t = recs["jax"], recs["port"]
    for key in ("step_cfg", "weights", "loop"):
        assert dataclasses.asdict(t[key]) == dataclasses.asdict(j[key]), key
    for key in ("max_steps", "start_iteration"):
        assert t["loop_kw"][key] == j["loop_kw"][key], key
    assert t["loop_kw"]["checkpoint_manager"].directory == \
        j["loop_kw"]["checkpoint_manager"].directory
    assert _dataset_view(t["loader"].dataset) == \
        _dataset_view(j["loader"].dataset)
    for a in _LOADER_ATTRS:
        assert getattr(t["loader"], a) == getattr(j["loader"], a), a
    has = {s: (r["teacher_apply"] is not None, r["fan_apply"] is not None)
           for s, r in recs.items()}
    if case == "roundtrip":
        assert has["port"] == (True, False) and has["jax"] == (False, False)
    else:
        assert has["port"] == has["jax"]
    if case == "eye_loss":
        fan = t["fan_apply"].__closure__[0].cell_contents
        assert not any(p.requires_grad for p in fan.parameters())
        assert not fan.training and not fan.stem_bn.train_stats


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


_SAMPLES = ["0", "1", "", "False", "false", "no", "off", "f", "n", "True",
            "yes", " On "]


def test_parser_matches_jax():
    """Every option: strings, dest, default, const, choices, nargs,
    required, and the same parsed value for each sample string (the
    `type=bool` warts: any non-empty string is True)."""
    from ghost_tpu.cli import train as jcli

    ref, got = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert sorted(got) == sorted(ref)
    for dest, r in ref.items():
        g = got[dest]
        for field in ("option_strings", "default", "const", "choices",
                      "nargs", "required"):
            assert getattr(g, field) == getattr(r, field), (dest, field)
        if r.type is None or r.type in (int, float, str, bool):
            assert g.type is r.type, dest
        else:  # str2bool: the same answers
            assert [g.type(s) for s in _SAMPLES] == \
                [r.type(s) for s in _SAMPLES], dest


@pytest.mark.parametrize("argv", [
    ["--dataset_path", "/d"],
    ["--dataset_path", "/d", "--pretrained", "", "--verbose_output", "x",
     "--diff_eq_same", "x", "--save_epoch", "3", "--scheduler", "1",
     "--teacher_fine_tune", "1", "--teacher_inner_crop", "1",
     "--teacher_lower_signal", "1", "--without_teacher_loss", "1",
     "--teacher_upsample", "1", "--fine_tune_filter", "foo",
     "--into_data_path", "/i", "--only_attractive", "1",
     "--normalize_training_images", "1"],
    ["--dataset_path", "/d", "--same_identity", "False", "--vgg_dataset",
     "0", "--celeba", "no", "--eye_detector_loss", "off", "--same_person",
     "0.35", "--mode", "roundtrip", "--bf16", "False", "--resume", "0",
     "--max_steps_per_process", "5", "--arcface_depth", "tiny"],
])
def test_parser_parses_like_jax(argv):
    from ghost_tpu.cli import train as jcli

    got = vars(tcli.build_parser().parse_args(argv))
    assert got == vars(jcli.build_parser().parse_args(argv))
    if "--same_identity" in argv:
        # the reference's type=bool wart: any non-empty string is True
        assert got["same_identity"] and got["vgg_dataset"] and got["celeba"]
        assert got["eye_detector_loss"] and got["bf16"] is False


def test_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--help"], device="cpu")
    assert e.value.code == 0
    assert "--teacher_onnx" in capsys.readouterr().out


def test_max_steps_per_process_stops_before_weights(files, tmp_path):
    """A nonzero --max_steps_per_process stops with the reason before any
    weight is read (the G path does not exist)."""
    argv = _argv(files, tmp_path / "run", "--max_steps_per_process", "2",
                 "--G_path", str(tmp_path / "missing.pth"))
    with pytest.raises(SystemExit, match="--max_steps_per_process is not "
                                         "ported"):
        tcli.main(argv, device="cpu")


def test_main_needs_a_card_by_default(files, tmp_path):
    """The command line trains on the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(_argv(files, tmp_path / "run"))


@pytest.fixture(scope="module")
def runs(files):
    """Both CLIs' `main` on the same files: canonical, f32, batch 2,
    --d_interval 1, 2 steps, a checkpoint at step 1; what each loop saw
    (`train_loop_spy`), the port's starting state copied."""
    out = {}
    for side in ("jax", "port"):
        rec = {"run": files["dir"] / f"run_{side}"}
        main, _, loop, _ = _modules(side)
        with pytest.MonkeyPatch.context() as mp, train_loop_spy(
                loop, rec, start=copy.deepcopy if side == "port" else None):
            _seeded_arcface(mp, files["arc"])
            main(_argv(files, rec["run"], "--d_interval", "1",
                       "--save_interval", "1", "--verbose_output", "1"))
        out[side] = rec
    return out


def _np_batch(b):
    return {k: np.asarray(v) for k, v in b.items()}


def test_run_starts_and_reads_like_jax(runs):
    """The same starting G and D (the .pth routes, bit for bit), the same
    batches (the loader's arrays bit for bit; the embedding within 1e-5
    of its largest value: the tiny ArcFace in f32 on both sides), the
    same steps (D at both: --d_interval 1), the loss terms of step 0
    within 1e-4 relative and of step 1 within 1e-2, and a checkpoint of
    step 1 on both sides."""
    from tests.test_torch_train_step import _as_port

    j, t = runs["jax"], runs["port"]
    init = t["start"]
    for mod, params, stats in ((init.g, j["start"].g_params,
                                j["start"].g_stats),
                               (init.d, j["start"].d_params, None)):
        want = _as_port(mod, params, stats)
        for k, v in mod.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert len(t["batches"]) == len(j["batches"]) == 2
    for jb, tb in zip(j["batches"], t["batches"]):
        jb, tb = _np_batch(jb), _np_batch(tb)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert tb[k].dtype == jb[k].dtype and tb[k].shape == jb[k].shape
            if k == "embed":
                assert np.abs(tb[k] - jb[k]).max() <= \
                    1e-5 * np.abs(jb[k]).max()
            else:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert [m[0] for m in t["metrics"]] == [m[0] for m in j["metrics"]] \
        == [0, 1]
    for (i, tm), (_, jm) in zip(t["metrics"], j["metrics"]):
        assert tm.keys() == jm.keys() and "lossD" in tm
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4 if i == 0
                                       else 1e-2, err_msg=(i, k))
    assert sorted(n for n in os.listdir(j["run"]) if n.isdigit()) == ["1"]
    assert CheckpointManager(t["run"]).all_steps() == [1]
    saved = CheckpointManager(t["run"]).restore(1)
    for k, v in t["final"].g.state_dict().items():
        assert torch.equal(saved["g"][k], v), k


@pytest.fixture(scope="module")
def replayed(runs):
    """Each side's two iterations again from the CLI's starting state on
    JAX's batches: JAX through the jitted step functions of its CLI's
    loop, the port through its CLI's steps. Each must end where its CLI
    ended, bit for bit (the port on its own batches)."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.train.train_step import default_distill_mults
    from tests.test_torch_train_step import _jbatch

    j, t = runs["jax"], runs["port"]
    jg, jd = jax.jit(j["g_step"]), jax.jit(j["d_step"])
    mults = {k: jnp.float32(v) for k, v in default_distill_mults().items()}
    batches = [_np_batch(b) for b in j["batches"]]
    states, s = [j["start"]], j["start"]
    for b in batches:
        jb = _jbatch(b)
        s, metrics, y = jg(s, jb, mults)
        states.append((s, metrics, np.asarray(y)))
        s, _ = jd(s, y, jb["xs"])
        states.append(s)
    for a, b in zip(jax.tree_util.tree_leaves(s),
                    jax.tree_util.tree_leaves(j["final"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    st = copy.deepcopy(t["start"])
    for b in t["batches"]:
        b = {k: torch.as_tensor(v) for k, v in b.items()}
        st, _, y = t["g_step"](st, b)
        st, _ = t["d_step"](st, y, b["xs"])
    want = t["final"].state_dict()
    for part in ("g", "d"):
        for k, v in st.state_dict()[part].items():
            assert torch.equal(v, want[part][k]), (part, k)
    return {"jax": states, "batches": batches}


def _port_steps(rec, state, batch, y=None):
    """The port CLI's G step on a numpy batch, then, given JAX's Y `y`,
    its D step on the batch's Xs and that Y (D's step from inputs shared
    with JAX); (state after G, G metrics, state after D or None)."""
    b = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    st, metrics, _ = rec["g_step"](state, b)
    if y is None:
        return st, metrics, None
    g_state = copy.deepcopy(st)
    st, _ = rec["d_step"](st, torch.from_numpy(y.copy()), b["xs"])
    return g_state, metrics, st


class _Float64Names:
    """jax.numpy with `float32` read as float64: JAX's discriminator casts
    each instance norm's input to jnp.float32."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return self._jnp.float64 if name == "float32" else getattr(
            self._jnp, name)


@pytest.fixture(scope="module")
def d_step_f64():
    """JAX's D step in float64, the reference of `_check_d`: a function of
    a JAX state (before the D step), Y and Xs, giving Adam's two moments
    and D's parameters after the step as flax trees, and the step count.
    The CLI's D (n_layers 5 x 3 scales, instance norm) and optimiser (lr
    4e-4, b1 = 0, b2 0.999, coupled decay 1e-4, eps 1e-8) in float64
    throughout, the instance norm (`ghost_tpu/nn/layers.py:304-317`)
    too; one jitted program serves both iterations."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ghost_tpu.core.precision import Policy
    from ghost_tpu.models import discriminator as jdisc
    from ghost_tpu.train.losses import hinge_d_loss
    from tests.test_torch_train_step import _adam

    def instance_norm(x, eps=1e-5):
        xc = x - jnp.mean(x, axis=(1, 2), keepdims=True)
        return xc * lax.rsqrt(jnp.mean(xc * xc, axis=(1, 2), keepdims=True)
                              + eps)

    f64 = Policy(jnp.float64, jnp.float64, jnp.float64)
    disc = jdisc.MultiscaleDiscriminator(n_layers=5, num_D=3,
                                         norm="instance", policy=f64)

    def step(params, nu, t, y, xs):
        def loss(p):
            return hinge_d_loss(disc.apply({"params": p}, y),
                                disc.apply({"params": p}, xs),
                                jnp.ones(xs.shape[0], jnp.float64))

        mu = jax.tree.map(lambda g, p: g + 1e-4 * p, jax.grad(loss)(params),
                          params)
        nu = jax.tree.map(lambda n, m: 0.999 * n + 1e-3 * m * m, nu, mu)
        new = jax.tree.map(lambda p, m, n: p - LR * m / (
            jnp.sqrt(n / (1 - 0.999 ** t)) + 1e-8), params, mu, nu)
        return mu, nu, new

    step = jax.jit(step)

    def run(state, y, xs):
        to64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: np.asarray(a, np.float64), t)
        adam = _adam(state.d_opt)
        t = int(adam.count) + 1
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdisc, "jnp", _Float64Names(jnp))
            mp.setattr(jdisc, "instance_norm", instance_norm)
            out = step(to64(state.d_params), to64(adam.nu), np.float64(t),
                       np.float64(y), np.float64(xs))
            assert all(a.dtype == jnp.float64
                       for a in jax.tree_util.tree_leaves(out))
            return jax.tree.map(np.asarray, out) + (t,)

    return run


def _check_d(st, ref):
    """The port's D step held to JAX's D step in float64 on the same
    state, Y and Xs (`ref`, from `d_step_f64`) with the single step's
    bounds (tests/test_torch_train_step.py): both Adam moments within 1e-2
    of each leaf's largest value + 1e-6 of the largest over all (the
    second moment twice that), the parameters within Adam's per-element
    step bound from that gradient bound. (The bridge rounds the reference
    to f32: 6e-8 of each value.) The reference is the exact step, so
    the bound holds the port's own f32 error, not its distance from
    another f32 run."""
    from tests.test_torch_train_step import (_as_port, _check_moments,
                                             _check_params, _moments)

    mu64, nu64, p64 = (_as_port(st.d, tree) for tree in ref[:3])
    mu, nu = _moments(st.d_opt, st.d)
    _check_moments(mu, mu64, 1.0, "D mu")
    _check_moments(nu, nu64, 2.0, "D nu")
    d_got = {k: v.detach().numpy() for k, v in st.d.state_dict().items()}
    _check_params(d_got, p64, mu64, "D params", t=ref[3])


def _swapped(batch):
    return {k: v[::-1].copy() for k, v in batch.items()}


def test_run_step_0_per_element(runs, replayed, d_step_f64):
    """Iteration 0 from the CLIs' starting state on the same batch: every
    loss term, the EMA, G's parameters, BN statistics and both Adam
    moments, each leaf's bound widened to 5x the port's own spread where
    larger (a cancelling scalar, an AAD mask's bias, carries f32 noise of
    a few % of itself); then D's on JAX's Y (`_check_d`)."""
    from tests.test_torch_train_step import _check_g_step

    t = runs["port"]
    s0 = runs["jax"]["start"]
    s1, jm, y = replayed["jax"][1]
    batch = replayed["batches"][0]
    (g_state, metrics, st), (g_spread, _, _) = (
        _port_steps(t, copy.deepcopy(t["start"]), b, yy)
        for b, yy in ((batch, y), (_swapped(batch), None)))
    _check_g_step(g_state, metrics, s0, s1, jm, g_spread)
    _check_d(st, d_step_f64(s1, y, batch["xs"]))


def test_run_step_1_per_element_from_jax_state(runs, replayed, d_step_f64):
    """Iteration 1 from JAX's state after iteration 0, loaded into the
    port: G with the single step's bounds, each leaf's widened to 5x the
    port's own spread (the batch's samples in the other order) where
    larger; then D's on JAX's Y (`_check_d`)."""
    from ghost_tpu.train.train_step import default_distill_mults
    from tests.test_torch_train_step import _check_g_step, _load_jax_state

    t = runs["port"]
    s1d, (s2, jm, y) = replayed["jax"][2:4]
    batch = replayed["batches"][1]
    out = []
    for b, yy in ((batch, y), (_swapped(batch), None)):
        st = copy.deepcopy(t["start"])
        _load_jax_state(st, s1d, default_distill_mults())
        out.append(_port_steps(t, st, b, yy))
    (g_state, metrics, st), (g_spread, _, _) = out
    _check_g_step(g_state, metrics, s1d, s2, jm, g_spread)
    _check_d(st, d_step_f64(s2, y, batch["xs"]))


def test_resume_continues_the_run(files, runs, tmp_path, capsys,
                                  monkeypatch):
    """A rerun of the port's run directory to --max_steps 4 prints
    `resuming from checkpoint step 1` and ends with steps 2 and 3 saved,
    3 the latest. --resume 0 warns and starts at iteration 0; a
    directory of JAX orbax steps is not read, with a warning."""
    run = tmp_path / "run"
    shutil.copytree(runs["port"]["run"], run)
    argv = _argv(files, run, "--d_interval", "1", "--save_interval", "1")
    _seeded_arcface(monkeypatch, files["arc"])
    capsys.readouterr()
    tcli.main(argv + ["--max_steps", "4"], device="cpu")
    assert "resuming from checkpoint step 1" in capsys.readouterr().out
    mgr = CheckpointManager(run)
    assert mgr.all_steps() == [1, 2, 3] and mgr.latest_step() == 3
    assert mgr.restore(3)["step"] == 4

    starts = []
    monkeypatch.setattr(
        "ghost_tpu_torch.train.loop.train_loop",
        lambda state, *a, **kw: (starts.append(kw["start_iteration"]),
                                 (state, {}))[1])
    tcli.main(argv + ["--resume", "0"], device="cpu")
    out = capsys.readouterr().out
    assert "WARNING: --resume 0 with existing checkpoints at step 3" in out
    orbax = tmp_path / "orbax_run"
    (orbax / "7").mkdir(parents=True)
    tcli.main(_argv(files, orbax), device="cpu")
    assert "holds the JAX CLI's orbax steps" in capsys.readouterr().out
    assert starts == [0, 0]


def test_arcface_pth_at_a_shallower_depth_reads_like_jax():
    """JAX's quirk, reproduced: the CLI reads an existing `.pth`
    --arcface_path through the converter's default depth whatever
    --arcface_depth says, and flax's apply ignores the leaves its module
    does not read, so a deeper tree drives a shallower IResNet through
    the first block of each stage. The port loads the leaves its module
    has (`_present_leaves`) and gives JAX's embedding: an iresnet
    (2,1,1,1) state dict into the tiny (1,1,1,1) IResNet, f32, within
    1e-5 of the largest value."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.convert.torch_loader import \
        convert_arcface_state_dict as jconvert
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import arcface as jarc
    from ghost_tpu_torch.convert.torch_loader import \
        convert_arcface_state_dict
    from torch_cli_inputs import arcface_state_dict

    rng = np.random.default_rng(12)
    sd = arcface_state_dict(rng, (2, 1, 1, 1))
    x = rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jarc.IResNet(layers=(1, 1, 1, 1),
                                           policy=JFULL).apply)(
        jconvert(sd, layers=(2, 1, 1, 1)), jnp.asarray(x)))
    arc = IResNet((1, 1, 1, 1), policy=TFULL)
    tree = convert_arcface_state_dict(sd, layers=(2, 1, 1, 1))
    with pytest.raises(KeyError):  # the strict bridge refuses the extra
        load_flax_variables(IResNet((1, 1, 1, 1), policy=TFULL), tree)
    load_flax_variables(arc, tcli._present_leaves(arc, tree))
    got = arc.eval()(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
