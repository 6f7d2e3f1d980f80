"""What the train CLI reaches beside the step, against ghost_tpu: FAN and
the eye heatmaps (`models/fan.py`), the teachers of distillation
(`train/distill.py`, `distill_native.py`), the LIPSPADE upscaler
(`train/extra_trainers.py`) and the SPADE `.pth` converter.

FAN: `FAN(num_stacks=2, features=32)` in f32 on seeded variables (shapes
by eval_shape) through the bridge; one jitted JAX program gives every
stack's heatmaps and the eye loss's value and input gradient. Bounds:
the heatmaps within 1e-4 of their largest value (an f32 forward through
~40 convs and BatchNorms; measured ~1e-6); the loss 1e-4 relative; the
input gradient within 1e-2 of its largest value, the size of f32's own
error on this backward through both stacks' hourglasses and the stem:
the test also holds JAX's f32 gradient and the port's within 1e-2 of a
float64 run of the port.

The inswapper teacher runs on a graph with inswapper_128's signature
written by `tests/torch_train_cli_inputs.py` (the stand-in of
`tests/test_onnx_exec.py:241-272`): 1e-5 absolute on outputs in
[-1, 1] (measured 2.4e-7), and the upsampled teacher through LIPSPADE
(ngf 4, from a seeded `10_net_G.pth`, ~25 f32 convs) the same
(measured 1.3e-7).

JAX is imported inside the tests that use it, so the card tests run
where jax is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_distill.py
"""

import threading
import time

import numpy as np
import pytest
import torch

from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.convert.torch_loader import (
    convert_spade_generator_state_dict)
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models import fan as tfan
from ghost_tpu_torch.models.sr.generator import LIPSPADEGenerator
from ghost_tpu_torch.train import distill as tdist
from ghost_tpu_torch.train import extra_trainers as textra
from ghost_tpu_torch.train.distill_native import NativeInswapperTeacher
from ghost_tpu_torch.train.losses import eye_heatmap_loss
from torch_cli_inputs import save_pth
from torch_train_cli_inputs import inswapper_graph, spade_state_dict

FAN_CFG = dict(num_stacks=2, features=32)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _eye_loss(hm_t, hm_y):
    return eye_heatmap_loss(hm_t[..., 96], hm_t[..., 97], hm_y[..., 96],
                            hm_y[..., 97])


@pytest.fixture(scope="module")
def fan_run():
    """The JAX FAN's heatmaps of x, and the eye loss between the last
    stack's heatmaps of xt (fixed) and of x with its gradient in x, from
    one jitted program; the seeded variables and inputs."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import fan as jfan
    from ghost_tpu.train import losses as jL
    from tests.test_torch_pipeline import _variables

    rng = np.random.default_rng(41)
    jm = jfan.FAN(policy=JFULL, **FAN_CFG)
    v = _variables(jm, rng, (1, 256, 256, 3))
    x, xt = (rng.uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
             for _ in range(2))

    def run(v, x, xt):
        hm_t = jax.lax.stop_gradient(jm.apply(v, xt)[-1])

        def loss(x):
            hm_y = jm.apply(v, x)[-1]
            return jL.eye_heatmap_loss(hm_t[..., 96], hm_t[..., 97],
                                       hm_y[..., 96], hm_y[..., 97])

        return jm.apply(v, x), jax.value_and_grad(loss)(x)

    outs, (loss, grad) = jax.jit(run)(v, jnp.asarray(x), jnp.asarray(xt))
    return {"v": v, "x": x, "xt": xt, "outs": [np.asarray(o) for o in outs],
            "loss": float(loss), "grad": np.asarray(grad)}


def _port_fan(v, device="cpu"):
    fan = tfan.FAN(policy=TFULL, **FAN_CFG)
    return load_flax_variables(fan, v).eval().requires_grad_(False).to(device)


def _fan_loss_grad(fan, x, xt, device):
    """The eye loss of the CLI's `fan_apply` (the last stack) and its
    gradient in the input, with FAN frozen."""
    with torch.no_grad():
        hm_t = fan(torch.from_numpy(xt).to(device))[-1]
    xx = torch.from_numpy(x).to(device).requires_grad_(True)
    loss = _eye_loss(hm_t, fan(xx)[-1])
    grad, = torch.autograd.grad(loss, xx)
    return float(loss.detach()), grad.cpu().numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_fan_forward_matches_jax(fan_run):
    """Every stack's (B,64,64,98) heatmaps within 1e-4 of their largest
    value; BatchNorm in eval mode moves no statistic."""
    fan = _port_fan(fan_run["v"])
    stats = {k: v.clone() for k, v in fan.state_dict().items()
             if "running" in k}
    outs = fan(torch.from_numpy(fan_run["x"]))
    assert len(outs) == len(fan_run["outs"]) == 2
    for o, r in zip(outs, fan_run["outs"]):
        assert tuple(o.shape) == r.shape == (2, 64, 64, 98)
        assert o.dtype == torch.float32
        assert _rel(o.detach().numpy(), r) <= 1e-4
    for k, v in fan.state_dict().items():
        if "running" in k:
            assert torch.equal(v, stats[k]), k


def test_fan_eye_loss_gradient_matches_jax(fan_run):
    """The eye loss through the frozen FAN (the CLI's `fan_apply`) and its
    gradient in the input, against jax.grad's: loss 1e-4 relative,
    gradient within 1e-2 of its largest value; that bound is f32's own
    error, so JAX's gradient and the port's are each within it of the
    port's float64 one; no FAN tensor takes a gradient."""
    from ghost_tpu_torch.core.precision import Policy

    fan = _port_fan(fan_run["v"])
    loss, grad = _fan_loss_grad(fan, fan_run["x"], fan_run["xt"], "cpu")
    np.testing.assert_allclose(loss, fan_run["loss"], rtol=1e-4)
    assert _rel(grad, fan_run["grad"]) <= 1e-2
    assert all(p.grad is None and not p.requires_grad
               for p in fan.parameters())
    f64 = Policy(torch.float64, torch.float64, torch.float64)
    fan64 = load_flax_variables(tfan.FAN(policy=f64, **FAN_CFG),
                                fan_run["v"]).double().eval()
    _, g64 = _fan_loss_grad(fan64.requires_grad_(False),
                            *(fan_run[k].astype(np.float64)
                              for k in ("x", "xt")), "cpu")
    assert _rel(fan_run["grad"], g64) <= 1e-2 and _rel(grad, g64) <= 1e-2


def test_eye_heatmaps_and_points_match_jax():
    """eye_heatmaps' channels and heatmaps_to_points' decode equal JAX's
    exactly on maps full of ties: small integer values, so the argmax
    has several maxima (the first in row-major order wins) and many
    neighbour differences are 0 (sign 0: no quarter step), plus maxima
    on the border (the clamped neighbour)."""
    import jax.numpy as jnp

    from ghost_tpu.models import fan as jfan

    rng = np.random.default_rng(5)
    hm = rng.integers(0, 3, (3, 9, 7, 98)).astype(np.float32)
    hm[0, 0, 0, :4] = 5.0
    hm[1, 8, 6, 4:8] = 5.0
    hm[2, 4, 3, 8] = hm[2, 4, 5, 8] = 5.0
    jl, jr = jfan.eye_heatmaps(jnp.asarray(hm))
    tl, tr = tfan.eye_heatmaps(torch.from_numpy(hm))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    want = np.asarray(jfan.heatmaps_to_points(jnp.asarray(hm)))
    got = tfan.heatmaps_to_points(torch.from_numpy(hm))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 98, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.abs(want - np.round(want)) == 0).any()  # ties: no step


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """Two inswapper-signature graphs: emap found by name, and by shape
    (the last 512x512 initializer)."""
    d = tmp_path_factory.mktemp("teacher")
    rng = np.random.default_rng(17)
    paths = {}
    for name in ("emap", "initializer_9"):
        paths[name] = str(d / f"swapper_{name}.onnx")
        with open(paths[name], "wb") as f:
            f.write(inswapper_graph(rng, emap_name=name))
    paths["dir"] = d
    return paths


def _teacher_inputs(seed=3, b=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, 256, 256, 3)).astype(np.float32),
            rng.normal(0, 1, (b, 512)).astype(np.float32))


@pytest.mark.parametrize("emap", ["emap", "initializer_9"])
def test_native_inswapper_teacher_matches_jax(graphs, emap):
    """The port's teacher against JAX's on the same graph and inputs:
    the emap found (by name, or by shape) is the same array, and
    teacher_y, a (B,256,256,3) f32 tensor, within 1e-5."""
    from ghost_tpu.train.distill_native import NativeInswapperTeacher as J

    xt, z = _teacher_inputs()
    jt, tt = J(graphs[emap]), NativeInswapperTeacher(graphs[emap], "cpu")
    np.testing.assert_array_equal(tt.emap, jt.emap)
    want = jt(xt, z)["teacher_y"]
    got = tt(xt, z)["teacher_y"]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == (2, 256, 256, 3)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5
    assert float(got.abs().max()) <= 1.0


@pytest.fixture(scope="module")
def sr_files(graphs):
    rng = np.random.default_rng(23)
    sd = spade_state_dict(rng, ngf=4)
    path = str(graphs["dir"] / "10_net_G.pth")
    save_pth(path, sd)
    return sd, path


def test_spade_converter_matches_jax(sr_files):
    """convert_spade_generator_state_dict on a state dict with the
    reference's names gives JAX's tree, leaf for leaf and bit for bit,
    and the strict bridge fills the port's LIPSPADE from it."""
    import jax

    from ghost_tpu.convert.torch_loader import \
        convert_spade_generator_state_dict as jconvert

    sd, _ = sr_files
    jt, tt = jconvert(sd, ngf=4), convert_spade_generator_state_dict(sd,
                                                                     ngf=4)
    jl, tl = (jax.tree_util.tree_leaves_with_path(t) for t in (jt, tt))
    assert [p for p, _ in tl] == [p for p, _ in jl] and len(jl) > 100
    for (p, a), (_, b) in zip(jl, tl):
        assert np.asarray(b).dtype == np.asarray(a).dtype, p
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    load_flax_variables(LIPSPADEGenerator(ngf=4, policy=TFULL), tt)


def test_upsampled_teacher_matches_jax(graphs, sr_files, tmp_path, capsys):
    """UpsampledTeacher over the inswapper teacher and a narrow LIPSPADE
    (ngf 4) from the `.pth` route of `load_lipspade_vars` against JAX's
    (`sr_upscale_fn(..., jit=True)`): 1e-5; the msgpack route loads the
    same weights, and no path gives random ones with JAX's warning."""
    import jax

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr.generator import LIPSPADEGenerator as JLIP
    from ghost_tpu.train import distill as jdist
    from ghost_tpu.train import extra_trainers as jextra
    from ghost_tpu.train.distill_native import NativeInswapperTeacher as J
    from ghost_tpu_torch.core.checkpoint import save_msgpack

    _, path = sr_files
    xt, z = _teacher_inputs(seed=4)
    jsr = JLIP(ngf=4, policy=JFULL)
    jvars = jextra.load_lipspade_vars(jsr, path, 4)
    want = jdist.UpsampledTeacher(J(graphs["emap"]), jextra.sr_upscale_fn(
        jsr, jvars, jit=True))(xt, z)["teacher_y"]
    sr = textra.load_lipspade_vars(LIPSPADEGenerator(ngf=4, policy=TFULL),
                                   path, 4)
    assert not any(p.requires_grad for p in sr.parameters())
    got = tdist.UpsampledTeacher(NativeInswapperTeacher(graphs["emap"], "cpu"),
                                 textra.sr_upscale_apply(sr))(xt, z)["teacher_y"]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5
    save_msgpack(tmp_path / "sr.msgpack", jax.tree.map(np.asarray, jvars))
    again = textra.load_lipspade_vars(LIPSPADEGenerator(ngf=4, policy=TFULL),
                                      str(tmp_path / "sr.msgpack"), 4)
    for (k, a), b in zip(sr.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    assert "random SR weights" not in capsys.readouterr().out
    textra.load_lipspade_vars(LIPSPADEGenerator(ngf=4, policy=TFULL), "", 4,
                              warn_context="--teacher_upsample")
    assert "WARNING: random SR weights (--teacher_upsample)" in \
        capsys.readouterr().out


def test_torch_teacher_is_the_frozen_generator():
    """TorchTeacher: the generator's Y (train=False) on (xt, z), and its
    ArcFace embedding at area 112, with no gradient kept."""
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.models.arcface import IResNet
    from ghost_tpu_torch.nn.layers import init_weights, resize

    g = torch.Generator().manual_seed(0)
    gen = init_weights(AEINet("unet", num_blocks=1, policy=TFULL,
                              width=1 / 16), g)
    arc = init_weights(IResNet((1, 1, 1, 1), policy=TFULL), g).eval()
    xt, z = _teacher_inputs(seed=5)
    out = tdist.TorchTeacher(gen, arc_apply=arc)(xt, z)
    with torch.no_grad():
        y = gen(torch.from_numpy(xt), torch.from_numpy(z))[0]
        e = arc(resize(y, (112, 112), method="area"))
    assert torch.equal(out["teacher_y"], y)
    assert torch.equal(out["teacher_embed"], e)
    assert not out["teacher_y"].requires_grad
    assert not any(p.requires_grad for p in gen.parameters())


def test_teacher_prefetcher_order_error_and_early_stop():
    """TeacherPrefetcher yields the batches in order with the teacher's
    outputs added, hands an error of its thread to the consumer, and a
    consumer that stops early stops the thread and closes the batches."""
    closed = []

    def source(n):
        try:
            for i in range(n):
                yield {"xt": np.full((1, 2), i, np.float32),
                       "embed": np.zeros((1, 512), np.float32), "i": i}
        finally:
            closed.append(n)

    def teacher(xt, embed):
        time.sleep(0.002 * (int(xt[0, 0]) % 3))  # uneven teacher times
        return {"teacher_y": xt * 2.0}

    out = list(tdist.TeacherPrefetcher(teacher, source(7)))
    assert [b["i"] for b in out] == list(range(7))
    assert all(float(b["teacher_y"][0, 0]) == 2 * b["i"] for b in out)

    def failing(xt, embed):
        if int(xt[0, 0]) == 3:
            raise RuntimeError("teacher failed on batch 3")
        return {"teacher_y": xt}

    seen = []
    with pytest.raises(RuntimeError, match="batch 3"):
        for b in tdist.TeacherPrefetcher(failing, source(6)):
            seen.append(b["i"])
    assert seen == [0, 1, 2]

    before = threading.active_count()
    it = iter(tdist.TeacherPrefetcher(teacher, source(50)))
    next(it)
    it.close()
    deadline = time.monotonic() + 5.0
    while (threading.active_count() > before or 50 not in closed) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before and 50 in closed


def test_build_inswapper_teacher_exits_like_jax(graphs, tmp_path):
    """The three SystemExits: no --teacher_onnx and a missing file with
    JAX's messages, and a graph the executor refuses (an op it lacks)
    with the executor's error; a good graph builds the native teacher."""
    from ghost_tpu.train import distill as jdist
    from ghost_tpu_torch.convert.onnx_writer import OnnxBuilder

    for arg in ("", str(tmp_path / "missing.onnx")):
        with pytest.raises(SystemExit) as want:
            jdist.build_inswapper_teacher(arg)
        with pytest.raises(SystemExit) as got:
            tdist.build_inswapper_teacher(arg, device="cpu")
        assert str(got.value) == str(want.value)
    b = OnnxBuilder()
    b.graph_input("target", ["b", 3, 128, 128])
    b.graph_input("source", ["b", 512])
    b.node("LSTM", ["target", "source"], outputs=["out"])
    b.graph_output("out", ["b", 3, 128, 128])
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(b.serialize())
    with pytest.raises(SystemExit) as want:
        jdist.build_inswapper_teacher(str(bad))
    with pytest.raises(SystemExit) as got:
        tdist.build_inswapper_teacher(str(bad), device="cpu")
    for e in (want, got):
        assert str(e.value).startswith("cannot build inswapper teacher: "
                                       "native executor failed")
        assert "LSTM" in str(e.value)
    assert isinstance(tdist.build_inswapper_teacher(graphs["emap"], "cpu"),
                      NativeInswapperTeacher)


@pytest.mark.gpu
def test_fan_on_card_matches_cpu():
    """FAN (2 stacks x 32) on the card against the CPU on the same seeded
    weights and inputs. In float64 the two compute the same function: the
    heatmaps, the eye loss and its input gradient within 1e-9 of their
    largest values. In f32 the heatmaps and the loss within 1e-4; the
    input gradient within 5e-2 of the float64 one's largest value: f32's
    own error on this backward through both hourglasses is large (this
    test holds the CPU's f32 gradient to the same bound), and a wrong
    gradient is off by O(1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ghost_tpu_torch.core.precision import Policy, disable_tf32
    from ghost_tpu_torch.nn.layers import init_weights

    disable_tf32()
    rng = np.random.default_rng(8)
    x, xt = (rng.uniform(0, 1, (2, 256, 256, 3)) for _ in range(2))
    res = {}
    for dt, npdt in ((torch.float32, np.float32), (torch.float64, np.float64)):
        fan = init_weights(tfan.FAN(policy=Policy(dt, dt, dt), **FAN_CFG),
                           torch.Generator().manual_seed(3)).eval()
        fan.requires_grad_(False)
        for dev in ("cpu", "cuda"):
            f = fan.to(dev, dt)
            with torch.no_grad():
                hm = f(torch.from_numpy(x.astype(npdt)).to(dev))[-1]
            res[dt, dev] = (hm.cpu().double().numpy(),) + _fan_loss_grad(
                f, x.astype(npdt), xt.astype(npdt), dev)
    (hm64, loss64, g64), (k_hm, k_loss, k_g) = (
        res[torch.float64, dev] for dev in ("cpu", "cuda"))
    assert _rel(k_hm, hm64) <= 1e-9 and _rel(k_g, g64) <= 1e-9
    np.testing.assert_allclose(k_loss, loss64, rtol=1e-9)
    for dev in ("cpu", "cuda"):
        hm, loss, g = res[torch.float32, dev]
        assert _rel(hm, hm64) <= 1e-4, dev
        np.testing.assert_allclose(loss, loss64, rtol=1e-4, err_msg=dev)
        assert _rel(g, g64) <= 5e-2, dev


@pytest.mark.gpu
def test_native_teacher_on_card_matches_cpu(tmp_path):
    """The inswapper teacher on the card against the CPU: teacher_y, a
    tensor on the card, within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ghost_tpu_torch.core.precision import disable_tf32

    disable_tf32()
    path = tmp_path / "swapper.onnx"
    path.write_bytes(inswapper_graph(np.random.default_rng(2)))
    xt, z = _teacher_inputs(seed=6, b=4)
    want = NativeInswapperTeacher(str(path), "cpu")(xt, z)["teacher_y"]
    got = NativeInswapperTeacher(str(path))(xt, z)["teacher_y"]
    assert got.is_cuda
    assert float((got.cpu() - want).abs().max()) <= 1e-5
