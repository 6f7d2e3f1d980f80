"""The port's SR seats against ghost_tpu's: the msgpack reader, SRVGG on
the bundled student weights, the student seat, rms_instance_norm,
SPADEResnetBlock and LIPSPADEGenerator.

Inputs and (for SPADE) weights are made from seeded numpy and go through
both packages; the weights reach the port through the bridge. Every
comparison is f32 (FULL_PRECISION on both sides) and held to 1e-4
absolute: the same math, with convolution sums in another order.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ghost_tpu.core.checkpoint import load_msgpack as j_load_msgpack
from ghost_tpu.core.precision import FULL_PRECISION as JFULL
from ghost_tpu.models.sr import generator as jgen
from ghost_tpu.models.sr import spade as jspade
from ghost_tpu.models.sr import srvgg as jsrvgg
from ghost_tpu.nn.layers import rms_instance_norm as j_rms_instance_norm
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.checkpoint import load_msgpack
from ghost_tpu_torch.core.precision import FULL_PRECISION
from ghost_tpu_torch.models.sr import generator as tgen
from ghost_tpu_torch.models.sr import spade as tspade
from ghost_tpu_torch.models.sr import srvgg as tsrvgg
from ghost_tpu_torch.nn.layers import rms_instance_norm

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "srvgg_student_x2_r05.msgpack")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _spade_variables(jmod, rng, *input_shapes):
    """Seeded numpy values for every params / batch_stats leaf; each
    spectral pair (u, v) is u random and v = W^T u normalized, the
    pair a flax init holds, so sigma = |W^T u| > 0."""
    shapes = jax.eval_shape(jmod.init, jax.random.key(0),
                            *[jnp.zeros(s) for s in input_shapes])

    def leaf(path, sd):
        name, shape = path[-1].key, sd.shape
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("var", "in_scale"):
            v = rng.uniform(0.9, 1.1, shape)
        else:
            v = rng.normal(0, 0.05, shape)
        return np.asarray(v, np.float32)

    tree = jax.tree_util.tree_map_with_path(
        leaf, {k: v for k, v in shapes.items() if k != "spectral"})

    def pair(node_params, node_spec):
        out = {}
        for k, v in node_spec.items():
            if "u" in v and not isinstance(v["u"], dict):
                kern = node_params[k]["kernel"]
                w_mat = kern.transpose(3, 2, 0, 1).reshape(kern.shape[-1], -1)
                u = rng.normal(0, 1, kern.shape[-1])
                u = u / np.linalg.norm(u)
                v_ = w_mat.T @ u
                out[k] = {"u": u.astype(np.float32),
                          "v": (v_ / np.linalg.norm(v_)).astype(np.float32)}
            else:
                out[k] = pair(node_params[k], v)
        return out

    tree["spectral"] = pair(tree["params"], shapes["spectral"])
    return tree


# ---------------------------------------------------------------- reader


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_load_msgpack_equals_flax_on_the_bundled_student():
    ours = dict(_leaves(load_msgpack(CKPT)))
    ref = dict(_leaves(j_load_msgpack(CKPT)))
    assert ours.keys() == ref.keys() and len(ours) == 53
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert ours[k].tobytes() == v.tobytes(), k


def test_load_msgpack_chunked_bf16_and_scalar_leaves(tmp_path, monkeypatch):
    """Chunked arrays (forced with a small chunk limit), a bfloat16 leaf
    (read as f32 holding the same values) and a numpy scalar."""
    rng = np.random.default_rng(0)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"big": rng.standard_normal((5, 7)).astype(np.float32),
                       "small": np.arange(3, dtype=np.int32)},
            "bf": np.asarray(jnp.asarray(rng.standard_normal(6),
                                         jnp.bfloat16)),
            "step": np.int64(7)}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got = load_msgpack(path)
    ref = serialization.msgpack_restore(path.read_bytes())
    np.testing.assert_array_equal(got["params"]["big"], ref["params"]["big"])
    np.testing.assert_array_equal(got["params"]["small"],
                                  ref["params"]["small"])
    assert got["bf"].dtype == np.float32
    np.testing.assert_array_equal(got["bf"], ref["bf"].astype(np.float32))
    assert got["step"] == 7


# ----------------------------------------------------------------- SRVGG


@pytest.fixture(scope="module")
def student():
    variables = load_msgpack(CKPT)
    jvars = j_load_msgpack(CKPT)
    jstudent = jsrvgg.srvgg_from_variables(jvars, policy=JFULL)
    tstudent = tsrvgg.srvgg_from_variables(variables, policy=FULL_PRECISION)
    load_flax_variables(tstudent, variables)
    return jstudent, jvars, tstudent


def test_srvgg_from_variables_reads_the_tree_and_raises(student):
    _, _, t = student
    assert (t.num_feat, t.num_conv, t.upscale) == (32, 16, 2)
    with pytest.raises(ValueError, match="not an SRVGG student tree"):
        tsrvgg.srvgg_from_variables({"params": {"head_0": {}}})
    bad = {"params": {"conv_0": {"Conv_0": {"kernel": np.zeros((3, 3, 3, 8))}},
                      "conv_last": {"Conv_0": {"kernel": np.zeros(
                          (3, 3, 8, 10))}}}}
    with pytest.raises(ValueError, match="square upscale"):
        tsrvgg.srvgg_from_variables(bad)


def test_srvgg_matches_jax_on_bundled_weights(student):
    jstudent, jvars, tstudent = student
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jstudent.apply)(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = tstudent(_t(x)).numpy()
    assert got.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_student_seat_contract_and_jax_parity(student):
    jstudent, jvars, tstudent = student
    seat = tsrvgg.SRVGGStudentSeat(tstudent)
    y = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jsrvgg.SRVGGStudentSeat(jstudent).apply)(
        jvars, jnp.asarray(y)))
    with torch.no_grad():
        got = seat(_t(y)).numpy()
        with pytest.raises(ValueError, match="not divisible"):
            seat(_t(y[:, :63]))
    assert got.shape == y.shape and np.isfinite(got).all()
    assert got.min() >= -1.0 - 1e-6 and got.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def _grads_as_port(tmod, jgrads, extra=None):
    """The JAX gradient tree laid out as `tmod`'s parameters: the bridge
    maps each leaf as it maps the weights (transposes are linear)."""
    twin = load_flax_variables(copy.deepcopy(tmod),
                               {"params": jgrads, **(extra or {})})
    return dict(twin.named_parameters())


def test_srvgg_grads_match_jax():
    """Gradients of x and of every conv weight, bias and PReLU slope of a
    narrow SRVGG (8 features, 2 body convs, x2; its trunk is a Conv3x3
    stack, each through S2's autograd op) against jax.grad of the JAX
    SRVGG on the same weights, f32. Bound 1e-4 absolute and relative:
    the same f32 sums in another order (loss O(10), 27-72 term convs)."""
    rng = np.random.default_rng(5)
    jm = jsrvgg.SRVGGNetCompact(num_feat=8, num_conv=2, upscale=2,
                                policy=JFULL)
    x = rng.uniform(0, 1, (2, 12, 12, 3)).astype(np.float32)
    w = rng.standard_normal((2, 24, 24, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(
        lambda s: jnp.asarray(rng.normal(0, 0.3, s.shape), jnp.float32),
        shapes)["params"]

    def loss(params, x):
        return jnp.sum(jm.apply({"params": params}, x) * w)

    jg, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tm = load_flax_variables(
        tsrvgg.SRVGGNetCompact(num_feat=8, num_conv=2, upscale=2,
                               policy=FULL_PRECISION), {"params": params})
    tx = _t(x).requires_grad_()
    torch.sum(tm(tx) * _t(w)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    want = _grads_as_port(tm, jg)
    assert len(want) == 2 * 4 + 3  # 4 convs (weight, bias), 3 slopes
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_pixel_shuffle_and_nearest_up_match_jax(factor):
    x = np.random.default_rng(factor).standard_normal(
        (2, 5, 3, 2 * factor * factor)).astype(np.float32)
    np.testing.assert_array_equal(
        tsrvgg.pixel_shuffle(_t(x), factor).numpy(),
        np.asarray(jsrvgg.pixel_shuffle(jnp.asarray(x), factor)))
    np.testing.assert_array_equal(
        tsrvgg.nearest_up(_t(x), factor).numpy(),
        np.asarray(jsrvgg.nearest_up(jnp.asarray(x), factor)))


# ----------------------------------------------------------------- SPADE


def test_rms_instance_norm_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 9, 7, 5)).astype(
        np.float32) * 3 + 1
    np.testing.assert_allclose(rms_instance_norm(_t(x)).numpy(),
                               np.asarray(j_rms_instance_norm(jnp.asarray(x))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("param_free", ["instance", "syncbatch"])
def test_spade_resnet_block_matches_jax(param_free):
    rng = np.random.default_rng(4)
    fin, fout = 8, 4
    jmod = jspade.SPADEResnetBlock(fin, fout, param_free=param_free,
                                   policy=JFULL)
    variables = _spade_variables(jmod, rng, (2, 16, 16, fin), (2, 32, 32, 3))
    x = rng.standard_normal((2, 16, 16, fin)).astype(np.float32)
    seg = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x),
                                         jnp.asarray(seg)))
    tmod = tspade.SPADEResnetBlock(fin, fout, param_free=param_free,
                                   policy=FULL_PRECISION)
    load_flax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod(_t(x), _t(seg)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_lipspade_generator_matches_jax():
    rng = np.random.default_rng(5)
    jmod = jgen.LIPSPADEGenerator(ngf=4, policy=JFULL)
    variables = _spade_variables(jmod, rng, (1, 64, 64, 3))
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    tmod = tgen.LIPSPADEGenerator(ngf=4, policy=FULL_PRECISION)
    load_flax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod(_t(x)).numpy()
    assert got.shape == x.shape
    assert ref.std() > 0.05  # the output is not saturated or flat
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
