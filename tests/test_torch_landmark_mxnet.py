"""The port's MXNet path (`ghost_tpu_torch/convert/mxnet_nd.py`,
`convert/mxnet_graph.py`, `models/landmark_mxnet.py`) against
ghost_tpu's, on the CPU.

No real 2d106det symbol JSON ships in the repository:
`tests/torch_weight_inputs.py` writes one from the layer plan, in
MXNet's node layout, and JAX's `parse_symbol_plan` must read it back as
`conv_plan()`. The `.params` files: the port's writer gives bytes equal
to JAX's for the same dict, and each package reads the other's file.
The interpreters: the same parameter shapes and seeded draws on the
2d106det graph, the same forward on a 3-block graph of the same ops
(1e-4 relative to the output's scale: f32, convolutions summed in
another order). Landmark106Det: converted from a real `.params` file,
through the bridge, against JAX's model (f32: 1e-4; bf16: within 2x
JAX's own bf16 error against its f32 run, plus 1e-3 of scale) and
against the port's interpreter (f32: 1e-4).
"""

import numpy as np
import pytest
import torch

import torch_weight_inputs as twi
from ghost_tpu_torch.convert import mxnet_graph as tgraph
from ghost_tpu_torch.convert import mxnet_nd as tnd
from ghost_tpu_torch.convert.from_jax import (flax_variables,
                                              load_flax_variables)
from ghost_tpu_torch.core.precision import DEFAULT_POLICY as TDEFAULT
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models import landmark_mxnet as tlm

B = 2

@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)



@pytest.fixture(scope="module")
def symbol(tmp_path_factory):
    return twi.write_symbol_2d106det(
        tmp_path_factory.mktemp("mx") / "2d106det-symbol.json")


@pytest.fixture(scope="module")
def checkpoint(symbol, tmp_path_factory):
    """Seeded params of every graph input (the port's interpreter's
    draws), written as a real `.params` file by the port's writer."""
    params = tgraph.MXNetGraphInterpreter(symbol, device="cpu").init_params(
        seed=3)
    path = str(tmp_path_factory.mktemp("mxp") / "2d106det-0000.params")
    tnd.save_ndarray_dict(path, twi.prefixed(params))
    x = np.random.default_rng(1).uniform(0, 255, (B, 192, 192, 3)).astype(
        np.float32)
    return params, path, x


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "arg:w": rng.normal(0, 1, (16, 3, 3, 3)).astype(np.float32),
        "arg:b": rng.normal(0, 1, (16,)).astype(np.float32),
        "aux:mean": rng.normal(0, 1, (16,)).astype(np.float64),
        "arg:idx": rng.integers(0, 100, (7, 2)).astype(np.int64),
        "arg:half": rng.normal(0, 1, (4, 4)).astype(np.float16),
        "arg:bytes": rng.integers(0, 255, (5,)).astype(np.uint8),
        "arg:i32": rng.integers(-9, 9, (3,)).astype(np.int32),
        "arg:i8": rng.integers(-9, 9, (2, 2)).astype(np.int8),
    }


def test_params_bytes_equal_and_cross_read(tmp_path):
    from ghost_tpu.convert import mxnet_nd as jnd

    arrays = _arrays()
    tp, jp = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tnd.save_ndarray_dict(tp, arrays)
    jnd.save_ndarray_dict(jp, arrays)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    for loaded in (tnd.load_ndarray_dict(jp), jnd.load_ndarray_dict(tp)):
        assert list(loaded) == list(arrays)
        for k, v in arrays.items():
            assert loaded[k].dtype == v.dtype, k
            np.testing.assert_array_equal(loaded[k], v)


def test_params_rejects_garbage(tmp_path):
    path = str(tmp_path / "bad.params")
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(ValueError):
        tnd.load_ndarray_dict(path)


def test_symbol_plan_reads_back(symbol):
    from ghost_tpu.models import landmark_mxnet as jlm

    assert jlm.parse_symbol_plan(symbol) == jlm.conv_plan()
    assert tlm.parse_symbol_plan(symbol) == tlm.conv_plan() == \
        jlm.conv_plan()


def test_interpreter_against_jax(symbol, checkpoint, tmp_path):
    """On the 2d106det graph: the same parameter shapes and seeded
    draws. The forward on a 3-block graph of the same ops at 32 px (JAX's
    interpreter runs op by op, each op compiled on its first call)."""
    import json

    from ghost_tpu.convert.mxnet_graph import MXNetGraphInterpreter

    params, _, _ = checkpoint
    ti = tgraph.MXNetGraphInterpreter(symbol, device="cpu")
    ji = MXNetGraphInterpreter(symbol)
    shapes = ti.param_shapes()
    assert shapes == ji.param_shapes()
    with open(symbol) as f:
        inputs = {n["name"] for n in json.load(f)["nodes"]
                  if n["op"] == "null" and n["name"] != "data"}
    assert set(shapes) == inputs
    jp = ji.init_params(seed=3)
    assert list(jp) == list(params)
    for k in params:
        np.testing.assert_array_equal(jp[k], params[k])

    small = twi.write_symbol_2d106det(tmp_path / "small.json",
                                      twi.SMALL_PLAN)
    ti = tgraph.MXNetGraphInterpreter(small, device="cpu")
    ji = MXNetGraphInterpreter(small)
    shape = (B, 3, 32, 32)
    assert ti.param_shapes(shape) == ji.param_shapes(shape)
    p = ti.init_params(seed=4, data_shape=shape)
    x = np.random.default_rng(5).uniform(0, 255, shape).astype(np.float32)
    got = ti.run(p, x).numpy()
    want = ji.run(p, x)
    assert got.shape == want.shape == (B, 212)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _jax_apply(policy, variables, x):
    import jax
    import jax.numpy as jnp

    from ghost_tpu.models.landmark_mxnet import Landmark106Det

    jv = jax.tree.map(jnp.asarray, variables)
    apply = jax.jit(Landmark106Det(policy=policy).apply)
    return np.asarray(apply(jv, jnp.asarray(x)))


def test_landmark106det_against_jax_and_interpreter(symbol, checkpoint):
    from ghost_tpu.convert.mxnet_nd import load_ndarray_dict
    from ghost_tpu.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu.models.landmark_mxnet import convert_2d106det_params

    params, path, x = checkpoint
    tree = tlm.convert_2d106det_params(tnd.load_ndarray_dict(path))
    jtree = convert_2d106det_params(load_ndarray_dict(path))
    flat_t, flat_j = _flat(tree), _flat(jtree)
    assert flat_t.keys() == flat_j.keys()
    for k in flat_t:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])

    want = _jax_apply(FULL_PRECISION, tree, x)
    model = load_flax_variables(tlm.Landmark106Det(policy=TFULL), tree)
    # the bridge's inverse gives the converter's tree back
    back = _flat(flax_variables(model))
    assert back.keys() == flat_t.keys()
    for k in back:
        np.testing.assert_array_equal(back[k], flat_t[k])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (B, 106, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    interp = tgraph.MXNetGraphInterpreter(symbol, device="cpu").run(
        params, x.transpose(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got.reshape(B, 212), interp, rtol=0,
                               atol=1e-4 * scale)

    want16 = _jax_apply(DEFAULT_POLICY, tree, x)
    model16 = load_flax_variables(tlm.Landmark106Det(policy=TDEFAULT), tree)
    with torch.no_grad():
        got16 = model16.eval()(torch.from_numpy(x)).numpy()
    jax_err = np.abs(want16 - want).max()
    assert np.abs(got16 - want16).max() <= 2 * jax_err + 1e-3 * scale


def test_landmark106det_prefixed_and_split_dicts(checkpoint):
    params, _, _ = checkpoint
    pre = twi.prefixed(params)
    arg = {k[4:]: v for k, v in pre.items() if k.startswith("arg:")}
    aux = {k[4:]: v for k, v in pre.items() if k.startswith("aux:")}
    a = _flat(tlm.convert_2d106det_params(pre))
    b = _flat(tlm.convert_2d106det_params(arg, aux))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # the FC's NCHW flatten reordered to the model's (H, W, C) flatten
    w = params["fc1_weight"].reshape(212, 64, 3, 3)
    np.testing.assert_array_equal(
        a["params/fc1/kernel"].reshape(3, 3, 64, 212),
        w.transpose(2, 3, 1, 0))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out
