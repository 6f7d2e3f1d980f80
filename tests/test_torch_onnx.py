"""The port's ONNX reader, writer, emitters and executor
(`ghost_tpu_torch/convert/onnx_*.py`) against ghost_tpu's.

- Reader: the same bytes (raw and typed tensor data, packed and unpacked
  fields, negative int64/int32 values, every attribute kind) give equal
  nodes, attributes, initializers and graph I/O.
- Writer and emitters: `emit_arcface` (iresnet (1,1,1,1)) and `emit_aei`
  (unet, 2 blocks, width 1/16) on the same seeded trees write the same
  bytes as the JAX emitters.
- Executor: one case per op family, on the graphs of
  `tests/test_onnx_exec.py` and graphs written with the port's
  `OnnxBuilder`, against the JAX `OnnxExecutor` run eagerly (no jit),
  within 1e-5 in f32 (rtol and atol). Unsupported ops, `auto_pad` and a
  grouped ConvTranspose raise at construction.
- Round trips, f32 within 1e-4: the executor on the emitted ArcFace
  against the port's `IResNet`, and on the emitted AEI-Net against the
  port's `AEINet(fused_aad=False)`, on the same weights.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghost_tpu_torch.convert import onnx_reader as treader
from ghost_tpu_torch.convert.onnx_exec import OnnxExecutor
from ghost_tpu_torch.convert.onnx_writer import (OnnxBuilder, _ld, _tag,
                                                 _varint, _vi)
from test_onnx_exec import model_bytes, node
from torch_cli_inputs import aei_state_dict, arcface_state_dict

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------------ reader
def _typed_tensor(name, dims, code, field, wire, values, packed_dims=False):
    """A TensorProto with typed (not raw) data."""
    if packed_dims:
        out = _ld(1, b"".join(_varint(d) for d in dims))
    else:
        out = b"".join(_vi(1, d) for d in dims)
    out += _vi(2, code) + _ld(8, name.encode())
    if wire == 2 and field == 4:
        out += _ld(4, struct.pack(f"<{len(values)}f", *values))
    elif wire == 5:
        out += b"".join(_tag(4, 5) + struct.pack("<f", v) for v in values)
    elif wire == 2:
        out += _ld(field, b"".join(_varint(v + (1 << 64) if v < 0 else v)
                                   for v in values))
    else:
        out += b"".join(_vi(field, v) for v in values)
    return out


def _reader_model():
    """Initializers raw (f32, negative int64, uint8, f16, bool) and typed
    (packed / unpacked float, int64, int32; packed dims; a scalar), and a
    node with every attribute kind, some values negative."""
    from ghost_tpu_torch.convert.onnx_writer import (_attribute_proto,
                                                     _tensor_proto,
                                                     _value_info)

    inits = [
        _tensor_proto("raw_f32", np.arange(6, dtype=np.float32).reshape(3, 2)),
        _tensor_proto("raw_i64", np.asarray([-1, -1000, 3, 2 ** 40],
                                            np.int64)),
        _tensor_proto("raw_u8", np.asarray([[0, 255], [7, 9]], np.uint8)),
        _tensor_proto("raw_f16", np.asarray([1.5, -2.25], np.float16)),
        _tensor_proto("raw_bool", np.asarray([True, False])),
        _typed_tensor("f_packed", [2, 2], 1, 4, 2, [0.5, -1.5, 2.0, 3.25],
                      packed_dims=True),
        _typed_tensor("f_unpacked", [3], 1, 4, 5, [1.0, -2.0, 4.5]),
        _typed_tensor("i64_packed", [3], 7, 7, 2, [-5, 0, 9]),
        _typed_tensor("i64_unpacked", [2], 7, 7, 0, [-(1 << 62), 11]),
        _typed_tensor("i32_packed", [2], 6, 5, 2, [-3, 4]),
        _typed_tensor("i32_unpacked", [1, 2], 6, 5, 0, [-7, 8]),
        _typed_tensor("scalar", [], 1, 4, 2, [0.75]),
    ]
    attrs = [("f", 0.125), ("i", -3), ("s", "nearest"),
             ("t", np.asarray([-1, 2], np.int64)), ("ints", [4, -2, 0]),
             ("floats", [0.5, 1.5])]
    nbuf = _ld(1, b"x") + _ld(1, b"raw_f32") + _ld(2, b"y") + _ld(3, b"n0")
    nbuf += _ld(4, b"Custom")
    for k, v in attrs:
        nbuf += _ld(5, _attribute_proto(k, v))
    # unpacked ints / floats and strings, as some exporters write them
    nbuf += _ld(5, _ld(1, b"ints_u") + _vi(8, -9) + _vi(8, 5))
    nbuf += _ld(5, _ld(1, b"floats_u") + _tag(7, 5) + struct.pack("<f", 2.5))
    nbuf += _ld(5, _ld(1, b"strs") + _ld(9, b"a") + _ld(9, b"bc"))
    graph = _ld(1, nbuf) + b"".join(_ld(5, t) for t in inits)
    graph += _ld(11, _value_info("x", ["b", 3])) + _ld(11, _value_info(
        "raw_f32", [3, 2])) + _ld(12, _value_info("y", ["b", 3]))
    return _ld(7, graph)


def test_reader_matches_jax(tmp_path):
    from ghost_tpu.convert import onnx_reader as jreader

    path = tmp_path / "m.onnx"
    path.write_bytes(_reader_model())
    got, ref = treader.read_onnx_graph(str(path)), \
        jreader.read_onnx_graph(str(path))
    assert (got.inputs, got.outputs) == (ref.inputs, ref.outputs) == \
        (["x"], ["y"])
    assert sorted(got.initializers) == sorted(ref.initializers)
    for k, r in ref.initializers.items():
        g = got.initializers[k]
        assert g.dtype == r.dtype and g.shape == r.shape, k
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got.initializers["raw_i64"],
                                  [-1, -1000, 3, 2 ** 40])
    np.testing.assert_array_equal(got.initializers["i64_unpacked"],
                                  [-(1 << 62), 11])
    assert got.initializers["scalar"].shape == ()
    assert len(got.nodes) == len(ref.nodes) == 1
    g, r = got.nodes[0], ref.nodes[0]
    assert (g.op_type, g.inputs, g.outputs, g.name) == \
        (r.op_type, r.inputs, r.outputs, r.name)
    assert sorted(g.attrs) == sorted(r.attrs)
    for k, v in r.attrs.items():
        np.testing.assert_array_equal(np.asarray(g.attrs[k]), np.asarray(v))
        assert type(g.attrs[k]) is type(v), k
    assert g.attrs["i"] == -3 and g.attrs["ints_u"] == [-9, 5]
    assert g.attrs["strs"] == ["a", "bc"]
    assert treader.read_onnx_initializers(str(path)).keys() == \
        ref.initializers.keys()


# ------------------------------------------------------ writer / emitters
@pytest.fixture(scope="module")
def arcface_tree():
    from ghost_tpu_torch.convert.torch_loader import convert_arcface_state_dict

    rng = np.random.default_rng(3)
    return convert_arcface_state_dict(arcface_state_dict(rng, (1, 1, 1, 1)),
                                      layers=(1, 1, 1, 1))


@pytest.fixture(scope="module")
def aei_tree():
    from ghost_tpu_torch.convert.torch_loader import convert_aei_state_dict

    rng = np.random.default_rng(4)
    return convert_aei_state_dict(aei_state_dict(rng, "unet", 2, 1 / 16),
                                  backbone="unet", num_blocks=2)


@pytest.mark.parametrize("model", ["arcface", "aei"])
def test_emitters_byte_identical(model, request):
    from ghost_tpu.convert import onnx_emit as jemit
    from ghost_tpu_torch.convert import onnx_emit as temit

    tree = request.getfixturevalue(f"{model}_tree")
    if model == "arcface":
        got = temit.emit_arcface(tree, layers=(1, 1, 1, 1))
        ref = jemit.emit_arcface(tree, layers=(1, 1, 1, 1))
    else:
        got = temit.emit_aei(tree, backbone="unet", num_blocks=2)
        ref = jemit.emit_aei(tree, backbone="unet", num_blocks=2)
    assert len(got) > 100_000 and got == ref


# ---------------------------------------------------------------- executor
def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _exec_graphs():
    """name -> (onnx bytes, feeds): the four graphs of
    tests/test_onnx_exec.py and one graph per further op family."""
    g = {}
    # tests/test_onnx_exec.py:108-150
    x = _rand(0, (2, 3, 16, 16))
    inits = {"w": _rand(1, (8, 3, 3, 3), 0.2), "b": _rand(2, (8,), 0.2),
             "s": np.abs(_rand(3, (8,), 0.1) + 1), "bb": _rand(4, (8,), 0.1),
             "m": _rand(5, (8,), 0.1), "v": np.abs(_rand(6, (8,), 0.1) + 1),
             "fw": _rand(7, (4, 8 * 8 * 8), 0.1),
             "fb": np.zeros(4, np.float32)}
    nodes = [
        node("Conv", ["x", "w", "b"], ["c"], kernel_shape=[3, 3],
             strides=[1, 1], pads=[1, 1, 1, 1]),
        node("BatchNormalization", ["c", "s", "bb", "m", "v"], ["bn"],
             epsilon=1e-5),
        node("Relu", ["bn"], ["r"]),
        node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2], strides=[2, 2]),
        node("Flatten", ["p"], ["f"], axis=1),
        node("Gemm", ["f", "fw", "fb"], ["y"], transB=1),
    ]
    g["conv_bn_relu_pool_gemm"] = (model_bytes(nodes, inits, ["x"], ["y"]),
                                   {"x": x})
    # :152-171
    nodes = [
        node("ConvTranspose", ["x", "w"], ["d"], kernel_shape=[4, 4],
             strides=[2, 2], pads=[1, 1, 1, 1]),
        node("InstanceNormalization", ["d", "s", "bb"], ["y"], epsilon=1e-5),
    ]
    inits = {"w": _rand(1, (4, 6, 4, 4), 0.2),
             "s": np.abs(_rand(2, (6,), 0.1) + 1), "bb": _rand(3, (6,), 0.1)}
    g["convtranspose_instancenorm"] = (
        model_bytes(nodes, inits, ["x"], ["y"]), {"x": _rand(0, (1, 4, 8, 8))})
    # :173-201
    nodes = [
        node("Shape", ["x"], ["sh"]),
        node("Gather", ["sh", "zero"], ["b"], axis=0),
        node("Unsqueeze", ["b"], ["b1"], axes=[0]),
        node("Concat", ["b1", "minus1"], ["newshape"], axis=0),
        node("Reshape", ["x", "newshape"], ["flat"]),
        node("Slice", ["flat", "st", "en", "ax"], ["sl"]),
        node("Resize", ["x", "", "scales"], ["up"], mode="nearest"),
    ]
    inits = {"zero": np.asarray(0, np.int64),
             "minus1": np.asarray([-1], np.int64),
             "st": np.asarray([0], np.int64), "en": np.asarray([5], np.int64),
             "ax": np.asarray([1], np.int64),
             "scales": np.asarray([1, 1, 2, 2], np.float32)}
    g["shape_reshape_slice_concat_resize"] = (
        model_bytes(nodes, inits, ["x"], ["flat", "sl", "up"]),
        {"x": np.arange(96, dtype=np.float32).reshape(2, 3, 4, 4)})
    # :203-225
    nodes = [
        node("PRelu", ["x", "slope"], ["p"]),
        node("Pad", ["p", "pads"], ["pp"], mode="constant"),
        node("AveragePool", ["pp"], ["a"], kernel_shape=[2, 2],
             strides=[2, 2]),
        node("LeakyRelu", ["a"], ["y"], alpha=0.2),
    ]
    inits = {"slope": np.asarray([0.1, 0.3], np.float32),
             "pads": np.asarray([0, 0, 1, 1, 0, 0, 1, 1], np.int64)}
    g["prelu_pad_avgpool_leaky"] = (model_bytes(nodes, inits, ["x"], ["y"]),
                                    {"x": _rand(0, (1, 2, 6, 6))})

    # elementwise and comparisons
    b = OnnxBuilder()
    x, y = b.graph_input("x", [2, 3, 4, 5]), b.graph_input("y", [2, 3, 4, 5])
    half = b.initializer(np.float32(0.5).reshape(()))
    lo, hi = (b.initializer(np.float32(v).reshape(())) for v in (-0.7, 0.9))
    outs = [
        b.node("Add", [x, y]), b.node("Sub", [x, y]), b.node("Mul", [x, half]),
        b.node("Div", [x, b.node("Add", [b.node("Abs", [y]), half])]),
        b.node("Pow", [b.node("Abs", [x]), half]),
        b.node("Sqrt", [b.node("Abs", [y])]), b.node("Exp", [x]),
        b.node("Neg", [x]), b.node("Erf", [x]), b.node("Sigmoid", [x]),
        b.node("Tanh", [x]), b.node("Softmax", [x], axis=1),
        b.node("Clip", [x, lo, hi]), b.node("Clip", [x], min=-0.2, max=0.3),
        b.node("Where", [b.node("Greater", [x, y]), x, y]),
        b.node("Cast", [b.node("Equal", [x, x])], to=1),
        b.node("Cast", [b.node("Less", [x, y])], to=1),
        b.node("Relu", [x]), b.node("Identity", [b.node("Dropout", [x])]),
        b.node("LeakyRelu", [x]),
    ]
    for i, o in enumerate(outs):
        b.graph_output(o, [2, 3, 4, 5])
    g["elementwise"] = (b.serialize(), {"x": _rand(10, (2, 3, 4, 5)),
                                        "y": _rand(11, (2, 3, 4, 5))})

    # structure: shapes on the host, data on the device
    b = OnnxBuilder()
    x = b.graph_input("x", [2, 6, 4, 3])
    c_f = b.node("Constant", [], value=np.asarray([[1.5], [-2.0]],
                                                  np.float32))
    c_i = b.node("Constant", [], value=np.asarray([2, 0], np.int64))
    sizes = b.initializer(np.asarray([2, 4], np.int64))
    parts = b.node("Split", [x], n_out=3, axis=1)
    parts2 = b.node("Split", [x, sizes], n_out=2, axis=1)
    sh = b.node("Shape", [x])
    zeros = b.node("ConstantOfShape", [sh], value=np.asarray([0.25],
                                                             np.float32))
    outs = list(parts) + list(parts2) + [
        b.node("Transpose", [x], perm=[0, 2, 3, 1]),
        b.node("Transpose", [x]),
        b.node("Gather", [x, b.initializer(np.asarray([[-1, 0], [2, 1]],
                                                      np.int64))], axis=1),
        b.node("Gather", [x, c_i], axis=3),
        b.node("Squeeze", [b.node("Unsqueeze", [x], axes=[0, 3])],
               axes=[0]),
        b.node("Unsqueeze", [x, b.initializer(np.asarray([-1], np.int64))]),
        b.node("Expand", [c_f, b.initializer(np.asarray([2, 1, 3],
                                                        np.int64))]),
        b.node("Expand", [b.node("Slice", [
            x, *(b.initializer(np.asarray(v, np.int64))
                 for v in ([0], [1], [1]))]),
            b.initializer(np.asarray([2, 6, 4, 3], np.int64))]),
        b.node("Tile", [x, b.initializer(np.asarray([1, 2, 1, 2],
                                                    np.int64))]),
        b.node("Concat", [x, x], axis=-1),
        b.node("Flatten", [x], axis=2),
        b.node("Add", [x, zeros]),
        b.node("Mul", [b.node("Cast", [sh], to=1), c_f]),
        b.node("Cast", [b.node("Mul", [x, b.initializer(
            np.float32(3.0).reshape(()))])], to=6),
        b.node("Div", [sh, b.initializer(np.asarray(2, np.int64))]),
    ]
    for o in outs:
        b.graph_output(o, ["?"])
    g["structure"] = (b.serialize(), {"x": _rand(12, (2, 6, 4, 3))})

    # conv and linear variants
    b = OnnxBuilder()
    x = b.graph_input("x", [2, 4, 9, 11])
    outs = [
        b.node("Conv", [x, b.initializer(_rand(20, (6, 2, 3, 3), 0.3)),
                        b.initializer(_rand(21, (6,), 0.1))],
               kernel_shape=[3, 3], strides=[2, 1], pads=[1, 0, 2, 1],
               dilations=[1, 2], group=2),
        b.node("ConvTranspose", [x, b.initializer(_rand(22, (4, 3, 3, 3),
                                                        0.3)),
                                 b.initializer(_rand(23, (3,), 0.1))],
               kernel_shape=[3, 3], strides=[2, 3], pads=[1, 0, 0, 2],
               output_padding=[1, 2]),
        b.node("MatMul", [x, b.initializer(_rand(24, (11, 5), 0.3))]),
        b.node("Gemm", [b.node("Flatten", [x], axis=1),
                        b.initializer(_rand(25, (7, 4 * 9 * 11), 0.05)),
                        b.initializer(_rand(26, (7,), 0.1))],
               transB=1, alpha=0.5, beta=2.0),
        b.node("Gemm", [b.initializer(_rand(27, (2, 5), 0.3)),
                        b.node("Flatten", [x], axis=1)], transA=1),
    ]
    for o in outs:
        b.graph_output(o, ["?"])
    g["conv_linear"] = (b.serialize(), {"x": _rand(13, (2, 4, 9, 11))})

    # pools and reductions
    b = OnnxBuilder()
    x = b.graph_input("x", [2, 3, 9, 10])
    outs = [
        b.node("MaxPool", [x], kernel_shape=[3, 3], strides=[2, 2],
               pads=[1, 1, 0, 1], ceil_mode=1),
        b.node("AveragePool", [x], kernel_shape=[3, 2], strides=[2, 2],
               pads=[1, 1, 1, 1], count_include_pad=1),
        b.node("AveragePool", [x], kernel_shape=[3, 3], strides=[2, 2],
               pads=[1, 0, 1, 1], ceil_mode=1),
        b.node("GlobalAveragePool", [x]),
        b.node("ReduceMean", [x], axes=[2, 3], keepdims=0),
        b.node("ReduceSum", [x, b.initializer(np.asarray([1], np.int64))]),
        b.node("ReduceMax", [x], axes=[-1]),
        b.node("ReduceMean", [x], keepdims=0),
    ]
    for o in outs:
        b.graph_output(o, ["?"])
    g["pool_reduce"] = (b.serialize(), {"x": _rand(14, (2, 3, 9, 10))})

    # resize routes
    b = OnnxBuilder()
    x = b.graph_input("x", [1, 3, 5, 7])
    sc2 = b.initializer(np.asarray([1, 1, 2, 2], np.float32))
    outs = [
        b.node("Upsample", [x], mode="nearest", scales=[1.0, 1.0, 2.0, 3.0]),
        b.node("Upsample", [x, b.initializer(np.asarray([1, 1, 3, 2],
                                                        np.float32))]),
        b.node("Resize", [x, "", sc2], mode="linear",
               coordinate_transformation_mode="align_corners"),
        b.node("Resize", [x, "", sc2], mode="linear"),
        b.node("Resize", [x, "", "", b.initializer(
            np.asarray([1, 3, 8, 4], np.int64))], mode="nearest",
            coordinate_transformation_mode="asymmetric",
            nearest_mode="floor"),
        b.node("Resize", [x, "", b.initializer(np.asarray(
            [1, 1, 1.5, 0.5], np.float32))], mode="linear"),
    ]
    for o in outs:
        b.graph_output(o, ["?"])
    g["resize"] = (b.serialize(), {"x": _rand(15, (1, 3, 5, 7))})

    # slices and pads
    b = OnnxBuilder()
    x = b.graph_input("x", [2, 3, 6, 7])

    def ints(v):
        return b.initializer(np.asarray(v, np.int64))
    outs = [
        b.node("Slice", [x, ints([-1, 5]), ints([-10 ** 12, 0]),
                         ints([2, 3]), ints([-1, -2])]),
        b.node("Slice", [x, ints([1]), ints([2 ** 62]), ints([-1]),
                         ints([2])]),
        b.node("Slice", [x], starts=[0, 1], ends=[1, 3], axes=[0, 1]),
        b.node("Pad", [x, ints([0, 0, 2, 1, 0, 0, 1, 3])], mode="reflect"),
        b.node("Pad", [x, ints([0, 1, 1, 0, 0, 0, 2, 2])], mode="edge"),
        b.node("Pad", [x, ints([0, 0, 1, 2, 0, 0, 3, 0]),
                       b.initializer(np.float32(-1.5).reshape(()))]),
    ]
    for o in outs:
        b.graph_output(o, ["?"])
    g["slice_pad"] = (b.serialize(), {"x": _rand(16, (2, 3, 6, 7))})
    return g


_GRAPHS = _exec_graphs()


def _run_both(tmp_path, blob, feeds):
    from ghost_tpu.convert.onnx_exec import OnnxExecutor as JExecutor
    from ghost_tpu.convert.onnx_reader import read_onnx_graph as jread

    path = tmp_path / "m.onnx"
    path.write_bytes(blob)
    ref = JExecutor(jread(str(path)))({k: jnp.asarray(v)
                                       for k, v in feeds.items()})
    ex = OnnxExecutor(treader.read_onnx_graph(str(path)), device="cpu")
    got = ex({k: torch.from_numpy(v) for k, v in feeds.items()})
    return got, ref


@pytest.mark.parametrize("family", sorted(_GRAPHS))
def test_executor_matches_jax(tmp_path, family):
    """Each output equal in shape and within 1e-5 (f32) of the JAX
    executor's; float outputs are tensors on the executor's device."""
    blob, feeds = _GRAPHS[family]
    got, ref = _run_both(tmp_path, blob, feeds)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        if isinstance(g, torch.Tensor):
            g = g.numpy()
        else:  # a shape-carrying value stays on the host
            assert r.dtype.kind != "f", (family, i)
        assert np.shape(g) == r.shape, (family, i)
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   r.astype(np.float64), **TOL,
                                   err_msg=f"{family} output {i}")


def test_feeds_shadow_initializers(tmp_path):
    """A feed named like an initializer replaces it, as in JAX: a fed
    BatchNormalization variance changes the result."""
    blob, feeds = _GRAPHS["conv_bn_relu_pool_gemm"]
    feeds = dict(feeds, v=np.full(8, 4.0, np.float32),
                 w=_rand(30, (8, 3, 3, 3), 0.2))
    got, ref = _run_both(tmp_path, blob, feeds)
    base, _ = _run_both(tmp_path, *_GRAPHS["conv_bn_relu_pool_gemm"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    assert not np.allclose(got[0].numpy(), base[0].numpy(), atol=1e-3)


@pytest.mark.parametrize("bad,match", [
    (node("NonMaxSuppression", ["x"], ["y"]), "NonMaxSuppression"),
    (node("Conv", ["x", "w"], ["y"], kernel_shape=[1, 1],
          auto_pad="SAME_UPPER"), "auto_pad=SAME_UPPER"),
    (node("MaxPool", ["x"], ["y"], kernel_shape=[2, 2], auto_pad="VALID"),
     "auto_pad=VALID"),
    (node("ConvTranspose", ["x", "w"], ["y"], kernel_shape=[1, 1], group=2),
     "grouped ConvTranspose"),
])
def test_executor_refuses_at_construction(tmp_path, bad, match):
    path = tmp_path / "bad.onnx"
    path.write_bytes(model_bytes([bad], {"w": np.ones((2, 1, 1, 1),
                                                      np.float32)},
                                 ["x"], ["y"]))
    with pytest.raises(NotImplementedError, match=match):
        OnnxExecutor(treader.read_onnx_graph(str(path)), device="cpu")


def test_executor_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    path = tmp_path / "m.onnx"
    path.write_bytes(_GRAPHS["elementwise"][0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnnxExecutor(treader.read_onnx_graph(str(path)))


# -------------------------------------------------------------- round trips
def test_round_trip_arcface(tmp_path, arcface_tree):
    """emit_arcface -> the port's executor equals the port's IResNet on
    the same weights (f32, 1e-4)."""
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.onnx_emit import emit_arcface
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.arcface import IResNet

    tree = arcface_tree
    path = tmp_path / "arc.onnx"
    path.write_bytes(emit_arcface(tree, layers=(1, 1, 1, 1)))
    ex = OnnxExecutor(treader.read_onnx_graph(str(path)), device="cpu")
    net = load_flax_variables(IResNet((1, 1, 1, 1), policy=FULL_PRECISION),
                              tree).eval()
    x = np.random.default_rng(5).uniform(-1, 1, (2, 112, 112, 3)).astype(
        np.float32)
    with torch.inference_mode():
        ref = net(torch.from_numpy(x))
        (got,) = ex({"input": torch.from_numpy(x).permute(0, 3, 1, 2)})
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_round_trip_aei(tmp_path, aei_tree):
    """emit_aei -> the port's executor equals the port's
    AEINet(fused_aad=False) on the same weights (f32, 1e-4)."""
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.onnx_emit import emit_aei
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.aei import AEINet

    tree = aei_tree
    path = tmp_path / "aei.onnx"
    path.write_bytes(emit_aei(tree, backbone="unet", num_blocks=2))
    ex = OnnxExecutor(treader.read_onnx_graph(str(path)), device="cpu")
    net = load_flax_variables(AEINet("unet", num_blocks=2,
                                     policy=FULL_PRECISION, width=1 / 16,
                                     fused_aad=False), tree).eval()
    rng = np.random.default_rng(6)
    xt = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    z = rng.standard_normal((1, 512)).astype(np.float32)
    z /= np.linalg.norm(z)
    with torch.inference_mode():
        ref = net(torch.from_numpy(xt), torch.from_numpy(z))[0]
        (got,) = ex({"xt": torch.from_numpy(xt).permute(0, 3, 1, 2),
                     "z_id": torch.from_numpy(z)})
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref.numpy(),
                               rtol=1e-4, atol=1e-4)
