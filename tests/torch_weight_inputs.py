"""Seeded inputs of the weight-conversion and export CLIs, made with
numpy: a 2d106det MXNet symbol JSON (the layer plan of
`models/landmark_mxnet.py:conv_plan`, in MXNet's node layout; no real
one ships in the repository) and its `.params` file in the
`save_checkpoint` layout, a WFLW_4HG-layout AdaptiveWingLoss FAN state
dict at any size, and a torchvision VGG19 `features.*` state dict. No
jax here: `chip_smoke.py` uses them too.

Kernels are drawn with std 1/sqrt(fan_in) so activations keep their
scale through the deep stacks; BatchNorm is moved off identity.
"""

from __future__ import annotations

import json

import numpy as np

from ghost_tpu_torch.models.landmark_mxnet import conv_plan

VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def _kernel(rng, *shape):
    fan = int(np.prod(shape[1:]))
    return (rng.standard_normal(shape, dtype=np.float32)
            / np.float32(np.sqrt(fan)))


def _vec(rng, n, scale=0.05):
    return rng.standard_normal(n, dtype=np.float32) * np.float32(scale)


def _bn(rng, sd, name, ch):
    sd[f"{name}.weight"] = 1.0 + _vec(rng, ch)
    sd[f"{name}.bias"] = _vec(rng, ch)
    sd[f"{name}.running_mean"] = _vec(rng, ch)
    sd[f"{name}.running_var"] = 1.0 + np.abs(_vec(rng, ch))


# ------------------------------------------------------------ 2d106det


# a 3-block graph of the same ops (a grouped conv among them), for the
# interpreters' cross-check at a small cost
SMALL_PLAN = [("conv_1_conv2d", (3, 3), 2, 1, 8, 1),
              ("conv_2_dw_conv2d", (3, 3), 2, 1, 8, 8),
              ("conv_2_conv2d", (1, 1), 1, 0, 12, 1)]


def symbol_2d106det(plan=None) -> dict:
    """The 2d106det symbol graph (insightface's coordinate_reg model) as
    MXNet writes it: data, the input scaling, 29 Convolution +
    BatchNorm(fix_gamma, eps 1e-3) + LeakyReLU(prelu) blocks in
    `conv_plan()`'s order (or `plan`'s) with their parameter nodes,
    Flatten and FullyConnected(212)."""
    nodes = []

    def node(op, name, inputs=(), **attrs):
        n = {"op": op, "name": name,
             "inputs": [[i, 0, 0] for i in inputs]}
        if attrs:
            n["attrs"] = {k: str(v) for k, v in attrs.items()}
        nodes.append(n)
        return len(nodes) - 1

    def var(name):
        return node("null", name)

    x = var("data")
    x = node("_minus_scalar", "_minusscalar0", [x], scalar="127.5")
    x = node("_mul_scalar", "_mulscalar0", [x], scalar="0.0078125")
    for name, (kh, kw), s, p, f, g in plan or conv_plan():
        base = name[:-len("_conv2d")]
        w = var(f"{name}_weight")
        x = node("Convolution", name, [x, w], kernel=f"({kh}, {kw})",
                 stride=f"({s}, {s})", pad=f"({p}, {p})", num_filter=f,
                 num_group=g, no_bias="True")
        bn_in = [var(f"{base}_batchnorm_{k}")
                 for k in ("gamma", "beta", "moving_mean", "moving_var")]
        x = node("BatchNorm", f"{base}_batchnorm", [x] + bn_in,
                 eps="0.001", fix_gamma="True", momentum="0.9")
        x = node("LeakyReLU", f"{base}_relu",
                 [x, var(f"{base}_relu_gamma")], act_type="prelu")
    x = node("Flatten", "flatten0", [x])
    heads = node("FullyConnected", "fc1",
                 [x, var("fc1_weight"), var("fc1_bias")], num_hidden=212)
    arg_nodes = [i for i, n in enumerate(nodes) if n["op"] == "null"]
    return {"nodes": nodes, "arg_nodes": arg_nodes,
            "heads": [[heads, 0, 0]], "attrs": {"mxnet_version": [
                "int", 10300]}}


def write_symbol_2d106det(path, plan=None) -> str:
    with open(path, "w") as f:
        json.dump(symbol_2d106det(plan), f, indent=2)
    return str(path)


def prefixed(params: dict) -> dict:
    """Bare graph-input names -> `save_checkpoint`'s layout: the moving
    statistics under `aux:`, everything else under `arg:`."""
    return {(f"aux:{k}" if "moving_" in k else f"arg:{k}"): v
            for k, v in params.items()}


# ------------------------------------------------------------- FAN AWL


def _convblock(rng, sd, name, cin, cout):
    _bn(rng, sd, f"{name}.bn1", cin)
    sd[f"{name}.conv1.weight"] = _kernel(rng, cout // 2, cin, 3, 3)
    _bn(rng, sd, f"{name}.bn2", cout // 2)
    sd[f"{name}.conv2.weight"] = _kernel(rng, cout // 4, cout // 2, 3, 3)
    _bn(rng, sd, f"{name}.bn3", cout // 4)
    sd[f"{name}.conv3.weight"] = _kernel(rng, cout // 4, cout // 4, 3, 3)
    if cin != cout:
        _bn(rng, sd, f"{name}.downsample.0", cin)
        sd[f"{name}.downsample.2.weight"] = _kernel(rng, cout, cin, 1, 1)


def _conv_b(rng, sd, name, cout, cin, k, bias_scale=0.05):
    sd[f"{name}.weight"] = _kernel(rng, cout, cin, k, k)
    sd[f"{name}.bias"] = _vec(rng, cout, bias_scale)


def fan_awl_state_dict(rng, num_modules=4, depth=4, features=256,
                       mid_features=128, num_landmarks=98) -> dict:
    """A WFLW_4HG.pth-layout state dict (the public AdaptiveWingLoss
    core/models.py FAN: CoordConv stems, ConvBlocks, hourglasses, heads),
    each stack's head biased so its boundary channel crosses the 0.05
    gate of the next stack's coordinates."""
    f, mid, nh = features, mid_features, num_landmarks + 1
    sd = {}
    _conv_b(rng, sd, "conv1.conv", 64, 3 + 3, 7)
    _bn(rng, sd, "bn1", 64)
    _convblock(rng, sd, "conv2", 64, mid)
    _convblock(rng, sd, "conv3", mid, mid)
    _convblock(rng, sd, "conv4", mid, f)
    for m in range(num_modules):
        _conv_b(rng, sd, f"m{m}.coordconv.conv", f,
                f + 3 + (0 if m == 0 else 2), 1)
        for d in range(depth, 0, -1):
            for b in ("b1", "b2", "b3"):
                _convblock(rng, sd, f"m{m}.{b}_{d}", f, f)
        _convblock(rng, sd, f"m{m}.b2_plus_1", f, f)
        _convblock(rng, sd, f"top_m_{m}", f, f)
        _conv_b(rng, sd, f"conv_last{m}", f, f, 1)
        _bn(rng, sd, f"bn_end{m}", f)
        _conv_b(rng, sd, f"l{m}", nh, f, 1)
        sd[f"l{m}.bias"] = rng.uniform(-0.2, 0.3, nh).astype(np.float32)
        if m < num_modules - 1:
            _conv_b(rng, sd, f"bl{m}", f, f, 1)
            _conv_b(rng, sd, f"al{m}", f, nh, 1)
    return sd


# --------------------------------------------------------------- VGG19


def vgg19_state_dict(rng) -> dict:
    """torchvision vgg19's `features.{i}.weight/bias` (the convs; pools
    and ReLUs hold no tensors)."""
    sd, cin, idx = {}, 3, 0
    for item in VGG19_CFG:
        if item == "M":
            idx += 1
            continue
        _conv_b(rng, sd, f"features.{idx}", item, cin, 3)
        cin, idx = item, idx + 2
    return sd
