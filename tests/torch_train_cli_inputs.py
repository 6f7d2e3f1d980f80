"""Seeded inputs of the train CLI, made with numpy and the port: state
dicts with the reference's names and shapes for what `D_*.pth` (the
multiscale discriminator, getIntermFeat=False) and `10_net_G.pth` (the
LIPSPADE SR generator) hold, a FAN variables tree in the flax layout of
`ghost_tpu/models/fan.py` (what `--fan_path` reads as msgpack), a graph
with inswapper_128's signature, and a directory of face jpgs; and a spy
on either CLI's `train_loop`. No jax here: `chip_smoke.py` phase 21 uses
them too.

Kernels are drawn with std 1/sqrt(fan_in), BatchNorm is moved off
identity, and the spectral-norm pairs (u, v) are the power iteration's.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from torch_cli_inputs import _bn, _kernel, _vec


def disc_state_dict(rng, num_D=2, n_layers=3, ndf=8):
    """A D_*.pth state dict with the reference's key names
    (`layer{i}.{idx}.weight|bias`, getIntermFeat=False)."""
    sd = {}
    for i in range(num_D):
        cin, nf = 3, ndf
        for n in range(n_layers + 1):
            idx = 0 if n == 0 else 2 + 3 * (n - 1)
            sd[f"layer{i}.{idx}.weight"] = rng.normal(
                0, 0.1, (nf, cin, 4, 4)).astype(np.float32)
            sd[f"layer{i}.{idx}.bias"] = rng.normal(0, 0.05, nf).astype(
                np.float32)
            cin, nf = nf, min(nf * 2, 512)
        head = 2 + 3 * n_layers
        sd[f"layer{i}.{head}.weight"] = rng.normal(
            0, 0.1, (1, cin, 4, 4)).astype(np.float32)
        sd[f"layer{i}.{head}.bias"] = np.zeros(1, np.float32)
    return sd


def _spectral(rng, sd, name, cout, cin, k, bias=True):
    """A spectral-norm conv whose (u, v) are the power iteration's pair
    (what a trained checkpoint stores), so u @ W v is W's largest
    singular value."""
    w = _kernel(rng, cout, cin, k, k)
    sd[f"{name}.weight_orig"] = w
    if bias:
        sd[f"{name}.bias"] = _vec(rng, cout)
    mat = w.reshape(cout, -1).astype(np.float64)
    u = rng.standard_normal(cout)
    for _ in range(30):
        v = mat.T @ u
        v /= np.linalg.norm(v)
        u = mat @ v
        u /= np.linalg.norm(u)
    sd[f"{name}.weight_u"] = u.astype(np.float32)
    sd[f"{name}.weight_v"] = v.astype(np.float32)


def _spade(rng, sd, name, norm_nc, label_nc=3):
    nhidden = 128 if norm_nc > 128 else norm_nc
    sd[f"{name}.mlp_shared.0.weight"] = _kernel(rng, nhidden, label_nc, 3, 3)
    sd[f"{name}.mlp_shared.0.bias"] = _vec(rng, nhidden)
    sd[f"{name}.mlp_gamma.weight"] = _kernel(rng, norm_nc, nhidden, 3, 3)
    sd[f"{name}.mlp_beta.weight"] = _kernel(rng, norm_nc, nhidden, 3, 3)
    sd[f"{name}.param_free_norm.running_mean"] = _vec(rng, norm_nc)
    sd[f"{name}.param_free_norm.running_var"] = 1.0 + np.abs(
        _vec(rng, norm_nc))


def spade_state_dict(rng, ngf=48, n_2xdown=5):
    """A LIPSPADE `10_net_G.pth` state dict (SPADEGenerator blocks, the
    to_rgbs list, of which the last is read, and the LIP encoder)."""
    sd = {}
    blocks = [("head_0", 16, 16), ("G_middle_0", 16, 16),
              ("G_middle_1", 16, 16), ("ups.0", 16, 8), ("ups.1", 8, 4),
              ("ups.2", 4, 2), ("ups.3", 2, 1)]
    for name, fin, fout in blocks:
        fin, fout = fin * ngf, fout * ngf
        mid = min(fin, fout)
        _spade(rng, sd, f"{name}.norm_0", fin)
        _spectral(rng, sd, f"{name}.conv_0", mid, fin, 3)
        _spade(rng, sd, f"{name}.norm_1", mid)
        _spectral(rng, sd, f"{name}.conv_1", fout, mid, 3)
        if fin != fout:
            _spade(rng, sd, f"{name}.norm_s", fin)
            _spectral(rng, sd, f"{name}.conv_s", fout, fin, 1, bias=False)
    for i, ch in enumerate((2 * ngf, ngf)):
        sd[f"to_rgbs.{i}.weight"] = _kernel(rng, 3, ch, 3, 3)
        sd[f"to_rgbs.{i}.bias"] = _vec(rng, 3)
    sd["lip_encoder.model.0.weight"] = _kernel(rng, ngf, 3, 3, 3)
    ratio = 1
    for i in range(n_2xdown):
        nxt = min(ratio * 2, 16)
        ch, idx = ngf * ratio, 3 + 4 * i
        sd[f"lip_encoder.model.{idx}.logit.0.weight"] = _kernel(rng, ch, ch,
                                                                3, 3)
        sd[f"lip_encoder.model.{idx}.logit.1.weight"] = 1.0 + _vec(rng, ch)
        sd[f"lip_encoder.model.{idx}.logit.1.bias"] = _vec(rng, ch)
        sd[f"lip_encoder.model.{idx + 1}.weight"] = _kernel(
            rng, ngf * nxt, ch, 3, 3)
        sd[f"lip_encoder.model.{idx + 1}.bias"] = _vec(rng, ngf * nxt)
        ratio = nxt
    return sd


def fan_variables(rng, num_stacks=4, features=256):
    """A FAN variables tree in the flax layout ({'params', 'batch_stats'},
    each layer's leaves under its `Conv_0` / `BatchNorm_0`), the layers
    read off the port's FAN; HWIO kernels."""
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.fan import FAN
    from ghost_tpu_torch.nn.layers import BatchNorm, Conv

    fan = FAN(num_stacks=num_stacks, features=features,
              policy=FULL_PRECISION, device="meta")
    params, stats = {}, {}

    def at(tree, name):
        for part in name.split("."):
            tree = tree.setdefault(part, {})
        return tree

    for name, m in fan.named_modules():
        if isinstance(m, Conv):
            cout, cin, kh, kw = m.weight.shape
            leaf = {"kernel": _kernel(rng, cout, cin, kh, kw).transpose(
                2, 3, 1, 0)}
            if m.bias is not None:
                leaf["bias"] = _vec(rng, cout)
            at(params, name)["Conv_0"] = leaf
        elif isinstance(m, BatchNorm):
            c = m.running_mean.shape[0]
            sd = {}
            _bn(rng, sd, "bn", c)
            at(params, name)["BatchNorm_0"] = {"scale": sd["bn.weight"],
                                               "bias": sd["bn.bias"]}
            at(stats, name)["BatchNorm_0"] = {"mean": sd["bn.running_mean"],
                                              "var": sd["bn.running_var"]}
    return {"params": params, "batch_stats": stats}


def inswapper_graph(rng, emap_name="emap") -> bytes:
    """An .onnx graph with inswapper_128's signature: target (B,3,128,128)
    in [0, 1] and source (B,512) in, (B,3,128,128) in [0, 1] out, and a
    512x512 projection initializer `emap_name` that the graph does not
    read (insightface keeps inswapper's emap so); inside, a 3x3 conv of
    the target plus a per-channel projection of the source, through a
    sigmoid (`tests/test_onnx_exec.py:241-272`'s stand-in)."""
    from ghost_tpu_torch.convert.onnx_writer import OnnxBuilder

    b = OnnxBuilder("inswapper_stand_in")
    target = b.graph_input("target", ["b", 3, 128, 128])
    source = b.graph_input("source", ["b", 512])
    w = b.initializer(rng.normal(0, 0.1, (3, 3, 3, 3)).astype(np.float32),
                      "w")
    proj = b.initializer(rng.normal(0, 0.1, (512, 3)).astype(np.float32),
                         "proj")
    b.initializer(rng.normal(0, 0.05, (512, 512)).astype(np.float32),
                  emap_name)
    c = b.node("Conv", [target, w], kernel_shape=[3, 3], strides=[1, 1],
               pads=[1, 1, 1, 1])
    sty = b.node("Unsqueeze", [b.node("MatMul", [source, proj])],
                 axes=[2, 3])
    b.node("Sigmoid", [b.node("Add", [c, sty])], outputs=["out"])
    b.graph_output("out", ["b", 3, 128, 128])
    return b.serialize()


def write_faces(d, rng, n, size=256, identities=0) -> str:
    """`n` seeded jpgs of `size` px (smooth gradients with noise, so the
    jpeg codec and the resizes see real structure) in `d`, flat or in
    `identities` folders; returns `d`."""
    import cv2

    yy, xx = np.mgrid[:size, :size]
    for i in range(n):
        sub = os.path.join(d, f"id{i % identities}") if identities else d
        os.makedirs(sub, exist_ok=True)
        base = np.stack([(xx + 11 * i) % 256, (yy + 5 * i) % 256,
                         (xx + 2 * yy + 3 * i) % 256], -1)
        img = np.clip(base + rng.integers(-25, 26, base.shape), 0, 255)
        cv2.imwrite(os.path.join(sub, f"{i:05d}.jpg"), img.astype(np.uint8))
    return d


@contextlib.contextmanager
def train_loop_spy(loop, rec, start=None, swap=False, keep_batches=True):
    """Spy on `loop.train_loop`, which either CLI's `main` imports from
    its loop module `loop` at each call. `rec` gets the step functions
    ("g_step", "d_step"), the checkpoint manager ("ckpt"), the starting
    state ("start": `start(state)`, or the state itself), per step the
    batch the loop read ("batches", with `swap` its samples in the other
    order; without `keep_batches` none is kept, so each is freed as the
    loop frees it), the seconds it blocked on that batch ("waits"), the
    time the step ended ("ends": the step observer syncs the card) and
    (iteration, metrics) ("metrics"), and the end state ("final")."""
    real = loop.train_loop

    def spy(state, g_step, d_step, batches, cfg, **kwargs):
        rec.update(start=start(state) if start else state, g_step=g_step,
                   d_step=d_step, ckpt=kwargs.get("checkpoint_manager"),
                   batches=[], waits=[], ends=[], metrics=[])

        def recorded():
            it = batches()
            try:
                while True:
                    t = time.perf_counter()
                    try:
                        b = next(it)
                    except StopIteration:
                        return
                    rec["waits"].append(time.perf_counter() - t)
                    if swap:
                        b = {k: v[::-1].copy() if isinstance(v, np.ndarray)
                             else v.flip(0) for k, v in b.items()}
                    if keep_batches:
                        rec["batches"].append(dict(b))
                    yield b
            finally:
                if hasattr(it, "close"):
                    it.close()

        def on_step(i, metrics, mults):
            rec["ends"].append(time.perf_counter())
            rec["metrics"].append((i, metrics))

        state, metrics = real(state, g_step, d_step, recorded, cfg,
                              on_step=on_step, **kwargs)
        rec["final"] = state
        return state, metrics

    loop.train_loop = spy
    try:
        yield rec
    finally:
        loop.train_loop = real
