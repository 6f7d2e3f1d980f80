"""The port's small training and measurement modules against ghost_tpu's,
on the CPU: `core/config.py`, `train/color.py`,
`train/arcface_margin.py`, `train/sparsity.py`, `utils/quality.py` and
`utils/profiling.py`.

Bounds: config and masks exact (the same dataclasses and errors; the
2:4 masks the same elements, carried through the bridge); colour
functions 1e-6 absolute on values in [0, 1] (f32, the same ops); the
margin logits 1e-4 of their scale (64 x cosines); the quality metrics
1e-5 relative (f32, the same embedding and feature maps in both
packages);
flops equal to XLA's cost analysis for a dense layer and a conv.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

from ghost_tpu_torch.convert.from_jax import (flax_variables,
                                              load_flax_variables)
from ghost_tpu_torch.core import config as tconfig
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.nn.layers import init_weights
from ghost_tpu_torch.train import color as tcolor
from ghost_tpu_torch.train import sparsity as tsparse
from ghost_tpu_torch.train.arcface_margin import ArcMarginHead
from ghost_tpu_torch.utils import profiling as tprof
from ghost_tpu_torch.utils import quality as tquality

OVERRIDES = ["train.lr_g=1e-3", "model.backbone=linknet", "bf16=false",
             "mesh.model=2", "inference.use_sr=yes", "model.width=0.5",
             "seed=7", "train.mode=round_trip"]

@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)



def test_config_overrides_against_jax():
    from ghost_tpu.core import config as jconfig

    got = tconfig.apply_overrides(tconfig.GhostConfig(), OVERRIDES)
    want = jconfig.apply_overrides(jconfig.GhostConfig(), OVERRIDES)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.bf16 is False and got.inference.use_sr is True
    assert tconfig.GhostConfig().train.lr_g == 4e-4  # untouched
    for module in (tconfig, jconfig):
        p = argparse.ArgumentParser()
        module.add_config_flag(p)
        args = p.parse_args(sum((["--set", o] for o in OVERRIDES), []))
        assert dataclasses.asdict(module.config_from_args(args)) == \
            dataclasses.asdict(want)
        assert module.config_from_args(p.parse_args([])) == \
            module.GhostConfig()


@pytest.mark.parametrize("bad,err", [(["train.nope=1"], AttributeError),
                                     (["nope.lr=1"], AttributeError),
                                     (["train.lr_g"], ValueError),
                                     (["train.batch_size=1.5"], ValueError)])
def test_config_errors_against_jax(bad, err):
    from ghost_tpu.core import config as jconfig

    msgs = []
    for module in (tconfig, jconfig):
        with pytest.raises(err) as e:
            module.apply_overrides(module.GhostConfig(), bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _images(rng, b=2, hw=112):
    """pm1 NHWC images with grey pixels, channel ties and a zero pixel,
    so every branch of the HSV priority order is taken."""
    x = rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
    x[:, :4, :4] = x[:, :4, :4, :1]  # grey (mn == mx)
    x[:, 4:8, :4, 1] = x[:, 4:8, :4, 0]  # r == g
    x[:, 8:12, :4, 2] = x[:, 8:12, :4, 1]  # g == b
    x[:, 12, 0] = -1.0  # black (mx == 0)
    return x


def test_color_against_jax():
    import jax
    import jax.numpy as jnp

    from ghost_tpu.train import color as jcolor

    rng = np.random.default_rng(0)
    x = _images(rng)
    t = torch.from_numpy(x)
    hsv = tcolor.get_hsv(t)
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jax.jit(
        jcolor.get_hsv)(jnp.asarray(x))), rtol=0, atol=1e-6)
    rgb = tcolor.hsv_to_rgb(hsv)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jax.jit(
        jcolor.hsv_to_rgb)(jnp.asarray(hsv.numpy()))), rtol=0, atol=1e-6)
    # the round trip gives the image back
    np.testing.assert_allclose(rgb.numpy(), x * 0.5 + 0.5, rtol=0, atol=2e-6)
    mod = tcolor.modify_images_with_hsv(t, t.flip(0))
    np.testing.assert_allclose(mod.numpy(), rgb.numpy(), rtol=0, atol=0)
    for fn, args in (("color_consistency_loss", ()),
                     ("stuck_loss", ((10, 20, 40, 30),)),
                     ("stuck_loss", ((0, 0, 112, 112), 0.25))):
        got = getattr(tcolor, fn)(t, *args).item()
        want = float(jax.jit(getattr(jcolor, fn), static_argnums=(1, 2)[
            :len(args)])(jnp.asarray(x), *args))
        assert got == pytest.approx(want, rel=1e-5), fn
    assert not tcolor.is_any_nan({"a": t, "b": [t[0], (np.ones(3),)]})
    bad = t.clone()
    bad[1, 5, 5, 2] = float("nan")
    assert tcolor.is_any_nan({"a": t, "b": [bad]})
    assert tcolor.is_any_nan([np.array([np.inf])])


@pytest.mark.parametrize("easy", [False, True])
def test_arc_margin_against_jax(easy):
    import jax
    import jax.numpy as jnp

    from ghost_tpu.train.arcface_margin import ArcMarginHead as JHead

    rng = np.random.default_rng(1)
    d, c, b = 32, 50, 8
    emb = rng.normal(0, 1, (b, d)).astype(np.float32)
    labels = rng.integers(0, c, b)
    jhead = JHead(num_classes=c, easy_margin=easy)
    variables = jhead.init(jax.random.key(0), jnp.asarray(emb),
                           jnp.asarray(labels))
    # a few target cosines pushed past cos(pi - m), the th/mm branch
    w = np.asarray(variables["params"]["weight"]).copy()
    w[:, labels[:2]] = -emb[:2].T
    variables = {"params": {"weight": jnp.asarray(w)}}
    want = np.asarray(jhead.apply(variables, jnp.asarray(emb),
                                  jnp.asarray(labels)))
    head = load_flax_variables(ArcMarginHead(d, c, easy_margin=easy),
                               variables)
    with torch.no_grad():
        got = head(torch.from_numpy(emb), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    back = flax_variables(head)["params"]["weight"]
    np.testing.assert_array_equal(back, w)
    # the init's fans: xavier-uniform over (D, C)
    init = init_weights(ArcMarginHead(d, c), torch.Generator().manual_seed(0))
    bound = np.sqrt(6 / (d + c))
    assert init.weight.abs().max().item() <= bound
    assert init.weight.abs().max().item() > 0.9 * bound


def _jax_tree(tree):
    import jax.numpy as jnp

    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict)
            else np.asarray(v).astype(np.float32) for k, v in tree.items()}


def _sparse_modules():
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact

    g = torch.Generator().manual_seed(4)
    return {"aei": init_weights(AEINet(num_blocks=1, width=1 / 16,
                                       policy=TFULL), g),
            # Conv3x3 keeps flax's HWIO layout; PReLU slopes
            "srvgg": init_weights(SRVGGNetCompact(num_feat=8, num_conv=2,
                                                  policy=TFULL), g)}


@pytest.mark.parametrize("name", ["aei", "srvgg"])
def test_sparsity_masks_against_jax(name):
    """The port's masks select, element for element, what JAX's
    `compute_masks` selects on the module's flax tree: JAX's masks are
    loaded through the bridge into a copy of the module and compared in
    the port's layouts."""
    import copy

    import jax

    from ghost_tpu.train import sparsity as jsparse

    module = _sparse_modules()[name]
    tree = flax_variables(module)
    jmasks = jax.jit(jsparse.compute_masks)(_jax_tree(tree["params"]))
    masks = tsparse.compute_masks(module)
    carried = load_flax_variables(copy.deepcopy(module),
                                  {**tree, "params": _np(jmasks)})
    for key, p in carried.named_parameters():
        np.testing.assert_array_equal(masks[key].numpy(),
                                      p.detach().numpy().astype(bool), key)
    assert tsparse.sparsity_ratio(masks) == float(
        jsparse.sparsity_ratio(jmasks))
    pruned = [k for k, m in masks.items() if not m.all()]
    assert pruned
    for k in pruned:  # 2 of every 4 kept
        assert masks[k].float().mean().item() == 0.5
    tsparse.apply_masks(module, masks)
    params = dict(module.named_parameters())
    for k, m in masks.items():
        assert not params[k].detach()[~m].any()


def test_mask_2to4_ties_keep_index_order():
    import jax.numpy as jnp

    from ghost_tpu.train.sparsity import mask_2to4_last_axis

    rng = np.random.default_rng(5)
    w = rng.integers(-2, 3, (6, 3, 8)).astype(np.float32)  # many ties
    got = tsparse.mask_2to4_last_axis(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(mask_2to4_last_axis(
        jnp.asarray(w))))
    np.testing.assert_array_equal(
        tsparse.mask_2to4_last_axis(torch.ones(2, 8)).numpy(),
        np.tile([True, True, False, False], (2, 2)))
    assert tsparse.mask_2to4_last_axis(torch.ones(3, 6)).all()


def test_quality_against_jax():
    """The metrics' arithmetic on the same inputs, JAX's jitted:
    id_similarity through each package's area resize to 112 and a fixed
    linear embedding; the perceptual distance over fixed feature maps
    of the images (identity, a 2x2 pool, a squared channel), each
    package computing its own; and the port's distance over its VGG19
    (the network is held to JAX's in
    `tests/test_torch_distill_enhancer.py`)."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.utils import quality as jquality
    from ghost_tpu_torch.models.sr.vgg import VGG19Features

    rng = np.random.default_rng(6)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)

    proj = rng.normal(0, 1, (112 * 112 * 3, 16)).astype(np.float32)
    got = tquality.id_similarity(
        lambda x: x.reshape(x.shape[0], -1) @ torch.from_numpy(proj),
        ta, tb).numpy()
    want = np.asarray(jax.jit(lambda x, y: jquality.id_similarity(
        lambda z: z.reshape(z.shape[0], -1) @ jnp.asarray(proj), x, y))(
        ja, jb))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    u8a = ((a + 1) * 127.5).astype(np.uint8)
    u8b = ((b + 1) * 127.5).astype(np.uint8)
    np.testing.assert_allclose(
        tquality.psnr(torch.from_numpy(u8a), torch.from_numpy(u8b)).numpy(),
        np.asarray(jax.jit(jquality.psnr)(jnp.asarray(u8a),
                                          jnp.asarray(u8b))), rtol=1e-6)

    def tfeats(x):
        pool = x.reshape(2, 32, 2, 32, 2, 3).mean(dim=(2, 4))
        return [x, pool * 2, x[..., :1] ** 2]

    def jfeats(x):
        pool = x.reshape(2, 32, 2, 32, 2, 3).mean(axis=(2, 4))
        return [x, pool * 2, x[..., :1] ** 2]

    lin = [rng.uniform(0, 1, c).astype(np.float32) for c in (3, 3, 1)]
    for weights in (None, lin):
        got = tquality.perceptual_distance(tfeats, ta, tb, weights).numpy()
        want = np.asarray(jax.jit(lambda x, y: jquality.perceptual_distance(
            jfeats, x, y, weights))(ja, jb))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    vgg = init_weights(VGG19Features(policy=TFULL),
                       torch.Generator().manual_seed(6)).eval()
    with torch.no_grad():
        d = tquality.perceptual_distance(vgg, ta, tb)
        same = tquality.perceptual_distance(vgg, ta, ta)
    assert d.shape == (2,) and (d > 0).all() and (same == 0).all()


def test_flop_estimate_equals_xla():
    import jax
    import jax.numpy as jnp

    from ghost_tpu.utils.profiling import flop_estimate as jflops

    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (32, 96)).astype(np.float32)
    w = rng.normal(0, 1, (96, 80)).astype(np.float32)
    got = tprof.flop_estimate(lambda a, b: a @ b, torch.from_numpy(x),
                              torch.from_numpy(w))
    want = jflops(lambda a, b: a @ b, jnp.asarray(x), jnp.asarray(w))
    assert got["flops"] == want["flops"] == 2 * 32 * 96 * 80
    # unfused bytes: the operands and the result, once each here
    assert got["bytes_accessed"] == 4 * (32 * 96 + 96 * 80 + 32 * 80)

    img = rng.normal(0, 1, (2, 16, 16, 8)).astype(np.float32)  # NHWC
    k = rng.normal(0, 1, (3, 3, 8, 12)).astype(np.float32)  # HWIO
    for stride, pad in ((1, 1), (2, 1), (1, 0)):
        got = tprof.flop_estimate(
            lambda a, b: torch.nn.functional.conv2d(a, b, stride=stride,
                                                    padding=pad),
            torch.from_numpy(img).permute(0, 3, 1, 2),
            torch.from_numpy(k).permute(3, 2, 0, 1))
        want = jflops(lambda a, b: jax.lax.conv_general_dilated(
            a, b, (stride, stride), [(pad, pad)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC")),
            jnp.asarray(img), jnp.asarray(k))
        assert got["flops"] == want["flops"], (stride, pad)
    # the unpadded conv: every tap inside the image
    assert got["flops"] == 2 * 2 * 14 * 14 * 12 * 9 * 8


def test_stage_timer_trace_and_annotate(tmp_path):
    t = tprof.StageTimer()
    x = torch.ones(64, 64)
    with t.stage("a", items=10, block_on={"y": [x @ x]}):
        sum(range(1000))
    with t.stage("a", items=10):
        pass
    with t.stage("b"):
        pass
    rep = t.report()
    assert "a" in rep and "b" in rep and "items/s" in rep
    assert t.counts["a"] == 2 and t.items["a"] == 20
    with tprof.trace(str(tmp_path)) as d:
        with tprof.annotate("phase24"):
            x @ x
    with open(f"{d}/{tprof.TRACE_FILE}") as f:
        assert "phase24" in f.read()
