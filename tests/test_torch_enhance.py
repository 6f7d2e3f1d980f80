"""The port's output enhancer against ghost_tpu's: RRDBNet, GFPGANClean,
the three converters, the background tiler and `FaceEnhancer`.

Weights come from the torch replicas of `tests/test_enhancers.py`
(state dicts with the official key names, every parameter moved off its
init) through both packages' converters, or from seeded numpy values for
every leaf of a JAX tree; they reach the port through the strict bridge.
Model comparisons are f32 on both sides, held to 1e-4 absolute (outputs
are O(1)): the same math, with convolution sums in another order.

`FaceEnhancer` runs narrow models (GFPGANClean out_size 64 at crop 64,
RRDBNet(8, 1 block, grow 4), SRVGG(8, 2 convs)) on two 96x128 frames
at det_size 160, the detector's head pinned to face templates of size 1
(`inject_detection_template(d=1.0)`) so four lanes are present and the
background shows between the pasted faces; 48x64 background tiles make
a 2x2 grid with a 10-px halo. Full + RRDB frames are held to JAX's with
`tests/test_torch_pipeline.py:_frames_close` (<= 3 grey levels, < 5% of
values): crops and paste-back contract in bf16 in both packages. The
face and full + SRVGG modes are held to JAX end to end through the CLI
(`tests/test_torch_cli.py:test_enhance_route_matches_jax`), which keeps
this file to one JAX FaceEnhancer compile.

JAX is imported inside the tests that use it, so the card tests run
where jax is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_enhance.py
"""

import functools

import numpy as np
import pytest
import torch

from ghost_tpu_torch.convert import torch_loader as tload
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import FULL_PRECISION
from ghost_tpu_torch.models.scrfd import SCRFD
from ghost_tpu_torch.models.sr.gfpgan import GFPGANClean, drop_unread_leaves
from ghost_tpu_torch.models.sr.rrdb import RRDBNet, pixel_unshuffle
from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact, pixel_shuffle
from ghost_tpu_torch.nn.layers import init_weights, resize
from ghost_tpu_torch.pipeline import enhance as tenh
from ghost_tpu_torch.utils.face_template import inject_detection_template

GFP = dict(out_size=32, num_style_feat=32, channel_multiplier=2, num_mlp=2,
           narrow=0.25)
RRDB = dict(num_feat=8, num_block=1, num_grow_ch=4)
SRVGG = dict(num_feat=8, num_conv=2, upscale=4)
ENH = dict(det_size=160, max_faces=4, crop_size=64, bg_tile=(48, 64))
ENH_GFP = dict(GFP, out_size=64)
HW = (96, 128)
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _replica_sd(make):
    """The state dict of a torch replica built under seed 0, every
    parameter moved by N(0, 0.05) off its init (zero biases and noise
    weights included), as numpy."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        tm = make().eval()
        with torch.no_grad():
            for p in tm.parameters():
                p.add_(0.05 * torch.randn_like(p))
    return {k: v.detach().numpy() for k, v in tm.state_dict().items()}


def _assert_same_tree(got, ref):
    import jax

    g = jax.tree_util.tree_flatten_with_path(got)[0]
    r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in g] == [p for p, _ in r]
    for (path, a), (_, b) in zip(g, r):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), str(path))


def _port(module, variables):
    return load_flax_variables(module, variables).eval()


# ------------------------------------------------------------------ RRDB
@pytest.mark.parametrize("scale", [4, 2, 1])
def test_rrdbnet_matches_jax(scale):
    """convert_rrdbnet_state_dict leaf for leaf; RRDBNet at x4, x2, x1
    within 1e-4 of the JAX module on the replica's weights."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.convert.torch_loader import convert_rrdbnet_state_dict
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr.rrdb import RRDBNet as JRRDB
    from tests.test_enhancers import TorchRRDBNet

    sd = _replica_sd(lambda: TorchRRDBNet(3, 3, 8, 1, 4, scale=scale))
    ref_vars = convert_rrdbnet_state_dict(sd, num_block=1)
    variables = tload.convert_rrdbnet_state_dict(sd, num_block=1)
    _assert_same_tree(variables, ref_vars)

    x = np.random.default_rng(scale).uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(JRRDB(**RRDB, scale=scale, policy=JFULL).apply)(
        ref_vars, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(RRDBNet(**RRDB, scale=scale, policy=FULL_PRECISION),
                    variables)(_t(x))
    assert got.shape == ref.shape == (2, 16 * scale, 16 * scale, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_pixel_unshuffle_order():
    """NHWC pixel_unshuffle is F.pixel_unshuffle on the NCHW view and
    JAX's, bit for bit, and pixel_shuffle undoes it."""
    import jax.numpy as jnp

    from ghost_tpu.models.sr.rrdb import pixel_unshuffle as j_unshuffle

    x = np.random.default_rng(1).normal(0, 1, (2, 8, 12, 5)).astype(
        np.float32)
    got = pixel_unshuffle(_t(x), 2)
    want = torch.nn.functional.pixel_unshuffle(_t(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.numpy(),
                                  want.permute(0, 2, 3, 1).numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_unshuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(pixel_shuffle(got, 2).numpy(), x)


# ---------------------------------------------------------------- GFPGAN
@pytest.fixture(scope="module")
def gfpgan_sd():
    """The GFPGANv1Clean replica's state dict (toRGB.* and
    stylegan_decoder.style_mlp.* included, as in GFPGANv1.4.pth), and
    both packages' conversions of it."""
    from ghost_tpu.convert.torch_loader import convert_gfpgan_state_dict
    from tests.test_enhancers import TGFPGANv1Clean

    sd = _replica_sd(lambda: TGFPGANv1Clean(
        GFP["out_size"], GFP["num_style_feat"], GFP["channel_multiplier"],
        GFP["num_mlp"], GFP["narrow"]))
    kw = dict(out_size=GFP["out_size"], num_style_feat=GFP["num_style_feat"])
    return (sd, convert_gfpgan_state_dict(sd, **kw),
            tload.convert_gfpgan_state_dict(sd, **kw))


def _jax_gfpgan(**kw):
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr.gfpgan import GFPGANClean as JGFPGAN

    return JGFPGAN(**{**GFP, **kw}, policy=JFULL)


def _face_input(seed, size=GFP["out_size"]):
    return np.random.default_rng(seed).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32)


def test_gfpgan_full_tree_loads_as_in_jax(gfpgan_sd):
    """The converted tree of the official layout: the port's converter
    equals JAX's leaf for leaf; `drop_unread_leaves` drops exactly the
    toRGB_{i} and stylegan_decoder/mlp_{j} leaves (the serving module
    reads neither); JAX's output is the same with and without them, and
    the port's module on the dropped tree is within 1e-4 of it."""
    import jax
    import jax.numpy as jnp

    _, ref_vars, variables = gfpgan_sd
    _assert_same_tree(variables, ref_vars)
    module = GFPGANClean(**GFP, policy=FULL_PRECISION)
    kept, dropped = drop_unread_leaves(variables, module)
    n = 3  # log2(32) - 2 stages
    assert dropped == (
        [f"params/toRGB_{i}/Conv_0/{k}" for i in range(n)
         for k in ("kernel", "bias")]
        + [f"params/stylegan_decoder/mlp_{j}/Dense_0/{k}"
           for j in range(GFP["num_mlp"]) for k in ("kernel", "bias")])
    # nothing else is dropped: the kept leaves are the full tree's minus those
    from ghost_tpu_torch.convert.from_jax import _flatten

    def paths(tree):
        return {"params/" + "/".join(p) for p, _ in _flatten(tree["params"])}
    assert paths(kept) == paths(variables) - set(dropped)

    x = jnp.asarray(_face_input(2))
    apply = jax.jit(_jax_gfpgan().apply)
    ref, _ = apply(ref_vars, x)
    ref_kept, _ = apply(kept, x)
    np.testing.assert_array_equal(np.asarray(ref_kept), np.asarray(ref))
    with torch.no_grad():
        got, rgbs = _port(module, kept)(_t(np.asarray(x)))
    assert rgbs is None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_gfpgan_rgb_heads_and_noises_match_jax(gfpgan_sd):
    """With the toRGB heads (return_rgb=True) and per-layer noise inputs:
    the image and every head's output within 1e-4 of JAX's."""
    import jax
    import jax.numpy as jnp

    _, ref_vars, variables = gfpgan_sd
    module = GFPGANClean(**GFP, rgb_heads=True, policy=FULL_PRECISION)
    kept, dropped = drop_unread_leaves(variables, module)
    assert all("/mlp_" in p for p in dropped)
    rng = np.random.default_rng(3)
    noises = [rng.normal(0, 1, s).astype(np.float32)
              for s in module.stylegan_decoder.noise_shapes(2)]
    x = _face_input(4)
    ref, ref_rgbs = jax.jit(functools.partial(
        _jax_gfpgan().apply, return_rgb=True))(
        ref_vars, jnp.asarray(x), [jnp.asarray(n) for n in noises])
    with torch.no_grad():
        got, rgbs = _port(module, kept)(_t(x), [_t(n) for n in noises],
                                        return_rgb=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    assert len(rgbs) == len(ref_rgbs) == 3
    for g, r in zip(rgbs, ref_rgbs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL)
    with pytest.raises(ValueError, match="rgb_heads"):
        GFPGANClean(**GFP, policy=FULL_PRECISION)(_t(x), return_rgb=True)


def test_gfpgan_z_path_and_full_sft_match_jax():
    """An init-shaped JAX tree (seeded values for every leaf) of the z
    path (NormStyleCode + the style MLP, one w) with sft_half=False loads
    as it is (the module builds mlp_{j}) and is within 1e-4 of JAX's."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_pipeline import _variables

    kw = dict(sft_half=False, different_w=False, input_is_latent=False)
    jmod = _jax_gfpgan(**kw)
    rng = np.random.default_rng(5)
    variables = _variables(jmod, rng, (1, 32, 32, 3))
    module = GFPGANClean(**GFP, **kw, policy=FULL_PRECISION)
    kept, dropped = drop_unread_leaves(variables, module)
    assert dropped == []
    x = _face_input(6)
    ref, _ = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got, _ = _port(module, kept)(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


# ----------------------------------------------------------------- SRVGG
def test_srvgg_converter_matches_jax():
    """convert_srvgg_state_dict leaf for leaf on the replica's weights
    (real PReLU slopes), and SRVGG x4 through the bridge within 1e-4 of
    the JAX module."""
    import jax.numpy as jnp

    from ghost_tpu.convert.torch_loader import convert_srvgg_state_dict
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models.sr.srvgg import SRVGGNetCompact as JSRVGG
    from tests.test_enhancers import TorchSRVGG

    sd = _replica_sd(lambda: TorchSRVGG(3, 3, 8, 2, 4))
    ref_vars = convert_srvgg_state_dict(sd, num_conv=2)
    variables = tload.convert_srvgg_state_dict(sd, num_conv=2)
    _assert_same_tree(variables, ref_vars)
    x = np.random.default_rng(7).uniform(0, 1, (2, 12, 12, 3)).astype(
        np.float32)
    ref = np.asarray(JSRVGG(**SRVGG, policy=JFULL).apply(ref_vars,
                                                          jnp.asarray(x)))
    with torch.no_grad():
        got = _port(SRVGGNetCompact(**SRVGG, policy=FULL_PRECISION),
                    variables)(_t(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


# ----------------------------------------------------------------- tiles
def test_fit_tile_matches_jax():
    """The cases of test_enhancers.py::test_bg_tile_fitting, and the same
    answers as JAX's `_fit_tile` (its prime-ish refusal included)."""
    from ghost_tpu.pipeline.enhance import _fit_tile as j_fit_tile

    cases = {(1080, 1920): (270, 240), (720, 1280): (240, 160),
             (480, 854): (240, 122), (96, 128): (96, 128)}
    for (h, w), want in cases.items():
        assert tenh._fit_tile((270, 240), h, w) == want
        assert j_fit_tile((270, 240), h, w) == want
    with pytest.raises(ValueError):
        tenh._fit_tile((270, 240), 1082, 1920)
    with pytest.raises(ValueError):
        j_fit_tile((270, 240), 1082, 1920)


@pytest.fixture(scope="module")
def seeded_rrdb():
    return init_weights(RRDBNet(**RRDB, policy=FULL_PRECISION),
                        torch.Generator().manual_seed(1)).eval()


def _frames01(seed, hw):
    return _t(np.random.default_rng(seed).uniform(0, 1, (1, *hw, 3)).astype(
        np.float32))


@torch.no_grad()
def test_upscale_tiled_single_tile_exact(seeded_rrdb):
    """One tile with pad=0 is the plain forward: stitching is exact."""
    bg = seeded_rrdb
    x = _frames01(0, (16, 24))
    np.testing.assert_array_equal(
        tenh.upscale_tiled(bg, x, tile=(16, 24), tile_pad=0).numpy(),
        bg(x).numpy())


@torch.no_grad()
def test_upscale_tiled_halo_converges_to_full_frame(seeded_rrdb):
    """A 2x2 grid stitches to the full x4 canvas; halos clamp to the
    image bounds, so the error against the full-frame pass does not grow
    with the halo, and at pad=8 (the halo spans the whole 32-px frame)
    the two agree within 1e-5."""
    bg = seeded_rrdb
    x = _frames01(1, (32, 32))
    full = bg(x).numpy()
    prev = None
    for pad in (2, 4, 8):
        tiled = tenh.upscale_tiled(bg, x, tile=16, tile_pad=pad).numpy()
        assert tiled.shape == full.shape == (1, 128, 128, 3)
        err = float(np.abs(tiled - full).max())
        if prev is not None:
            assert err <= prev + 1e-6, (pad, err, prev)
        prev = err
    np.testing.assert_allclose(tiled, full, rtol=1e-5, atol=1e-5)


@torch.no_grad()
def test_tiled_downscale_folding_exact(seeded_rrdb):
    """Per-tile x4 -> area x1 resize and stitch equals stitching the x4
    canvas, then area-resizing it (the 4x4 box is tile-aligned)."""
    bg = seeded_rrdb
    x = _frames01(2, (32, 32))
    big = tenh._tiled_rect(bg, x, 16, 16, 4)
    ref = resize(big.float(), (32, 32), method="area").numpy()
    got = tenh._tiled_rect(bg, x, 16, 16, 4, downscale=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------- FaceEnhancer
def _frames(seed=11, b=2):
    return np.random.default_rng(seed).integers(0, 255, (b, *HW, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def enhanced():
    """The port's FaceEnhancer per mode (face, full + RRDB, full + SRVGG)
    on the same seeded weights and frames, JAX's for full + RRDB, and both
    packages' SRVGG background tiles (face and full + SRVGG are held to
    the JAX CLI's `main` body in tests/test_torch_cli.py)."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import scrfd as jscrfd
    from ghost_tpu.models.sr.rrdb import RRDBNet as JRRDB
    from ghost_tpu.models.sr.srvgg import SRVGGNetCompact as JSRVGG
    from ghost_tpu.pipeline import enhance as jenh
    from ghost_tpu.utils.face_template import \
        inject_detection_template as j_inject
    from tests.test_torch_pipeline import _variables

    rng = np.random.default_rng(12)
    det = jscrfd.SCRFD(policy=JFULL)
    dv = j_inject(_variables(det, rng, (1, 160, 160, 3)), d=1.0)
    gfp = _jax_gfpgan(out_size=64)
    gv = _variables(gfp, rng, (1, 64, 64, 3))
    bgs = {"rrdb": (JRRDB(**RRDB, policy=JFULL), RRDBNet(
                **RRDB, policy=FULL_PRECISION)),
           "srvgg": (JSRVGG(**SRVGG, policy=JFULL), SRVGGNetCompact(
                **SRVGG, policy=FULL_PRECISION))}
    tdet = _port(SCRFD(policy=FULL_PRECISION), dv)
    tgfp = _port(GFPGANClean(**ENH_GFP, policy=FULL_PRECISION), gv)
    frames = _frames()
    runs = {}
    for mode in ("face", "rrdb", "srvgg"):
        tbg = None
        if mode in bgs:
            jmod, tmod = bgs[mode]
            bv = _variables(jmod, rng, (1, 16, 16, 3))
            tbg = _port(tmod, bv)
        r = runs[mode] = {"got": tenh.FaceEnhancer(tdet, tgfp, tbg,
                                                   **ENH).enhance(frames)}
        if mode == "rrdb":
            r["ref"] = jenh.FaceEnhancer((det, dv), (gfp, gv), (jmod, bv),
                                         **ENH).enhance(frames)
        elif mode == "srvgg":
            # the background as FaceEnhancer tiles it: 48x64 tiles with
            # the 10-px halo, each area-resized back from x4
            x01 = frames.astype(np.float32) / 255.0
            r["ref_bg"] = np.asarray(jax.jit(
                lambda v, x: jenh._tiled_rect(jmod, v, x, 48, 64, 10,
                                              downscale=True))(
                bv, jnp.asarray(x01)))
            with torch.no_grad():
                r["got_bg"] = tenh._tiled_rect(tbg, _t(x01), 48, 64, 10,
                                               downscale=True).numpy()
    return frames, runs


def test_face_enhancer_matches_jax(enhanced):
    """`enhance` of full with RRDB (GFPGAN on every present lane, pasted
    on the tiled background): uint8 frames of the input's shape within
    _frames_close of JAX's."""
    from tests.test_torch_pipeline import _frames_close

    frames, runs = enhanced
    got, ref = runs["rrdb"]["got"], runs["rrdb"]["ref"]
    assert got.shape == ref.shape == frames.shape and got.dtype == np.uint8
    _frames_close(got, ref)


@pytest.mark.parametrize("mode", ["face", "rrdb", "srvgg"])
def test_face_enhancer_modes(enhanced, mode):
    """Each mode returns uint8 frames of the input's shape with faces
    restored over a large part of the frame; with a background the frame
    between faces changes too. SRVGG's tiled background is within 1e-4
    of JAX's tiler on the same frames."""
    frames, runs = enhanced
    got = runs[mode]["got"]
    assert got.shape == frames.shape and got.dtype == np.uint8
    assert (got != frames).mean() > 0.1
    if mode != "face":
        assert (got != runs["face"]["got"]).mean() > 0.2
    if mode == "srvgg":
        ref_bg, got_bg = runs[mode]["ref_bg"], runs[mode]["got_bg"]
        assert got_bg.shape == ref_bg.shape == frames.shape
        np.testing.assert_allclose(got_bg, ref_bg, rtol=0, atol=TOL)


def test_lane_skip_is_exact():
    """With a threshold that admits only each frame's top face, a
    max_faces=4 enhancer (lanes 1-3 skipped) equals a max_faces=1 one
    bit for bit (lanes are score-sorted: lane 0 is the same face)."""
    from ghost_tpu_torch.models.scrfd import (decode_detections,
                                              preprocess_frames)

    gen = torch.Generator().manual_seed(2)
    det = init_weights(SCRFD(policy=FULL_PRECISION), gen).eval()
    gfp = init_weights(GFPGANClean(**ENH_GFP, policy=FULL_PRECISION),
                       gen).eval()
    frames = _frames(3)
    with torch.no_grad():
        canvas, _ = preprocess_frames(_t(frames), ENH["det_size"])
        scores = decode_detections(det(canvas), input_size=ENH["det_size"],
                                   score_thresh=0.0, max_faces=4)[0].numpy()
    lo, hi = float(np.max(scores[:, 1])), float(np.min(scores[:, 0]))
    assert lo < hi, "the seeded detector's top two scores do not separate"
    outs = [tenh.FaceEnhancer(det, gfp, None,
                              **{**ENH, "max_faces": max_faces},
                              det_thresh=0.5 * (lo + hi)).enhance(frames)
            for max_faces in (4, 1)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert (outs[0] != frames).any()


def test_no_face_passes_frames_through():
    """With no lane present and no background, frames come back bit for
    bit (det_thresh 2.0 admits no score)."""
    gen = torch.Generator().manual_seed(3)
    det = inject_detection_template(
        init_weights(SCRFD(policy=FULL_PRECISION), gen).eval(), d=1.0)
    gfp = init_weights(GFPGANClean(**ENH_GFP, policy=FULL_PRECISION),
                       gen).eval()
    frames = _frames(4)
    out = tenh.FaceEnhancer(det, gfp, None, **ENH,
                            det_thresh=2.0).enhance(frames)
    np.testing.assert_array_equal(out, frames)


# ------------------------------------------------------------------ card
@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["face", "rrdb", "srvgg"])
def test_face_enhancer_on_card(mode):
    """The narrow enhancer on the card against the same modules on the
    CPU, f32: frames within <= 3 grey levels on < 5% of values (the
    paste-back's bf16 contractions); with SRVGG every background conv
    launches S2 (4 tiles x 4 convs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: S2 has no CPU mode")
    from ghost_tpu_torch.core.precision import disable_tf32
    from ghost_tpu_torch.ops.cuda.conv3x3 import conv3x3

    disable_tf32()
    gen = torch.Generator().manual_seed(4)
    det = inject_detection_template(
        init_weights(SCRFD(policy=FULL_PRECISION), gen).eval(), d=1.0)
    gfp = init_weights(GFPGANClean(**ENH_GFP, policy=FULL_PRECISION),
                       gen).eval()
    bg = None
    if mode != "face":
        bg = RRDBNet(**RRDB, policy=FULL_PRECISION) if mode == "rrdb" \
            else SRVGGNetCompact(**SRVGG, policy=FULL_PRECISION)
        bg = init_weights(bg, gen).eval()
    frames = _frames(5)
    ref = tenh.FaceEnhancer(det, gfp, bg, **ENH).enhance(frames)
    card = [m.cuda() if m is not None else None for m in (det, gfp, bg)]
    before = conv3x3.launches
    got = tenh.FaceEnhancer(*card, **ENH).enhance(frames)
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 3 and (diff > 0).mean() < 0.05, \
        (diff.max(), (diff > 0).mean())
    assert conv3x3.launches - before == (16 if mode == "srvgg" else 0)
    assert (ref != frames).mean() > 0.1
