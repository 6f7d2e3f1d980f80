"""The port's detect -> swap -> paste-back slice against ghost_tpu's.

Config: det_size 320, chunk 2 of 256x320 seeded frames, T=1,
max_faces 4, match_faces 2, FULL_PRECISION, arcface (1,1,1,1), AEI-Net
unet 2 blocks at width 1/8, detector and landmark templates injected
(so detections, the mask and the blend are real on random weights),
every lane forced present (similarity_th=-2). The same seeded weights
are bridged into the port. The JAX side compiles once: one jitted
function returns the matched kps and similarity, the swapped crop, the
mask and the `_detect_swap` frames.

Bounds, with their reason: kps 1e-3 px and similarity 1e-4 (f32
detector and embedder); the crop extraction contracts in bf16, where
the frameworks may round a product to the neighbouring bf16 value, so
the swapped crop (0-255) is held to 1.0 and the mask (0-1) to 2e-3; the
paste-back blends in bf16 (1 ulp = 1-2 grey levels above 128) wherever
the mask reaches, so a sub-ulp difference upstream can move a pixel by
a level or two: output frames are held to 3 grey levels, on under 5%
of the pixels. The same bound holds the port's micro-batched run
against its one-group run (another batch size, other conv algorithms).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghost_tpu.core.precision import FULL_PRECISION as JFULL
from ghost_tpu.models import aei as jaei
from ghost_tpu.models import arcface as jarc
from ghost_tpu.models import landmark as jlmk
from ghost_tpu.models import scrfd as jscrfd
from ghost_tpu.nn.layers import resize as jresize
from ghost_tpu.ops.mask import soft_face_mask_dynamic as j_mask_dynamic
from ghost_tpu.ops.umeyama import estimate_norm as j_estimate_norm
from ghost_tpu.ops.warp import warp_affine_similarity as j_warp_sim
from ghost_tpu.pipeline import swap as jswap
from ghost_tpu.utils.face_template import (inject_detection_template,
                                           inject_landmark_template)
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import FULL_PRECISION
from ghost_tpu_torch.models.arcface import normalize_embedding
from ghost_tpu_torch.ops.umeyama import estimate_norm
from ghost_tpu_torch.pipeline import swap as tswap

CFG = dict(det_size=320, chunk_size=2, max_faces=4, match_faces=2,
           similarity_th=-2.0)
MASK_PARAMS = np.array([[5.0, 5.0, 5.0, 2.0]], np.float32)


def _variables(jmod, rng, *input_shapes):
    """Seeded random values for every leaf (shapes via eval_shape)."""
    shapes = jax.eval_shape(jmod.init, jax.random.key(0),
                            *[jnp.zeros(s) for s in input_shapes])

    def leaf(path, sd):
        name, shape = path[-1].key, sd.shape
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.9, 1.1, shape)
        elif name == "alpha":
            v = rng.uniform(0.2, 0.3, shape)
        else:
            v = rng.normal(0, 0.05, shape)
        return jnp.asarray(v, jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def slice_run():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    rng = np.random.default_rng(7)
    det = jscrfd.SCRFD(policy=JFULL)
    arc = jarc.IResNet(layers=(1, 1, 1, 1), policy=JFULL)
    gen = jaei.AEINet(backbone="unet", num_blocks=2, policy=JFULL,
                      width=1 / 8)
    lmk = jlmk.Landmark106(policy=JFULL)
    dv = inject_detection_template(_variables(det, rng, (1, 320, 320, 3)))
    av = _variables(arc, rng, (1, 112, 112, 3))
    gv = _variables(gen, rng, (1, 256, 256, 3), (1, 512))
    lv = inject_landmark_template(_variables(lmk, rng, (1, 192, 192, 3)))
    jp = jswap.SwapPipeline((det, dv), (arc, av), (gen, gv), (lmk, lv),
                            config=jswap.SwapConfig(**CFG))

    tp = tswap.build_random_pipeline(tswap.SwapConfig(**CFG),
                                     policy=FULL_PRECISION,
                                     gen_width=1 / 8, device="cpu")
    for mod, v in ((tp.det_mod, dv), (tp.arc_mod, av), (tp.gen_mod, gv),
                   (tp.lmk_mod, lv)):
        load_flax_variables(mod, v)

    frames = rng.integers(0, 255, (2, 256, 320, 3), dtype=np.uint8)
    sources = rng.integers(0, 255, (1, 224, 224, 3), dtype=np.uint8)
    cs = jp.cfg.crop_size

    def fn(v, frames, sources, mp):
        x = (sources.astype(jnp.float32) / 255.0 - 0.5) / 0.5
        x = jresize(x, (112, 112), method="bilinear", align_corners=True)
        src = jp.arc_mod.apply(v["arc"], x)
        tgt = jarc.normalize_embedding(src)
        kps, sim, _, _ = jp._detect_match_impl(v, frames, tgt)
        b = frames.shape[0]
        m = j_estimate_norm(kps.reshape(b, 5, 2), cs)
        crops = j_warp_sim(frames, m[:, None], cs, subpix=jp.cfg.crop_subpix,
                           interp=jp.cfg.crop_interp)
        gen_in = (jresize(crops / 255.0, (256, 256), method="bilinear")
                  - 0.5) / 0.5
        y, _ = jp.gen_mod.apply(v["gen"], gen_in, jnp.tile(src, (b, 1)))
        swap = jresize((y * 0.5 + 0.5) * 255.0, (cs, cs), method="bilinear")
        lmks = jlmk.landmarks_from_crops(jp.lmk_mod.apply, v["lmk"], swap, cs)
        mask = jax.vmap(lambda lm: j_mask_dynamic(lm, cs, *mp[0]))(lmks)
        out = jp._detect_swap_impl(v, frames, tgt, src, mp, True)
        return kps, sim, swap, mask, out

    ref = [np.asarray(a) for a in jax.jit(fn)(
        jp._vars, jnp.asarray(frames), jnp.asarray(sources),
        jnp.asarray(MASK_PARAMS))]

    src = tp.embed_sources(sources)
    tgt = normalize_embedding(src)
    kps, sim, _, _ = tp._detect_match(frames, tgt)
    with torch.inference_mode():
        m = estimate_norm(kps.reshape(2, 5, 2), cs)
        p = torch.from_numpy(MASK_PARAMS).expand(2, 4)
        swap, mask, _ = tp._swap_masks(torch.from_numpy(frames), m[:, None],
                                       src.expand(2, -1), p, False)
    out = tp._detect_swap(frames, tgt, src, MASK_PARAMS)
    got = [kps.numpy(), sim.numpy(), swap.numpy(), mask[..., 0].numpy(),
           out.numpy()]
    yield dict(ref=ref, got=got, frames=frames, tp=tp, src=src, tgt=tgt)
    torch.set_num_threads(prev)


def test_kps_and_similarity(slice_run):
    ref, got = slice_run["ref"], slice_run["got"]
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-4)


def test_swapped_crop_and_mask(slice_run):
    ref, got = slice_run["ref"], slice_run["got"]
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1.0)
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=2e-3)
    assert (ref[3] > 0.5).mean() > 0.05  # the mask is not empty


def _frames_close(out, ref):
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 3 and (diff > 0).mean() < 0.05, \
        (diff.max(), (diff > 0).mean())


def test_frames(slice_run):
    ref, out, frames = slice_run["ref"][4], slice_run["got"][4], \
        slice_run["frames"]
    assert out.shape == frames.shape and out.dtype == np.uint8
    _frames_close(out, ref)
    assert (ref != frames).mean() > 0.01  # the blend is real
    assert (out != frames).mean() > 0.01


def test_lane_skip_equals_batched_and_groups(slice_run):
    tp, frames = slice_run["tp"], slice_run["frames"]
    src, tgt, out = slice_run["src"], slice_run["tgt"], slice_run["got"][4]
    def run(**kw):
        other = tswap.SwapPipeline(tp.det_mod, tp.arc_mod, tp.gen_mod,
                                   tp.lmk_mod, tswap.SwapConfig(**CFG, **kw))
        return other._detect_swap(frames, tgt, src, MASK_PARAMS).numpy()

    np.testing.assert_array_equal(run(lane_skip=False), out)
    _frames_close(run(fused_group=1), out)  # two groups of one frame
    # an all-absent override leaves the frames untouched
    none = tp._detect_swap(frames, tgt, src, MASK_PARAMS,
                           present_override=np.zeros((2, 1), bool))
    np.testing.assert_array_equal(none.numpy(), frames)


def test_build_without_device_needs_a_card():
    """The entry point runs on the card unless the caller asks for the
    CPU: with no card, a call without `device` raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tswap.build_random_pipeline(tswap.SwapConfig(**CFG),
                                    policy=FULL_PRECISION, gen_width=1 / 8)


def test_port_imports_neither_jax_nor_ghost_tpu():
    """Every module of ghost_tpu_torch, found by walking the package,
    imports without pulling in jax, flax, orbax or ghost_tpu."""
    code = ("import importlib, pkgutil, sys, ghost_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "ghost_tpu_torch.__path__, 'ghost_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert 'ghost_tpu_torch.core.checkpoint' in names, names\n"
            "assert 'ghost_tpu_torch.models.sr.spade' in names, names\n"
            "for name in ('cli.inference', 'data.frames', 'pipeline.video',\n"
            "             'convert.torch_loader', 'models.aei_resnet',\n"
            "             'pipeline.enhance', 'models.sr.gfpgan',\n"
            "             'models.discriminator', 'train.train_step',\n"
            "             'train.loop', 'core.loss_scale', 'data.datasets',\n"
            "             'data.loader', 'models.fan', 'train.distill',\n"
            "             'train.distill_native', 'train.extra_trainers',\n"
            "             'cli.train'):\n"
            "    assert 'ghost_tpu_torch.' + name in names, (name, names)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'orbax', 'ghost_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])
