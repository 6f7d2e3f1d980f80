"""The port's user entry points with the SR seat against ghost_tpu's:
swap_video_frames, swap_video_stream (both smoothing modes),
swap_image_fused and crop_faces, plus smooth_tracks and the per-shot
mask probe of a target that never appears.

Config: the tiny config of tests/test_torch_pipeline.py (det_size 320,
chunk 2, max_faces 4, match_faces 2, FULL_PRECISION, arcface (1,1,1,1),
AEI-Net unet at width 1/8, detector and landmark templates injected,
every lane present at similarity_th=-2) with use_sr and a tiny SRVGG
student seat (8 features, 2 body convs, x2), 2 identities and 5 seeded
256x320 frames, so the last chunk is padded and the per-shot probe runs.
The same seeded weights are bridged into the port. Each JAX program runs
once, in the module fixture. Both sides run the all-lanes batched body
(lane_skip=False, whose one traced generator and seat halve the JAX
compile time); the port's lanes body, the default, is held against the
port's batched body on the same video (`test_lanes_body_matches_batched`)
and with an absent lane (`test_sr_seat_runs_once_per_present_lane`).

Frames are held to the bound of tests/test_torch_pipeline.py
(`_frames_close`: 3 grey levels on under 5% of the values): the
paste-back blends in bf16, so a sub-ulp difference upstream can move a
pixel by a level or two. Crops from `crop_faces` (bilinear warp in f32)
are held to 1 grey level.
"""

import jax
import numpy as np
import pytest
import torch

from ghost_tpu.core.precision import FULL_PRECISION as JFULL
from ghost_tpu.models import aei as jaei
from ghost_tpu.models import arcface as jarc
from ghost_tpu.models import landmark as jlmk
from ghost_tpu.models import scrfd as jscrfd
from ghost_tpu.models.sr import srvgg as jsrvgg
from ghost_tpu.pipeline import smoothing as jsmoothing
from ghost_tpu.pipeline import swap as jswap
from ghost_tpu.utils.face_template import (inject_detection_template,
                                           inject_landmark_template)
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import FULL_PRECISION
from ghost_tpu_torch.models.sr import srvgg as tsrvgg
from ghost_tpu_torch.pipeline import smoothing as tsmoothing
from ghost_tpu_torch.pipeline import swap as tswap
from tests.test_torch_pipeline import _frames_close, _variables

CFG = dict(det_size=320, chunk_size=2, max_faces=4, match_faces=2,
           similarity_th=-2.0, use_sr=True, lane_skip=False)
# functions of ghost_tpu.pipeline.swap and their static arguments
_EAGER_JAX = {"preprocess_frames": ("det_size",),
              "decode_detections": ("input_size", "score_thresh",
                                    "max_faces", "pre_nms", "iou_thresh"),
              "estimate_norm": ("crop_size", "mode"),
              "warp_affine": ("out_hw", "border", "border_value")}


class _Jitted:
    """A flax module whose `apply` runs jitted: the JAX pipeline applies
    the detector (crop_faces) and ArcFace (embed_sources) eagerly, op by
    op, which costs seconds of per-op compiles here; inside its jitted
    stages a jitted apply inlines. Same math."""

    def __init__(self, mod):
        self.apply = jax.jit(mod.apply)


def _stream(pipe, frames, sources, smooth):
    chunks = iter([frames[0:2], frames[2:4], frames[4:5]])
    outs = list(pipe.swap_video_stream(chunks, sources, sources,
                                       smooth=smooth))
    assert [o.shape[0] for o in outs] == [2, 2, 1]
    return np.concatenate(outs, 0)


@pytest.fixture(scope="module")
def video_run():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    rng = np.random.default_rng(11)
    det = jscrfd.SCRFD(policy=JFULL)
    arc = jarc.IResNet(layers=(1, 1, 1, 1), policy=JFULL)
    gen = jaei.AEINet(backbone="unet", num_blocks=2, policy=JFULL,
                      width=1 / 8)
    lmk = jlmk.Landmark106(policy=JFULL)
    student = jsrvgg.SRVGGNetCompact(num_feat=8, num_conv=2, upscale=2,
                                     policy=JFULL)
    dv = inject_detection_template(_variables(det, rng, (1, 320, 320, 3)))
    av = _variables(arc, rng, (1, 112, 112, 3))
    gv = _variables(gen, rng, (1, 256, 256, 3), (1, 512))
    lv = inject_landmark_template(_variables(lmk, rng, (1, 192, 192, 3)))
    sv = _variables(student, rng, (1, 128, 128, 3))
    jp = jswap.SwapPipeline((_Jitted(det), dv), (_Jitted(arc), av),
                            (gen, gv), (lmk, lv),
                            sr=(jsrvgg.SRVGGStudentSeat(student), sv),
                            config=jswap.SwapConfig(**CFG))

    sv_np = {"params": {k: np.asarray(v) if not isinstance(v, dict) else
                        {"Conv_0": {n: np.asarray(a) for n, a in
                                    v["Conv_0"].items()}}
                        for k, v in sv["params"].items()}}
    tstudent = tsrvgg.srvgg_from_variables(sv_np, policy=FULL_PRECISION)
    load_flax_variables(tstudent, sv_np)
    tp = tswap.build_random_pipeline(
        tswap.SwapConfig(**CFG), policy=FULL_PRECISION, gen_width=1 / 8,
        device="cpu", sr=tsrvgg.SRVGGStudentSeat(tstudent))
    for mod, v in ((tp.det_mod, dv), (tp.arc_mod, av), (tp.gen_mod, gv),
                   (tp.lmk_mod, lv)):
        load_flax_variables(mod, v)

    frames = rng.integers(0, 255, (5, 256, 320, 3), dtype=np.uint8)
    sources = rng.integers(0, 255, (2, 224, 224, 3), dtype=np.uint8)
    runs = {}
    with pytest.MonkeyPatch.context() as mpatch:
        # crop_faces runs these eagerly in the JAX package: jitted, the
        # same math costs one compile each instead of one per op
        for fname, static in _EAGER_JAX.items():
            mpatch.setattr(jswap, fname, jax.jit(getattr(jswap, fname),
                                                 static_argnames=static))
        for name, pipe in (("jax", jp), ("port", tp)):
            r = runs[name] = {}
            r["frames"] = np.asarray(pipe.swap_video_frames(
                frames, sources, sources, smooth=True))
            r["stream"] = _stream(pipe, frames, sources, smooth=True)
            r["stream_fused"] = _stream(pipe, frames, sources, smooth=False)
            r["image"] = np.asarray(pipe.swap_image_fused(frames[0], sources,
                                                          sources))
            r["crops"], r["scores"] = (np.asarray(a) for a in
                                       pipe.crop_faces(frames[1]))
    lanes = tswap.SwapPipeline(tp.det_mod, tp.arc_mod, tp.gen_mod,
                               tp.lmk_mod,
                               tswap.SwapConfig(**dict(CFG, lane_skip=True)),
                               sr=tp.sr)
    runs["port_lanes"] = lanes.swap_video_frames(frames, sources, sources,
                                                 smooth=True)
    yield dict(runs=runs, frames=frames, sources=sources, tp=tp, jp=jp)
    torch.set_num_threads(prev)


@pytest.mark.parametrize("entry", ["frames", "stream", "stream_fused",
                                   "image"])
def test_entry_matches_jax(video_run, entry):
    ref, got = video_run["runs"]["jax"][entry], video_run["runs"]["port"][entry]
    frames = video_run["frames"]
    assert got.shape == ref.shape and got.dtype == np.uint8
    _frames_close(got, ref)
    # the blend is real: the swap moved pixels of every output frame
    base = frames[:1] if entry == "image" else frames
    assert all((g != f).mean() > 0.01 for g, f in
               zip(got.reshape((-1,) + frames.shape[1:]), base))


def test_lanes_body_matches_batched(video_run):
    """The default lanes body with the seat against the batched body
    (another batch size for the generator and seat: the bound of
    `_frames_close`)."""
    runs = video_run["runs"]
    _frames_close(runs["port_lanes"], runs["port"]["frames"])


def test_stream_equals_frames(video_run):
    port = video_run["runs"]["port"]
    np.testing.assert_array_equal(port["stream"], port["frames"])


def test_crop_faces_matches_jax(video_run):
    ref, got = video_run["runs"]["jax"], video_run["runs"]["port"]
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0,
                               atol=1e-4)
    assert got["crops"].shape == ref["crops"].shape
    assert got["crops"].shape[0] >= 1 and got["crops"].dtype == np.uint8
    diff = np.abs(got["crops"].astype(np.int16) - ref["crops"])
    assert diff.max() <= 1, diff.max()


def test_sr_seat_runs_once_per_present_lane(video_run):
    """The lanes body runs the seat once per present lane; the batched
    body skips it for a lane absent from the whole group and passes
    that lane's generator output through."""
    tp, frames = video_run["tp"], video_run["frames"]
    src = tp.embed_sources(video_run["sources"])
    calls = []
    seat = tp.sr
    tp.sr = lambda y: (calls.append(y.shape[0]), seat(y))[1]
    try:
        kps, _, _, _ = tp._detect_match(frames[:2], tswap.normalize_embedding(
            src))
        present = np.array([[True, False], [True, False]])
        for lane_skip in (True, False):
            calls.clear()
            pipe = tswap.SwapPipeline(tp.det_mod, tp.arc_mod, tp.gen_mod,
                                      tp.lmk_mod, tswap.SwapConfig(**dict(
                                          CFG, lane_skip=lane_skip,
                                          gen_groups=1)),
                                      sr=tp.sr)
            out = pipe._swap_blend(frames[:2], kps, present, src)
            assert calls == [2], (lane_skip, calls)
            if lane_skip:
                first = out.numpy()
            else:
                _frames_close(out.numpy(), first)
    finally:
        tp.sr = seat


def test_smooth_tracks_matches_jax():
    rng = np.random.default_rng(3)
    kps = (rng.standard_normal((12, 3, 5, 2)) * 2 + 50).astype(np.float32)
    kps[6:] += 20.0  # a scene cut
    present = rng.uniform(size=(12, 3)) > 0.2
    np.testing.assert_array_equal(
        tsmoothing.smooth_tracks(kps, present, n=2),
        jsmoothing.smooth_tracks(kps, present, n=2))


def test_never_present_target_keeps_defaults_without_a_probe(video_run):
    """A target absent from every frame gets no probe and the default
    mask params, in both video entry points
    (tests/test_mask_first_presence.py)."""
    tp = video_run["tp"]
    pipe = tswap.SwapPipeline(tp.det_mod, tp.arc_mod, tp.gen_mod, tp.lmk_mod,
                              tswap.SwapConfig(**dict(CFG, similarity_th=0.15)),
                              sr=tp.sr)
    kps = np.tile(np.asarray([[40., 40.], [80., 40.], [60., 60.], [45., 85.],
                              [75., 85.]], np.float32)[None, None],
                  (2, 1, 1, 1))

    def fake(frames_u8, target_embeds):
        b = np.asarray(frames_u8).shape[0]
        sim = np.full((b, 1), -1.0, np.float32)
        scores = np.zeros((b, 2), np.float32)
        return (torch.from_numpy(kps[:b]), torch.from_numpy(sim),
                torch.from_numpy(scores),
                torch.from_numpy(np.tile(kps[:b], (1, 2, 1, 1))))

    calls = {"probe": 0, "params": []}
    blend = pipe._swap_blend

    def counted(frames, kps, present, src, mask_params=None, probe=False):
        calls["probe"] += bool(probe)
        calls["params"].append(mask_params)
        return blend(frames, kps, present, src, mask_params, probe)

    pipe._detect_match = fake
    pipe._swap_blend = counted
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (3, 128, 160, 3), dtype=np.uint8)
    src = video_run["sources"][:1]
    out = pipe.swap_video_frames(frames, src, src, smooth=False)
    np.testing.assert_array_equal(out, frames)
    outs = list(pipe.swap_video_stream(iter([frames[:2], frames[2:]]), src,
                                       src, smooth=False))
    np.testing.assert_array_equal(np.concatenate(outs), frames)
    assert calls["probe"] == 0
    default = np.asarray([pipe.cfg.mask_params], np.float32)
    for p in calls["params"]:
        np.testing.assert_array_equal(p, default)
