"""The port's swap CLI (`ghost_tpu_torch/cli/inference.py`) against
ghost_tpu's: the parser flag for flag, `load_pipeline`'s weights on the
same files, and `main` runs on a small png and a 5-frame mp4 on the CPU.

Files (module fixture): a narrow `.pth` G (unet, 2 blocks, width 1/16)
and an iresnet34 `backbone.pth` with the reference's names
(`tests/torch_cli_inputs.py`), detector and landmark msgpack written by
the JAX package's `save_msgpack` from seeded variables with its face
templates injected (so detections, the mask and the blend are real), and
the bundled SRVGG student. Weights must be equal exactly: the port's
loaded modules against the JAX CLI's variables passed through the bridge.
The written image must equal `swap_image_fused` on the same pipeline bit
for bit. The enhancer's routes (`--enhance_output face`, `full
--bg_model srvgg`) run narrow GFPGAN and SRVGG `.pth` files written from
the torch replicas of `tests/test_enhancers.py`, both CLIs' full-width
classes monkeypatched to narrow ones, and are held to the JAX CLI's
`main` body on the same files (its `load_pipeline` returning the JAX
pipeline of `loaded`). The video runs take `--arcface_depth tiny` (which, as in the JAX CLI, ignores `--arcface_path` and needs
`--allow_random_weights`): iresnet34 embeds 8 crops a frame, ~0.6 s of
CPU each frame.

JAX is imported inside the tests that use it, so the card tests run
where jax is not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_cli.py
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ghost_tpu_torch.cli import inference as tcli
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.nn.layers import cast_to_compute_dtype
from ghost_tpu_torch.pipeline.image import read_image_rgb
from ghost_tpu_torch.pipeline.video import read_video
from torch_cli_inputs import (aei_state_dict, arcface_state_dict, save_pth,
                              write_media)
from torch_route_inputs import (emit_scrfd, planted_scrfd_graph,
                                recognition_graph, scrfd_mmdet_state_dict)

HW = (160, 224)
N_FRAMES = 5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from ghost_tpu.core.checkpoint import save_msgpack
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import landmark as jlmk
    from ghost_tpu.models import scrfd as jscrfd
    from ghost_tpu.utils.face_template import (inject_detection_template,
                                               inject_landmark_template)
    from tests.test_torch_pipeline import _variables

    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(21)
    paths = write_media(d, rng, HW, N_FRAMES)
    paths["G"], paths["arc"] = str(d / "G_unet_2blocks.pth"), \
        str(d / "backbone.pth")
    save_pth(paths["G"], aei_state_dict(rng, "unet", 2, 1 / 16))
    save_pth(paths["arc"], arcface_state_dict(rng, (3, 4, 6, 3)))
    paths["det"], paths["lmk"] = str(d / "det.msgpack"), str(d / "lmk.msgpack")
    det = inject_detection_template(
        _variables(jscrfd.SCRFD(policy=JFULL), rng, (1, 320, 320, 3)))
    lmk = inject_landmark_template(
        _variables(jlmk.Landmark106(policy=JFULL), rng, (1, 192, 192, 3)))
    save_msgpack(paths["det"], det)
    save_msgpack(paths["lmk"], lmk)
    paths["dir"] = d
    return paths


def _argv(f, *extra, arcface="iresnet34"):
    return ["--G_path", f["G"], "--width", "0.0625",
            "--arcface_path", f["arc"], "--arcface_depth", arcface,
            "--detector_path", f["det"], "--landmark_path", f["lmk"],
            "--det_size", "320", "--batch_size", "2", "--bf16", "",
            "--source_paths", f["src"], *extra]


SR = ("--use_sr", "1", "--sr_model", "srvgg_student")


@pytest.fixture(scope="module")
def loaded(files):
    """The JAX CLI's and the port's pipelines on the same files."""
    from ghost_tpu.cli import inference as jcli

    argv = _argv(files, *SR)
    jpipe = jcli.load_pipeline(jcli.build_parser().parse_args(argv))
    tpipe = tcli.load_pipeline(tcli.build_parser().parse_args(argv), "cpu")
    return jpipe, tpipe


@pytest.fixture(scope="module")
def swapped(files, loaded):
    """The port's `swap_image_fused` of the target image on `loaded`,
    with the sources as the CLI crops them."""
    _, tpipe = loaded
    sources = tcli.crop_or_center(tpipe, files["src"])[None]
    return tpipe.swap_image_fused(read_image_rgb(files["tgt"]), sources)


# ------------------------------------------------------------------ parser
def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


_SAMPLES = ["0", "1", "", "False", "false", "no", "off", "f", "n", "True",
            "yes", " On "]


def test_parser_matches_jax():
    """Every option: strings, dest, default, const, choices, nargs, and
    the same parsed value for each sample string (type behaviour)."""
    from ghost_tpu.cli import inference as jcli

    ref, got = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert sorted(got) == sorted(ref)
    for dest, r in ref.items():
        g = got[dest]
        for field in ("option_strings", "default", "const", "choices",
                      "nargs", "required"):
            assert getattr(g, field) == getattr(r, field), (dest, field)
        if r.type is None or r.type in (int, float, str, bool):
            assert g.type is r.type, dest
        else:  # str2bool: the same answers
            assert [g.type(s) for s in _SAMPLES] == \
                [r.type(s) for s in _SAMPLES], dest


@pytest.mark.parametrize("argv", [
    [],
    ["--source_paths", "a.jpg", "b.jpg", "--target_faces_paths", "t.jpg",
     "--target_video", "in.mp4", "--out_video_name", "out.mp4",
     "--batch_size", "20", "--similarity_th", "0.2", "--backbone",
     "linknet", "--num_blocks", "3"],
    ["--use_sr", "False", "--bf16", "", "--image_to_image", "0",
     "--streaming", "off", "--smooth", "0", "--backbone"],
    ["--sr_model", "srvgg_student", "--arcface_depth", "tiny",
     "--enhance_output", "full", "--bg_model", "srvgg", "--width", "0.5",
     "--allow_random_weights", "yes", "--det_size", "320"],
])
def test_parser_parses_like_jax(argv):
    from ghost_tpu.cli import inference as jcli

    got = vars(tcli.build_parser().parse_args(argv))
    assert got == vars(jcli.build_parser().parse_args(argv))
    if "--use_sr" in argv:
        # the reference's type=bool wart: any non-empty string is True
        assert got["use_sr"] is True and got["bf16"] is False
        assert got["image_to_image"] is True and got["backbone"] == "unet"


def test_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--help"], device="cpu")
    assert e.value.code == 0
    assert "--enhance_output" in capsys.readouterr().out


def test_bundled_student_ckpt_is_the_repo_asset():
    from ghost_tpu.cli import inference as jcli

    path = tcli.bundled_student_ckpt()
    assert path is not None and path == jcli.bundled_student_ckpt()


# ----------------------------------------------------------------- weights
def _bridged(tmod, variables):
    return cast_to_compute_dtype(load_flax_variables(tmod, variables).eval())


def _assert_same_tensors(got, ref):
    g, r = got.state_dict(), ref.state_dict()
    assert sorted(g) == sorted(r)
    for k in r:
        assert g[k].dtype == r[k].dtype and torch.equal(g[k], r[k]), k


def test_load_pipeline_weights_match_jax(loaded):
    """Each of the port's loaded modules equals a fresh port module
    filled by the bridge from the JAX CLI's variables, tensor for tensor,
    and the two SwapConfigs agree."""
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.models.arcface import IResNet
    from ghost_tpu_torch.models.landmark import Landmark106
    from ghost_tpu_torch.models.scrfd import SCRFD
    from ghost_tpu_torch.models.sr.srvgg import srvgg_from_variables

    jpipe, tpipe = loaded
    p = FULL_PRECISION
    refs = {"det_mod": SCRFD(policy=p), "arc_mod": IResNet((3, 4, 6, 3),
                                                           policy=p),
            "gen_mod": AEINet("unet", num_blocks=2, policy=p, width=1 / 16,
                              fused_aad=True),
            "lmk_mod": Landmark106(policy=p)}
    vars_of = {"det_mod": jpipe.det_vars, "arc_mod": jpipe.arc_vars,
               "gen_mod": jpipe.gen_vars, "lmk_mod": jpipe.lmk_vars}
    for name, ref in refs.items():
        _assert_same_tensors(getattr(tpipe, name),
                             _bridged(ref, vars_of[name]))
    assert tpipe.gen_mod.generator.blk1.aad0.fused_aad
    seat, sr_vars = jpipe.sr
    _assert_same_tensors(tpipe.sr.student,
                         _bridged(srvgg_from_variables(sr_vars, policy=p),
                                  sr_vars))
    assert dataclasses.asdict(tpipe.cfg) == dataclasses.asdict(jpipe.cfg)


# --------------------------------------------------------------- CLI runs
def test_image_run_writes_swap_image_fused(files, swapped, capsys):
    """main on the image path writes the target's shape; the png equals
    swap_image_fused on the same pipeline bit for bit, and the blend is
    real."""
    out = str(files["dir"] / "out.png")
    tcli.main(_argv(files, *SR, "--image_to_image", "1", "--target_image",
                    files["tgt"], "--out_image_name", out), device="cpu")
    assert "Swapped Image saved" in capsys.readouterr().out
    written, target = read_image_rgb(out), read_image_rgb(files["tgt"])
    assert written.shape == target.shape
    np.testing.assert_array_equal(written, swapped)
    assert (written != target).mean() > 0.01


@pytest.mark.parametrize("mode", ["streaming", "frames", "streaming_sr"])
def test_video_run_writes_every_frame(files, mode, capsys):
    out = str(files["dir"] / f"{mode}.mp4")
    extra = ["--target_video", files["mp4"], "--out_video_name", out,
             "--streaming", "0" if mode == "frames" else "1"]
    if mode == "streaming_sr":
        extra += list(SR)
    tcli.main(_argv(files, *extra, "--allow_random_weights", "1",
                    arcface="tiny"), device="cpu")
    printed = capsys.readouterr().out
    # the JAX rule: tiny ignores --arcface_path and takes random weights
    assert "WARNING: random ArcFace weights" in printed
    assert "Video saved with path" in printed
    frames, fps = read_video(out)
    source, _ = read_video(files["mp4"])
    assert frames.shape == (N_FRAMES, *HW, 3) and fps == 25.0
    assert (frames != source).mean() > 0.01  # the swap is blended in


# ---------------------------------------------------------------- refusals
def test_main_needs_a_card_by_default(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(_argv(files, "--image_to_image", "1", "--target_image",
                        files["tgt"]))


# ----------------------------------------------------------- the enhancer
# the narrow enhancer both CLIs build in these tests (their classes and
# their converters' defaults are full width), at a crop of 64 and with
# 80x112 background tiles (a 2x2 grid with a 10-px halo on 160x224)
NARROW_GFPGAN = dict(out_size=64, num_style_feat=32, channel_multiplier=2,
                     num_mlp=2, narrow=0.25)
NARROW_SRVGG = dict(num_feat=8, num_conv=2)
ENHANCE_ROUTES = {
    "face": ("--enhance_output", "face"),
    "full_srvgg": ("--enhance_output", "full", "--bg_model", "srvgg"),
}


@pytest.fixture(scope="module")
def enhancer_files(files):
    """GFPGANv1Clean and SRVGG `.pth` files written from the torch
    replicas of `tests/test_enhancers.py` (the official names; GFPGAN's
    toRGB.* and style_mlp.* included), nested under params_ema as the
    real files are."""
    from tests.test_enhancers import TGFPGANv1Clean, TorchSRVGG

    d = files["dir"]
    paths = {"gfpgan": str(d / "GFPGANv1.4.pth"),
             "srvgg": str(d / "realesr-general-x4v3.pth")}
    with torch.random.fork_rng():
        torch.manual_seed(0)
        for key, tm in (("gfpgan", TGFPGANv1Clean(64, 32, 2, 2, 0.25)),
                        ("srvgg", TorchSRVGG(3, 3, 8, 2, 4))):
            with torch.no_grad():
                for prm in tm.parameters():
                    prm.add_(0.05 * torch.randn_like(prm))
            save_pth(paths[key], {k: v.numpy() for k, v in
                                  tm.state_dict().items()}, "params_ema")
    return paths


@pytest.fixture
def narrow_enhancer(monkeypatch):
    """Narrow GFPGANClean and SRVGGNetCompact, their converters' defaults
    and the enhancer's crop in both packages."""
    import functools

    import ghost_tpu.convert.torch_loader as jload
    import ghost_tpu.models.sr.gfpgan as jgfp
    import ghost_tpu.models.sr.srvgg as jsrvgg
    import ghost_tpu.pipeline.enhance as jenh
    import ghost_tpu_torch.convert.torch_loader as tload
    import ghost_tpu_torch.models.sr.gfpgan as tgfp
    import ghost_tpu_torch.models.sr.srvgg as tsrvgg
    import ghost_tpu_torch.pipeline.enhance as tenh

    for gfp, srvgg, load, enh in ((jgfp, jsrvgg, jload, jenh),
                                  (tgfp, tsrvgg, tload, tenh)):
        for mod, name, kw in (
                (gfp, "GFPGANClean", NARROW_GFPGAN),
                (srvgg, "SRVGGNetCompact", NARROW_SRVGG),
                (load, "convert_gfpgan_state_dict",
                 dict(out_size=64, num_style_feat=32)),
                (load, "convert_srvgg_state_dict", dict(num_conv=2)),
                (enh, "FaceEnhancer", dict(crop_size=64,
                                           bg_tile=(80, 112)))):
            monkeypatch.setattr(mod, name, functools.partial(
                getattr(mod, name), **kw))


def _enhance_argv(files, enhancer_files, route, out):
    return _argv(files, *SR, "--image_to_image", "1", "--target_image",
                 files["tgt"], "--out_image_name", out,
                 *ENHANCE_ROUTES[route], "--gfpgan_path",
                 enhancer_files["gfpgan"], "--bg_upsampler_path",
                 enhancer_files["srvgg"])


def _jax_main(jpipe, argv, monkeypatch):
    """The JAX CLI's `main` body on the `loaded` pipeline (its
    `load_pipeline` returns it). What the JAX package runs eagerly, op by
    op (`crop_faces`' detector and functions, the source embedding's
    ArcFace), runs jitted here, as in tests/test_torch_video.py: the same
    math, one compile each instead of one per op."""
    import jax

    from ghost_tpu.cli import inference as jcli
    from ghost_tpu.pipeline import swap as jswap
    from tests.test_torch_video import _EAGER_JAX, _Jitted

    monkeypatch.setattr(jcli, "load_pipeline", lambda args: jpipe)
    for name in ("det_mod", "arc_mod"):
        monkeypatch.setattr(jpipe, name, _Jitted(getattr(jpipe, name)))
    for fname, static in _EAGER_JAX.items():
        monkeypatch.setattr(jswap, fname, jax.jit(getattr(jswap, fname),
                                                  static_argnames=static))
    jcli.main(argv)


@pytest.mark.parametrize("route", list(ENHANCE_ROUTES))
def test_enhance_route_matches_jax(files, loaded, swapped, enhancer_files,
                                   narrow_enhancer, route, capsys,
                                   monkeypatch):
    """`--enhance_output face` and `full --bg_model srvgg` through
    `main(argv, device="cpu")` on the replicas' `.pth` files: the written
    image is within _frames_close of the JAX CLI's `main` body on the
    same files and inputs, and the post-pass changes the swapped frame.
    With face, `run(args, pipe)` on `loaded` writes the same image bit for
    bit."""
    from tests.test_torch_pipeline import _frames_close

    jpipe, tpipe = loaded
    out = str(files["dir"] / f"enhance_{route}.png")
    out_jax = str(files["dir"] / f"enhance_{route}_jax.png")
    argv = _enhance_argv(files, enhancer_files, route, out)
    tcli.main(argv, device="cpu")
    printed = capsys.readouterr().out
    assert "Swapped Image saved" in printed
    assert "random GFPGAN" not in printed and "random srvgg" not in printed
    _jax_main(jpipe, _enhance_argv(files, enhancer_files, route, out_jax),
              monkeypatch)
    written, ref = read_image_rgb(out), read_image_rgb(out_jax)
    assert written.shape == ref.shape == swapped.shape
    _frames_close(written, ref)
    assert (written != swapped).mean() > 0.01
    if route == "face":
        tcli.run(tcli.build_parser().parse_args(argv), tpipe)
        np.testing.assert_array_equal(read_image_rgb(out), written)


@pytest.mark.parametrize("missing", ["gfpgan", "bg"])
def test_enhancer_missing_weights_exit_like_jax(files, loaded,
                                                enhancer_files,
                                                narrow_enhancer, missing):
    """Without --allow_random_weights, a missing --gfpgan_path or
    --bg_upsampler_path exits as the JAX CLI does, with its message."""
    from ghost_tpu.cli import inference as jcli

    jpipe, tpipe = loaded
    gfp = "missing.pth" if missing == "gfpgan" else enhancer_files["gfpgan"]
    argv = _argv(files, "--enhance_output", "full", "--gfpgan_path", gfp,
                 "--bg_upsampler_path", "missing.pth")
    with pytest.raises(SystemExit) as ref:
        jcli.build_enhancer(jcli.build_parser().parse_args(argv), jpipe)
    with pytest.raises(SystemExit) as got:
        tcli.build_enhancer(tcli.build_parser().parse_args(argv), tpipe)
    assert str(got.value) == str(ref.value)
    assert str(got.value).startswith(
        "missing --gfpgan_path" if missing == "gfpgan"
        else "missing --bg_upsampler_path")


def test_enhancer_state_dicts_match_replicas():
    """The numpy writers `chip_smoke.py` uses for full-width enhancer
    checkpoints give the replicas' names and shapes (narrow configs)."""
    from tests.test_enhancers import (TGFPGANv1Clean, TorchRRDBNet,
                                      TorchSRVGG)
    from torch_cli_inputs import (gfpgan_state_dict, rrdb_state_dict,
                                  srvgg_state_dict)

    rng = np.random.default_rng(0)
    for sd, tm in (
            (gfpgan_state_dict(rng, 64, 32, 2, 2, 0.25),
             TGFPGANv1Clean(64, 32, 2, 2, 0.25)),
            (rrdb_state_dict(rng, 8, 2, 4, scale=2),
             TorchRRDBNet(3, 3, 8, 2, 4, scale=2)),
            (srvgg_state_dict(rng, 8, 3, 4), TorchSRVGG(3, 3, 8, 3, 4))):
        ref = tm.state_dict()
        assert sorted(sd) == sorted(ref)
        for k, v in ref.items():
            assert sd[k].shape == tuple(v.shape) and sd[k].dtype == np.float32, k


# ------------------------------------------------------------ pack routes
@pytest.fixture(scope="module")
def routes(files):
    """The reference-pack route files: the planted-head SCRFD graph, a
    full-width SCRFD graph emitted from the port's templated SCRFD, a
    recognition-shaped graph and an mmdet SCRFD-2.5GF `.pth`
    (`tests/torch_route_inputs.py`)."""
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.scrfd import SCRFD
    from ghost_tpu_torch.models.scrfd_v1e import SCRFD_2_5GF
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.utils.face_template import inject_detection_template

    d, rng = files["dir"], np.random.default_rng(22)
    det = inject_detection_template(init_weights(
        SCRFD(policy=FULL_PRECISION), torch.Generator().manual_seed(0)))
    paths = {k: str(d / name) for k, name in (
        ("planted", "planted.onnx"), ("scrfd", "scrfd_10g_bnkps.onnx"),
        ("rec", "glintr100.onnx"), ("mmdet", "model_25GF.pth"))}
    for key, blob in (("planted", planted_scrfd_graph()),
                      ("scrfd", emit_scrfd(det.eval())),
                      ("rec", recognition_graph(rng))):
        Path(paths[key]).write_bytes(blob)
    save_pth(paths["mmdet"], scrfd_mmdet_state_dict(rng, SCRFD_2_5GF))
    return paths


def _jax_and_port(argv):
    from ghost_tpu.cli import inference as jcli

    return (jcli.load_pipeline(jcli.build_parser().parse_args(argv)),
            tcli.load_pipeline(tcli.build_parser().parse_args(argv), "cpu"))


@pytest.fixture(scope="module")
def onnx_loaded(files, routes):
    """Both CLIs' pipelines with `--detector_path *.onnx` (the planted
    graph) and `--arcface_path *.onnx`."""
    return _jax_and_port(_argv(files, "--detector_path", routes["planted"],
                               "--arcface_path", routes["rec"]))


def test_onnx_detector_route_matches_jax(onnx_loaded):
    """`--detector_path *.onnx` builds SCRFDOnnx at --det_size: its rows
    on a letterboxed frame within 1e-5 of the JAX CLI's (its executor
    eager) and the decoded detections equal."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.models import scrfd as jscrfd
    from ghost_tpu_torch.models import scrfd as tscrfd
    from ghost_tpu_torch.models.scrfd_onnx import SCRFDOnnx

    jpipe, tpipe = onnx_loaded
    assert isinstance(tpipe.det_mod, SCRFDOnnx) and tpipe.det_mod.has_kps
    assert tpipe.det_mod.input_size == jpipe.det_mod.input_size == 320
    frames = np.random.default_rng(23).integers(0, 256, (1, *HW, 3),
                                                dtype=np.uint8)
    jcanvas, _ = jscrfd.preprocess_frames(jnp.asarray(frames), 320)
    tcanvas, _ = tscrfd.preprocess_frames(torch.from_numpy(frames), 320)
    jrows = jpipe.det_mod.apply(jpipe.det_vars, jcanvas)
    trows = tpipe.det_mod(tcanvas)
    for jr, tr in zip(jrows, trows):
        for j, t in zip(jr, tr):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-5)
    cfg = tpipe.cfg
    jdec = jax.jit(lambda r: jscrfd.decode_detections(
        r, input_size=320, score_thresh=cfg.det_thresh,
        max_faces=cfg.max_faces))(jrows)
    tdec = tscrfd.decode_detections(trows, input_size=320,
                                    score_thresh=cfg.det_thresh,
                                    max_faces=cfg.max_faces)
    assert float(tdec[0][0, 0]) > 0.5
    for j, t in zip(jdec, tdec):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


def test_onnx_arcface_route_matches_jax(onnx_loaded):
    """`--arcface_path *.onnx` builds ArcFaceOnnx (whatever
    --arcface_depth says): the pipeline's source embeddings within 1e-5
    of the JAX CLI's."""
    from ghost_tpu_torch.models.arcface_onnx import ArcFaceOnnx

    jpipe, tpipe = onnx_loaded
    assert isinstance(tpipe.arc_mod, ArcFaceOnnx)
    crops = np.random.default_rng(24).integers(0, 256, (2, 224, 224, 3),
                                               dtype=np.uint8)
    ref = np.asarray(jpipe.embed_sources(crops))
    got = tpipe.embed_sources(crops)
    assert got.shape == (2, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_mmdet_detector_route_matches_jax(files, routes, capsys):
    """`--detector_path *.pth` builds SCRFDV1e (SCRFD-2.5GF) from the
    mmdet names: the JAX CLI's variables through the bridge, tensor for
    tensor, with its no-kps warning."""
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.scrfd_v1e import SCRFDV1e

    jpipe, tpipe = _jax_and_port(_argv(files, "--detector_path",
                                       routes["mmdet"]))
    assert "SCRFD-2.5GF has no kps branch" in capsys.readouterr().out
    assert isinstance(tpipe.det_mod, SCRFDV1e)
    _assert_same_tensors(tpipe.det_mod, _bridged(
        SCRFDV1e(policy=FULL_PRECISION), jpipe.det_vars))


@pytest.mark.parametrize("route", ["onnx", "mmdet"])
def test_route_image_run(files, routes, route, capsys):
    """main on the image path through the routes: the emitted templated
    SCRFD and the recognition graph (every face detected, a real blend,
    no random detector or ArcFace), or the mmdet `.pth` (it completes and
    warns that alignment has no keypoints)."""
    out = str(files["dir"] / f"route_{route}.png")
    det = routes["scrfd"] if route == "onnx" else routes["mmdet"]
    tcli.main(_argv(files, "--image_to_image", "1", "--target_image",
                    files["tgt"], "--out_image_name", out,
                    "--detector_path", det, "--arcface_path", routes["rec"]),
              device="cpu")
    printed = capsys.readouterr().out
    assert "Swapped Image saved" in printed
    assert "random detector" not in printed and "random ArcFace" not in printed
    written, target = read_image_rgb(out), read_image_rgb(files["tgt"])
    assert written.shape == target.shape
    if route == "onnx":
        assert "no face found" not in printed
        assert (written != target).mean() > 0.01
    else:
        assert "SCRFD-2.5GF has no kps branch" in printed


# ------------------------------------------------------------------- card
@pytest.mark.gpu
def test_image_run_on_card(tmp_path):
    """The image path on the card at the CPU test's size: main writes
    the target's shape; with the face templates injected into a loaded
    pipeline, the split-off run writes swap_image_fused's frame, every
    AADLayer runs K1, and the blend is real."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    from ghost_tpu_torch.ops.cuda.aad import aad_modulate
    from ghost_tpu_torch.utils.face_template import (
        inject_detection_template, inject_landmark_template)

    rng = np.random.default_rng(21)
    f = write_media(tmp_path, rng, HW, N_FRAMES)
    f["G"], f["arc"] = str(tmp_path / "G.pth"), str(tmp_path / "arc.pth")
    save_pth(f["G"], aei_state_dict(rng, "unet", 2, 1 / 16))
    save_pth(f["arc"], arcface_state_dict(rng, (3, 4, 6, 3)))
    out = str(tmp_path / "out.png")
    argv = ["--G_path", f["G"], "--width", "0.0625", "--arcface_path",
            f["arc"], "--arcface_depth", "iresnet34",
            "--allow_random_weights", "1", "--det_size", "320",
            "--batch_size", "2", "--bf16", "", "--source_paths", f["src"],
            "--image_to_image", "1", "--target_image", f["tgt"],
            "--out_image_name", out]
    tcli.main(argv)
    target = read_image_rgb(f["tgt"])
    assert read_image_rgb(out).shape == target.shape

    args = tcli.build_parser().parse_args(argv)
    pipe = tcli.load_pipeline(args)
    assert pipe.device.type == "cuda"
    inject_detection_template(pipe.det_mod)
    inject_landmark_template(pipe.lmk_mod)
    before = aad_modulate.launches
    tcli.run(args, pipe)
    assert aad_modulate.launches > before
    written = read_image_rgb(out)
    sources = tcli.crop_or_center(pipe, f["src"])[None]
    np.testing.assert_array_equal(written,
                                  pipe.swap_image_fused(target, sources))
    assert (written != target).mean() > 0.01
