"""The port's mask-target and preprocessing CLIs
(`ghost_tpu_torch/cli/precompute_masks.py`'s hull route,
`cli/preprocess.py`) against ghost_tpu's `main`s, on the CPU.

precompute_masks: both `main`s at their defaults (Landmark106 in bf16,
as both CLIs build it) on the same seeded, face-templated landmark
msgpack, over 5 readable 256-px crops and an unreadable file between
them, in chunks of 2: the same file names (the unreadable one skipped,
the masks after it under their own names), each mask equal to JAX's on
all but 1e-3 of its values (`chip_smoke.py` ROUTE_EDGE_SHARE: the hull's
hard threshold turns a landmark difference of bf16 rounding into flipped
edge pixels) and within 3 grey levels elsewhere.

preprocess: `build_random_pipeline` patched in both packages to one
narrow pipeline (det_size 320, ArcFace (1,1,1,1), f32; what
`tests/test_torch_pipeline.py` narrows) with the same weights through
the bridge, and the same face-templated detector msgpack through
--detector_path; celeba with --max_darken 2, vgg (2 identity folders)
and gender (the random head, numpy-seeded in both): the same files,
each image within 3 grey levels on all but 1e-3 of its values (the
crops of the same detections, jpeg-coded). The JAX pipeline's detector
and ArcFace run jitted, as `tests/test_torch_cli.py` runs them: the same
math, one compile each.

JAX is imported inside the fixtures and tests that use it.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from ghost_tpu_torch.cli import precompute_masks as tmasks
from ghost_tpu_torch.cli import preprocess as tprep
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.pipeline import swap as tswap

EDGE_SHARE = 1e-3
GREY = 3


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _image(rng, hw):
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    base = np.stack([(xx + rng.integers(256)) % 256, (yy * 2) % 256,
                     (xx + yy) % 256], -1)
    return np.clip(base + rng.integers(-20, 21, base.shape), 0,
                   255).astype(np.uint8)


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue().splitlines()


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _compare_images(got_dir, want_dir, grey=GREY, share=EDGE_SHARE):
    import cv2

    names = _files(want_dir)
    assert names and names == _files(got_dir)
    for name in names:
        want = cv2.imread(os.path.join(want_dir, name), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(os.path.join(got_dir, name), cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape, name
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert (diff > grey).mean() <= share, (name, (diff > grey).mean())
    return names


# -------------------------------------------------------- precompute_masks


@pytest.fixture(scope="module")
def mask_files(tmp_path_factory):
    """5 seeded 256-px crops and an unreadable `.png` among them; a
    Landmark106 msgpack (seeded, its head pinned to the face template)
    written by the JAX package."""
    import cv2

    from ghost_tpu.core.checkpoint import save_msgpack
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import landmark as jlmk
    from ghost_tpu.utils.face_template import inject_landmark_template
    from tests.test_torch_pipeline import _variables

    d = tmp_path_factory.mktemp("masks")
    rng = np.random.default_rng(31)
    crops = d / "crops"
    crops.mkdir()
    for name in ("a.jpg", "b.png", "d.jpg", "e.png", "f.jpg"):
        cv2.imwrite(str(crops / name), _image(rng, (256, 256)))
    (crops / "c.png").write_bytes(b"not an image")
    lmk = str(d / "lmk.msgpack")
    save_msgpack(lmk, inject_landmark_template(_variables(
        jlmk.Landmark106(policy=JFULL), rng, (1, 192, 192, 3))))
    return dict(dir=d, crops=str(crops), lmk=lmk)


def test_precompute_masks_parser_matches_jax():
    from ghost_tpu.cli import precompute_masks as jcli

    from tests.test_torch_cli import _actions

    got, want = (_actions(m.build_parser()) for m in (tmasks, jcli))
    assert got.keys() == want.keys()
    for k, a in want.items():
        b = got[k]
        assert (b.default, b.type, b.choices, b.required, b.help) == \
            (a.default, a.type, a.choices, a.required, a.help), k


def test_precompute_masks_hull_matches_jax(mask_files):
    """Hull masks through both `main`s, --batch_size 2: the unreadable
    file skips its own mask only; each mask as the module docstring
    says, and a real face mask (neither empty nor full)."""
    import cv2

    from ghost_tpu.cli import precompute_masks as jcli

    d = mask_files["dir"]
    argv = ["--input_dir", mask_files["crops"], "--landmark_path",
            mask_files["lmk"], "--batch_size", "2"]
    lines = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("port", tmasks.main, {"device": "cpu"})):
        lines[name] = _run(main, argv + ["--output_dir", str(d / name)],
                           **kw)
    assert lines["port"] == lines["jax"] == ["done"]
    names = _compare_images(str(d / "port"), str(d / "jax"))
    assert names == ["a.png", "b.png", "d.png", "e.png", "f.png"]
    for name in names:
        m = cv2.imread(str(d / "port" / name), cv2.IMREAD_GRAYSCALE)
        assert m.shape == (256, 256) and 0.05 < (m > 127).mean() < 0.95


def test_precompute_masks_random_landmarks_warn(mask_files, tmp_path):
    """Without --landmark_path: the JAX CLI's warning, then one mask per
    readable crop."""
    out = tmp_path / "out"
    lines = _run(tmasks.main, ["--input_dir", mask_files["crops"],
                               "--output_dir", str(out)], device="cpu")
    assert lines == ["WARNING: random landmark weights; masks will be "
                     "arbitrary", "done"]
    assert _files(str(out)) == ["a.png", "b.png", "d.png", "e.png", "f.png"]


def test_cli_refuses_without_a_card():
    """The command line's default device is the card: without one both
    CLIs raise before reading anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for main in (tmasks.main, tprep.main):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(["--input_dir", "x", "--output_dir", "y"])


# ----------------------------------------------------------------- preprocess


PIPE_CFG = dict(det_size=320)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """One narrow JAX pipeline and the port's on the same weights, a
    face-templated detector msgpack, and the raw images: a flat folder
    of 3 and 2 identity folders of 3 (240x320)."""
    import cv2

    from ghost_tpu.core.checkpoint import save_msgpack
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import aei as jaei
    from ghost_tpu.models import arcface as jarc
    from ghost_tpu.models import landmark as jlmk
    from ghost_tpu.models import scrfd as jscrfd
    from ghost_tpu.pipeline import swap as jswap
    from ghost_tpu.utils.face_template import inject_detection_template
    from tests.test_torch_pipeline import _variables
    from tests.test_torch_video import _Jitted

    d = tmp_path_factory.mktemp("prep")
    rng = np.random.default_rng(32)
    det = jscrfd.SCRFD(policy=JFULL)
    arc = jarc.IResNet(layers=(1, 1, 1, 1), policy=JFULL)
    gen = jaei.AEINet(backbone="unet", num_blocks=1, policy=JFULL,
                      width=1 / 16)
    lmk = jlmk.Landmark106(policy=JFULL)
    # the random pipeline's detector: the --detector_path msgpack
    # replaces it in both CLIs
    dv = _variables(det, rng, (1, 320, 320, 3))
    av = _variables(arc, rng, (1, 112, 112, 3))
    gv = _variables(gen, rng, (1, 256, 256, 3), (1, 512))
    lv = _variables(lmk, rng, (1, 192, 192, 3))
    det_path = str(d / "det.msgpack")
    save_msgpack(det_path, inject_detection_template(
        _variables(det, rng, (1, 320, 320, 3))))
    cfg = jswap.SwapConfig(crop_size=256, **PIPE_CFG)
    jp = jswap.SwapPipeline((det, dv), (arc, av), (gen, gv), (lmk, lv),
                            config=cfg)
    jp.det_mod, jp.arc_mod = _Jitted(det), _Jitted(arc)
    tp = tswap.build_random_pipeline(tswap.SwapConfig(crop_size=256,
                                                      **PIPE_CFG),
                                     policy=TFULL, gen_width=1 / 16,
                                     device="cpu")
    for mod, v in ((tp.det_mod, dv), (tp.arc_mod, av), (tp.lmk_mod, lv)):
        load_flax_variables(mod, v)
    flat, tree = d / "flat", d / "tree"
    for i in range(3):
        flat.mkdir(exist_ok=True)
        cv2.imwrite(str(flat / f"img{i}.jpg"), _image(rng, (240, 320)))
        for ident in ("id0", "id1"):
            (tree / ident).mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(tree / ident / f"{i}.png"),
                        _image(rng, (240, 320)))
    return dict(dir=d, jp=jp, tp=tp, det=det_path, flat=str(flat),
                tree=str(tree))


def test_preprocess_parser_matches_jax():
    from ghost_tpu.cli import preprocess as jcli

    from tests.test_torch_cli import _actions

    got, want = (_actions(m.build_parser()) for m in (tprep, jcli))
    assert got.keys() == want.keys()
    for k, a in want.items():
        b = got[k]
        assert (b.default, b.type, b.choices, b.required, b.help) == \
            (a.default, a.type, a.choices, a.required, a.help), k


MODES = {"celeba": ("flat", ["--max_darken", "2"]),
         "vgg": ("tree", ["--max_images_per_dir", "2"]),
         "gender": ("flat", [])}


@pytest.mark.parametrize("mode", list(MODES))
def test_preprocess_matches_jax(pipelines, mode, monkeypatch):
    """Each mode through both `main`s on the patched pipelines: the same
    printed lines and files, the images as the module docstring says."""
    import jax

    from ghost_tpu.cli import preprocess as jcli
    from ghost_tpu.pipeline import swap as jswap
    from tests.test_torch_video import _EAGER_JAX

    jp, tp = pipelines["jp"], pipelines["tp"]

    def patched(pipe):
        def build(config, *a, **kw):
            assert config.crop_size == 256
            assert kw.get("device", "cpu") == "cpu"
            return pipe
        return build

    monkeypatch.setattr(jswap, "build_random_pipeline", patched(jp))
    monkeypatch.setattr(tswap, "build_random_pipeline", patched(tp))
    for fname, static in _EAGER_JAX.items():
        monkeypatch.setattr(jswap, fname, jax.jit(getattr(jswap, fname),
                                                  static_argnames=static))
    src, extra = MODES[mode]
    d = pipelines["dir"] / mode
    lines = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("port", tprep.main, {"device": "cpu"})):
        lines[name] = _run(main, ["--mode", mode, "--input_dir",
                                  pipelines[src], "--output_dir",
                                  str(d / name), "--detector_path",
                                  pipelines["det"], *extra], **kw)
    assert lines["port"] == lines["jax"]
    names = _compare_images(str(d / "port"), str(d / "jax"))
    if mode == "celeba":
        assert names == sorted(f"img{i}{s}.jpg" for i in range(3)
                               for s in ("", "_d1", "_d2"))
    elif mode == "vgg":
        assert names == [f"id{k}/{i}.jpg" for k in range(2)
                         for i in range(2)]
    else:
        assert len(names) == 3 and all(n.split("/")[0] in ("male", "female")
                                       for n in names)
        assert lines["port"][0].startswith("WARNING: random gender head")
