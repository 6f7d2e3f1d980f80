"""The port's Segment Anything (`models/sam.py`), its `.pth` converter
(`convert/torch_loader.py:convert_sam_state_dict`) and the SAM route of
`cli/precompute_masks.py` against ghost_tpu's, on the CPU in f32, at
`tests/test_sam.py`'s tiny config: a 48-px image in 16-px patches (a 3x3
grid; windows of 2, so the windows are zero-padded), depth 2 with block
1 global, a 16-dim decoder.

The weights are a seeded state dict in the upstream `segment_anything`
layout (`tests/torch_prep_inputs.py:sam_state_dict`), converted by each
package's converter; the port's modules take the tree through the weight
bridge. Bounds, with their reason:

  * the converter: the same tree as JAX's, bit for bit, at every preset
    depth (12, 24, 32) and the tiny one;
  * the image encoder, the prompt encoder, the mask decoder and the
    whole `Sam`: 2e-4 of each output's largest value (as
    `tests/test_sam.py` holds JAX to its torch replica: f32 matmuls and
    softmaxes in another order);
  * `_get_rel_pos` with a table of another length (the bilinear resize
    through the interpolation matrices) and the window partition: 1e-6;
  * `SamPredictor.predict_points`: the logits within 2e-4 of their
    largest value; the masks (logits > 0) equal except where |JAX's
    logit| <= 2e-4 of the largest, at most 1e-3 of the pixels (measured:
    none);
  * `sam_mask_loop` on 2 crops and `main --sam_path` through a `.pth`
    and a `.msgpack`, with `build_sam` patched to the tiny builder in
    both packages: every written png (0/255) equal except where the
    predictor's |logit| on that crop is <= 2e-4 of its largest, at most
    1e-3 of the pixels.

JAX is imported inside the fixtures and tests that use it.
"""

import functools

import numpy as np
import pytest
import torch

from ghost_tpu_torch.convert.from_jax import (flax_variables,
                                              load_flax_variables)
from ghost_tpu_torch.convert.torch_loader import convert_sam_state_dict
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models import sam as tsam
from torch_cli_inputs import save_pth
from torch_prep_inputs import SAM_PRESETS, sam_state_dict

IMG, PATCH, DIM, HEADS, DEPTH = 48, 16, 8, 2, 2
GLOBAL, WS, OUT_CH, MLP = (1,), 2, 16, 32
GRID = IMG // PATCH
TOL = 2e-4
EDGE_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiny_sd(seed=0, depth=DEPTH):
    return sam_state_dict(np.random.default_rng(seed), DIM, depth, HEADS,
                          GLOBAL, IMG, PATCH, WS, OUT_CH, MLP)


def tiny_port_sam(preset="vit_h", img_size=IMG, policy=TFULL, device=None,
                  depth=DEPTH):
    """The tiny SAM in the port (build_sam's signature, f32 unless a
    policy is given; preset ignored)."""
    return tsam.Sam(
        tsam.ImageEncoderViT(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                             depth=depth, num_heads=HEADS, window_size=WS,
                             global_attn_indexes=GLOBAL, out_chans=OUT_CH,
                             policy=policy, device=device),
        tsam.PromptEncoder(embed_dim=OUT_CH, image_size=IMG, grid=GRID,
                           policy=policy, device=device),
        tsam.MaskDecoder(embed_dim=OUT_CH, num_heads=HEADS, mlp_dim=MLP,
                         policy=policy, device=device))


def tiny_jax_sam(preset="vit_h", img_size=IMG, policy=None, depth=DEPTH):
    """The tiny SAM in JAX (build_sam's signature, f32 unless a policy
    is given; preset ignored)."""
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import sam as jsam

    JFULL = policy or JFULL
    return jsam.Sam(
        image_encoder=jsam.ImageEncoderViT(
            img_size=IMG, patch_size=PATCH, embed_dim=DIM, depth=depth,
            num_heads=HEADS, window_size=WS, global_attn_indexes=GLOBAL,
            out_chans=OUT_CH, policy=JFULL),
        prompt_encoder=jsam.PromptEncoder(embed_dim=OUT_CH, image_size=IMG,
                                          grid=GRID, policy=JFULL),
        mask_decoder=jsam.MaskDecoder(embed_dim=OUT_CH, num_heads=HEADS,
                                      mlp_dim=MLP, policy=JFULL))


@pytest.fixture(scope="module")
def tiny():
    """The seeded upstream state dict, JAX's converted tree, model and
    predictor, and the port's model on the port's converted tree."""
    sd = _tiny_sd()
    from ghost_tpu.convert.torch_loader import convert_sam_state_dict as jconv

    from ghost_tpu.models import sam as jsam

    jv = jconv(sd, depth=DEPTH)
    port = load_flax_variables(tiny_port_sam(),
                               convert_sam_state_dict(sd, depth=DEPTH)).eval()
    jm = tiny_jax_sam()
    # one JAX predictor (one compile a crop size) for every test
    return dict(sd=sd, jv=jv, jm=jm, port=port,
                jpred=jsam.SamPredictor(jm, jv))


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    pts = rng.uniform(0, IMG, (2, 6, 2)).astype(np.float32)
    labels = np.array([[1, 0, 1, 1, 1, -1], [1, 1, 0, 0, 1, -1]], np.float32)
    return x, pts, labels


# -------------------------------------------------------------- converter


@pytest.mark.parametrize("preset", ["tiny", "vit_b", "vit_l", "vit_h"])
def test_convert_sam_state_dict_matches_jax(preset):
    """The port's converter gives JAX's tree bit for bit; at each preset's
    depth (12, 24, 32; tiny widths) every upstream block is read."""
    from ghost_tpu.convert.torch_loader import convert_sam_state_dict as jconv

    depth = DEPTH if preset == "tiny" else SAM_PRESETS[preset][1]
    sd = _tiny_sd(1, depth)
    got, want = (f(sd, depth=depth) for f in (convert_sam_state_dict, jconv))

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    got, want = dict(flat(got)), dict(flat(want))
    assert got.keys() == want.keys()
    assert sum(k.startswith("params/image_encoder/block_")
               and k.endswith("attn/rel_pos_h") for k in got) == depth
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


def test_bridge_inverse_gives_the_jax_tree(tiny):
    """`flax_variables` of the loaded port SAM is JAX's converted tree:
    the same paths (bare LayerNorm/LayerNorm2d scale and bias,
    pos_embed, rel_pos, the prompt and token parameters) and values."""
    import jax

    got = flax_variables(tiny["port"])
    want = jax.tree.map(np.asarray, tiny["jv"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------- modules


def test_image_encoder_matches_jax(tiny):
    """Patch embed, two blocks (windows of 2 on a 3x3 grid: padded), the
    neck with its LayerNorm2ds."""
    import jax
    import jax.numpy as jnp

    x, _, _ = _inputs(2)
    jm, jv = tiny["jm"], tiny["jv"]
    want = jax.jit(lambda v, x: jm.image_encoder.apply(
        {"params": v["params"]["image_encoder"]}, x))(jv, jnp.asarray(x))
    with torch.no_grad():
        got = tiny["port"].image_encoder(_t(x))
    assert tuple(got.shape) == (2, GRID, GRID, OUT_CH)
    _close(got, want)


def test_prompt_encoder_matches_jax(tiny):
    """Sparse embeddings (labels 1, 0 and the -1 pad), the dense no-mask
    embedding and the dense position encoding."""
    import jax
    import jax.numpy as jnp

    _, pts, labels = _inputs(3)
    jm, jv = tiny["jm"], tiny["jv"]
    want = jax.jit(jm.prompt_encoder.apply)(
        {"params": jv["params"]["prompt_encoder"]}, jnp.asarray(pts),
        jnp.asarray(labels))
    with torch.no_grad():
        got = tiny["port"].prompt_encoder(_t(pts), _t(labels))
    for g, w in zip(got, want):
        _close(g, w)


def test_mask_decoder_matches_jax(tiny):
    """The two-way transformer, the upscaling and the heads on seeded
    embeddings: mask logits and IoU."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    embed = rng.normal(size=(2, GRID, GRID, OUT_CH)).astype(np.float32)
    pe = rng.normal(size=(1, GRID, GRID, OUT_CH)).astype(np.float32)
    sparse = rng.normal(size=(2, 6, OUT_CH)).astype(np.float32)
    dense = rng.normal(size=(2, GRID, GRID, OUT_CH)).astype(np.float32)
    jm, jv = tiny["jm"], tiny["jv"]
    want = jax.jit(jm.mask_decoder.apply)(
        {"params": jv["params"]["mask_decoder"]},
        *(jnp.asarray(a) for a in (embed, pe, sparse, dense)))
    with torch.no_grad():
        got = tiny["port"].mask_decoder(*(_t(a) for a in (embed, pe, sparse,
                                                          dense)))
    assert tuple(got[0].shape) == (2, 4, 4 * GRID, 4 * GRID)
    for g, w in zip(got, want):
        _close(g, w)


def test_sam_matches_jax(tiny):
    """The whole model: mask logits (2, 4, 12, 12) and IoU."""
    import jax
    import jax.numpy as jnp

    x, pts, labels = _inputs(5)
    masks, iou = jax.jit(tiny["jm"].apply)(
        tiny["jv"], *(jnp.asarray(a) for a in (x, pts, labels)))
    with torch.no_grad():
        tm, ti = tiny["port"](_t(x), _t(pts), _t(labels))
    _close(tm, masks)
    _close(ti, iou)


@pytest.mark.parametrize("length", [3, 7, 9])
def test_get_rel_pos_matches_jax(length):
    """A (length, 4) table indexed at q = k = 3 (2 * 3 - 1 = 5 rows): the
    lengths 7 and 9 take the bilinear resize first."""
    from ghost_tpu.models import sam as jsam

    table = np.random.default_rng(length).normal(
        size=(length, 4)).astype(np.float32)
    for q in (2, 3):
        want = np.asarray(jsam._get_rel_pos(q, q, table))
        got = tsam._get_rel_pos(q, q, _t(table)).numpy()
        assert got.shape == want.shape == (q, q, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_window_partition_matches_jax():
    """Zero padding to multiples of the window, and the way back."""
    from ghost_tpu.models import sam as jsam

    x = np.random.default_rng(6).normal(size=(2, 5, 7, 3)).astype(np.float32)
    jw, jpad = jsam.window_partition(x, 3)
    tw, tpad = tsam.window_partition(_t(x), 3)
    assert tpad == jpad == (6, 9)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    back = tsam.window_unpartition(tw, 3, tpad, (5, 7))
    np.testing.assert_array_equal(back.numpy(), x)


# -------------------------------------------------------------- predictor


def _mask_diff(got_masks, want_masks, want_logits):
    """The share of differing mask pixels, after checking that each lies
    where JAX's logit is within TOL of its largest value of 0."""
    diff = got_masks != want_masks
    edge = np.abs(want_logits) <= TOL * np.abs(want_logits).max()
    assert not (diff & ~edge).any()
    return float(diff.mean())


@pytest.mark.parametrize("multimask", [False, True])
def test_predictor_matches_jax(tiny, multimask):
    """predict_points on a 96-px crop (two bilinear steps back from the
    12-px logits): logits, IoU, and the thresholded masks."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)
    kps = rng.uniform(0, 96, (5, 2)).astype(np.float32)
    jm, jiou, jl = tiny["jpred"].predict_points(
        img, kps, np.ones(5), multimask_output=multimask)
    tm, tiou, tl = tsam.SamPredictor(tiny["port"]).predict_points(
        img, kps, np.ones(5), multimask_output=multimask)
    assert tm.shape == jm.shape == ((3 if multimask else 1), 96, 96)
    assert tm.dtype == bool
    _close(tl, jl)
    _close(tiou, jiou)
    assert _mask_diff(tm, jm, jl) <= EDGE_SHARE


def _write_crops(d, seed, names=("a.jpg", "b.png")):
    import cv2

    d.mkdir()
    rng = np.random.default_rng(seed)
    for name in names:
        cv2.imwrite(str(d / name), rng.integers(0, 255, (64, 64, 3),
                                                dtype=np.uint8))
    return d


def _edge_logits(port_model, crop_dir):
    """Per crop, the port predictor's logits on it as the loop prepares
    it (its 256 resize, the template keypoints)."""
    import cv2

    from ghost_tpu_torch.ops.umeyama import ARCFACE_TEMPLATE

    pred = tsam.SamPredictor(port_model)
    kps = np.asarray(ARCFACE_TEMPLATE, np.float32) * (256.0 / 112.0)
    out = {}
    for f in sorted(crop_dir.iterdir()):
        img = cv2.resize(cv2.imread(str(f))[:, :, ::-1], (256, 256))
        out[f.stem] = pred.predict_points(img, kps, np.ones(5))[2][0]
    return out


def _compare_pngs(got_dir, want_dir, logits):
    import cv2

    names = sorted(p.name for p in want_dir.iterdir())
    assert names == sorted(p.name for p in got_dir.iterdir())
    assert names == sorted(f"{k}.png" for k in logits)
    shares = []
    for name in names:
        want = cv2.imread(str(want_dir / name), cv2.IMREAD_GRAYSCALE)
        got = cv2.imread(str(got_dir / name), cv2.IMREAD_GRAYSCALE)
        assert got.shape == want.shape == (256, 256)
        assert set(np.unique(got)) <= {0, 255}
        shares.append(_mask_diff(got > 0, want > 0, logits[name[:-4]]))
    assert max(shares) <= EDGE_SHARE


def test_sam_mask_loop_matches_jax(tiny, tmp_path):
    """The loop over a crop directory (a jpg and a png): one 0/255 mask
    png of 256 px per crop, prompted at the scaled ArcFace template."""
    from ghost_tpu.cli.precompute_masks import sam_mask_loop as jloop

    from ghost_tpu_torch.cli.precompute_masks import sam_mask_loop

    src = _write_crops(tmp_path / "crops", 8)
    jdst, tdst = tmp_path / "jax", tmp_path / "port"
    jdst.mkdir(), tdst.mkdir()
    jloop(tiny["jpred"], str(src), str(jdst))
    sam_mask_loop(tsam.SamPredictor(tiny["port"]), str(src), str(tdst))
    _compare_pngs(tdst, jdst, _edge_logits(tiny["port"], src))


@pytest.mark.parametrize("fmt", ["pth", "msgpack"])
def test_main_sam_path_matches_jax(tmp_path, monkeypatch, fmt):
    """`main --sam_path --sam_preset vit_b` through a `.pth` (converted on
    load, 12 blocks) and a `.msgpack` (the converted tree), `build_sam`
    patched to the tiny builder, 12 blocks deep, in both packages'
    modules: the same pngs, "done (SAM)"."""
    import contextlib
    import io

    from ghost_tpu.cli import precompute_masks as jcli
    from ghost_tpu.core.checkpoint import save_msgpack
    from ghost_tpu.models import sam as jsam

    from ghost_tpu_torch.cli import precompute_masks as tcli

    from ghost_tpu.convert.torch_loader import convert_sam_state_dict as jconv

    # --sam_preset vit_b reads 12 blocks: tiny ones
    monkeypatch.setattr(jsam, "build_sam", functools.partial(
        tiny_jax_sam, depth=12))
    monkeypatch.setattr(tsam, "build_sam", functools.partial(
        tiny_port_sam, depth=12))
    sd = _tiny_sd(11, 12)
    port = load_flax_variables(tiny_port_sam(depth=12),
                               convert_sam_state_dict(sd, depth=12)).eval()
    src = _write_crops(tmp_path / "crops", 9, ("c.jpg", "d.png", "e.jpg"))
    path = tmp_path / f"sam.{fmt}"
    if fmt == "pth":
        save_pth(path, sd)
    else:
        save_msgpack(str(path), jconv(sd, depth=12))
    outs = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("port", tcli.main, {"device": "cpu"})):
        outs[name] = tmp_path / name
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--input_dir", str(src), "--output_dir", str(outs[name]),
                  "--sam_path", str(path), "--sam_preset", "vit_b"], **kw)
        assert buf.getvalue().strip().endswith("done (SAM)")
    _compare_pngs(outs["port"], outs["jax"], _edge_logits(port, src))


def test_predictor_bf16_matches_jax(tiny):
    """Both packages' tiny SAM at the default policy (bf16 compute, the
    port's weights cast once as the CLI casts them) on the same tree,
    held to JAX's f32 run beside JAX's own bf16 error on it: the port's
    logits and IoU within 1.5x JAX's bf16 error + one bf16 ulp (2^-7) of
    the largest value (the outputs are bf16; measured on the logits:
    JAX 6.8e-2 of the largest, the port 3.3e-2)."""
    from ghost_tpu.core.precision import DEFAULT_POLICY as JDEF
    from ghost_tpu.models import sam as jsam

    from ghost_tpu_torch.core.precision import DEFAULT_POLICY
    from ghost_tpu_torch.nn.layers import cast_to_compute_dtype

    port = cast_to_compute_dtype(load_flax_variables(
        tiny_port_sam(policy=DEFAULT_POLICY), tiny["jv"]).eval())
    rng = np.random.default_rng(10)
    img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    kps = rng.uniform(0, 64, (5, 2)).astype(np.float32)
    runs = [p.predict_points(img, kps, np.ones(5)) for p in (
        tiny["jpred"],
        jsam.SamPredictor(tiny_jax_sam(policy=JDEF), tiny["jv"]),
        tsam.SamPredictor(port))]
    for i in (1, 2):  # IoU, logits
        f32, jax16, port16 = (np.asarray(r[i], np.float32) for r in runs)
        top = float(np.abs(f32).max())
        err_jax = float(np.abs(jax16 - f32).max())
        err = float(np.abs(port16 - f32).max())
        assert np.isfinite(port16).all()
        assert err <= 1.5 * err_jax + 2 ** -7 * top, (i, err, err_jax)
