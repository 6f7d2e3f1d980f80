"""ghost_tpu_torch.ops (umeyama, warp, mask) against ghost_tpu.ops on the CPU.

Same seeded numpy inputs through both. f32 bounds 1e-4 (pixel-scale
coordinates, sums in another order). The similarity warps contract in
bf16 by default: there the frameworks may round a product to the
neighbouring bf16 value (1 ulp = 1 to 2 grey levels at 128-255), so
those cases are also run with compute_dtype=float32 at 1e-3 and the bf16
case is bounded by 2 ulps at the value's magnitude plus one grey level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghost_tpu.ops import mask as jm
from ghost_tpu.ops import umeyama as ju
from ghost_tpu.ops import warp as jw
from ghost_tpu_torch.ops import mask as tm
from ghost_tpu_torch.ops import umeyama as tu
from ghost_tpu_torch.ops import warp as tw
from ghost_tpu_torch.utils.face_template import face_template_106

F32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _kps(rng, n, scale=1.0, offset=(40.0, 30.0)):
    base = ju._SRC_112[rng.integers(0, 5, n)] * scale + np.asarray(offset)
    return (base + rng.normal(0, 2, base.shape)).astype(np.float32)


def _similarities(rng, n, crop=24):
    """Frame->crop similarity matrices with varied angle and scale."""
    th = rng.uniform(-0.6, 0.6, n)
    s = rng.uniform(0.6, 1.4, n)
    t = rng.uniform(-20, 5, (n, 2))
    m = np.zeros((n, 2, 3), np.float32)
    m[:, 0, 0] = s * np.cos(th)
    m[:, 0, 1] = -s * np.sin(th)
    m[:, 1, 0] = s * np.sin(th)
    m[:, 1, 1] = s * np.cos(th)
    m[:, :, 2] = t
    return m


def _bf16_close(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    bound = 1.0 + 2 ** -7 * np.abs(ref)
    assert np.all(np.abs(out - ref) <= bound), np.abs(out - ref).max()


def test_umeyama_and_transform(rng):
    src = rng.normal(0, 20, (4, 5, 2)).astype(np.float32)
    dst = rng.normal(0, 20, (4, 5, 2)).astype(np.float32)
    ref = ju.umeyama_similarity(jnp.asarray(src), jnp.asarray(dst))
    out = tu.umeyama_similarity(_t(src), _t(dst))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    pts = ju.transform_points(jnp.asarray(src), ref)
    np.testing.assert_allclose(tu.transform_points(_t(src), out).numpy(),
                               np.asarray(pts), **F32)
    inv = jw.invert_affine(ref)
    np.testing.assert_allclose(tw.invert_affine(out).numpy(), np.asarray(inv),
                               **F32)


@pytest.mark.parametrize("mode", ["None", "arcface"])
def test_estimate_norm(rng, mode):
    kps = _kps(rng, 12, scale=1.7).reshape(3, 4, 5, 2)
    ref = ju.estimate_norm(jnp.asarray(kps), 224, mode=mode)
    out = tu.estimate_norm(_t(kps), 224, mode=mode)
    assert tuple(out.shape) == (3, 4, 2, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("border", ["constant", "replicate"])
def test_warp_affine(rng, border):
    img = rng.uniform(0, 255, (3, 20, 26, 3)).astype(np.float32)
    m = _similarities(rng, 3)
    ref = jw.warp_affine(jnp.asarray(img), jnp.asarray(m), (24, 24),
                         border=border, border_value=7.0)
    out = tw.warp_affine(_t(img), _t(m), (24, 24), border=border,
                         border_value=7.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    one = tw.warp_affine(_t(img[0]), _t(m[0]), (24, 24), border=border,
                         border_value=7.0)
    np.testing.assert_allclose(one.numpy(), np.asarray(ref)[0], **F32)


def test_warp_and_blend(rng):
    frame = rng.integers(0, 255, (3, 20, 26, 3)).astype(np.float32)
    swap = rng.uniform(0, 255, (3, 24, 24, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (3, 24, 24, 1)).astype(np.float32)
    m = _similarities(rng, 3)
    present = np.array([True, False, True])
    ref = jw.warp_and_blend(jnp.asarray(frame), jnp.asarray(swap),
                            jnp.asarray(mask), jnp.asarray(m),
                            present=jnp.asarray(present))
    out = tw.warp_and_blend(_t(frame), _t(swap), _t(mask), _t(m),
                            present=_t(present))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    np.testing.assert_array_equal(out.numpy()[1], frame[1])


def test_nearest_taps_round_half_to_even():
    """Taps exactly at .5 go to the even neighbour in both, and taps
    rounding outside the image are zero (ghost_tpu/ops/warp.py:197-203)."""
    img = np.arange(2 * 4 * 5 * 1, dtype=np.float32).reshape(2, 4, 5, 1) + 1
    xs = np.array([[-0.5, 0.5, 1.5, 2.5, 3.5, 4.5, -0.6, 4.4]] * 2,
                  np.float32)
    ys = np.array([[0.5, 1.5, 2.5, 3.5, -0.5, 0.5, 1.0, 3.5]] * 2, np.float32)
    ref = jw._sample_nearest_batch(jnp.asarray(img), jnp.asarray(xs),
                                   jnp.asarray(ys))
    out = tw._sample_nearest_batch(_t(img), _t(xs), _t(ys))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[0, 6, 0] == 0  # x rounds to -1: outside


@pytest.mark.parametrize("interp,subpix", [("nearest", 3), ("nearest", 2),
                                           ("bilinear", 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_affine_similarity(rng, interp, subpix, dtype):
    frames = rng.integers(0, 255, (2, 40, 52, 3), dtype=np.uint8)
    m = _similarities(rng, 4).reshape(2, 2, 2, 3)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    ref = jw.warp_affine_similarity(jnp.asarray(frames), jnp.asarray(m), 24,
                                    compute_dtype=jd, subpix=subpix,
                                    interp=interp)
    out = tw.warp_affine_similarity(_t(frames), _t(m), 24, compute_dtype=td,
                                    subpix=subpix, interp=interp)
    assert tuple(out.shape) == (4, 24, 24, 3) and out.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3,
                                   atol=1e-3)
    else:
        _bf16_close(out.numpy(), ref)


@pytest.mark.parametrize("rot_subpix,rot_interp", [(1, "bilinear"),
                                                   (2, "nearest")])
def test_warp_and_blend_similarity(rng, rot_subpix, rot_interp):
    frame = rng.integers(0, 255, (3, 30, 40, 3), dtype=np.uint8)
    swap = rng.uniform(0, 255, (3, 24, 24, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (3, 24, 24, 1)).astype(np.float32)
    m = _similarities(rng, 3)
    present = np.array([True, True, False])
    ref = jw.warp_and_blend_similarity(
        jnp.asarray(frame), jnp.asarray(swap), jnp.asarray(mask),
        jnp.asarray(m), present=jnp.asarray(present), grid=40,
        rot_subpix=rot_subpix, rot_interp=rot_interp)
    out = tw.warp_and_blend_similarity(
        _t(frame), _t(swap), _t(mask), _t(m), present=_t(present), grid=40,
        rot_subpix=rot_subpix, rot_interp=rot_interp)
    assert out.dtype == torch.bfloat16
    _bf16_close(out.float().numpy(), ref)
    np.testing.assert_array_equal(out.float().numpy()[2], frame[2])


def _landmarks(rng, n, size=224):
    base = (face_template_106() + 1.0) * (size / 2)
    return (base[None] + rng.normal(0, 1.5, (n, 106, 2))).astype(np.float32)


def test_mask_geometry_pieces(rng):
    lm = _landmarks(rng, 3, 64)
    np.testing.assert_allclose(
        tm.expand_eyebrows(_t(lm), 2.0).numpy(),
        np.asarray(jm.expand_eyebrows(jnp.asarray(lm), 2.0)), **F32)
    sd_ref = jax.vmap(lambda p: jm._signed_dist_to_hull(p, 64))(jnp.asarray(lm))
    np.testing.assert_allclose(tm._signed_dist_to_hull(_t(lm), 64).numpy(),
                               np.asarray(sd_ref), **F32)
    lt = _landmarks(rng, 3, 64)
    off_ref = jax.vmap(jm.mask_offset_from_landmarks)(jnp.asarray(lm),
                                                      jnp.asarray(lt))
    off = tm.mask_offset_from_landmarks(_t(lm), _t(lt))
    np.testing.assert_allclose(off.numpy(), np.asarray(off_ref), **F32)


def test_mask_params_tables():
    offs = np.array([-4.0, -3.0, 0.0, 3.0, 3.5, 6.0, 6.5], np.float32)
    ref = jax.vmap(jm.mask_params_from_offset_traced)(jnp.asarray(offs))
    out = tm.mask_params_from_offset_traced(_t(offs))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for o, row in zip(offs, out.numpy()):
        assert tm.mask_params_from_offset(o) == jm.mask_params_from_offset(o)
        np.testing.assert_allclose(row, tm.mask_params_from_offset(o))


@pytest.mark.parametrize("params", [(5.0, 5.0, 5.0, 2.0),
                                    (10.0, 10.0, 8.0, 2.0)])
def test_face_mask_batch(rng, params):
    lm = _landmarks(rng, 2, 96)
    ref = jm.face_mask_batch(jnp.asarray(lm), 96, params)
    out = tm.face_mask_batch(_t(lm), 96, params)
    assert tuple(out.shape) == (2, 96, 96, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    assert float(out.max()) > 0.5  # the hull is filled


def test_soft_face_mask_dynamic(rng):
    lm = _landmarks(rng, 3, 96)
    p = np.array([[5.0, 5.0, 5.0, 2.0], [10.0, 10.0, 8.0, 2.0],
                  [-5.0, 5.0, 10.0, 0.5]], np.float32)
    ref = jax.vmap(lambda l, q: jm.soft_face_mask_dynamic(
        l, 96, q[0], q[1], q[2], q[3]))(jnp.asarray(lm), jnp.asarray(p))
    out = tm.soft_face_mask_dynamic(_t(lm), 96, _t(p[:, 0]), _t(p[:, 1]),
                                    _t(p[:, 2]), _t(p[:, 3]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    assert float(out.max()) > 0.5
