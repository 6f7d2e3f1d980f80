"""ghost_tpu_torch.models against ghost_tpu.models on the CPU, weights
bridged from the JAX variables (convert/from_jax.py), FULL_PRECISION.

Bound 1e-4 in f32 (deep conv stacks, sums in another order). The
weights are seeded numpy draws for every leaf, BatchNorm off identity.
"""

import copy

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
from ghost_tpu.utils.face_template import (inject_detection_template,
                                           inject_landmark_template)
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import FULL_PRECISION
from ghost_tpu_torch.nn.layers import init_weights
from ghost_tpu_torch.models import aei as taei
from ghost_tpu_torch.models import arcface as tarc
from ghost_tpu_torch.models import landmark as tlmk
from ghost_tpu_torch.models import scrfd as tscrfd

F32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _variables(jmod, rng, *input_shapes):
    """Seeded random values for every leaf of `jmod`'s variable tree
    (shapes from jax.eval_shape: no init compile). BatchNorm leaves are
    moved off identity so the bridge's BN mapping matters."""
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
        else:  # bias, mean
            v = rng.normal(0, 0.05, shape)
        return jnp.asarray(v, jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _run(tmod, *args):
    with torch.no_grad():
        return tmod(*[torch.from_numpy(np.asarray(a)) for a in args])


def test_scrfd_decode_with_template(rng):
    """Detector + decode + NMS. The letterbox leaves a constant zero band
    (rows 256-319 of a 320 canvas), so scores tie exactly there; both
    sides must keep tied candidates in index order."""
    jdet = jscrfd.SCRFD(policy=JFULL)
    variables = inject_detection_template(
        _variables(jdet, rng, (1, 320, 320, 3)))
    tdet = load_flax_variables(tscrfd.SCRFD(policy=FULL_PRECISION), variables)

    frames = rng.integers(0, 255, (2, 256, 320, 3), dtype=np.uint8)
    canvas, scale = jscrfd.preprocess_frames(jnp.asarray(frames), 320)
    tcanvas, tscale = tscrfd.preprocess_frames(torch.from_numpy(frames), 320)
    assert scale == tscale
    np.testing.assert_array_equal(tcanvas.float().numpy(),
                                  np.asarray(canvas, np.float32))

    jouts = jax.jit(jdet.apply)(variables, canvas)
    touts = _run(tdet, np.asarray(canvas, np.float32))
    for jo, to in zip(jouts, touts):
        for a, b in zip(jo, to):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)

    decode = jax.jit(lambda o: jscrfd.decode_detections(
        o, input_size=320, score_thresh=0.6, max_faces=4))
    ref = [np.asarray(a) for a in decode(jouts)]
    out = [a.numpy() for a in tscrfd.decode_detections(
        touts, input_size=320, score_thresh=0.6, max_faces=4)]
    # candidates whose scores differ by less than the two frameworks'
    # rounding (~1e-7 here) may trade places: match them up by box first
    for i in range(2):
        perm = [int(np.argmin(np.abs(ref[1][i] - bx).sum(-1)))
                for bx in out[1][i]]
        assert sorted(perm) == list(range(4))
        for a, b in zip(ref, out):
            np.testing.assert_allclose(b[i], a[i][perm], **F32)
    # decoding the SAME head outputs: identical picks, ties included
    same = tscrfd.decode_detections(
        [tuple(torch.tensor(np.asarray(x)) for x in lvl) for lvl in jouts],
        input_size=320, score_thresh=0.6, max_faces=4)
    for a, b in zip(ref, same):
        np.testing.assert_array_equal(b.numpy(), a)
    assert out[0].min() > 0  # the template fires


def test_nms_tie_order():
    """Exact score ties with non-overlapping boxes: index order wins."""
    scores = np.array([[0.5, 0.9, 0.5, 0.9, -1.0, 0.5]], np.float32)
    boxes = np.stack([np.array([10.0 * i, 0, 10.0 * i + 5, 5])
                      for i in range(6)])[None].astype(np.float32)
    kps = np.arange(60, dtype=np.float32).reshape(1, 6, 5, 2)
    ref = jscrfd._batched_nms(jnp.asarray(scores), jnp.asarray(boxes),
                              jnp.asarray(kps), 5, 0.4)
    out = tscrfd._batched_nms(torch.from_numpy(scores),
                              torch.from_numpy(boxes),
                              torch.from_numpy(kps), 5, 0.4)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(out[1][0, :, 0].numpy(),
                                  [10, 30, 0, 20, 50])


def test_iresnet(rng):
    jm = jarc.IResNet(layers=(1, 1, 1, 1), policy=JFULL)
    variables = _variables(jm, rng, (1, 112, 112, 3))
    tm = load_flax_variables(tarc.IResNet((1, 1, 1, 1), policy=FULL_PRECISION),
                             variables)
    x = rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    out = _run(tm, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(
        tarc.normalize_embedding(out).numpy(),
        np.asarray(jarc.normalize_embedding(ref)), **F32)


def test_landmark106_and_crops(rng):
    jm = jlmk.Landmark106(policy=JFULL)
    variables = _variables(jm, rng, (1, 192, 192, 3))
    tm = load_flax_variables(tlmk.Landmark106(policy=FULL_PRECISION),
                             variables)
    x = rng.uniform(0, 255, (2, 192, 192, 3)).astype(np.float32)
    np.testing.assert_allclose(_run(tm, x).numpy(),
                               np.asarray(jax.jit(jm.apply)(variables,
                                                            jnp.asarray(x))),
                               **F32)
    # the fused crop -> landmarks wrapper, with the face template injected
    variables = inject_landmark_template(variables)
    tm = load_flax_variables(tlmk.Landmark106(policy=FULL_PRECISION),
                             variables)
    crops = rng.uniform(0, 255, (2, 224, 224, 3)).astype(np.float32)
    ref = jlmk.landmarks_from_crops(jax.jit(jm.apply), variables,
                                    jnp.asarray(crops), 224)
    with torch.no_grad():
        out = tlmk.landmarks_from_crops(tm, torch.from_numpy(crops), 224)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("backbone,num_blocks", [("unet", 1), ("unet", 2),
                                                 ("linknet", 1),
                                                 ("linknet", 2)])
def test_aeinet(rng, backbone, num_blocks):
    width = 1 / 16
    jm = jaei.AEINet(backbone=backbone, num_blocks=num_blocks, policy=JFULL,
                     width=width)
    variables = _variables(jm, rng, (1, 256, 256, 3), (1, 512))
    tm = load_flax_variables(
        taei.AEINet(backbone, num_blocks=num_blocks, policy=FULL_PRECISION,
                    width=width), variables)
    xt = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    zid = rng.normal(0, 1, (1, 512)).astype(np.float32)
    y_ref, attrs_ref = jax.jit(jm.apply)(variables, jnp.asarray(xt),
                                         jnp.asarray(zid))
    y, attrs = _run(tm, xt, zid)
    assert tuple(y.shape) == (1, 256, 256, 3)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **F32)
    for a, b in zip(attrs_ref, attrs):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)


def test_aeinet_grads_match_jax(rng):
    """AEINet(fused_aad=False), the training route, f32: gradients of Xt,
    z_id and every parameter against jax.grad of the JAX AEINet
    (fused_aad=False) on the same weights, at the narrow width of
    test_aeinet. The JAX gradient tree reaches the port's layout through
    the bridge (its transposes are linear).

    Bound per tensor: 2e-2 of its largest |gradient|, plus 1e-6 of the
    largest |gradient| in the model. The gradients are ill-conditioned
    in f32: the instance norms over 2x2 and 4x4 maps divide by standard
    deviations of 4 and 16 values, and a loss over 196608 outputs sums
    terms of both signs. The port's own f32 and f64 runs of this case
    part by up to 6.5e-3 of a tensor's largest gradient (JAX's f32 run
    and the port's f64 one by up to 4.4e-3), while one AADLayer's
    gradients agree with JAX to 1e-6. The bias of up1
    has an exact gradient of 0 (the next instance norm removes its
    shift): both sides give noise at 1e-7 of the model's largest
    gradient. A wrong term (mask, blend, a missing norm) moves a
    gradient by O(1) of its size."""
    width = 1 / 16
    jm = jaei.AEINet(backbone="unet", num_blocks=1, policy=JFULL,
                     width=width)
    variables = _variables(jm, rng, (1, 256, 256, 3), (1, 512))
    tm = load_flax_variables(
        taei.AEINet("unet", num_blocks=1, policy=FULL_PRECISION,
                    width=width), variables)
    xt = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    zid = rng.normal(0, 1, (1, 512)).astype(np.float32)
    w = rng.normal(0, 1, (1, 256, 256, 3)).astype(np.float32)

    def loss(params, xt, zid):
        y, _ = jm.apply({"params": params,
                         "batch_stats": variables["batch_stats"]}, xt, zid)
        return jnp.sum(y * w)

    jg, jgx, jgz = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        variables["params"], jnp.asarray(xt), jnp.asarray(zid))
    tx, tz = (torch.from_numpy(a).requires_grad_() for a in (xt, zid))
    y, _ = tm(tx, tz)
    torch.sum(y * torch.from_numpy(w)).backward()
    want = {name: p.detach().numpy() for name, p in load_flax_variables(
        copy.deepcopy(tm), {"params": jg,
                            "batch_stats": variables["batch_stats"]})
        .named_parameters()}
    want["xt"], want["z_id"] = np.asarray(jgx), np.asarray(jgz)
    got = {name: p.grad for name, p in tm.named_parameters()}
    got["xt"], got["z_id"] = tx.grad, tz.grad
    floor = 1e-6 * max(np.abs(g).max() for g in want.values())
    for name, g in got.items():
        assert g is not None, name
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= 2e-2 * np.abs(want[name]).max() + floor, (name, err)


def test_aeinet_fused_backward_raises(rng):
    """AEINet(fused_aad=True) runs the inference-only fused AAD kernel
    (its plain version on the CPU): a backward through it raises, on
    every device, as JAX's Pallas call has no VJP."""
    tm = init_weights(taei.AEINet("unet", num_blocks=1,
                                  policy=FULL_PRECISION, width=1 / 16,
                                  fused_aad=True),
                      torch.Generator().manual_seed(0))
    y, _ = tm(torch.from_numpy(rng.uniform(-1, 1, (1, 256, 256, 3)).astype(
        np.float32)), torch.from_numpy(rng.normal(0, 1, (1, 512)).astype(
            np.float32)))
    with pytest.raises(RuntimeError, match="fused_aad=False"):
        y.sum().backward()
