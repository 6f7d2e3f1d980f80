"""The port's ONNX adapters for the reference's packs against ghost_tpu's:
`SCRFDOnnx` on the planted-head graph (against the JAX adapter) and on a
full-width SCRFD graph emitted from the port's own `SCRFD` (against that
module), and `ArcFaceOnnx` on a recognition-shaped graph (against the
JAX adapter). The JAX executor runs eagerly.

Bounds, with their reason: 1e-5 against the JAX adapters (the same
executor semantics in f32); decoded detections of the emitted SCRFD
against the native module: scores 1e-5, boxes and kps 1e-3 px (f32
through ~60 conv layers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ghost_tpu_torch.core.precision import FULL_PRECISION
from torch_route_inputs import (emit_scrfd, planted_scrfd_graph,
                                recognition_graph)


# ---------------------------------------------------------------- SCRFDOnnx
def test_scrfd_onnx_matches_jax_adapter(tmp_path):
    """The planted-head graph: rows within 1e-5 of the JAX adapter's and
    decode_detections' output equal, with the planted values."""
    from ghost_tpu.models import scrfd as jscrfd
    from ghost_tpu.models.scrfd_onnx import SCRFDOnnx as JSCRFDOnnx
    from ghost_tpu_torch.models import scrfd as tscrfd
    from ghost_tpu_torch.models.scrfd_onnx import SCRFDOnnx

    path = tmp_path / "planted.onnx"
    path.write_bytes(planted_scrfd_graph())
    jdet, tdet = JSCRFDOnnx(str(path)), SCRFDOnnx(str(path), device="cpu")
    assert jdet.has_kps and tdet.has_kps
    frames = np.zeros((1, 640, 640, 3), np.uint8)
    jcanvas, _ = jscrfd.preprocess_frames(jnp.asarray(frames), 640)
    tcanvas, _ = tscrfd.preprocess_frames(torch.from_numpy(frames), 640)
    jrows, trows = jdet.apply({}, jcanvas), tdet(tcanvas)
    for jr, tr in zip(jrows, trows):
        for j, t in zip(jr, tr):
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-5)
    jdec = jax.jit(functools.partial(  # eager, its NMS takes ~6 s
        jscrfd.decode_detections, input_size=640, score_thresh=0.5,
        max_faces=4))(jrows)
    tdec = tscrfd.decode_detections(trows, input_size=640, score_thresh=0.5,
                                    max_faces=4)
    for j, t in zip(jdec, tdec):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    scores, boxes, _ = tdec
    assert abs(float(scores[0, 0]) - 0.9) < 1e-3
    x0, y0, x1, y1 = boxes[0, 0].tolist()
    assert abs(x1 - x0 - 32) < 1e-3 and abs(y1 - y0 - 16) < 1e-3


def test_scrfd_onnx_gives_native_detections(tmp_path):
    """A full-width SCRFD graph emitted from the port's templated SCRFD:
    SCRFDOnnx decodes the native module's detections (2 letterboxed
    frames at det_size 320, f32)."""
    from ghost_tpu_torch.models.scrfd import (SCRFD, decode_detections,
                                              preprocess_frames)
    from ghost_tpu_torch.models.scrfd_onnx import SCRFDOnnx
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.utils.face_template import inject_detection_template

    det = inject_detection_template(init_weights(
        SCRFD(policy=FULL_PRECISION), torch.Generator().manual_seed(0)))
    det.eval()
    path = tmp_path / "scrfd.onnx"
    path.write_bytes(emit_scrfd(det))
    onnx = SCRFDOnnx(str(path), input_size=320, device="cpu")
    frames = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 180, 320, 3), dtype=np.uint8))
    canvas, _ = preprocess_frames(frames, 320)
    with torch.inference_mode():
        got = decode_detections(onnx(canvas), 320, max_faces=4)
        ref = decode_detections(det(canvas), 320, max_faces=4)
    assert bool((ref[0] > 0).all())  # the template finds faces
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=1e-5)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-3)


# -------------------------------------------------------------- ArcFaceOnnx
def test_arcface_onnx_matches_jax_adapter(tmp_path):
    """A recognition-shaped graph (`recognition_graph`): the port's
    adapter within 1e-5 of the JAX adapter's embeddings (the emitted
    iresnet is held to the port's IResNet in tests/test_torch_onnx.py);
    bf16 crops compute in f32."""
    from ghost_tpu.models.arcface_onnx import ArcFaceOnnx as JArcFaceOnnx
    from ghost_tpu_torch.models.arcface_onnx import ArcFaceOnnx

    rng = np.random.default_rng(4)
    path = tmp_path / "rec.onnx"
    path.write_bytes(recognition_graph(rng))
    jarc, tarc = JArcFaceOnnx(str(path)), ArcFaceOnnx(str(path), device="cpu")
    x = rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    ref = np.asarray(jarc.apply(jax.tree.map(jnp.asarray, jarc.variables),
                                jnp.asarray(x)))
    with torch.inference_mode():
        got = tarc(torch.from_numpy(x))
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got_b, got_bf = tarc(xb), tarc(xb.float())
    assert got.shape == (2, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert got_b.dtype == torch.float32 and torch.equal(got_b, got_bf)
