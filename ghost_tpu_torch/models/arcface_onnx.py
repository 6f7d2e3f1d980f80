"""Run insightface recognition ONNX packs (no onnxruntime), mirroring
`ghost_tpu/models/arcface_onnx.py`.

The reference's antelope pack ships glintr100.onnx (reference
download_models.sh:6, loaded by insightface's FaceAnalysis model zoo);
the swap itself embeds with the torch ArcFace backbone, but the
recognition pack is part of the reference's deployable surface. Given
such a file, `ArcFaceOnnx(path)` is a drop-in for the port's `IResNet`
wherever `SwapPipeline` takes the ArcFace module: calling it on the
pipeline's [-1,1] RGB NHWC 112-crops (identical to insightface's own
preprocessing, (x - 127.5)/127.5 on RGB, model_zoo/arcface_onnx.py)
returns raw (B, 512) embeddings, which the pipeline L2-normalizes where
the reference does.

It computes in float32 whatever the pipeline's policy, as the JAX
adapter does: the input is cast to f32 and the graph's weights stay as
the file holds them (it has no conv or dense layers for
`nn.layers.cast_to_compute_dtype` to cast).
"""

from __future__ import annotations

import torch

from ghost_tpu_torch.convert.onnx_exec import OnnxExecutor
from ghost_tpu_torch.convert.onnx_reader import read_onnx_graph


class ArcFaceOnnx:
    """Callable mirroring `IResNet.forward`, built from an insightface
    recognition .onnx file, on `device` (the card by default)."""

    def __init__(self, model_path: str, device="cuda"):
        graph = read_onnx_graph(model_path)
        if len(graph.inputs) != 1:
            raise ValueError(f"expected one graph input, got {graph.inputs}")
        self.input_name = graph.inputs[0]
        self._ex = OnnxExecutor(graph, device)
        self.device = self._ex.device

    def __call__(self, x):
        """x (B,112,112,3) NHWC RGB in [-1,1] -> (B,512) embeddings."""
        blob = x.to(self.device, torch.float32).permute(0, 3, 1, 2)
        return self._ex({self.input_name: blob})[0]
