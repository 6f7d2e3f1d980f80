"""The inswapper_128 teacher on the port's ONNX executor, mirroring
`ghost_tpu/train/distill_native.py` (no onnxruntime).

The reference's distillation regime drives an onnxruntime session per
batch (inswapper_128.onnx with the `emap` embedding projection stored in
the model's own initializers, reference train.py:42-57,139-145). Here the
teacher runs on the card, batched: an area resize 256 -> 128, the emap
projection and L2 normalisation, the graph on `convert/onnx_exec.py`,
and a bilinear resize back to 256; the output stays a device tensor.

Divergence from the reference, as in the JAX package: the teacher's
outputs go back to 256 bilinearly, where the reference takes cv2
INTER_CUBIC (train.py:150-152 lineage).
"""

from __future__ import annotations

import numpy as np
import torch

from ghost_tpu_torch.convert.onnx_exec import OnnxExecutor
from ghost_tpu_torch.convert.onnx_reader import read_onnx_graph
from ghost_tpu_torch.nn.layers import resize


class NativeInswapperTeacher:
    """TeacherProtocol: (xt_256_pm1 NHWC, source_embed (B,512)), numpy or
    tensors -> {'teacher_y': (B,256,256,3) f32 tensor in [-1, 1] on
    `device`}. The card unless the caller asks for the CPU; the
    executor raises without one."""

    def __init__(self, model_path: str, device="cuda"):
        graph = read_onnx_graph(model_path)
        if len(graph.inputs) != 2:
            raise ValueError(
                f"expected (target, source) graph inputs, got {graph.inputs}")
        # insightface stores the 512x512 embedding projection as a graph
        # initializer named 'emap' (the INSwapper wrapper reads
        # graph.initializer[-1])
        emap = graph.initializers.get("emap")
        if emap is None:
            for arr in reversed(list(graph.initializers.values())):
                if arr.shape == (512, 512):
                    emap = arr
                    break
        self.emap = np.asarray(emap, np.float32) if emap is not None else None
        self.executor = OnnxExecutor(graph, device=device)
        self.device = self.executor.device
        self._in_img, self._in_src = graph.inputs
        self._emap = (None if self.emap is None
                      else torch.tensor(self.emap, device=self.device))

    def __call__(self, xt_256_pm1, source_embed):
        with torch.no_grad():
            xt = torch.as_tensor(xt_256_pm1, dtype=torch.float32,
                                 device=self.device)
            latent = torch.as_tensor(source_embed, dtype=torch.float32,
                                     device=self.device)
            x128 = resize(xt * 0.5 + 0.5, (128, 128), method="area")
            blob = x128.permute(0, 3, 1, 2).contiguous()  # NCHW
            if self._emap is not None:
                latent = latent @ self._emap
            latent = latent / torch.clamp(torch.linalg.vector_norm(
                latent, dim=-1, keepdim=True), min=1e-12)
            (pred,) = self.executor({self._in_img: blob,
                                     self._in_src: latent})
            y = resize(pred.permute(0, 2, 3, 1), (256, 256),
                       method="bilinear")
            return {"teacher_y": y * 2.0 - 1.0}
