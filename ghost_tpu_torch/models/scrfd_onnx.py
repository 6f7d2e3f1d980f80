"""Run insightface SCRFD ONNX packs (no onnxruntime), mirroring
`ghost_tpu/models/scrfd_onnx.py`.

The reference's production detector is scrfd_10g_bnkps.onnx driven by
an onnxruntime session (reference
insightface_func/face_detect_crop_multi.py:22-93, download_models.sh:6-8). Given that file, this adapter executes the
graph through the port's ONNX executor (`convert/onnx_exec.py`) and
adapts its outputs to the pipeline's [(score, bbox, kps) per stride]
contract, so `models.scrfd.decode_detections` (and therefore
SwapPipeline) consume it unchanged.

insightface SCRFD graphs emit a flat list of 3*K outputs ordered
[scores x K, bboxes x K, kps x K] for K strides (model_zoo/scrfd.py
detects the layout from len(outputs): 9 with kps, 6 without), each
shaped (B, anchors_per_level, C) or (anchors, C) for batch-1 exports.
"""

from __future__ import annotations

import torch

from ghost_tpu_torch.convert.onnx_exec import OnnxExecutor
from ghost_tpu_torch.convert.onnx_reader import read_onnx_graph
from ghost_tpu_torch.models.scrfd import NUM_ANCHORS, STRIDES


class SCRFDOnnx:
    """Callable mirroring `SCRFD.forward(canvas)`: returns per-stride
    (score_map, bbox_map, kps_map) rows compatible with
    decode_detections. Built from an .onnx file, on `device` (the card
    by default)."""

    def __init__(self, model_path: str, input_size: int = 640,
                 device="cuda"):
        graph = read_onnx_graph(model_path)
        if len(graph.inputs) != 1:
            raise ValueError(f"expected one graph input, got {graph.inputs}")
        n_out = len(graph.outputs)
        if n_out not in (6, 9):
            raise ValueError(
                f"unrecognized SCRFD output count {n_out} (expect 6 or 9)")
        self.has_kps = n_out == 9
        self.input_size = input_size
        self.input_name = graph.inputs[0]
        self._ex = OnnxExecutor(graph, device)
        self.device = self._ex.device

    def __call__(self, canvas_nhwc):
        """canvas (B,S,S,3) normalized (x-127.5)/128 -> per-stride rows."""
        b, s = canvas_nhwc.shape[0], canvas_nhwc.shape[1]
        blob = canvas_nhwc.to(self.device, torch.float32).permute(0, 3, 1, 2)
        outs = self._ex({self.input_name: blob})
        k = len(STRIDES)
        rows = []
        for level, stride in enumerate(STRIDES):
            h = s // stride

            def grab(t, ch):
                if t.ndim == 2:  # batch-1 export: (anchors, C)
                    t = t[None]
                # (B, n, C) -> map layout (B, h, w, NA*C) that
                # decode_detections re-flattens identically
                return t.reshape(b, h, h, NUM_ANCHORS * ch)

            score = grab(outs[level], 1)
            # decode_detections applies sigmoid; insightface graphs
            # already emit probabilities: invert to keep one contract
            p = torch.clamp(score, 1e-12, 1 - 1e-12)
            score = torch.log(p) - torch.log1p(-p)
            bbox = grab(outs[k + level], 4)
            if self.has_kps:
                kps = grab(outs[2 * k + level], 10)
            else:
                kps = torch.zeros((b, h, h, 10 * NUM_ANCHORS),
                                  dtype=score.dtype, device=score.device)
            rows.append((score, bbox, kps))
        return rows
