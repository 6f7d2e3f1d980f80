"""The teacher stage of distillation, mirroring `ghost_tpu/train/distill.py`.

The reference's dominant training cost is a per-sample host loop around
an onnxruntime inswapper session (reference train.py:94-174). Here the
teacher is a batched stage on the card, run one batch ahead:

  * `build_inswapper_teacher`: inswapper_128 on the port's ONNX executor
    (`distill_native.NativeInswapperTeacher`);
  * `TorchTeacher`: a frozen AEI generator (the self-distillation teacher
    of reference train-self.py:244-254), the twin of JAX's `JaxTeacher`;
  * `UpsampledTeacher`: the teacher's output through an SR upscaler
    (`--teacher_upsample`);
  * `TeacherPrefetcher`: runs the teacher one batch ahead on a worker
    thread, in order.

The JAX package's onnxruntime teacher (`OnnxInswapperTeacher`,
`onnx_teacher_available`) has no twin: an onnxruntime session would run
the teacher on the host's CPU, a fallback that hides the card, and the
card's machine has no onnxruntime. Where the executor refuses the graph,
`build_inswapper_teacher` stops with its error.

Teachers return device tensors. The prefetch thread enqueues its CUDA
work on the thread's current stream, the default stream, which the
training step on the main thread shares, so the step reads `teacher_y`
only after the teacher has written it.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, Optional, Protocol

import torch

from ghost_tpu_torch.nn.layers import resize


class TeacherProtocol(Protocol):
    def __call__(self, xt_256_pm1, source_embed) -> dict:
        """Returns {'teacher_y': (B,256,256,3) pm1[, 'teacher_embed':
        (B,512)]}."""


class TorchTeacher:
    """A frozen AEI generator as teacher (train-self.py parity): `gen`
    built with train=False; with `arc_apply`, its output's ArcFace
    embedding at area 112 as 'teacher_embed'."""

    def __init__(self, gen, arc_apply: Optional[Callable] = None):
        self.gen = gen.eval().requires_grad_(False)
        self.arc_apply = arc_apply
        self.device = next(gen.parameters()).device

    def __call__(self, xt_256_pm1, source_embed):
        with torch.no_grad():
            xt = torch.as_tensor(xt_256_pm1, dtype=torch.float32,
                                 device=self.device)
            z = torch.as_tensor(source_embed, dtype=torch.float32,
                                device=self.device)
            y = self.gen(xt, z)[0]
            out = {"teacher_y": y}
            if self.arc_apply is not None:
                out["teacher_embed"] = self.arc_apply(
                    resize(y, (112, 112), method="area"))
        return out


class UpsampledTeacher:
    """--teacher_upsample (reference train.py:228-229): the teacher's
    outputs go through the SR upscaler before the residual loss
    (`extra_trainers.sr_upscale_apply` over LIPSPADE is the CLI's)."""

    def __init__(self, teacher, upscale_fn):
        self.teacher = teacher
        self.upscale_fn = upscale_fn

    def __call__(self, xt_256_pm1, source_embed):
        out = self.teacher(xt_256_pm1, source_embed)
        out["teacher_y"] = self.upscale_fn(out["teacher_y"]).float()
        return out


def build_inswapper_teacher(model_path: str, device="cuda"):
    """The inswapper_128 teacher of --mode distill on the ONNX executor,
    on `device`; stops with the JAX CLI's messages for a missing flag or
    file, and with the executor's error for a graph it refuses."""
    if not model_path:
        raise SystemExit("--mode distill needs --teacher_onnx <inswapper_128.onnx>")
    if not os.path.exists(model_path):
        raise SystemExit(f"teacher model not found: {model_path!r}")
    from ghost_tpu_torch.train.distill_native import NativeInswapperTeacher

    try:
        return NativeInswapperTeacher(model_path, device=device)
    except Exception as e:  # a graph the reader or the executor refuses
        raise SystemExit(f"cannot build inswapper teacher: native executor "
                         f"failed ({e})") from e


class TeacherPrefetcher:
    """Runs the teacher one batch ahead on a worker thread; batches come
    out in order, each with the teacher's outputs added. An error in the
    thread is raised by the iterator; a consumer that stops early stops
    the thread and closes the batches it read from."""

    def __init__(self, teacher: TeacherProtocol, batches: Iterator[dict],
                 depth: int = 2):
        self.teacher = teacher
        self._out: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(batches,), daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, batches):
        try:
            for batch in batches:
                t = self.teacher(batch["xt"], batch["embed"])
                batch = dict(batch)
                batch.update(t)
                if not self._put(batch):
                    return
            self._put(None)
        except Exception as e:  # handed to the consumer, which raises it
            self._put(e)
        finally:
            if hasattr(batches, "close"):
                batches.close()

    def __iter__(self):
        try:
            while True:
                try:
                    item = self._out.get(timeout=1.0)
                except queue.Empty:
                    if not self._thread.is_alive():
                        raise RuntimeError("TeacherPrefetcher: the teacher "
                                           "thread died without a batch")
                    continue
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            self._stop.set()
