"""Host-side video IO: decode, encode, audio mux, mirroring
`ghost_tpu/pipeline/video.py`.

Parity targets: read_video (reference utils/inference/video_processing.py:37-66),
VideoWriter output (ibid. :202,241), ffmpeg audio remux (ibid. :21-34).
Decode and encode stay on the host (cv2, RGB uint8 arrays); the swap
drivers of `pipeline/swap.py` move fixed-size chunks to the card.
`data/frames.py:stream_video_chunks` decodes on a thread into the
native frame ring instead.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Iterator, List, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def read_video(path: str) -> Tuple[np.ndarray, float]:
    """Decode all frames -> (N,H,W,3) RGB uint8 + fps."""
    if cv2 is None:
        raise RuntimeError("cv2 unavailable: cannot decode video")
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])  # BGR -> RGB
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames), fps


def iter_video_chunks(path: str, chunk_size: int) -> Iterator[np.ndarray]:
    """Streaming decode in fixed-size chunks (last chunk may be short)."""
    if cv2 is None:
        raise RuntimeError("cv2 unavailable: cannot decode video")
    cap = cv2.VideoCapture(path)
    buf: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        buf.append(frame[:, :, ::-1])
        if len(buf) == chunk_size:
            yield np.stack(buf)
            buf = []
    cap.release()
    if buf:
        yield np.stack(buf)


def write_video(path: str, frames_rgb: np.ndarray, fps: float) -> None:
    if cv2 is None:
        raise RuntimeError("cv2 unavailable: cannot encode video")
    h, w = frames_rgb.shape[1:3]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames_rgb:
        out.write(np.ascontiguousarray(f[:, :, ::-1]))
    out.release()


class VideoChunkWriter:
    """Incremental mp4 writer for the streaming swap path (constant
    memory: chunks are encoded as they arrive instead of materializing
    the full output video like the reference's VideoWriter loop over an
    in-RAM list, video_processing.py:191-243)."""

    def __init__(self, path: str, fps: float):
        if cv2 is None:
            raise RuntimeError("cv2 unavailable: cannot encode video")
        self.path = path
        self.fps = fps
        self._writer = None

    def write(self, frames_rgb: np.ndarray) -> None:
        if self._writer is None:
            h, w = frames_rgb.shape[1:3]
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
        for f in frames_rgb:
            self._writer.write(np.ascontiguousarray(f[:, :, ::-1]))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None


def video_fps(path: str) -> float:
    if cv2 is None:
        raise RuntimeError("cv2 unavailable")
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return fps or 25.0


def add_audio_from_video(src_video: str, dst_video: str) -> bool:
    """Remux the source's audio track onto dst (reference
    add_audio_from_another_video, video_processing.py:21-34). Gated on
    ffmpeg availability; returns False (video stays silent) if absent."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return False
    with tempfile.TemporaryDirectory() as td:
        tmp = os.path.join(td, "muxed.mp4")
        res = subprocess.run(
            [ffmpeg, "-v", "error", "-i", dst_video, "-i", src_video,
             "-map", "0:v", "-map", "1:a?", "-c", "copy", "-shortest", tmp],
            capture_output=True,
        )
        if res.returncode != 0 or not os.path.exists(tmp):
            return False
        shutil.move(tmp, dst_video)
    return True
