"""Native frame transport: ctypes bindings for `runtime/ghost_rt.cpp`,
mirroring `ghost_tpu/data/frames.py`.

The host half of the decode -> swap feed: a lock-free SPSC ring of
fixed-size frame slots (a decode thread pushes, the swap driver pops)
and a fused uint8 -> float conversion. g++ builds the library at first
use into `build/ghost_tpu_torch/` at the root of the checkout, under a
name that carries a hash of the source and the flags (as the CUDA
libraries are, `ops/cuda/_build.py`), never next to the source.

Without g++ the module falls back to numpy + `queue.Queue`, as the JAX
module does; the fallback is never silent: `native_available()` says
whether the library loaded (`native_error()` why not), a `FrameRing`
says which ring it is (`native`), and `stream_video_chunks` logs the
ring it used.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import queue
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ghost_tpu_torch.ops.cuda._build import BUILD_DIR

_SRC = Path(__file__).resolve().parents[1] / "runtime" / "ghost_rt.cpp"
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_log = logging.getLogger(__name__)
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None
_lib_tried = False


def library_path() -> Path:
    """Where the library is (or will be) built for this source and flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return BUILD_DIR / f"libghost_rt-{h.hexdigest()[:12]}.so"


def _build_lib() -> Path:
    """Build the library if this source has none yet; raises on failure.
    The compiler writes a temporary name that is renamed into place, so
    concurrent first uses never load a half-written file."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name} (rc {res.returncode}):"
                           f"\n{res.stderr}")
    os.replace(tmp, path)
    return path


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_error, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(str(_build_lib()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _lib_error = f"{type(e).__name__}: {e}"
        return None
    # argtypes before the first call: an undeclared pointer argument is
    # passed as a 32-bit int and cut
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gr_ring_create.restype = ptr
    lib.gr_ring_create.argtypes = [i64, i64]
    lib.gr_ring_destroy.restype = None
    lib.gr_ring_destroy.argtypes = [ptr]
    lib.gr_ring_try_push.restype = ctypes.c_int
    lib.gr_ring_try_push.argtypes = [ptr, ptr, i64]
    lib.gr_ring_try_pop.restype = ctypes.c_int
    lib.gr_ring_try_pop.argtypes = [ptr, ptr, i64]
    lib.gr_ring_size.restype = i64
    lib.gr_ring_size.argtypes = [ptr]
    lib.gr_u8_to_f32_affine.restype = None
    lib.gr_u8_to_f32_affine.argtypes = [ptr, ptr, i64, ctypes.c_float,
                                        ctypes.c_float]
    _lib = lib
    return _lib


def native_available() -> bool:
    """True when libghost_rt built (or was found) and loaded."""
    return _load_lib() is not None


def native_error() -> Optional[str]:
    """Why the library did not load, or None."""
    _load_lib()
    return _lib_error


def u8_to_pm1(frames_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1,1] via the native kernel when available."""
    lib = _load_lib()
    out = np.empty(frames_u8.shape, np.float32)
    if lib is not None and frames_u8.flags["C_CONTIGUOUS"]:
        lib.gr_u8_to_f32_affine(frames_u8.ctypes.data, out.ctypes.data,
                                frames_u8.size, 1.0 / 127.5, -1.0)
        return out
    return frames_u8.astype(np.float32) / 127.5 - 1.0


class FrameRing:
    """SPSC ring of fixed-shape uint8 frames (native or Queue fallback;
    `native` says which)."""

    def __init__(self, frame_shape: tuple, slots: int = 8):
        self.frame_shape = tuple(frame_shape)
        self.nbytes = int(np.prod(frame_shape))
        self._lib = _load_lib()
        self._ring = None
        if self._lib is not None:
            self._ring = self._lib.gr_ring_create(slots, self.nbytes)
            if not self._ring:
                self._lib = None
        if self._lib is None:
            self._q: queue.Queue = queue.Queue(maxsize=slots)
        self.native = self._lib is not None
        self._closed = threading.Event()

    def push(self, frame: np.ndarray, timeout: float = 10.0) -> bool:
        frame = np.ascontiguousarray(frame, np.uint8)
        if self._lib is not None:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if self._lib.gr_ring_try_push(self._ring, frame.ctypes.data,
                                              self.nbytes):
                    return True
                time.sleep(0.0005)
            return False
        try:
            self._q.put(frame, timeout=timeout)
            return True
        except queue.Full:
            return False

    def pop(self, timeout: float = 10.0) -> Optional[np.ndarray]:
        if self._lib is not None:
            out = np.empty(self.frame_shape, np.uint8)
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if self._lib.gr_ring_try_pop(self._ring, out.ctypes.data,
                                             self.nbytes):
                    return out
                if self._closed.is_set() and self.size() == 0:
                    return None
                time.sleep(0.0005)
            return None
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def size(self) -> int:
        if self._lib is not None:
            return int(self._lib.gr_ring_size(self._ring))
        return self._q.qsize()

    def drained(self) -> bool:
        """True only when the producer closed the ring AND every frame
        has been popped — the one condition that means end-of-stream
        (a pop timeout alone is a stall, not EOF)."""
        return self._closed.is_set() and self.size() == 0

    def close(self):
        self._closed.set()

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_ring",
                                                               None):
            self._lib.gr_ring_destroy(self._ring)
            self._ring = None


def stream_video_chunks(path: str, chunk_size: int,
                        slots: int = 4) -> Iterator[np.ndarray]:
    """Decode-on-thread video chunk iterator: cv2 decode runs in a
    producer thread pushing into the ring while the consumer feeds the
    device. Logs which ring it used (WARNING for the Queue fallback)."""
    import cv2

    cap = cv2.VideoCapture(path)
    ok, first = cap.read()
    if not ok:
        cap.release()
        return
    h, w = first.shape[:2]
    ring = FrameRing((h, w, 3), slots=slots * chunk_size)
    if ring.native:
        _log.info("stream_video_chunks: native ring (%s)", library_path())
    else:
        _log.warning("stream_video_chunks: queue.Queue fallback, libghost_rt "
                     "unavailable (%s)", native_error())

    def producer():
        ring.push(first[:, :, ::-1])
        while True:
            ok2, frame = cap.read()
            if not ok2:
                break
            if not ring.push(frame[:, :, ::-1], timeout=30.0):
                break
        cap.release()
        ring.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    buf = []
    while True:
        f = ring.pop(timeout=30.0)
        if f is None:
            # only a closed-and-drained ring is EOF; a timeout with the
            # decode thread still alive is a stall and must not
            # silently truncate the video
            if ring.drained():
                break
            if not t.is_alive():
                break
            continue  # producer alive: keep waiting
        buf.append(f)
        if len(buf) == chunk_size:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)
    t.join(timeout=5.0)
