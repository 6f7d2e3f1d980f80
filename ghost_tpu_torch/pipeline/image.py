"""Host-side image IO, mirroring `ghost_tpu/pipeline/image.py` (reference
utils/inference/image_processing.py): RGB uint8 arrays in and out,
decoded and encoded by cv2."""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def read_image_rgb(path: str) -> np.ndarray:
    if cv2 is None:
        raise RuntimeError("cv2 unavailable")
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img[:, :, ::-1].copy()


def write_image_rgb(path: str, img_rgb: np.ndarray) -> None:
    if cv2 is None:
        raise RuntimeError("cv2 unavailable")
    cv2.imwrite(path, np.ascontiguousarray(img_rgb[:, :, ::-1]))


def normalize_pm1(img_rgb_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 in [-1, 1] (reference normalize_and_torch
    semantics, image_processing.py:23-48, NHWC instead of NCHW)."""
    x = img_rgb_u8.astype(np.float32) / 255.0
    return (x - 0.5) / 0.5


def denormalize_u8(x_pm1: np.ndarray) -> np.ndarray:
    return np.clip((x_pm1 * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
