"""Training datasets: the source/target pairing of the reference, a copy
of `ghost_tpu/data/datasets.py` (numpy and cv2 only).

Parity targets (reference utils/training/Dataset.py):
  * FaceEmbed (:17-75): flat image dirs; with prob `same_prob` the
    target IS the source (same_person=1), else a random image from a
    random dir (same_person=0); emits (Xs_arcface224, Xs256, Xt_raw256,
    Xt256, same_person);
  * FaceEmbedVGG2 (:78-143): per-identity folders; same_identity mode
    samples the "same" pair from the same folder;
  * CelebADataset (:169-283): flat dir + optional fine_tune_filter /
    into_data_path / only_attractive CSV attribute filter, random
    horizontal flips, always same_person=0.

Items are numpy HWC RGB float32 arrays (no torchvision): the color
jitter is brightness/contrast/saturation/hue factors with torchvision's
semantics, the hue step through uint8 HSV. Every item equals the JAX
package's bit for bit: the same files, the same `random.Random(seed)`
draws in the same order, the same cv2 calls and dtypes. `train_loop`
moves the stacked batches to the card.
"""

from __future__ import annotations

import csv
import glob
import os
import random
from typing import List, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _imread_rgb(path: str) -> np.ndarray:
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img[:, :, ::-1]


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)


def color_jitter(
    img: np.ndarray,
    rng: random.Random,
    brightness=(0.8, 1.2),
    contrast=(0.8, 1.2),
    saturation=(0.8, 1.2),
    hue=0.01,
) -> np.ndarray:
    """torchvision ColorJitter-style augmentation on uint8 RGB."""
    x = img.astype(np.float32)
    x = x * rng.uniform(*brightness)
    mean = x.mean()
    x = (x - mean) * rng.uniform(*contrast) + mean
    gray = x.mean(axis=2, keepdims=True)
    x = (x - gray) * rng.uniform(*saturation) + gray
    if hue > 0 and cv2 is not None:
        h = rng.uniform(-hue, hue) * 180.0
        hsv = cv2.cvtColor(np.clip(x, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
        hsv = hsv.astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] + h) % 180.0
        x = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(np.float32)
    return np.clip(x, 0, 255)


def _to_pm1(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


def _to_01(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0


def random_rgb_to_bgr(img: np.ndarray, rng: random.Random,
                      probability: float = 1 / 25) -> np.ndarray:
    """Channel-swap augmentation (reference utils/training/helpers.py:258-269)."""
    if rng.random() < probability:
        return np.ascontiguousarray(img[:, :, ::-1])
    return img


class _PairDataset:
    """Shared item assembly: returns dict of numpy arrays."""

    jitter: bool = True
    normalize_pm1: bool = True
    bgr_aug_prob: float = 0.0  # reference RandomRGBtoBGR uses 1/25

    def _assemble(self, xs_img, xt_img, same_person, rng):
        if self.bgr_aug_prob > 0:
            xs_img = random_rgb_to_bgr(xs_img, rng, self.bgr_aug_prob)
            xt_img = random_rgb_to_bgr(xt_img, rng, self.bgr_aug_prob)
        if self.jitter:
            xs_a = color_jitter(xs_img, rng)
            xs_b = color_jitter(xs_img, rng)
            xt_b = color_jitter(xt_img, rng)
        else:
            xs_a = xs_b = xs_img.astype(np.float32)
            xt_b = xt_img.astype(np.float32)
        norm = _to_pm1 if self.normalize_pm1 else _to_01
        return {
            "xs_arcface": norm(_resize(xs_a, 224)),
            "xs": norm(_resize(xs_b, 256)),
            "xt_raw": _to_01(_resize(xt_img, 256)),
            "xt": norm(_resize(xt_b, 256)),
            "same_person": np.float32(same_person),
        }


class FaceEmbedDataset(_PairDataset):
    def __init__(self, data_paths: Sequence[str], same_prob: float = 0.8,
                 normalize_pm1: bool = True, seed: int = 0):
        self.files: List[List[str]] = [
            sorted(glob.glob(os.path.join(p, "*.*g"))) for p in data_paths
        ]
        self.flat = [f for sub in self.files for f in sub]
        if not self.flat:
            raise ValueError(f"no images under {data_paths}")
        self.same_prob = same_prob
        self.normalize_pm1 = normalize_pm1
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.flat)

    def __getitem__(self, idx: int):
        rng = self.rng
        xs = _imread_rgb(self.flat[idx])
        if rng.random() > self.same_prob:
            sub = rng.choice(self.files)
            xt = _imread_rgb(rng.choice(sub))
            same = 0
        else:
            xt = xs.copy()
            same = 1
        return self._assemble(xs, xt, same, rng)


class FaceEmbedVGG2Dataset(_PairDataset):
    def __init__(self, data_path: str, same_prob: float = 0.8,
                 same_identity: bool = False, normalize_pm1: bool = True,
                 seed: int = 0):
        self.images = sorted(glob.glob(os.path.join(data_path, "*", "*.*g")))
        if not self.images:
            raise ValueError(f"no identity folders under {data_path}")
        self.by_folder = {}
        for f in self.images:
            self.by_folder.setdefault(os.path.dirname(f), []).append(f)
        self.same_prob = same_prob
        self.same_identity = same_identity
        self.normalize_pm1 = normalize_pm1
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        rng = self.rng
        path = self.images[idx]
        xs = _imread_rgb(path)
        if rng.random() > self.same_prob:
            xt = _imread_rgb(rng.choice(self.images))
            same = 0
        else:
            if self.same_identity:
                xt = _imread_rgb(rng.choice(self.by_folder[os.path.dirname(path)]))
            else:
                xt = xs.copy()
            same = 1
        return self._assemble(xs, xt, same, rng)


def parse_celeba_attrs(csv_path: str, attribute: str) -> set:
    """list_attr_celeba.csv -> image ids with attribute == 1 (reference
    Dataset.py:145-165)."""
    keep = set()
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            if row.get(attribute) == "1":
                keep.add(row["image_id"])
    return keep


class CelebAStyleDataset(_PairDataset):
    """Flat-dir dataset with flips and the fork's filters
    (reference Dataset.py:169-283); always same_person=0."""

    def __init__(self, data_path: str, fine_tune_filter: str | None = None,
                 into_data_path: str | None = None, only_attractive: bool = False,
                 csv_file: str = "list_attr_celeba.csv",
                 normalize_pm1: bool = False, jitter: bool = False, seed: int = 0):
        files = sorted(glob.glob(os.path.join(data_path, "*.*g")))
        self.fine_tune_list = []
        if fine_tune_filter:
            self.fine_tune_list = [f for f in files if fine_tune_filter in f]
            files = [f for f in files if fine_tune_filter not in f]
        if only_attractive:
            csv_path = os.path.join(data_path, csv_file)
            if os.path.exists(csv_path):
                keep = parse_celeba_attrs(csv_path, "Attractive")
                filtered = [f for f in files if os.path.basename(f) in keep]
                files = filtered or files
        self.images = files
        if not self.images:
            raise ValueError(f"no images under {data_path}")
        self.into_images = (
            sorted(glob.glob(os.path.join(into_data_path, "*.*g")))
            if into_data_path else []
        )
        self.normalize_pm1 = normalize_pm1
        self.jitter = jitter
        self.rng = random.Random(seed)
        self.rng.shuffle(self.images)

    def __len__(self):
        return len(self.images)

    def _maybe_flip(self, img):
        return img[:, ::-1] if self.rng.random() < 0.5 else img

    def __getitem__(self, idx: int):
        rng = self.rng
        pool = self.fine_tune_list or None
        xs_path = rng.choice(pool) if pool else self.images[idx]
        xs = self._maybe_flip(_imread_rgb(xs_path))
        xt_pool = self.into_images or self.images
        xt = self._maybe_flip(_imread_rgb(rng.choice(xt_pool)))
        return self._assemble(np.ascontiguousarray(xs),
                              np.ascontiguousarray(xt), 0, rng)


class MaskTargetDataset:
    """(aligned crop, precomputed soft-mask target) pairs for the mask
    trainer (reference train-mask.py:236-308 computes SAM targets
    inline per batch; here targets are precomputed once by
    `cli/precompute_masks.py` — hull or native-SAM — and paired by
    basename: `crops/x.jpg` <-> `masks/x.png` or `masks/x.npy`).

    Emits per item: xt (256 pm1), xs_arcface (224 pm1, same image —
    train-mask embeds the target itself), mask (256,256,1 in [0,1]).
    """

    def __init__(self, data_path: str, mask_path: str):
        self.pairs: List[tuple] = []
        for f in sorted(glob.glob(os.path.join(data_path, "*.*g"))):
            base = os.path.splitext(os.path.basename(f))[0]
            for ext in (".png", ".npy", ".jpg"):
                m = os.path.join(mask_path, base + ext)
                if os.path.exists(m):
                    self.pairs.append((f, m))
                    break
        if not self.pairs:
            raise ValueError(
                f"no (image, mask) basename pairs between {data_path} "
                f"and {mask_path}")

    def __len__(self):
        return len(self.pairs)

    @staticmethod
    def _read_mask(path: str) -> np.ndarray:
        if path.endswith(".npy"):
            m = np.load(path).astype(np.float32)
            if m.max() > 1.5:  # stored as 0..255
                m = m / 255.0
        else:
            m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            if m is None:
                raise FileNotFoundError(path)
            m = m.astype(np.float32) / 255.0
        if m.ndim == 3:
            m = m[..., 0]
        return np.clip(
            cv2.resize(m, (256, 256), interpolation=cv2.INTER_LINEAR),
            0.0, 1.0)[..., None]

    def __getitem__(self, idx: int):
        img_path, mask_path = self.pairs[idx]
        img = _imread_rgb(img_path).astype(np.float32)
        return {
            "xt": _to_pm1(_resize(img, 256)),
            "xs_arcface": _to_pm1(_resize(img, 224)),
            "mask": self._read_mask(mask_path),
        }
