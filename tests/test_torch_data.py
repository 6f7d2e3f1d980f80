"""The port's training datasets and prefetch loader
(`ghost_tpu_torch/data/datasets.py`, `loader.py`) against ghost_tpu's.

Inputs (module fixture): seeded 96x96 jpgs in a flat directory, in 3
identity folders, a CelebA-style directory with a `list_attr_celeba.csv`
and filenames a `fine_tune_filter` picks, an `into_data_path` directory,
and hull-style masks as png and npy. Every item must equal JAX's bit for
bit (values and dtypes): the same files, the same `random.Random(seed)`
draws in the same order, the same cv2 calls. With one worker the
loader's batches are JAX's too; with more workers the order of the
items is the threads' (in JAX as well). The loader's own cases
(`tests/test_data_runtime.py:101-156`) run against the port.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from ghost_tpu_torch.data import datasets as tds
from ghost_tpu_torch.data.loader import PrefetchLoader
from torch_train_cli_inputs import write_faces


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(3)
    d = {"flat": write_faces(str(root / "flat"), rng, 10, 96),
         "vgg": write_faces(str(root / "vgg"), rng, 12, 96, identities=3),
         "into": write_faces(str(root / "into"), rng, 4, 96)}
    celeba = write_faces(str(root / "celeba"), rng, 8, 96)
    for i in (1, 4):  # what --fine_tune_filter "tune" picks
        os.rename(f"{celeba}/{i:05d}.jpg", f"{celeba}/tune_{i:05d}.jpg")
    names = sorted(f for f in os.listdir(celeba) if f.endswith(".jpg"))
    with open(f"{celeba}/list_attr_celeba.csv", "w") as f:
        f.write("image_id,Smiling,Attractive\n")
        for i, n in enumerate(names):
            f.write(f"{n},1,{1 if i % 3 else -1}\n")
    d["celeba"] = celeba
    masks = root / "masks"
    masks.mkdir()
    for i, n in enumerate(sorted(os.listdir(d["flat"]))):
        base = os.path.splitext(n)[0]
        m = rng.uniform(0, 1, (80, 80)).astype(np.float32)
        if i % 3 == 0:
            cv2.imwrite(str(masks / f"{base}.png"),
                        (m * 255).astype(np.uint8))
        elif i % 3 == 1:
            np.save(masks / f"{base}.npy", m * 255.0)  # stored as 0..255
        # every third image has no mask: the dataset skips it
    d["masks"] = str(masks)
    return d


def _pair(dirs, case):
    """(JAX dataset, port dataset) of `case`, built with the same
    arguments."""
    from ghost_tpu.data import datasets as jds

    kw, cls = {}, "FaceEmbedDataset"
    if case == "flat":
        args = ([dirs["flat"], dirs["vgg"] + "/id1"],)
        kw = dict(same_prob=0.5, seed=4)
    elif case == "flat_01":
        args, kw = ([dirs["flat"]],), dict(normalize_pm1=False, seed=5)
    elif case in ("vgg", "vgg_same_identity"):
        cls, args = "FaceEmbedVGG2Dataset", (dirs["vgg"],)
        kw = dict(same_prob=0.6, same_identity=case != "vgg", seed=6)
    elif case == "celeba":
        cls, args = "CelebAStyleDataset", (dirs["celeba"],)
        kw = dict(seed=7)
    elif case == "celeba_filters":
        cls, args = "CelebAStyleDataset", (dirs["celeba"],)
        kw = dict(fine_tune_filter="tune", into_data_path=dirs["into"],
                  only_attractive=True, normalize_pm1=True, jitter=True,
                  seed=8)
    elif case == "mask":
        cls, args = "MaskTargetDataset", (dirs["flat"], dirs["masks"])
    out = (getattr(jds, cls)(*args, **kw), getattr(tds, cls)(*args, **kw))
    if case == "flat_01":  # the reference's RGB->BGR augmentation on
        for ds in out:
            ds.bgr_aug_prob = 0.5
    return out


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        got, want = np.asarray(b[k]), np.asarray(a[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


CASES = ["flat", "flat_01", "vgg", "vgg_same_identity", "celeba",
         "celeba_filters", "mask"]


@pytest.mark.parametrize("case", CASES)
def test_dataset_items_equal_jax(dirs, case):
    """The same items bit for bit over a run of indices (the datasets'
    generators advance through it, so later items check the draws'
    order), and the same file lists."""
    jds, tds_ = _pair(dirs, case)
    assert len(tds_) == len(jds)
    for attr in ("files", "images", "fine_tune_list", "into_images",
                 "pairs"):
        if hasattr(jds, attr):
            assert getattr(tds_, attr) == getattr(jds, attr), attr
    n = len(jds)
    for idx in [0, n - 1, 1, 2 % n, n // 2, 0]:
        _assert_items_equal(jds[idx], tds_[idx])


def test_celeba_filters_take_effect(dirs):
    """The filters the parity case runs do pick: the fine-tune pool is
    the 'tune' files, they leave the main list, the CSV keeps only the
    attractive rows, and the targets come from into_data_path."""
    _, ds = _pair(dirs, "celeba_filters")
    assert [os.path.basename(f) for f in ds.fine_tune_list] == [
        "tune_00001.jpg", "tune_00004.jpg"]
    assert not any("tune" in f for f in ds.images)
    keep = tds.parse_celeba_attrs(f"{dirs['celeba']}/list_attr_celeba.csv",
                                  "Attractive")
    assert ds.images and all(os.path.basename(f) in keep for f in ds.images)
    assert len(ds.images) < len(os.listdir(dirs["celeba"])) - 3
    assert all(f.startswith(dirs["into"]) for f in ds.into_images)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter_and_bgr_equal_jax(seed):
    """The jitter (brightness, contrast, saturation, the hue step through
    uint8 HSV) and the channel swap, on the same image and generator."""
    import random

    from ghost_tpu.data import datasets as jds

    img = np.random.default_rng(seed).integers(0, 256, (40, 56, 3),
                                               dtype=np.uint8)
    for fn in ("color_jitter", "random_rgb_to_bgr"):
        kw = {"probability": 0.5} if fn == "random_rgb_to_bgr" else {}
        ja, ta = random.Random(seed), random.Random(seed)
        for _ in range(4):
            want = getattr(jds, fn)(img, ja, **kw)
            got = getattr(tds, fn)(img, ta, **kw)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["flat", "vgg_same_identity",
                                  "celeba_filters"])
def test_loader_batches_equal_jax(dirs, case):
    """PrefetchLoader with one worker: the same batches bit for bit, two
    epochs (the shuffle is per loader, the pairs' draws go on)."""
    from ghost_tpu.data.loader import PrefetchLoader as JLoader

    jds, tds_ = _pair(dirs, case)
    jl = JLoader(jds, batch_size=3, num_workers=1, seed=9)
    tl = PrefetchLoader(tds_, batch_size=3, num_workers=1, seed=9)
    assert len(tl) == len(jl) > 0
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(jl)
        for a, b in zip(jb, tb):
            _assert_items_equal(a, b)


def test_loader_drop_last_false_short_final_batch(dirs):
    """drop_last=False: the final batch comes back short (asking for a
    full batch would block forever)."""
    ds = tds.CelebAStyleDataset(dirs["into"])  # 4 images
    loader = PrefetchLoader(ds, batch_size=3, num_workers=2, shuffle=False,
                            drop_last=False)
    assert len(loader) == 2
    batches = list(loader)
    assert [b["xs"].shape[0] for b in batches] == [3, 1]


def test_loader_early_break_joins_workers(dirs):
    """A consumer that breaks mid-epoch stops and joins the workers
    blocked on the bounded item queue."""
    ds = tds.CelebAStyleDataset(dirs["flat"])
    before = threading.active_count()
    it = iter(PrefetchLoader(ds, batch_size=2, num_workers=2, prefetch=1))
    next(it)  # workers now racing to fill the bounded queue
    it.close()  # the generator's finally stops and joins them
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_loader_unreadable_dataset_raises():
    """A dataset whose every item fails raises once the failure budget
    is spent, not respin random indices forever."""
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise IOError("corrupt")

    with pytest.raises(RuntimeError, match="unreadable"):
        next(iter(PrefetchLoader(Broken(), batch_size=2, num_workers=1)))


@pytest.mark.gpu
def test_loader_batches_on_card(dirs):
    """The loader's batches, moved to the card as `train_loop` moves
    them, hold the host values exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds = tds.FaceEmbedDataset([dirs["flat"]], seed=1)
    for b in PrefetchLoader(ds, batch_size=4, num_workers=2):
        for k, v in b.items():
            t = torch.as_tensor(v, device="cuda")
            assert t.is_cuda and t.dtype == torch.from_numpy(
                np.asarray(v)).dtype
            np.testing.assert_array_equal(t.cpu().numpy(), v)
