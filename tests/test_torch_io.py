"""The port's image and video IO (`ghost_tpu_torch/pipeline/image.py`,
`pipeline/video.py`) and native frame transport (`data/frames.py`,
`runtime/ghost_rt.cpp` built with g++ into `build/ghost_tpu_torch/`)
against ghost_tpu's on the same tiny png and 5-frame 96x128 mp4.

Decoded arrays, fps and chunks must be exactly equal, as must
`u8_to_pm1`. The native library must build here (g++ is present): the
Queue fallback would hide a build failure.
"""

import logging
from pathlib import Path

import numpy as np
import pytest

from ghost_tpu_torch.data import frames as tframes
from ghost_tpu_torch.pipeline import image as timage
from ghost_tpu_torch.pipeline import video as tvideo

N_FRAMES, HW, FPS = 5, (96, 128), 24.0


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A seeded png and mp4 written by the JAX package's writers."""
    from ghost_tpu.pipeline import image as jimage
    from ghost_tpu.pipeline import video as jvideo

    d = tmp_path_factory.mktemp("io")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    png = str(d / "img.png")
    jimage.write_image_rgb(png, img)
    # smooth content with a moving edge: mp4v keeps it close, so a
    # decoder that dropped or reordered frames would show
    yy, xx = np.mgrid[:HW[0], :HW[1]]
    frames = np.stack([np.stack([(xx * 2 + 40 * i) % 256, yy * 2,
                                 (xx + yy + 30 * i) % 256], -1)
                       for i in range(N_FRAMES)]).astype(np.uint8)
    mp4 = str(d / "clip.mp4")
    jvideo.write_video(mp4, frames, FPS)
    return {"dir": d, "img": img, "png": png, "frames": frames, "mp4": mp4}


def test_image_io_matches_jax(media):
    from ghost_tpu.pipeline import image as jimage

    got = timage.read_image_rgb(media["png"])
    np.testing.assert_array_equal(got, jimage.read_image_rgb(media["png"]))
    np.testing.assert_array_equal(got, media["img"])  # png is lossless
    out = str(media["dir"] / "port.png")
    timage.write_image_rgb(out, media["img"])
    assert Path(out).read_bytes() == Path(media["png"]).read_bytes()
    with pytest.raises(FileNotFoundError):
        timage.read_image_rgb(str(media["dir"] / "missing.png"))
    pm1 = timage.normalize_pm1(media["img"])
    np.testing.assert_array_equal(pm1, jimage.normalize_pm1(media["img"]))
    np.testing.assert_array_equal(timage.denormalize_u8(pm1),
                                  jimage.denormalize_u8(pm1))


def test_read_video_matches_jax(media):
    from ghost_tpu.pipeline import video as jvideo

    frames, fps = tvideo.read_video(media["mp4"])
    ref, ref_fps = jvideo.read_video(media["mp4"])
    assert frames.shape == (N_FRAMES, *HW, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(frames, ref)
    assert fps == ref_fps == FPS
    assert tvideo.video_fps(media["mp4"]) == jvideo.video_fps(media["mp4"])
    # the mp4 holds the written clip, up to the codec's loss
    assert np.abs(frames.astype(int) - media["frames"]).mean() < 8


@pytest.mark.parametrize("chunk", [2, 5])
def test_chunk_iterators_match_jax(media, chunk, caplog):
    """iter_video_chunks and the ring-fed stream_video_chunks give JAX's
    chunks; the stream says it used the native ring."""
    from ghost_tpu.data import frames as jframes
    from ghost_tpu.pipeline import video as jvideo

    ref = list(jvideo.iter_video_chunks(media["mp4"], chunk))
    assert [c.shape[0] for c in ref] == \
        [min(chunk, N_FRAMES - i) for i in range(0, N_FRAMES, chunk)]
    with caplog.at_level(logging.INFO, logger=tframes.__name__):
        streamed = list(tframes.stream_video_chunks(media["mp4"], chunk))
    assert "native ring" in caplog.text
    for got in (list(tvideo.iter_video_chunks(media["mp4"], chunk)),
                streamed,
                list(jframes.stream_video_chunks(media["mp4"], chunk))):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_writers_match_jax(media):
    """write_video and VideoChunkWriter (chunks of 2) encode what JAX's
    writers encode: the files decode to the same frames."""
    from ghost_tpu.pipeline import video as jvideo

    frames, d = media["frames"], media["dir"]
    paths = {}
    for name, mod in (("port", tvideo), ("jax", jvideo)):
        paths[name] = str(d / f"{name}.mp4")
        mod.write_video(paths[name], frames, FPS)
        paths[name + "_chunks"] = str(d / f"{name}_chunks.mp4")
        w = mod.VideoChunkWriter(paths[name + "_chunks"], FPS)
        for i in range(0, N_FRAMES, 2):
            w.write(frames[i:i + 2])
        w.close()
    ref, ref_fps = jvideo.read_video(paths["jax"])
    for name in ("port", "port_chunks", "jax_chunks"):
        got, fps = jvideo.read_video(paths[name])
        np.testing.assert_array_equal(got, ref)
        assert fps == ref_fps


def test_add_audio_matches_jax(media):
    """The remux gives JAX's answer (False where ffmpeg is missing; the
    video then stays as written)."""
    from ghost_tpu.pipeline import video as jvideo

    d = media["dir"]
    outs = {}
    for name, mod in (("port", tvideo), ("jax", jvideo)):
        dst = d / f"remux_{name}.mp4"
        dst.write_bytes(Path(media["mp4"]).read_bytes())
        outs[name] = mod.add_audio_from_video(media["mp4"], str(dst))
    assert outs["port"] == outs["jax"]
    frames, _ = tvideo.read_video(str(d / "remux_port.mp4"))
    assert frames.shape[0] == N_FRAMES


def test_native_library_built_under_build_dir():
    """libghost_rt builds with g++ into build/ghost_tpu_torch/ under a
    hashed name, never next to its source."""
    assert tframes.native_available(), tframes.native_error()
    assert tframes.native_error() is None
    lib = tframes.library_path()
    root = Path(tframes.__file__).resolve().parents[2]
    assert lib.parent == root / "build" / "ghost_tpu_torch" and lib.exists()
    assert lib.name.startswith("libghost_rt-") and lib.suffix == ".so"
    runtime = root / "ghost_tpu_torch" / "runtime"
    assert sorted(p.name for p in runtime.iterdir()) == ["ghost_rt.cpp"]


def test_u8_to_pm1_matches_jax():
    from ghost_tpu.data import frames as jframes

    x = np.random.default_rng(1).integers(0, 256, (3, 17, 29, 3),
                                          dtype=np.uint8)
    got = tframes.u8_to_pm1(x)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, jframes.u8_to_pm1(x))
    assert got.min() == -1.0 and got.max() == 1.0
    # a strided view takes the numpy route, in both packages
    np.testing.assert_array_equal(tframes.u8_to_pm1(x[:, ::2]),
                                  jframes.u8_to_pm1(x[:, ::2]))


def test_frame_ring_round_trip_and_capacity():
    ring = tframes.FrameRing((4, 6, 3), slots=3)
    assert ring.native
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (4, 4, 6, 3), dtype=np.uint8)
    for f in frames[:3]:
        assert ring.push(f, timeout=1.0)
    assert ring.size() == 3
    assert not ring.push(frames[3], timeout=0.01)  # full: 3 slots
    np.testing.assert_array_equal(ring.pop(timeout=1.0), frames[0])
    assert ring.push(frames[3], timeout=1.0)
    ring.close()
    assert not ring.drained()
    for f in frames[1:]:
        np.testing.assert_array_equal(ring.pop(timeout=1.0), f)
    assert ring.drained() and ring.pop(timeout=0.01) is None
