"""End-to-end example (the SberSwapInference.ipynb equivalent), the
twin of `examples/swap_example.py`.

Runs the whole pipeline on synthetic data with random weights so it works
without checkpoints; load converted ones for real output (see README).
On the card by default:

    python -m ghost_tpu_torch.examples.swap_example
    python -m ghost_tpu_torch.examples.swap_example --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ghost_tpu_torch.core.precision import DEFAULT_POLICY
from ghost_tpu_torch.pipeline.swap import SwapConfig, build_random_pipeline
from ghost_tpu_torch.utils.profiling import StageTimer


def main(argv=None, frames: int = 16, hw: tuple[int, int] = (480, 640)):
    """Build the random pipeline, swap a `frames`-frame video and one
    image; returns (video output, image output, the timer's report)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = SwapConfig(chunk_size=8, max_faces=4)
    print("building pipeline (random weights)...")
    pipe = build_random_pipeline(cfg, policy=DEFAULT_POLICY,
                                 arcface_layers=(1, 1, 1, 1),
                                 device=args.device)

    rng = np.random.default_rng(0)
    video = rng.integers(0, 255, (frames, *hw, 3), dtype=np.uint8)
    source = rng.integers(0, 255, (1, 224, 224, 3), dtype=np.uint8)
    target = rng.integers(0, 255, (1, 224, 224, 3), dtype=np.uint8)

    timer = StageTimer()
    with timer.stage("video_swap", items=len(video)):
        out = pipe.swap_video_frames(video, source, target)
    print("output:", out.shape, out.dtype)
    report = timer.report()
    print(report)

    with timer.stage("image_swap", items=1):
        img = pipe.swap_image(video[0], source)
    print("image:", img.shape)
    return out, img, timer.report()


if __name__ == "__main__":
    main()
