"""Dataset preprocessing on the card, mirroring `ghost_tpu/cli/preprocess.py`
flag for flag (reference preprocess_{vgg,celeba,gender}.py):

  * vgg: a VGGFace2-style tree -> per-identity aligned crops, at most
    --max_images_per_dir a folder (reference preprocess_vgg.py:14-43);
  * celeba: a flat directory -> aligned crops, with --max_darken N
    darkened copies of each (reference preprocess_celeba.py:31-47);
  * gender: aligned crops split into male/ and female/ by a logistic
    head over the ArcFace embedding (the JAX package's stand-in for
    insightface buffalo_l's genderage model the reference drives,
    preprocess_gender.py:8-39); head weights from --gender_head_path.

Detection and alignment are the swap pipeline's `crop_faces` (SCRFD,
umeyama, the crop warp) and the embedding its `embed_targets`, on a
`build_random_pipeline` whose detector takes --detector_path's msgpack.

A fault of the JAX CLI, kept: --arcface_path is parsed and never read,
so gender mode embeds with the random pipeline's ArcFace weights (the
port's from a torch.Generator seeded with 0, JAX's from its key 0: the
two packages split differently without a head that fits each).

    python -m ghost_tpu_torch.cli.preprocess --mode celeba \\
        --input_dir raw/ --output_dir crops/ --detector_path det.msgpack

`main(argv, device="cpu")` runs on the CPU (tests); the command line
always runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="ghost-tpu dataset preprocessing")
    p.add_argument("--mode", default="celeba",
                   choices=["vgg", "celeba", "gender"])
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--gender_head_path", default="",
                   help="msgpack {'w': (512,), 'b': ()} logistic gender "
                        "head over ArcFace embeddings (--mode gender)")
    p.add_argument("--arcface_path", default="weights/backbone.pth")
    p.add_argument("--crop_size", default=256, type=int)
    p.add_argument("--max_images_per_dir", default=8, type=int)
    p.add_argument("--max_darken", default=0, type=int,
                   help="emit N progressively darkened variants per crop")
    p.add_argument("--detector_path", default="")
    return p


def _images(d):
    return sorted(glob.glob(os.path.join(d, "*.*g")))


def main(argv=None, device="cuda"):
    """Parse argv and write the crops, detected and embedded on `device`
    (the card unless the caller asks for the CPU; raises without one)."""
    import cv2

    from ghost_tpu_torch.pipeline import swap

    args = build_parser().parse_args(argv)
    if torch.device(device).type == "cuda":
        from ghost_tpu_torch.core.precision import disable_tf32

        disable_tf32()
    pipe = swap.build_random_pipeline(swap.SwapConfig(crop_size=args.crop_size),
                                      device=device)
    if args.detector_path:
        from ghost_tpu_torch.convert.from_jax import load_flax_variables
        from ghost_tpu_torch.core.checkpoint import load_msgpack

        load_flax_variables(pipe.det_mod, load_msgpack(args.detector_path))
    else:
        print("WARNING: random detector weights; crops will be arbitrary")

    def first_crop(path):
        img = cv2.imread(path)
        if img is None:
            return None
        crops, _ = pipe.crop_faces(img[:, :, ::-1])
        return crops[0] if crops.shape[0] else None

    if args.mode == "vgg":
        for folder in sorted(glob.glob(os.path.join(args.input_dir, "*"))):
            out_dir = os.path.join(args.output_dir, os.path.basename(folder))
            os.makedirs(out_dir, exist_ok=True)
            kept = 0
            for path in _images(folder):
                if kept >= args.max_images_per_dir:
                    break
                crop = first_crop(path)
                if crop is None:
                    continue
                cv2.imwrite(os.path.join(out_dir, f"{kept}.jpg"),
                            crop[:, :, ::-1])
                kept += 1
    elif args.mode == "gender":
        from ghost_tpu_torch.core.checkpoint import load_msgpack

        if args.gender_head_path:
            head = load_msgpack(args.gender_head_path)
            w = np.asarray(head["w"], np.float32)
            b = float(np.asarray(head["b"]))
        else:
            print("WARNING: random gender head (--gender_head_path not "
                  "given); split will be arbitrary")
            w = np.random.default_rng(0).normal(0, 0.1, (512,)).astype(
                np.float32)
            b = 0.0
        male_dir = os.path.join(args.output_dir, "male")
        female_dir = os.path.join(args.output_dir, "female")
        os.makedirs(male_dir, exist_ok=True)
        os.makedirs(female_dir, exist_ok=True)
        for path in _images(args.input_dir):
            crop = first_crop(path)
            if crop is None:
                continue
            emb = pipe.embed_targets(crop[None]).float().cpu().numpy()[0]
            out_dir = male_dir if float(emb @ w + b) > 0.0 else female_dir
            cv2.imwrite(os.path.join(out_dir, os.path.basename(path)),
                        crop[:, :, ::-1])
    else:  # celeba
        os.makedirs(args.output_dir, exist_ok=True)
        for path in _images(args.input_dir):
            crop = first_crop(path)
            if crop is None:
                continue
            base = os.path.splitext(os.path.basename(path))[0]
            cv2.imwrite(os.path.join(args.output_dir, f"{base}.jpg"),
                        crop[:, :, ::-1])
            # brightness sweep (preprocess_celeba.py:31-47)
            for d in range(1, args.max_darken + 1):
                factor = 1.0 - d / (args.max_darken + 1)
                dark = np.clip(crop.astype(np.float32) * factor, 0,
                               255).astype(np.uint8)
                cv2.imwrite(os.path.join(args.output_dir,
                                         f"{base}_d{d}.jpg"),
                            dark[:, :, ::-1])
    print("done")


if __name__ == "__main__":
    main()
