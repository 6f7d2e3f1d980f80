"""Distill a heavy enhancer teacher into a cheap serving trunk on the
card, mirroring `ghost_tpu/cli/distill_enhancer.py` flag for flag.

The reference's enhancement quality path is pinned to GFPGAN/RealESRGAN
(reference utils/training/upsampler.py:20-120). This CLI trains an
SRVGGNetCompact student to mimic a teacher on degraded data; the student
is then served by the swap CLI (--bg_model srvgg, the SR seat):

    # background: RRDB x4plus -> SRVGG x4
    python -m ghost_tpu_torch.cli.distill_enhancer --task background \\
        --dataset_path frames/ --teacher_path RealESRGAN_x4plus.pth \\
        --out srvgg_distilled.msgpack --steps 20000

    # face: GFPGAN 512-crop restorer -> SRVGG x2 reading 256
    python -m ghost_tpu_torch.cli.distill_enhancer --task face \\
        --dataset_path crops512/ --teacher_path GFPGANv1.4.pth \\
        --out face_student.msgpack

Teacher weights: official torch checkpoints (.pth, converted on load)
or converted flax trees (.msgpack). The student's convs run S2
(`ops/cuda/conv3x3.py`) forward and, for its dx, backward; its
parameters stay float32 masters (flax's `param_dtype`), each conv
casting at the forward. The product is a flax-layout `{"params"}`
msgpack (`convert.from_jax.flax_variables`), which the JAX package's
`load_msgpack` and the port's `srvgg_from_variables` both read.

Where the port departs from the JAX CLI:
  * random weights (a random teacher under --allow_random_weights, a
    student without --student_path) come from torch.Generators seeded
    as JAX's keys (1 for the teacher, --seed for the student), not
    JAX's values; the degradation draws come from a torch.Generator
    seeded with --seed;
  * the face task's `.pth` teacher is converted at --hq_size (the JAX
    CLI converts at 512 whatever --hq_size says, so its `.pth` route
    takes only 512 crops).

`main(argv, device="cpu")` runs on the CPU (tests); the command line
always runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from ghost_tpu_torch.cli import str2bool


def build_parser():
    p = argparse.ArgumentParser(description="enhancer distillation")
    p.add_argument("--task", default="background",
                   choices=["background", "face"])
    p.add_argument("--dataset_path", required=True,
                   help="dir of HQ images (frames for background, "
                        "aligned crops for face)")
    p.add_argument("--teacher_path", default="",
                   help="RRDB/GFPGAN weights (.pth or .msgpack)")
    p.add_argument("--student_path", default="", help="resume student")
    p.add_argument("--out", required=True, help="student msgpack out")
    p.add_argument("--hq_size", default=256, type=int,
                   help="HQ patch size (face: crop size, use 512 for "
                        "the real GFPGAN teacher)")
    p.add_argument("--student_feats", default=64, type=int)
    p.add_argument("--student_convs", default=32, type=int)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--steps", default=10000, type=int)
    p.add_argument("--lr", default=2e-4, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--log_every", default=50, type=int)
    p.add_argument("--save_every", default=1000, type=int)
    p.add_argument("--allow_random_weights", action="store_true",
                   help="random teacher (smoke tests only)")
    p.add_argument("--bf16", default=True, type=str2bool)
    return p


def _load_teacher_vars(path: str, module, convert_fn, allow_random: bool):
    """Fill the teacher `module` from `path` (.msgpack through the weight
    bridge, .pth through `convert_fn`), or with random weights (a
    generator seeded with 1) under `allow_random`; returns it. An
    explicitly given path that does not exist exits, even under
    `allow_random`: a typo'd filename must not distill a long run
    against a random teacher."""
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.torch_loader import load_torch_checkpoint
    from ghost_tpu_torch.core.checkpoint import load_msgpack
    from ghost_tpu_torch.models.sr.gfpgan import (GFPGANClean,
                                                  drop_unread_leaves)
    from ghost_tpu_torch.nn.layers import init_weights

    if path:
        if not os.path.exists(path):
            raise SystemExit(f"--teacher_path {path!r} does not exist")
        if path.endswith(".msgpack"):
            tree = load_msgpack(path)
        else:
            tree = convert_fn(load_torch_checkpoint(path))
        if isinstance(module, GFPGANClean):
            # the official layout's toRGB and style-MLP leaves, which
            # flax ignores and the strict bridge would refuse
            tree, _ = drop_unread_leaves(tree, module)
        return load_flax_variables(module, tree)
    if allow_random:
        print("WARNING: random teacher weights (smoke mode)")
        return init_weights(module, torch.Generator().manual_seed(1))
    raise SystemExit("missing --teacher_path")


def _image_batches(paths, size: int, batch: int, seed: int):
    """Endless host-side HQ sampler: decode, random-crop (or resize) to
    `size`, stack to (B, size, size, 3) float32 in [0, 1] RGB; the JAX
    CLI's batches for the same seed."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    while True:
        out = []
        while len(out) < batch:
            f = paths[int(rng.integers(len(paths)))]
            img = cv2.imread(f)
            if img is None:
                continue
            img = img[:, :, ::-1]
            h, w = img.shape[:2]
            if h > size and w > size:
                y = int(rng.integers(h - size + 1))
                x = int(rng.integers(w - size + 1))
                img = img[y:y + size, x:x + size]
            else:
                img = cv2.resize(img, (size, size))
            out.append(img.astype(np.float32) / 255.0)
        yield np.stack(out)


def main(argv=None, device="cuda"):
    """Parse argv and distill on `device` (the card unless the caller
    asks for the CPU; raises without one)."""
    args = build_parser().parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distill_enhancer: no CUDA card; pass "
                               "device='cpu' to distill on the CPU")
        from ghost_tpu_torch.core.precision import disable_tf32

        disable_tf32()

    from ghost_tpu_torch.convert.from_jax import (flax_variables,
                                                  load_flax_variables)
    from ghost_tpu_torch.core.checkpoint import load_msgpack, save_msgpack
    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact
    from ghost_tpu_torch.nn.layers import cast_to_compute_dtype, init_weights
    from ghost_tpu_torch.train.distill_enhancer import (
        degrade, face_student_wrapper, make_enhancer_distill_step,
        make_teacher_fn)

    policy = DEFAULT_POLICY if args.bf16 else FULL_PRECISION
    hq = args.hq_size

    paths = sorted(
        f for f in glob.glob(os.path.join(args.dataset_path, "*.*"))
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".webp")))
    if not paths:
        raise SystemExit(f"no images under {args.dataset_path!r}")

    if args.task == "background":
        from ghost_tpu_torch.convert.torch_loader import (
            convert_rrdbnet_state_dict)
        from ghost_tpu_torch.models.sr.rrdb import RRDBNet

        teacher_mod = _load_teacher_vars(
            args.teacher_path, RRDBNet(policy=policy),
            convert_rrdbnet_state_dict, args.allow_random_weights)
        upscale, lq_size, out_range = 4, (hq // 4, hq // 4), (0.0, 1.0)
    else:  # face: same-size degradation, the teacher restores the pm1 crop
        from ghost_tpu_torch.convert.torch_loader import (
            convert_gfpgan_state_dict)
        from ghost_tpu_torch.models.sr.gfpgan import GFPGANClean

        teacher_mod = _load_teacher_vars(
            args.teacher_path, GFPGANClean(out_size=hq, policy=policy),
            lambda sd: convert_gfpgan_state_dict(sd, out_size=hq),
            args.allow_random_weights)
        upscale, lq_size, out_range = 2, (hq, hq), (-1.0, 1.0)
    teacher_mod = cast_to_compute_dtype(
        teacher_mod.eval().requires_grad_(False)).to(device)
    teacher = make_teacher_fn(teacher_mod, out_range)

    student = SRVGGNetCompact(num_feat=args.student_feats,
                              num_conv=args.student_convs, upscale=upscale,
                              policy=policy)
    if args.student_path:
        load_flax_variables(student, load_msgpack(args.student_path))
    else:
        init_weights(student, torch.Generator().manual_seed(args.seed))
    student = student.to(device)
    step_student = student if args.task == "background" \
        else face_student_wrapper(student)

    def sample(gen, hq01):
        lq = degrade(gen, hq01, lq_size)
        if args.task == "face":
            lq = lq * 2.0 - 1.0
        return lq, teacher(lq)

    step, _ = make_enhancer_distill_step(step_student, lr=args.lr)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    batches = _image_batches(paths, hq, args.batch_size, args.seed)
    for it in range(args.steps):
        hq01 = torch.from_numpy(next(batches)).to(device)
        lq, target = sample(gen, hq01)
        metrics = step(lq, target)
        if it % args.log_every == 0:
            print(f"step {it}: l1={float(metrics['l1']):.5f}")
        if args.save_every and it and it % args.save_every == 0:
            save_msgpack(args.out, flax_variables(student))
    save_msgpack(args.out, flax_variables(student))
    print(f"saved student to {args.out}")


if __name__ == "__main__":
    main()
