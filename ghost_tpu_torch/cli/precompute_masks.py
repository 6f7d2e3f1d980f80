"""Precompute soft face masks for mask training on the card, mirroring
`ghost_tpu/cli/precompute_masks.py` flag for flag.

The reference precomputes Segment Anything masks prompted with the 5 face
keypoints (reference segment_anything_celeba.py:53-63) as the targets of
train-mask.py (`cli/train_extras.py --mode mask --mask_source`). Two
target sources:

- default: the 106-landmark convex-hull soft mask (`ops/mask.py`, the
  construction the swap's paste-back uses): `Landmark106` at 192 ->
  `landmarks_from_crops` -> `face_mask_batch` at 256, in chunks of
  --batch_size. Masks pair with the files actually read, so an
  unreadable file skips its own mask only;
- --sam_path ckpt.pth (converted on load) or a flax .msgpack: `SamPredictor`
  (`models/sam.py`) prompted with the 5 face keypoints at the ArcFace
  template scaled to the 256 crop; one 0/255 png per crop.

Both write `<basename>.png` per input into --output_dir. The JAX CLI pads
each hull chunk to --batch_size so its jitted program sees one shape;
the port runs eagerly and keeps the chunk as it is (the landmark net is
in eval mode, so each crop's mask is the same either way). Random
landmark weights (no --landmark_path) come from a torch.Generator seeded
with 0, not JAX's values, with the JAX CLI's warning.

    python -m ghost_tpu_torch.cli.precompute_masks --input_dir crops/ \\
        --output_dir masks/

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
    p = argparse.ArgumentParser(description="precompute mask targets")
    p.add_argument("--input_dir", required=True, help="aligned 256 crops")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--landmark_path", default="", help="landmark net weights")
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--sam_path", default="",
                   help="SAM checkpoint (.pth): generate targets with the "
                        "native Segment-Anything prompted by the 5 face "
                        "keypoints (reference segment_anything_celeba.py:"
                        "53-63) instead of hull masks")
    p.add_argument("--sam_preset", default="vit_h",
                   choices=["vit_b", "vit_l", "vit_h"])
    return p


def _crop_files(input_dir):
    return sorted(glob.glob(os.path.join(input_dir, "*.*g")))


def sam_mask_loop(pred, input_dir: str, output_dir: str):
    """SAM targets (reference train-mask.py:236-274): prompt with the 5
    face keypoints. Inputs are norm_crop-aligned crops, so the keypoints
    sit at the ArcFace template scaled to the crop; no detector pass."""
    import cv2

    from ghost_tpu_torch.ops.umeyama import ARCFACE_TEMPLATE

    kps = np.asarray(ARCFACE_TEMPLATE, np.float32) * (256.0 / 112.0)
    for f in _crop_files(input_dir):
        img = cv2.imread(f)
        if img is None:
            continue
        img = cv2.resize(img[:, :, ::-1], (256, 256))
        masks, _iou, _logits = pred.predict_points(
            img, kps, np.ones(5), multimask_output=False)
        base = os.path.splitext(os.path.basename(f))[0]
        cv2.imwrite(os.path.join(output_dir, f"{base}.png"),
                    (masks[0] * 255).astype(np.uint8))


def load_sam(sam_path: str, preset: str, device):
    """`build_sam(preset)` on `device` with the weights of a `.msgpack`
    (a flax tree) or a `.pth` (the upstream layout, converted), cast to
    its compute dtype once, in eval mode."""
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.models import sam as sam_mod
    from ghost_tpu_torch.nn.layers import cast_to_compute_dtype

    model = sam_mod.build_sam(preset, device=device)
    if sam_path.endswith(".msgpack"):
        from ghost_tpu_torch.core.checkpoint import load_msgpack

        tree = load_msgpack(sam_path)
    else:
        from ghost_tpu_torch.convert.torch_loader import (
            convert_sam_state_dict, load_torch_checkpoint)

        depth = {"vit_b": 12, "vit_l": 24, "vit_h": 32}[preset]
        tree = convert_sam_state_dict(load_torch_checkpoint(sam_path),
                                      depth=depth)
    load_flax_variables(model, tree)
    return cast_to_compute_dtype(model.eval().requires_grad_(False))


def main(argv=None, device="cuda"):
    """Parse argv and write the masks, computed on `device` (the card
    unless the caller asks for the CPU; raises without one)."""
    import cv2

    from ghost_tpu_torch.models.landmark import (Landmark106,
                                                 landmarks_from_crops)
    from ghost_tpu_torch.ops.mask import face_mask_batch

    args = build_parser().parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("precompute_masks: no CUDA card; pass "
                               "device='cpu' to run on the CPU")
        from ghost_tpu_torch.core.precision import disable_tf32

        disable_tf32()
    os.makedirs(args.output_dir, exist_ok=True)

    if args.sam_path:
        from ghost_tpu_torch.models.sam import SamPredictor

        model = load_sam(args.sam_path, args.sam_preset, device)
        sam_mask_loop(SamPredictor(model), args.input_dir, args.output_dir)
        print("done (SAM)")
        return

    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.nn.layers import cast_to_compute_dtype, init_weights

    lmk = Landmark106()
    if args.landmark_path:
        from ghost_tpu_torch.core.checkpoint import load_msgpack

        load_flax_variables(lmk, load_msgpack(args.landmark_path))
    else:
        init_weights(lmk, torch.Generator().manual_seed(0))
        print("WARNING: random landmark weights; masks will be arbitrary")
    lmk = cast_to_compute_dtype(lmk.to(device).eval())

    files = _crop_files(args.input_dir)
    for i in range(0, len(files), args.batch_size):
        imgs, kept = [], []
        for f in files[i:i + args.batch_size]:
            img = cv2.imread(f)
            if img is None:
                # pair masks with the files read: one unreadable file
                # must not shift the masks after it onto other names
                continue
            imgs.append(cv2.resize(img[:, :, ::-1], (256, 256)))
            kept.append(f)
        if not imgs:
            continue
        crops = torch.from_numpy(np.stack(imgs)).to(device).float()
        with torch.inference_mode():
            pts = landmarks_from_crops(lmk, crops, crops.shape[1])
            out = face_mask_batch(pts, crops.shape[1]).cpu().numpy()
        for f, m in zip(kept, out):
            base = os.path.splitext(os.path.basename(f))[0]
            cv2.imwrite(os.path.join(args.output_dir, f"{base}.png"),
                        (m[..., 0] * 255).astype(np.uint8))
    print("done")


if __name__ == "__main__":
    main()
