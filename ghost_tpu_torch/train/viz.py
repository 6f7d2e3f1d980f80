"""Training visualisation helpers, mirroring `ghost_tpu/train/viz.py`:
`make_image_list` builds the side-by-side grid the loop dumps every
`show_step`; `get_faceswap` swaps one (source, target) pair of image
files through the current generator as a sanity check.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_to_image(x_pm1) -> np.ndarray:
    """(H,W,3) in [-1, 1] -> uint8 RGB."""
    if isinstance(x_pm1, torch.Tensor):
        x_pm1 = x_pm1.detach().float().cpu().numpy()
    x = np.asarray(x_pm1)
    return np.clip((x * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)


def make_image_list(batches, max_rows: int = 4) -> np.ndarray:
    """List of (B,H,W,3) arrays in [-1, 1] -> one uint8 grid, a column
    per array and a row per sample (at most `max_rows`)."""
    n = min(min(b.shape[0] for b in batches), max_rows)
    rows = [np.concatenate([tensor_to_image(b[i]) for b in batches], axis=1)
            for i in range(n)]
    return np.concatenate(rows, axis=0)


@torch.no_grad()
def get_faceswap(gen, source_path: str, target_path: str, arc=None):
    """Swap two image files through `gen` (an AEINet): the source at 224
    (embedded by `arc` at 112 by an area resize, or a zero embedding),
    the target at 256; returns the [source | target | Y] grid."""
    import cv2

    from ghost_tpu_torch.nn.layers import resize

    device = next(gen.parameters()).device
    src = cv2.imread(source_path)[:, :, ::-1]
    tgt = cv2.imread(target_path)[:, :, ::-1]
    src = cv2.resize(src, (224, 224)).astype(np.float32) / 127.5 - 1.0
    tgt = cv2.resize(tgt, (256, 256)).astype(np.float32) / 127.5 - 1.0
    if arc is not None:
        emb = arc(resize(torch.from_numpy(src[None]).to(device), (112, 112),
                         method="area"))
    else:
        emb = torch.zeros((1, 512), device=device)
    y, _ = gen(torch.from_numpy(tgt[None]).to(device), emb)
    return make_image_list([src[None], tgt[None], y.float().cpu().numpy()])
