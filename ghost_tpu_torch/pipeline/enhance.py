"""Output enhancement: GFPGAN face restore over an optional Real-ESRGAN
background, mirroring `ghost_tpu/pipeline/enhance.py` (the reference's
`upsample()` post-pass, utils/training/upsampler.py:92-106).

One chunk of uint8 frames stays on the device:

  detect (the pipeline's detector, shared decode) -> FFHQ-template
  similarity align to 512 crops -> GFPGANClean -> soft-mask paste-back,
  over the frame or over a tiled x4 background (RRDBNet or
  SRVGGNetCompact) area-resized back to the frame's size.

The background runs tiled (RealESRGANer `tile`/`tile_pad` parity): x4 on
a whole 1080p chunk would need tens of GB of activations. Tiles run one
after another with halos clamped to the image (with a mesh, each shard
runs its contiguous run of them on its device); each tile's x4 output is
area-resized back to the tile's size before the stitch, which equals
resizing the stitched x4 canvas (the 4x4 box average is tile-aligned).

Face lanes are fixed-capacity (max_faces, presence-masked), as in the
swap pipeline. A lane that no frame of the chunk has is skipped for both
the GFPGAN pass and the paste-back (a Python branch in place of
`lax.cond`: one host sync per lane); a paste-back with present all false
would be an exact no-op. Output stays at the input resolution.
"""

from __future__ import annotations

import numpy as np
import torch

from ghost_tpu_torch.core.mesh import (replicate, replicate_module,
                                       to_device)
from ghost_tpu_torch.models.scrfd import decode_detections, preprocess_frames
from ghost_tpu_torch.nn.layers import resize
from ghost_tpu_torch.ops.umeyama import umeyama_similarity
from ghost_tpu_torch.ops.warp import (warp_affine_similarity,
                                      warp_and_blend_similarity)

# facexlib FaceRestoreHelper's canonical 5-point template for a 512x512
# FFHQ-aligned face crop (public constants; the reference's GFPGANer
# aligns to exactly these points before enhancing)
FFHQ_TEMPLATE_512 = np.array(
    [[192.98138, 239.94708], [318.90277, 240.1936],
     [256.63416, 314.01935], [201.26117, 371.41043],
     [313.08905, 371.15118]], np.float32)


def _soft_border_mask(size: int, border_frac: float = 0.1):
    """Static soft paste mask (1, size, size, 1) f32 numpy: 1 inside, a
    cosine falloff to 0 at the crop border."""
    border = max(1, int(size * border_frac))
    ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(border) + 0.5) / border)
    prof = np.ones((size,), np.float32)
    prof[:border] = ramp
    prof[-border:] = ramp[::-1]
    return (prof[:, None] * prof[None, :])[None, :, :, None]


def largest_divisor_below(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (>= 1 always exists); the
    port's copy of `ghost_tpu/ops/pallas/tiling.py:largest_divisor_below`."""
    for cand in range(min(cap, n), 0, -1):
        if n % cand == 0:
            return cand
    return 1


def _fit_tile(pref: tuple[int, int], h: int, w: int) -> tuple[int, int]:
    """Largest dividing tile dims <= the preferred (th, tw), so frames
    the defaults don't divide (720 % 270 != 0) still tile. Degenerate
    fits (< 8 px) raise: pad or crop the frames instead."""
    th = largest_divisor_below(h, pref[0]) if h > pref[0] else h
    tw = largest_divisor_below(w, pref[1]) if w > pref[1] else w
    if th < 8 or tw < 8:
        raise ValueError(
            f"no usable background tile for frame {h}x{w} (fitted "
            f"{th}x{tw} from preferred {pref[0]}x{pref[1]}); pad or crop "
            f"the frames to dims with a divisor in [8, {pref[0]}]x"
            f"[8, {pref[1]}]")
    return th, tw


def _one_tile(mod, frames01, start, th, tw, pad, scale, downscale):
    """The x`scale` output of the tile at `start` (y, x), run with its
    halo clamped to the image; area-resized back to (th, tw) in f32 with
    `downscale`."""
    b, h, w, c = frames01.shape
    sy = min(max(start[0] - pad, 0), h - (th + 2 * pad))
    sx = min(max(start[1] - pad, 0), w - (tw + 2 * pad))
    up = mod(frames01[:, sy:sy + th + 2 * pad, sx:sx + tw + 2 * pad])
    oy, ox = (start[0] - sy) * scale, (start[1] - sx) * scale
    out = up[:, oy:oy + th * scale, ox:ox + tw * scale]
    if downscale:
        out = resize(out.float(), (th, tw), method="area")
    return out


def _tiled_rect(mod, frames01, th: int, tw: int, pad: int, scale: int = 4,
                downscale: bool = False, mesh=None, mesh_axis: str = "data"):
    """`mod` over (B,H,W,C) in th x tw tiles with a `pad` halo, stitched.

    Halos clamp to the image bounds like RealESRGANer.tile_process, so
    frame borders see the model's own conv padding as the full-frame
    pass would; only interior seams beyond the halo's receptive-field
    reach differ from it.

    `mesh` shards the tile axis (row-major tile order) over `mesh_axis`:
    shard i runs its contiguous run of tiles on its device, with the
    frames and `mod` there (`mod` may be {device: replica}, made once by
    `core.mesh.replicate_module`; a module is used on every shard's
    device), and the tiles come back to the frames' device for the
    stitch, which equals the unsharded one."""
    b, h, w, c = frames01.shape
    if h % th or w % tw:
        raise ValueError(f"tiles {th}x{tw} do not divide {h}x{w}")
    if th + 2 * pad > h or tw + 2 * pad > w:
        raise ValueError(f"tile {th}x{tw} with halo {pad} exceeds {h}x{w}")
    starts = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    if mesh is None:
        tiles = [_one_tile(mod, frames01, st, th, tw, pad, scale, downscale)
                 for st in starts]
    else:
        devices = mesh.axis_devices(mesh_axis)[0]
        if len(starts) % len(devices):
            raise ValueError(
                f"{len(starts)} tiles not divisible by mesh "
                f"'{mesh_axis}' size {len(devices)}")
        per = len(starts) // len(devices)
        frames_on = replicate(frames01, devices)
        tiles = []
        for i, d in enumerate(devices):
            mod_d = mod[d] if isinstance(mod, dict) else mod
            tiles += [to_device(_one_tile(mod_d, frames_on[d], st, th, tw,
                                          pad, scale, downscale),
                                frames01.device)
                      for st in starts[i * per:(i + 1) * per]]
    nx = w // tw
    rows = [torch.cat(tiles[i:i + nx], dim=2)
            for i in range(0, len(tiles), nx)]
    return torch.cat(rows, dim=1)


def upscale_tiled(mod, frames01, scale: int = 4,
                  tile: int | tuple[int, int] = 256, tile_pad: int = 10,
                  mesh=None, mesh_axis: str = "data"):
    """RealESRGANer.tile_process parity: split (B,H,W,C) into tiles with
    a `tile_pad` halo, upsample each through `mod` and stitch the
    x`scale` outputs. H and W must divide by the tile dims. `mesh` shards
    the tiles over `mesh_axis` (see `_tiled_rect`)."""
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    return _tiled_rect(mod, frames01, th, tw, tile_pad, scale=scale,
                       mesh=mesh, mesh_axis=mesh_axis)


def _to_host(out) -> np.ndarray:
    """The enhancer's output in one numpy buffer: a tensor (what
    `FaceEnhancer` makes: `_tiled_rect` stitches the shards' tiles on the
    frames' device), or the per-shard pieces of one as (index, tensor)
    pairs, each index a tuple of slices into the whole. Every shard of a
    mesh lives in this process, so JAX's refusal of an output sharded
    across hosts has nothing to refuse here."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    pieces = [(idx, t.cpu().numpy()) for idx, t in out]
    shape = tuple(max(sl.stop for sl in col) for col in
                  zip(*(idx for idx, _ in pieces)))
    buf = np.empty(shape, pieces[0][1].dtype)
    for idx, piece in pieces:
        buf[idx] = piece
    return buf


class FaceEnhancer:
    """GFPGAN face restoration (+ optional x4 background) of uint8 chunks.

    det: the pipeline's detector module (`SCRFD`, `SCRFDOnnx` or
    `SCRFDV1e`: letterboxed canvas in, SCRFD head rows out); gfpgan: a
    `GFPGANClean`; bg: None, an `RRDBNet` or an `SRVGGNetCompact` (x4,
    NHWC). Each owns its weights, on one device.

    bg_mesh: a `core.mesh.Mesh` whose "data" axis shards the background
    tiles (`_tiled_rect`); the background model is copied once to each
    of its devices other than its own, here."""

    def __init__(self, det, gfpgan, bg=None, det_size: int = 640,
                 det_thresh: float = 0.5, max_faces: int = 4,
                 crop_size: int = 512, bg_tile: tuple[int, int] = (270, 240),
                 bg_tile_pad: int = 10, bg_mesh=None):
        self.det_mod, self.gfp_mod, self.bg_mod = det, gfpgan, bg
        self.bg_mesh = bg_mesh
        self._bg_on = (replicate_module(bg, bg_mesh.axis_devices("data")[0])
                       if bg is not None and bg_mesh is not None else bg)
        self.det_size = det_size
        self.det_thresh = det_thresh
        self.max_faces = max_faces
        self.crop_size = crop_size
        self.bg_tile = bg_tile
        self.bg_tile_pad = bg_tile_pad
        self.device = next(gfpgan.parameters()).device
        self._mask = torch.from_numpy(_soft_border_mask(crop_size)).to(
            self.device)
        self._template = torch.from_numpy(
            FFHQ_TEMPLATE_512 * (crop_size / 512.0)).to(self.device)
        # paste-back rotation window must cover the rotated crop
        self._blend_grid = int(np.ceil(crop_size * np.sqrt(2) / 32.0)) * 32

    def _bg_base(self, frames_u8):
        """Resolution-preserving background cleanup: the tiled x4 model,
        each tile area-resized back, clipped, in [0, 255] f32."""
        _, h, w, _ = frames_u8.shape
        x01 = frames_u8.float() / 255.0
        th, tw = _fit_tile(self.bg_tile, h, w)
        # the halo must fit inside the frame (halos clamp to the image);
        # a frame of one tile on an axis gets none
        pad = min(self.bg_tile_pad, (h - th) // 2, (w - tw) // 2)
        up = _tiled_rect(self._bg_on, x01, th, tw, pad, downscale=True,
                         mesh=self.bg_mesh)
        return torch.clamp(up.float(), 0.0, 1.0) * 255.0

    def _enhance(self, frames_u8):
        b = frames_u8.shape[0]
        canvas, scale = preprocess_frames(frames_u8, self.det_size)
        scores, _boxes, kps = decode_detections(
            self.det_mod(canvas), input_size=self.det_size,
            score_thresh=self.det_thresh, max_faces=self.max_faces)
        kps = kps / scale  # (B,F,5,2) frame coords
        f = kps.shape[1]
        m = umeyama_similarity(
            kps.reshape(b * f, 5, 2),
            self._template.expand(b * f, 5, 2)).reshape(b, f, 2, 3)
        present = scores > 0  # (B,F)
        framesf = frames_u8.float()
        s = self.crop_size

        base = self._bg_base(frames_u8) if self.bg_mod is not None \
            else framesf
        mask = self._mask.expand(b, s, s, 1)
        for lane in range(f):
            # lanes are score-sorted, so lane k fires only on frames with
            # more than k faces; a lane absent from the whole chunk skips
            # the crop, GFPGAN and the paste-back
            if not bool(present[:, lane].any()):
                continue
            crop = warp_affine_similarity(framesf, m[:, lane, None], s,
                                          subpix=3, interp="nearest")
            r, _ = self.gfp_mod(crop / 127.5 - 1.0)
            restored = (torch.clamp(r.float(), -1.0, 1.0) + 1.0) * 127.5
            base = warp_and_blend_similarity(
                base, restored, mask, m[:, lane], present=present[:, lane],
                grid=self._blend_grid, rot_subpix=2,
                rot_interp="nearest").float()
        return torch.clamp(base, 0.0, 255.0).to(torch.uint8)

    @torch.inference_mode()
    def enhance(self, frames_rgb_u8: np.ndarray) -> np.ndarray:
        """frames (B,H,W,3) RGB uint8 -> enhanced frames, same shape."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_rgb_u8))
        return _to_host(self._enhance(frames.to(self.device)))
