"""End-to-end face-swap pipeline, mirroring `ghost_tpu/pipeline/swap.py`.

One chunk of uint8 frames stays on the device from detection to the
blended output (`SwapPipeline._detect_swap`):

  detect-match: letterbox -> SCRFD -> NMS -> umeyama align -> 112-px
      matching crops -> ArcFace embed -> cosine match vs targets
  swap-blend:   umeyama on the matched kps -> 224-px similarity crops ->
      resize 256 -> AEI-Net with the source embeds -> landmark net on
      the swap -> soft mask -> similarity paste-back blend

Shapes are fixed by the chunk size B, the target count T and the face
capacity F; missing faces ride through as lanes with present=False.
`jax.lax.map` over micro-batch groups becomes a Python loop, `vmap`
written-out batch dims. Models are `nn.Module`s that own their weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.models.aei import AEINet
from ghost_tpu_torch.models.arcface import IResNet, normalize_embedding
from ghost_tpu_torch.models.landmark import Landmark106, landmarks_from_crops
from ghost_tpu_torch.models.scrfd import (SCRFD, decode_detections,
                                          preprocess_frames)
from ghost_tpu_torch.nn.layers import (cast_to_compute_dtype, init_weights,
                                       resize)
from ghost_tpu_torch.ops.mask import (face_mask_batch,
                                      mask_offset_from_landmarks,
                                      mask_params_from_offset_traced,
                                      soft_face_mask_dynamic)
from ghost_tpu_torch.ops.umeyama import estimate_norm
from ghost_tpu_torch.ops.warp import (warp_affine, warp_affine_similarity,
                                      warp_and_blend,
                                      warp_and_blend_similarity)
from ghost_tpu_torch.utils.face_template import (inject_detection_template,
                                                 inject_landmark_template)


@dataclasses.dataclass(frozen=True)
class SwapConfig:
    """Knobs mirror the reference CLI; see `ghost_tpu/pipeline/swap.py`."""

    crop_size: int = 224
    similarity_th: float = 0.15
    det_thresh: float = 0.6
    det_size: int = 640
    max_faces: int = 8
    chunk_size: int = 32
    gen_size: int = 256
    use_sr: bool = False
    mask_params: tuple = (5.0, 5.0, 5.0, 2.0)
    # paste-back: 'similarity' = crop-space rotation + tent matmuls;
    # 'gather' = the single-resample gather warp
    pasteback: str = "similarity"
    # 'None' = best of the 5 pose templates; 'arcface' = frontal only
    align_mode: str = "None"
    # stage-A matching crops sampled at 112 directly (matching only)
    fast_match_crops: bool = True
    # crop extraction: 'similarity' (tent matmuls + rotation resample)
    # or 'gather' (direct warp)
    crop_mode: str = "similarity"
    # rotation-resample taps: 'nearest' from a subpix-oversampled grid
    # (error ~1/(2*subpix) px) or 'bilinear'
    crop_interp: str = "nearest"
    crop_subpix: int = 3
    # the paste-back's rotation resample: nearest taps from a 2x
    # upsampled [swap|mask]
    blend_rot_subpix: int = 2
    # micro-batch groups of the swap-blend body (peak-memory knob)
    gen_groups: int = 2
    # matching crops sample an area-downsampled frame (1 = full res)
    match_downsample: int = 2
    # per-shot mask parameters (read by the video paths, not ported yet)
    mask_per_shot: bool = True
    # embed only the top-K score-sorted face lanes (None = all)
    match_faces: int | None = None
    # frames per micro-batch group of `_detect_swap`; 0 disables grouping
    fused_group: int = 32
    # skip a target lane whose face is absent from the whole group
    lane_skip: bool = True


def _cat(results):
    """Concatenate per-group results (tensors or tuples of tensors)."""
    if isinstance(results[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*results))
    return torch.cat(results)


class SwapPipeline:
    """The four models of the main path and the chunk programs."""

    def __init__(self, detector: SCRFD, arcface: IResNet, generator: AEINet,
                 landmarker: Landmark106, config: SwapConfig = SwapConfig()):
        self.det_mod = detector
        self.arc_mod = arcface
        self.gen_mod = generator
        self.lmk_mod = landmarker
        self.cfg = config
        self.device = next(detector.parameters()).device

    def _tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _params(self, mask_params):
        if mask_params is None or isinstance(mask_params, str):
            return mask_params
        return self._tensor(mask_params).float()

    # ------------------------------------------------------------ entries
    @torch.inference_mode()
    def _detect_match(self, frames_u8, target_embeds):
        return self._detect_match_impl(self._tensor(frames_u8),
                                       self._tensor(target_embeds))

    @torch.inference_mode()
    def _swap_blend(self, frames_u8, kps, present, source_embeds,
                    mask_params=None, probe=False):
        return self._swap_blend_impl(
            self._tensor(frames_u8), self._tensor(kps), self._tensor(present),
            self._tensor(source_embeds), self._params(mask_params), probe)

    @torch.inference_mode()
    def _detect_swap(self, frames_u8, target_embeds, source_embeds,
                     mask_params=None, match_targets=True,
                     present_override=None):
        """Detect -> match -> swap -> blend for one chunk.

        present_override: optional (B,T) bool replacing the similarity
        threshold presence (pins lane occupancy for measurements)."""
        pov = (None if present_override is None
               else self._tensor(present_override))
        return self._detect_swap_impl(
            self._tensor(frames_u8), self._tensor(target_embeds),
            self._tensor(source_embeds), self._params(mask_params),
            match_targets, pov)

    # ----------------------------------------------------------- embeds
    def _arc_input(self, crops_rgb):
        x = crops_rgb.float() / 255.0
        x = (x - 0.5) / 0.5
        return resize(x, (112, 112), method="bilinear", align_corners=True)

    @torch.inference_mode()
    def embed_sources(self, source_crops_rgb):
        """Source face crops (T,crop,crop,3) -> (T,512), not normalized."""
        return self.arc_mod(self._arc_input(self._tensor(source_crops_rgb)))

    @torch.inference_mode()
    def embed_targets(self, target_crops_rgb):
        """Target face crops -> L2-normalized (T,512)."""
        e = self.arc_mod(self._arc_input(self._tensor(target_crops_rgb)))
        return normalize_embedding(e)

    # ----------------------------------------------------- detect-match
    def _detect_match_impl(self, frames_u8, target_embeds):
        """frames (B,H,W,3) uint8; target_embeds (T,512) normalized.

        Returns (kps (B,T,5,2), sim (B,T), scores (B,F), raw kps (B,F,5,2))."""
        cfg = self.cfg
        canvas, scale = preprocess_frames(frames_u8, cfg.det_size)
        scores, _boxes, kps = decode_detections(
            self.det_mod(canvas), input_size=cfg.det_size,
            score_thresh=cfg.det_thresh, max_faces=cfg.max_faces)
        kps = kps / scale
        b, f = scores.shape
        h, w = frames_u8.shape[1:3]

        k = f if cfg.match_faces is None else min(cfg.match_faces, f)
        kps_k = kps[:, :k]
        m = estimate_norm(kps_k.reshape(b * k, 5, 2), cfg.crop_size,
                          mode=cfg.align_mode)
        crop_px = 112 if cfg.fast_match_crops else cfg.crop_size
        m = m * (crop_px / cfg.crop_size)

        d = cfg.match_downsample
        if d > 1 and h % d == 0 and w % d == 0:
            # crops from an area-downsampled frame; half->full pixel
            # centres x_full = d*x_half + (d-1)/2 fold into the matrices
            small = resize(frames_u8.to(torch.bfloat16), (h // d, w // d),
                           method="area")
            a_part = m[..., :2]
            t_part = m[..., 2] + (d - 1) / 2.0 * (a_part[..., 0]
                                                  + a_part[..., 1])
            m = torch.cat([a_part * d, t_part[..., None]], dim=-1)
        else:
            small = frames_u8

        if cfg.crop_mode == "similarity":
            crops = warp_affine_similarity(small, m.reshape(b, k, 2, 3),
                                           crop_px, subpix=2,
                                           interp=cfg.crop_interp)
        else:
            crops = warp_affine(small.float().repeat_interleave(k, dim=0), m,
                                (crop_px, crop_px))
        x = (crops / 255.0 - 0.5) / 0.5
        if not cfg.fast_match_crops:
            x = resize(x, (112, 112), method="bilinear", align_corners=True)
        embeds = normalize_embedding(self.arc_mod(x)).reshape(b, k, -1)

        sim = torch.einsum("bfc,tc->bft", embeds, target_embeds)
        valid = (scores[:, :k] > 0)[:, :, None]
        sim = torch.where(valid, sim, torch.full((), -1.0, device=sim.device))
        best = torch.argmax(sim, dim=1)  # (B,T), first index on ties
        best_sim = torch.take_along_dim(sim, best[:, None, :], dim=1)[:, 0, :]
        best_kps = torch.take_along_dim(kps_k, best[..., None, None], dim=1)
        return best_kps, best_sim, scores, kps

    # ------------------------------------------------------- swap-blend
    def _swap_blend_impl(self, frames_u8, kps, present, source_embeds,
                         mask_params=None, probe=False, groups=None):
        """frames (B,H,W,3) uint8; kps (B,T,5,2); present (B,T) bool;
        source_embeds (T,512). Returns blended uint8 frames, and with
        probe=True (or "auto" params) also the (B,T) mask offsets.

        mask_params: None -> cfg.mask_params; a (T,4) tensor -> per-target
        params; "auto" -> per-face params from the offset statistic."""
        cfg = self.cfg
        b, t = kps.shape[:2]
        m_all = estimate_norm(kps.reshape(b * t, 5, 2), cfg.crop_size,
                              mode=cfg.align_mode).reshape(b, t, 2, 3)
        g = cfg.gen_groups if groups is None else groups
        if g <= 1 or b % g != 0 or b < g:
            g = 1
        bg = b // g
        return _cat([self._swap_body(frames_u8[i * bg:(i + 1) * bg],
                                     m_all[i * bg:(i + 1) * bg],
                                     present[i * bg:(i + 1) * bg],
                                     source_embeds, mask_params, probe)
                     for i in range(g)])

    def _swap_body(self, frames_u8, m, present, source_embeds, mask_params,
                   probe=False):
        if self.cfg.lane_skip:
            return self._swap_body_lanes(frames_u8, m, present, source_embeds,
                                         mask_params, probe)
        return self._swap_body_batched(frames_u8, m, present, source_embeds,
                                       mask_params, probe)

    def _swap_masks(self, frames_u8, m, src, params, need_offsets):
        """Crops -> AEI-Net -> landmarks -> soft masks for frames (B,...)
        and matrices m (B,L,2,3), L lanes frame-major.

        src (B*L,512); params None (cfg.mask_params), "auto", or (B*L,4).
        Returns swap (B*L,cs,cs,3) f32, mask (B*L,cs,cs,1), offsets (B*L,)."""
        cfg = self.cfg
        cs = cfg.crop_size
        n = m.shape[0] * m.shape[1]
        if cfg.crop_mode == "similarity":
            crops = warp_affine_similarity(frames_u8, m, cs,
                                           subpix=cfg.crop_subpix,
                                           interp=cfg.crop_interp)
        else:
            crops = warp_affine(
                frames_u8.float().repeat_interleave(m.shape[1], dim=0),
                m.reshape(n, 2, 3), (cs, cs))
        gen_in = resize(crops / 255.0, (cfg.gen_size, cfg.gen_size),
                        method="bilinear")
        gen_in = (gen_in - 0.5) / 0.5
        y, _ = self.gen_mod(gen_in, src)
        y = (y * 0.5 + 0.5) * 255.0
        swap = resize(y, (cs, cs), method="bilinear")

        offsets = torch.zeros((n,), device=swap.device)
        if params is None:
            lmks = landmarks_from_crops(self.lmk_mod, swap, cs)
            return swap, face_mask_batch(lmks, cs, cfg.mask_params), offsets
        if need_offsets:
            # the offset statistic needs the original target crop's
            # landmarks too: one landmark pass over [swap | crop]
            both = torch.cat([swap, crops.to(swap.dtype)], dim=0)
            lm_both = landmarks_from_crops(self.lmk_mod, both, cs)
            lmks = lm_both[:n]
            offsets = mask_offset_from_landmarks(lmks, lm_both[n:])
        else:
            lmks = landmarks_from_crops(self.lmk_mod, swap, cs)
        if isinstance(params, str):  # "auto": per-face params
            params = mask_params_from_offset_traced(offsets)
        mask = soft_face_mask_dynamic(lmks, cs, params[:, 0], params[:, 1],
                                      params[:, 2], params[:, 3])[..., None]
        return swap, mask, offsets

    def _blend(self, out, swap, mask, m, present):
        cfg = self.cfg
        if cfg.pasteback == "similarity":
            return warp_and_blend_similarity(out, swap, mask, m,
                                             present=present,
                                             rot_subpix=cfg.blend_rot_subpix)
        return warp_and_blend(out, swap, mask, m, present=present)

    def _swap_body_lanes(self, frames_u8, m, present, source_embeds,
                         mask_params, probe=False):
        """Per-target-lane body: a lane whose face is absent from every
        frame of the group is skipped (the reference swaps only detected
        identities). Frames with present=False pass through."""
        cfg = self.cfg
        b, t = m.shape[:2]
        need_offsets = probe or isinstance(mask_params, str)
        blend_dtype = (torch.bfloat16 if cfg.pasteback == "similarity"
                       else torch.float32)
        out = frames_u8.to(blend_dtype)  # exact: u8 fits bf16
        offsets = torch.zeros((b, t), device=frames_u8.device)
        for j in range(t):
            # a Python branch in place of lax.cond: one host sync per
            # lane per group (a later perf item)
            if not bool(present[:, j].any()):
                continue
            params = mask_params
            if isinstance(mask_params, torch.Tensor):
                params = mask_params[j][None].expand(b, 4)
            swap, mask, offs = self._swap_masks(
                frames_u8, m[:, j:j + 1],
                source_embeds[j][None].expand(b, -1), params, need_offsets)
            offsets[:, j] = offs
            out = self._blend(out, swap, mask, m[:, j],
                              present[:, j]).to(blend_dtype)
        out = torch.clamp(out, 0, 255).to(torch.uint8)
        if need_offsets and mask_params is not None:
            return out, offsets
        return out

    def _swap_body_batched(self, frames_u8, m, present, source_embeds,
                           mask_params, probe=False):
        """All-lanes-batched body (lane_skip=False): the reference for the
        lane-skip body."""
        b, t = m.shape[:2]
        need_offsets = probe or isinstance(mask_params, str)
        params = mask_params
        if isinstance(mask_params, torch.Tensor):
            params = mask_params.repeat(b, 1)  # (B*T,4) frame-major
        swap, mask, offsets = self._swap_masks(
            frames_u8, m, source_embeds.repeat(b, 1), params, need_offsets)
        cs = self.cfg.crop_size
        swap = swap.reshape(b, t, cs, cs, 3)
        mask = mask.reshape(b, t, cs, cs, 1)
        out = frames_u8
        for j in range(t):
            out = self._blend(out, swap[:, j], mask[:, j], m[:, j],
                              present[:, j])
        out = torch.clamp(out, 0, 255).to(torch.uint8)
        if need_offsets and mask_params is not None:
            return out, offsets.reshape(b, t)
        return out

    def _detect_swap_impl(self, frames_u8, target_embeds, source_embeds,
                          mask_params, match_targets: bool,
                          present_override=None):
        """Detect -> match -> swap -> blend, micro-batched over
        cfg.fused_group frames (the detector included)."""
        cfg = self.cfg
        b = frames_u8.shape[0]
        t = target_embeds.shape[0]
        gs = cfg.fused_group
        if not (gs > 0 and b % gs == 0 and b > gs):
            gs = b

        def body(fr, pov):
            kps, sim, scores, raw_kps = self._detect_match_impl(
                fr, target_embeds)
            if match_targets:
                present = sim > cfg.similarity_th
            else:
                kps = raw_kps[:, :t]
                present = scores[:, :t] > 0.0
            if pov is not None:
                present = pov
            return self._swap_blend_impl(fr, kps, present, source_embeds,
                                         mask_params, groups=1)

        return _cat([body(frames_u8[i:i + gs],
                          None if present_override is None
                          else present_override[i:i + gs])
                     for i in range(0, b, gs)])


def build_random_pipeline(config: SwapConfig = SwapConfig(),
                          policy: Policy = DEFAULT_POLICY,
                          arcface_layers=(1, 1, 1, 1),
                          backbone: str = "unet", seed: int = 0,
                          gen_width: float = 1.0,
                          inject_templates: bool = False,
                          device="cuda") -> SwapPipeline:
    """Random-weight pipeline (flax-style init from a seeded
    torch.Generator on the CPU, then moved to `device`).

    device: the card by default; a CPU run asks for `device="cpu"`.
    Without a card the default raises rather than running on the CPU.

    inject_templates: pin the detector head and landmark head to face
    layouts (utils/face_template.py) so detections, masks and the blend
    are non-trivial on random weights."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_random_pipeline: no CUDA card; pass "
                           "device='cpu' to build on the CPU")
    gen = torch.Generator().manual_seed(seed)
    det = SCRFD(policy=policy)
    arc = IResNet(layers=arcface_layers, policy=policy)
    aei = AEINet(backbone=backbone, num_blocks=2, policy=policy,
                 width=gen_width)
    lmk = Landmark106(policy=policy)
    for model in (det, arc, aei, lmk):
        init_weights(model, gen)
    if inject_templates:
        inject_detection_template(det)
        inject_landmark_template(lmk)
    models = [cast_to_compute_dtype(mod.to(device).eval())
              for mod in (det, arc, aei, lmk)]
    return SwapPipeline(*models, config=config)
