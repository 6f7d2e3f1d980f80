"""End-to-end face-swap pipeline, mirroring `ghost_tpu/pipeline/swap.py`.

One chunk of uint8 frames stays on the device from detection to the
blended output (`SwapPipeline._detect_swap`):

  detect-match: letterbox -> SCRFD -> NMS -> umeyama align -> 112-px
      matching crops -> ArcFace embed -> cosine match vs targets
  swap-blend:   umeyama on the matched kps -> 224-px similarity crops ->
      resize 256 -> AEI-Net with the source embeds -> (the SR seat,
      `use_sr`) -> landmark net on the swap -> soft mask -> similarity
      paste-back blend

The user's entry points drive those chunk programs from the host:
`swap_video_frames` (the two stages with keypoint smoothing between
them and the per-shot mask probe), `swap_video_stream` (the same over an
iterator of chunks, smoothing with a one-chunk lag, or the fused
program with a one-chunk lookahead), `swap_image`, `swap_image_fused`
and `crop_faces`.

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
                                      mask_params_from_offset,
                                      mask_params_from_offset_traced,
                                      soft_face_mask_dynamic)
from ghost_tpu_torch.ops.umeyama import estimate_norm
from ghost_tpu_torch.ops.warp import (warp_affine, warp_affine_similarity,
                                      warp_and_blend,
                                      warp_and_blend_similarity)
from ghost_tpu_torch.pipeline.smoothing import smooth_tracks
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
    # per-shot mask parameters: the video paths probe each target's
    # first present frame once; swap_image_fused selects per face
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


def _pad_chunk(frames, bsz):
    """Pad a chunk to bsz frames by repeating its last frame."""
    pad = bsz - frames.shape[0]
    if not pad:
        return frames
    return np.concatenate([frames, np.repeat(frames[-1:], pad, 0)], 0)


class SwapPipeline:
    """The four models of the main path, the optional SR seat and the
    chunk programs.

    sr: None, a seat module that owns its weights ([-1,1] NHWC in and
    out at the generator's resolution: `SRVGGStudentSeat`,
    `LIPSPADEGenerator`), or a `(seat, _)` pair as the JAX package takes
    it; it must sit on the detector's device."""

    def __init__(self, detector: SCRFD, arcface: IResNet, generator: AEINet,
                 landmarker: Landmark106, config: SwapConfig = SwapConfig(),
                 sr=None):
        self.det_mod = detector
        self.arc_mod = arcface
        self.gen_mod = generator
        self.lmk_mod = landmarker
        self.sr = sr[0] if isinstance(sr, tuple) else sr
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

    @torch.inference_mode()
    def _swap_fused(self, frames_u8, target_embeds, source_embeds,
                    match_targets: bool):
        return self._swap_fused_impl(self._tensor(frames_u8),
                                     self._tensor(target_embeds),
                                     self._tensor(source_embeds),
                                     match_targets)

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

    def _sr_lanes(self, y, lanes_on):
        """The SR seat on the generator output y (B*L,g,g,3) in [0,255],
        L lanes frame-major: lane j goes through the seat where
        lanes_on[j] and passes through as f32 where not (the JAX batched
        body's per-target skip)."""
        n, g = y.shape[0], y.shape[1]
        y_l = y.reshape(n // len(lanes_on), len(lanes_on), g, g, 3)
        lanes = []
        for j, on in enumerate(lanes_on):
            v = y_l[:, j]
            if on:
                r = self.sr((v / 255.0 - 0.5) / 0.5)
                v = (r * 0.5 + 0.5) * 255.0
            lanes.append(v.float())
        if len(lanes) == 1:
            return lanes[0]
        return torch.stack(lanes, dim=1).reshape(n, g, g, 3)

    def _swap_masks(self, frames_u8, m, src, params, need_offsets,
                    sr_lanes=None):
        """Crops -> AEI-Net -> (SR seat) -> landmarks -> soft masks for
        frames (B,...) and matrices m (B,L,2,3), L lanes frame-major.

        src (B*L,512); params None (cfg.mask_params), "auto", or (B*L,4);
        sr_lanes: which lanes the SR seat runs on (None = all).
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
        if self.sr is not None:
            y = self._sr_lanes(y, [True] * m.shape[1] if sr_lanes is None
                               else sr_lanes)
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
        lane-skip body. A lane absent from the whole group skips the SR
        seat."""
        b, t = m.shape[:2]
        need_offsets = probe or isinstance(mask_params, str)
        params = mask_params
        if isinstance(mask_params, torch.Tensor):
            params = mask_params.repeat(b, 1)  # (B*T,4) frame-major
        sr_lanes = ([bool(present[:, j].any()) for j in range(t)]
                    if self.sr is not None else None)
        swap, mask, offsets = self._swap_masks(
            frames_u8, m, source_embeds.repeat(b, 1), params, need_offsets,
            sr_lanes)
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

    def _swap_fused_impl(self, frames_u8, target_embeds, source_embeds,
                         match_targets: bool):
        """Detect -> match -> swap -> blend for stills, with per-face
        mask parameters ("auto") when cfg.mask_per_shot: the same result
        as the two stages with smooth=False."""
        cfg = self.cfg
        kps, sim, scores, raw_kps = self._detect_match_impl(frames_u8,
                                                            target_embeds)
        t = target_embeds.shape[0]
        if match_targets:
            present = sim > cfg.similarity_th
        else:
            kps = raw_kps[:, :t]
            present = scores[:, :t] > 0.0
        mp = "auto" if cfg.mask_per_shot else None
        out = self._swap_blend_impl(frames_u8, kps, present, source_embeds, mp)
        return out[0] if isinstance(out, tuple) else out

    # ----------------------------------------------- host entry points
    def _embeds(self, source_crops_rgb, target_crops_rgb):
        """Source embeds, target embeds (the normalized sources when no
        targets are given) and whether to match targets."""
        src_emb = self.embed_sources(source_crops_rgb)
        if target_crops_rgb is None:
            return src_emb, normalize_embedding(src_emb), False
        return src_emb, self.embed_targets(target_crops_rgb), True

    def swap_image_fused(self, frame_rgb_u8, source_crops_rgb,
                         target_crops_rgb=None) -> np.ndarray:
        """--image_to_image in one chunk program (no host hop)."""
        src_emb, tgt_emb, match_targets = self._embeds(source_crops_rgb,
                                                       target_crops_rgb)
        out = self._swap_fused(np.asarray(frame_rgb_u8)[None], tgt_emb,
                               src_emb, match_targets)
        return out.cpu().numpy()[0]

    def _probe_mask_params(self, frames, kps, present, src_emb, chosen,
                           need, n_valid):
        """Probe one chunk with the current params; each target of `need`
        present in its first n_valid frames gets the params of the offset
        at its first present frame and leaves `need`. Returns the (T,4)
        float32 params."""
        js = [j for j in need if present[:n_valid, j].any()]
        if js:
            _probe, offs = self._swap_blend(
                frames, kps, present, src_emb,
                np.asarray(chosen, np.float32), probe=True)
            offs = offs.cpu().numpy()
            for j in js:
                idx = np.nonzero(present[:n_valid, j])[0]
                chosen[j] = mask_params_from_offset(float(offs[idx[0], j]))
                need.discard(j)
        return np.asarray(chosen, np.float32)

    def swap_video_frames(self, frames_rgb_u8, source_crops_rgb,
                          target_crops_rgb, smooth: bool = True) -> np.ndarray:
        """Chunked video swap on fixed-size chunks (the last one padded).

        frames (N,H,W,3) RGB uint8; sources (T,crop,crop,3); targets the
        same (or None: source j swaps the j-th best-scored face). Stage A
        (detect-match) over every chunk, keypoint smoothing over the whole
        track, the per-shot mask probe at each target's first present
        frame, then stage B (swap-blend) over every chunk."""
        cfg = self.cfg
        frames_rgb_u8 = np.asarray(frames_rgb_u8)
        n = frames_rgb_u8.shape[0]
        t = source_crops_rgb.shape[0]
        src_emb, tgt_emb, match_targets = self._embeds(source_crops_rgb,
                                                       target_crops_rgb)

        kps_all = np.zeros((n, t, 5, 2), np.float32)
        sim_all = np.zeros((n, t), np.float32)
        bsz = cfg.chunk_size
        pad = (-n) % bsz
        frames_pad = _pad_chunk(frames_rgb_u8, n + pad)
        for i in range(0, n + pad, bsz):
            kps, sim, scores, raw_kps = self._detect_match(
                frames_pad[i:i + bsz], tgt_emb)
            hi = min(i + bsz, n)
            if match_targets:
                kps_all[i:hi] = kps.cpu().numpy()[:hi - i]
                sim_all[i:hi] = sim.cpu().numpy()[:hi - i]
            else:
                kps_all[i:hi] = raw_kps.cpu().numpy()[:hi - i, :t]
                sim_all[i:hi] = scores.cpu().numpy()[:hi - i, :t]

        present = sim_all > (cfg.similarity_th if match_targets else 0.0)
        if smooth:
            kps_all = smooth_tracks(kps_all, present, n=2)
        present_pad = np.concatenate([present, np.zeros((pad, t), bool)], 0)
        kps_pad = np.concatenate(
            [kps_all, np.zeros((pad, t, 5, 2), np.float32)], 0)

        mask_params_t = None
        if cfg.mask_per_shot:
            chosen = [tuple(cfg.mask_params)] * t
            need = set(range(t))
            mask_params_t = np.asarray(chosen, np.float32)
            for i in range(0, n + pad, bsz):
                if not need:
                    break
                sl = slice(i, i + bsz)
                mask_params_t = self._probe_mask_params(
                    frames_pad[sl], kps_pad[sl], present_pad[sl], src_emb,
                    chosen, need, bsz)

        out = np.empty_like(frames_pad)
        for i in range(0, n + pad, bsz):
            sl = slice(i, i + bsz)
            out[sl] = self._swap_blend(frames_pad[sl], kps_pad[sl],
                                       present_pad[sl], src_emb,
                                       mask_params_t).cpu().numpy()
        return out[:n]

    def swap_video_stream(self, chunks, source_crops_rgb,
                          target_crops_rgb=None, smooth: bool = True):
        """Constant-memory streaming swap: consumes an iterator of
        (<=chunk,H,W,3) RGB uint8 chunks and yields swapped chunks in
        order.

        smooth=True: stage B of chunk i runs after stage A of chunk i+1,
        the keypoints smoothed over a window with the previous chunk's
        2-frame tail and the next chunk's 2-frame head (the same result
        as the whole-video smoothing of swap_video_frames). smooth=False:
        chunks run split (stage A, probe, stage B) while a target is
        unprobed, then the fused program with a one-chunk lookahead: chunk
        i's result is read back after chunk i+1 is dispatched."""
        cfg = self.cfg
        t = source_crops_rgb.shape[0]
        bsz = cfg.chunk_size
        src_emb, tgt_emb, match_targets = self._embeds(source_crops_rgb,
                                                       target_crops_rgb)

        def run_a(frames_np):
            n = frames_np.shape[0]
            frames_np = _pad_chunk(frames_np, bsz)
            kps, sim, scores, raw_kps = self._detect_match(frames_np, tgt_emb)
            if match_targets:
                kps_np, sim_np = kps.cpu().numpy(), sim.cpu().numpy()
            else:
                kps_np = raw_kps.cpu().numpy()[:, :t]
                sim_np = scores.cpu().numpy()[:, :t]
            present = sim_np > (cfg.similarity_th if match_targets else 0.0)
            present[n:] = False
            return frames_np, n, kps_np, present

        # per-shot mask params, derived at each target's first present
        # frame; `need` holds the targets not yet probed
        chosen = [tuple(cfg.mask_params)] * t
        need = set(range(t)) if cfg.mask_per_shot else set()
        state = {"params": (np.asarray(chosen, np.float32)
                            if cfg.mask_per_shot else None),
                 "tail": None}

        def run_b(frames_np, n, kps_np, present, head):
            k = kps_np
            if smooth:
                tail = state["tail"]
                ctx_k, ctx_p = [kps_np[:n]], [present[:n]]
                if tail is not None:
                    ctx_k.insert(0, tail[0])
                    ctx_p.insert(0, tail[1])
                if head is not None:
                    ctx_k.append(head[0])
                    ctx_p.append(head[1])
                lo = 0 if tail is None else tail[0].shape[0]
                sm = smooth_tracks(np.concatenate(ctx_k, 0),
                                   np.concatenate(ctx_p, 0), n=2)
                k = kps_np.copy()
                k[:n] = sm[lo:lo + n]
            if need:
                state["params"] = self._probe_mask_params(
                    frames_np, k, present, src_emb, chosen, need, n)
            res = self._swap_blend(frames_np, k, present, src_emb,
                                   state["params"])
            return res.cpu().numpy()[:n]

        if not smooth:
            pending = None  # (device result, valid frame count)
            for frames_np in chunks:
                frames_np = np.asarray(frames_np)
                if need:
                    fpad, fn, kps_np, present = run_a(frames_np)
                    yield run_b(fpad, fn, kps_np, present, None)
                    continue
                res = self._detect_swap(_pad_chunk(frames_np, bsz), tgt_emb,
                                        src_emb, state["params"],
                                        match_targets)
                if pending is not None:
                    yield pending[0].cpu().numpy()[:pending[1]]
                pending = (res, frames_np.shape[0])
            if pending is not None:
                yield pending[0].cpu().numpy()[:pending[1]]
            return

        prev = None  # (frames, n, kps, present) awaiting stage B
        for frames_np in chunks:
            cur = run_a(np.asarray(frames_np))
            if prev is not None:
                pf, pn, pk, pp = prev
                out = run_b(pf, pn, pk, pp, (cur[2][:2], cur[3][:2]))
                state["tail"] = (pk[max(pn - 2, 0):pn], pp[max(pn - 2, 0):pn])
                yield out
            prev = cur
        if prev is not None:
            yield run_b(*prev, None)

    def swap_image(self, frame_rgb_u8, source_crops_rgb,
                   target_crops_rgb=None) -> np.ndarray:
        """Single-image path (--image_to_image) through the two stages."""
        out = self.swap_video_frames(np.asarray(frame_rgb_u8)[None],
                                     source_crops_rgb, target_crops_rgb,
                                     smooth=False)
        return out[0]

    @torch.inference_mode()
    def crop_faces(self, image_rgb_u8, max_faces: int | None = None):
        """Detect, align to crop_size and return (crops (K,cs,cs,3) uint8
        sorted by score, scores (F,)) as numpy."""
        cfg = self.cfg
        cs = cfg.crop_size
        frames = self._tensor(np.asarray(image_rgb_u8)[None])
        canvas, scale = preprocess_frames(frames, cfg.det_size)
        scores, _boxes, kps = decode_detections(
            self.det_mod(canvas), input_size=cfg.det_size,
            score_thresh=cfg.det_thresh,
            max_faces=max_faces or cfg.max_faces)
        kps = kps[0] / scale
        scores = scores[0].cpu().numpy()
        n_valid = int((scores > 0).sum())
        if n_valid == 0:
            return np.zeros((0, cs, cs, 3), np.uint8), scores
        m = estimate_norm(kps[:n_valid], cs)
        crops = warp_affine(frames.float().repeat(n_valid, 1, 1, 1), m,
                            (cs, cs))
        return (torch.clamp(crops, 0, 255).to(torch.uint8).cpu().numpy(),
                scores)


def build_random_pipeline(config: SwapConfig = SwapConfig(),
                          policy: Policy = DEFAULT_POLICY,
                          arcface_layers=(1, 1, 1, 1),
                          backbone: str = "unet", seed: int = 0,
                          gen_width: float = 1.0,
                          inject_templates: bool = False,
                          device="cuda", sr=None) -> SwapPipeline:
    """Random-weight pipeline (flax-style init from a seeded
    torch.Generator on the CPU, then moved to `device`).

    device: the card by default; a CPU run asks for `device="cpu"`.
    Without a card the default raises rather than running on the CPU.

    inject_templates: pin the detector head and landmark head to face
    layouts (utils/face_template.py) so detections, masks and the blend
    are non-trivial on random weights.

    AEI-Net is built with fused_aad=True: the pipeline is inference, and
    every AADLayer runs the fused kernel (as `ghost_tpu/pipeline/swap.py`
    turns it on).

    sr: the SR seat (see `SwapPipeline`), passed through as it is."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_random_pipeline: no CUDA card; pass "
                           "device='cpu' to build on the CPU")
    gen = torch.Generator().manual_seed(seed)
    det = SCRFD(policy=policy)
    arc = IResNet(layers=arcface_layers, policy=policy)
    aei = AEINet(backbone=backbone, num_blocks=2, policy=policy,
                 width=gen_width, fused_aad=True)
    lmk = Landmark106(policy=policy)
    for model in (det, arc, aei, lmk):
        init_weights(model, gen)
    if inject_templates:
        inject_detection_template(det)
        inject_landmark_template(lmk)
    models = [cast_to_compute_dtype(mod.to(device).eval())
              for mod in (det, arc, aei, lmk)]
    return SwapPipeline(*models, config=config, sr=sr)
