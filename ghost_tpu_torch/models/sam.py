"""Segment Anything (SAM), mirroring `ghost_tpu/models/sam.py`.

The reference precomputes mask-training targets by prompting
`SamPredictor` (sam_vit_h) with the 5 face keypoints (reference
segment_anything_celeba.py:53-63, train-mask.py:236-274). The layer plan
is the public `segment_anything/modeling` sources', as the JAX package
writes it:

  * ImageEncoderViT: 16x16 patch embed, absolute position embedding, ViT
    blocks with windowed attention (windows padded with zeros) and
    decomposed relative positions, global attention on the preset's
    blocks, a 256-channel neck (1x1 conv, LayerNorm2d, 3x3 conv,
    LayerNorm2d); LayerNorm eps 1e-6 and exact GELU in the blocks;
  * PromptEncoder: points only (the reference's one prompt mode), the
    random-Fourier position encoding with the +0.5 pixel offset, label -1
    mapped to `not_a_point`;
  * MaskDecoder: IoU and mask tokens through a two-way transformer
    (LayerNorm eps 1e-5), 4x upscaling by two 2x2 transposed convs with
    LayerNorm2d and exact GELU, hypernetwork MLPs and the IoU head.

Attention is a plain batched matmul with an f32 softmax, as in JAX: the
relative-position terms are added to the scores before the softmax,
which no fused attention kernel of the port takes, and JAX runs no
Pallas kernel here either. Rel-pos terms are in the compute dtype,
softmax in f32, then cast back. Tensors are NHWC at every module
boundary (convs on the NCHW view). `SamPredictor.predict_points` is the
upstream predictor's resize / normalise / threshold pipeline for square
crops; the `.pth` converter is `convert/torch_loader.py:
convert_sam_state_dict`.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import (Conv, ConvTranspose, Dense, resize,
                                       to_nchw, to_nhwc)

SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)
PRESETS = {"vit_b": dict(embed_dim=768, depth=12, num_heads=12,
                         global_attn_indexes=(2, 5, 8, 11)),
           "vit_l": dict(embed_dim=1024, depth=24, num_heads=16,
                         global_attn_indexes=(5, 11, 17, 23)),
           "vit_h": dict(embed_dim=1280, depth=32, num_heads=16,
                         global_attn_indexes=(7, 15, 23, 31))}


def _conv_nhwc(conv, x):
    return to_nhwc(conv(to_nchw(x))).contiguous()


def layer_norm_2d(x, scale, bias, eps: float = 1e-6):
    """SAM's LayerNorm2d: each pixel normalised over its channels, two-pass
    statistics in f32; an f32 result."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


class LayerNorm2d(nn.Module):
    """`scale` and `bias` are bare parameters, as in the flax tree."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return layer_norm_2d(x, self.scale, self.bias)


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis with dtype float32: fast
    variance max(0, E[x^2] - E[x]^2) in f32, then (x - mean) *
    (rsqrt(var + eps) * scale) + bias; an f32 result."""

    def __init__(self, features: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp(torch.square(x).mean(dim=-1, keepdim=True)
                          - torch.square(mean), min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


def window_partition(x, ws: int):
    """(B,H,W,C) -> ((B*nw, ws, ws, C), (Hp, Wp)), zero-padded to
    multiples of ws."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(win, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp // ws * (wp // ws))
    x = win.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _get_rel_pos(q_size: int, k_size: int, rel_pos):
    """Index the (L, head_dim) table into (q, k, head_dim) (upstream
    get_rel_pos). A table whose length is not 2 * max - 1 is first
    resized to it, bilinear without corners, in f32 through the port's
    interpolation matrices (`nn.layers.resize`), as JAX resizes it."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize(rel_pos[None, :, :, None].float(),
                         (max_rel_dist, rel_pos.shape[1]),
                         method="bilinear", align_corners=False)[0, :, :, 0]
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    idx = torch.from_numpy(rel.astype(np.int64)).to(rel_pos.device)
    return rel_pos[idx]


class VitAttention(nn.Module):
    """ViT block attention with decomposed relative positions;
    `rel_pos_h`/`rel_pos_w` are bare parameters."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool = True,
                 input_size: Tuple[int, int] = (14, 14),
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.dim, self.num_heads = dim, num_heads
        self.use_rel_pos = use_rel_pos
        self.cd = cd
        hd = dim // num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=cd, device=device)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.empty(
                2 * input_size[0] - 1, hd, device=device))
            self.rel_pos_w = nn.Parameter(torch.empty(
                2 * input_size[1] - 1, hd, device=device))
        self.proj = Dense(dim, dim, dtype=cd, device=device)

    def reset_parameters(self, generator):
        if self.use_rel_pos:
            nn.init.zeros_(self.rel_pos_h)
            nn.init.zeros_(self.rel_pos_w)

    def forward(self, x):
        b, h, w, _ = x.shape
        nh, cd = self.num_heads, self.cd
        hd = self.dim // nh
        qkv = self.qkv(x.reshape(b, h * w, self.dim))
        qkv = qkv.reshape(b, h * w, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2).reshape(b * nh, h * w, hd)
                   for i in range(3))
        attn = (q * (hd ** -0.5)) @ k.transpose(1, 2)
        if self.use_rel_pos:
            rh = _get_rel_pos(h, h, self.rel_pos_h).to(cd)
            rw = _get_rel_pos(w, w, self.rel_pos_w).to(cd)
            r_q = q.reshape(b * nh, h, w, hd)
            dh = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
            dw = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
            attn = (attn.reshape(-1, h, w, h, w) + dh[:, :, :, :, None]
                    + dw[:, :, :, None, :]).reshape(-1, h * w, h * w)
        attn = torch.softmax(attn.float(), dim=-1).to(cd)
        out = (attn @ v).reshape(b, nh, h * w, hd)
        out = out.transpose(1, 2).reshape(b, h, w, self.dim)
        return self.proj(out)


class VitBlock(nn.Module):
    """window_size 0: global attention over the whole (input_size) grid."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 window_size: int = 14, input_size=(64, 64),
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.cd = cd
        self.window_size = window_size
        # upstream build_sam: the image encoder's norm_layer has eps 1e-6
        self.norm1 = LayerNorm(dim, 1e-6, device=device)
        attn_size = (window_size, window_size) if window_size > 0 \
            else tuple(input_size)
        self.attn = VitAttention(dim, num_heads, True, attn_size, policy,
                                 device=device)
        self.norm2 = LayerNorm(dim, 1e-6, device=device)
        hidden = int(dim * mlp_ratio)
        self.mlp_lin1 = Dense(dim, hidden, dtype=cd, device=device)
        self.mlp_lin2 = Dense(hidden, dim, dtype=cd, device=device)

    def forward(self, x):
        sc = x
        x = self.norm1(x).to(self.cd)
        hw = x.shape[1:3]
        if self.window_size > 0:
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, hw)
        x = sc + x
        y = self.mlp_lin1(self.norm2(x).to(self.cd))
        return x + self.mlp_lin2(F.gelu(y, approximate="none"))


class ImageEncoderViT(nn.Module):
    """(B, img_size, img_size, 3) normalised -> (B, g, g, out_chans) in the
    compute dtype, g = img_size / patch_size. `pos_embed` is a bare
    parameter in flax's NHWC layout (1, g, g, embed_dim)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (7, 15, 23, 31),
                 out_chans: int = 256, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.cd = cd
        self.img_size = img_size
        self.depth = depth
        grid = img_size // patch_size
        self.patch_embed = Conv(3, embed_dim, patch_size, patch_size,
                                dtype=cd, device=device)
        self.pos_embed = nn.Parameter(torch.empty(1, grid, grid, embed_dim,
                                                  device=device))
        for i in range(depth):
            ws = 0 if i in global_attn_indexes else window_size
            setattr(self, f"block_{i}", VitBlock(
                embed_dim, num_heads, 4.0, ws, (grid, grid), policy,
                device=device))
        self.neck_conv1 = Conv(embed_dim, out_chans, 1, use_bias=False,
                               dtype=cd, device=device)
        self.neck_ln1 = LayerNorm2d(out_chans, device=device)
        self.neck_conv2 = Conv(out_chans, out_chans, 3, padding=1,
                               use_bias=False, dtype=cd, device=device)
        self.neck_ln2 = LayerNorm2d(out_chans, device=device)

    def reset_parameters(self, generator):
        nn.init.zeros_(self.pos_embed)

    def forward(self, x):
        cd = self.cd
        x = _conv_nhwc(self.patch_embed, x.to(cd))
        x = x + self.pos_embed.to(cd)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        x = _conv_nhwc(self.neck_conv1, x)
        x = self.neck_ln1(x).to(cd)
        x = _conv_nhwc(self.neck_conv2, x)
        return self.neck_ln2(x).to(cd)


def sam_image_encoder(preset: str, **kw) -> ImageEncoderViT:
    """vit_b / vit_l / vit_h (upstream build_sam's encoders)."""
    return ImageEncoderViT(**PRESETS[preset], **kw)


class PromptEncoder(nn.Module):
    """Point prompts only. `pe_gauss` (2, embed_dim/2), `point_embed_{i}`,
    `not_a_point` and `no_mask_embed` are bare parameters."""

    def __init__(self, embed_dim: int = 256, image_size: int = 1024,
                 grid: int = 64, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        self.embed_dim, self.image_size, self.grid = embed_dim, image_size, grid
        self.pe_gauss = nn.Parameter(torch.empty(2, embed_dim // 2,
                                                 device=device))
        for i in range(4):
            setattr(self, f"point_embed_{i}", nn.Parameter(
                torch.empty(embed_dim, device=device)))
        self.not_a_point = nn.Parameter(torch.empty(embed_dim, device=device))
        self.no_mask_embed = nn.Parameter(torch.empty(embed_dim,
                                                      device=device))

    def reset_parameters(self, generator):
        for p in self.parameters(recurse=False):
            p.normal_(0.0, 1.0, generator=generator)

    def _pe(self, coords01, gauss):
        c = 2.0 * coords01 - 1.0
        c = (2.0 * np.pi) * (c @ gauss)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def forward(self, points, labels):
        """points (B,N,2) pixel coords in the encoder's input frame,
        labels (B,N): 1 foreground, 0 background, -1 padding. Returns
        (sparse (B,N,C), dense (B,g,g,C), dense_pe (1,g,g,C)), f32."""
        gauss = self.pe_gauss.float()
        pts = (points.float() + 0.5) / self.image_size
        pe = self._pe(pts, gauss)
        lab = labels[..., None]
        zero = pe.new_zeros(())
        sparse = torch.where(lab == -1, self.not_a_point, pe)
        sparse = sparse + torch.where(lab == 0, self.point_embed_0, zero)
        sparse = sparse + torch.where(lab == 1, self.point_embed_1, zero)
        b = pts.shape[0]
        dense = self.no_mask_embed.view(1, 1, 1, -1).expand(
            b, self.grid, self.grid, self.embed_dim)
        ys = (np.arange(self.grid, dtype=np.float32) + 0.5) / self.grid
        gy, gx = np.meshgrid(ys, ys, indexing="ij")
        grid01 = torch.from_numpy(np.stack([gx, gy], axis=-1)).to(gauss.device)
        return sparse, dense, self._pe(grid01, gauss)[None]


class DecoderAttention(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 downsample_rate: int = 1, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.cd = cd
        self.num_heads = num_heads
        idim = embed_dim // downsample_rate
        self.idim = idim
        for n in ("q_proj", "k_proj", "v_proj"):
            setattr(self, n, Dense(embed_dim, idim, dtype=cd, device=device))
        self.out_proj = Dense(idim, embed_dim, dtype=cd, device=device)

    def forward(self, q, k, v):
        hd = self.idim // self.num_heads

        def split(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.num_heads, hd).transpose(1, 2)

        q = split(self.q_proj(q))
        k = split(self.k_proj(k))
        v = split(self.v_proj(v))
        attn = (q / math.sqrt(hd)) @ k.transpose(2, 3)
        attn = torch.softmax(attn.float(), dim=-1).to(self.cd)
        out = attn @ v
        b, _, n, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, self.idim))


class TwoWayBlock(nn.Module):
    def __init__(self, skip_first_layer_pe: bool = False,
                 embed_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.cd = cd
        self.skip_first_layer_pe = skip_first_layer_pe
        kw = dict(policy=policy, device=device)
        self.self_attn = DecoderAttention(embed_dim, num_heads, 1, **kw)
        self.cross_attn_token_to_image = DecoderAttention(embed_dim,
                                                          num_heads, 2, **kw)
        self.cross_attn_image_to_token = DecoderAttention(embed_dim,
                                                          num_heads, 2, **kw)
        for i in range(1, 5):
            setattr(self, f"norm{i}", LayerNorm(embed_dim, 1e-5,
                                                device=device))
        self.mlp_lin1 = Dense(embed_dim, mlp_dim, dtype=cd, device=device)
        self.mlp_lin2 = Dense(mlp_dim, embed_dim, dtype=cd, device=device)

    def _ln(self, name, t):
        return getattr(self, name)(t).to(self.cd)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self._ln("norm1", queries)
        q, k = queries + query_pe, keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = self._ln("norm2", queries)
        y = self.mlp_lin2(torch.relu(self.mlp_lin1(queries)))
        queries = self._ln("norm3", queries + y)
        q, k = queries + query_pe, keys + key_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        return queries, self._ln("norm4", keys)


class MaskDecoder(nn.Module):
    """`iou_token` (1, C) and `mask_tokens` (M, C) are bare parameters."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, depth: int = 2,
                 num_mask_tokens: int = 4, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.cd = cd
        self.embed_dim, self.depth = embed_dim, depth
        self.num_mask_tokens = num_mask_tokens
        self.iou_token = nn.Parameter(torch.empty(1, embed_dim,
                                                  device=device))
        self.mask_tokens = nn.Parameter(torch.empty(
            num_mask_tokens, embed_dim, device=device))
        for i in range(depth):
            setattr(self, f"layer_{i}", TwoWayBlock(
                i == 0, embed_dim, num_heads, mlp_dim, policy, device))
        self.final_attn = DecoderAttention(embed_dim, num_heads, 2, policy,
                                           device)
        self.norm_final = LayerNorm(embed_dim, 1e-5, device=device)
        c4, c8 = embed_dim // 4, embed_dim // 8
        self.upscale_conv1 = ConvTranspose(embed_dim, c4, 2, 2, 0, dtype=cd,
                                           device=device)
        self.upscale_ln = LayerNorm2d(c4, device=device)
        self.upscale_conv2 = ConvTranspose(c4, c8, 2, 2, 0, dtype=cd,
                                           device=device)
        for i in range(num_mask_tokens):
            for j, (a, b) in enumerate(((embed_dim, embed_dim),
                                        (embed_dim, embed_dim), (embed_dim,
                                                                 c8))):
                setattr(self, f"hyper_{i}_lin{j}", Dense(a, b, dtype=cd,
                                                         device=device))
        for j, (a, b) in enumerate(((embed_dim, embed_dim),
                                    (embed_dim, embed_dim),
                                    (embed_dim, num_mask_tokens))):
            setattr(self, f"iou_lin{j}", Dense(a, b, dtype=cd, device=device))

    def reset_parameters(self, generator):
        self.iou_token.normal_(0.0, 1.0, generator=generator)
        self.mask_tokens.normal_(0.0, 1.0, generator=generator)

    def _mlp(self, prefix, t):
        for j in range(3):
            t = getattr(self, f"{prefix}{j}")(t)
            if j < 2:
                t = torch.relu(t)
        return t

    def forward(self, image_embed, dense_pe, sparse, dense):
        """image_embed (B,g,g,C), dense_pe (1,g,g,C), sparse (B,N,C),
        dense (B,g,g,C) -> (mask logits (B,M,4g,4g), iou (B,M)), in the
        compute dtype."""
        cd = self.cd
        b, g, _, c = image_embed.shape
        out_tokens = torch.cat([self.iou_token, self.mask_tokens], 0).to(cd)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1),
                            sparse.to(cd)], 1)
        src = (image_embed + dense).reshape(b, g * g, c).to(cd)
        pos = dense_pe.reshape(1, g * g, c).expand(b, g * g, c).to(cd)
        queries, keys = tokens, src
        for i in range(self.depth):
            queries, keys = getattr(self, f"layer_{i}")(queries, keys,
                                                        tokens, pos)
        q, k = queries + tokens, keys + pos
        queries = queries + self.final_attn(q, k, keys)
        queries = self.norm_final(queries).to(cd)
        iou_out = queries[:, 0]
        mask_out = queries[:, 1:1 + self.num_mask_tokens]

        up = keys.reshape(b, g, g, c)
        up = _conv_nhwc(self.upscale_conv1, up)
        up = F.gelu(self.upscale_ln(up).to(cd), approximate="none")
        up = F.gelu(_conv_nhwc(self.upscale_conv2, up), approximate="none")
        hyper = torch.stack([self._mlp(f"hyper_{i}_lin", mask_out[:, i])
                             for i in range(self.num_mask_tokens)], 1)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper, up)
        return masks, self._mlp("iou_lin", iou_out)


class Sam(nn.Module):
    """Image -> point-prompted mask logits at 1/4 of the encoder's input
    size; the multimask choice is the caller's."""

    def __init__(self, image_encoder: ImageEncoderViT,
                 prompt_encoder: PromptEncoder, mask_decoder: MaskDecoder):
        super().__init__()
        self.image_encoder = image_encoder
        self.prompt_encoder = prompt_encoder
        self.mask_decoder = mask_decoder

    @property
    def img_size(self):
        return self.image_encoder.img_size

    def forward(self, image, points, labels):
        """image (B,S,S,3) normalised ((x - mean) / std), S = img_size;
        points (B,N,2) [x, y] in image pixels; labels (B,N)."""
        embed = self.image_encoder(image)
        sparse, dense, dense_pe = self.prompt_encoder(points, labels)
        return self.mask_decoder(embed, dense_pe, sparse, dense)


def build_sam(preset: str = "vit_h", img_size: int = 1024,
              policy: Policy = DEFAULT_POLICY, device=None) -> Sam:
    """sam_model_registry parity: vit_b / vit_l / vit_h, parameters
    uninitialised (the bridge fills them; `init_weights` draws them)."""
    return Sam(
        sam_image_encoder(preset, img_size=img_size, policy=policy,
                          device=device),
        PromptEncoder(image_size=img_size, grid=img_size // 16,
                      policy=policy, device=device),
        MaskDecoder(policy=policy, device=device))


class SamPredictor:
    """Upstream SamPredictor parity for square crops, on the model's
    device: resize to the encoder's size, normalise, predict, resize the
    mask logits back, threshold at 0."""

    def __init__(self, model: Sam):
        self.model = model
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def predict_logits(self, image_u8, points, labels):
        """image_u8 (B,H,W,3), points (B,N,2) [x, y] in its pixels, labels
        (B,N), tensors on the model's device -> (logits (B,M,H,W), iou
        (B,M)) in the compute dtype."""
        size = self.model.img_size
        h, w = image_u8.shape[1:3]
        x = resize(image_u8.float(), (size, size), method="bilinear",
                   align_corners=False)
        dev = x.device
        x = (x - torch.from_numpy(SAM_PIXEL_MEAN).to(dev)) \
            / torch.from_numpy(SAM_PIXEL_STD).to(dev)
        pts = points.float() * torch.tensor([size / w, size / h],
                                            dtype=torch.float32, device=dev)
        masks, iou = self.model(x, pts, labels)
        # upstream postprocess_masks resizes in TWO bilinear steps (the
        # 4g grid -> img_size -> the crop's size); one direct step is
        # another function and flips near-zero logits across the
        # threshold at the mask's edges
        logits = resize(masks.permute(0, 2, 3, 1), (size, size),
                        method="bilinear", align_corners=False)
        logits = resize(logits, (h, w), method="bilinear",
                        align_corners=False)
        return logits.permute(0, 3, 1, 2), iou

    def predict_points(self, image_rgb_u8, point_coords, point_labels,
                       multimask_output: bool = False):
        """image (H,W,3) u8; point_coords (N,2) [x, y]; labels (N,).
        Returns numpy (masks bool (M,H,W), iou (M,), logits (M,H,W)) like
        the upstream predictor."""
        dev = self.device
        img = torch.as_tensor(np.asarray(image_rgb_u8))[None].to(dev)
        # the point list padded with one (0,0)/-1 entry, as the upstream
        # point-only path (prompt_encoder._embed_points pad=True)
        pts = np.concatenate(
            [np.asarray(point_coords, np.float32), np.zeros((1, 2))], 0)
        lab = np.concatenate(
            [np.asarray(point_labels, np.float32), -np.ones((1,))], 0)
        logits, iou = self.predict_logits(
            img, torch.from_numpy(pts.astype(np.float32))[None].to(dev),
            torch.from_numpy(lab.astype(np.float32))[None].to(dev))
        logits = logits[0].float().cpu().numpy()
        iou = iou[0].float().cpu().numpy()
        sel = slice(1, None) if multimask_output else slice(0, 1)
        logits, iou = logits[sel], iou[sel]
        return logits > 0.0, iou, logits
