"""Seeded inputs of the mask-target and preprocessing CLIs, made with
numpy and the port: a Segment Anything state dict with the upstream
`segment_anything` names and shapes (what sam_vit_{b,l,h}_*.pth hold, at
any size), and the templated landmark and detector weights as flax
msgpack files. No jax here: `chip_smoke.py` phase 23 uses them too.

Kernels are drawn with std 1/sqrt(fan_in) so activations keep their
scale through the deep ViT; LayerNorms are moved off identity; the
relative-position tables and the position embedding are small, as a
trained SAM's are.
"""

from __future__ import annotations

import numpy as np

from torch_cli_inputs import _kernel, _vec

# upstream build_sam's encoders (embed_dim, depth, num_heads,
# global_attn_indexes)
SAM_PRESETS = {"vit_b": (768, 12, 12, (2, 5, 8, 11)),
               "vit_l": (1024, 24, 16, (5, 11, 17, 23)),
               "vit_h": (1280, 32, 16, (7, 15, 23, 31))}


def _linear(rng, sd, name, cout, cin):
    sd[f"{name}.weight"] = _kernel(rng, cout, cin)
    sd[f"{name}.bias"] = _vec(rng, cout)


def _norm(rng, sd, name, ch):
    sd[f"{name}.weight"] = 1.0 + _vec(rng, ch)
    sd[f"{name}.bias"] = _vec(rng, ch)


def _attn(rng, sd, name, dim, internal):
    for p in ("q_proj", "k_proj", "v_proj"):
        _linear(rng, sd, f"{name}.{p}", internal, dim)
    _linear(rng, sd, f"{name}.out_proj", dim, internal)


def sam_state_dict(rng, embed_dim=1280, depth=32, num_heads=16,
                   global_attn_indexes=(7, 15, 23, 31), img_size=1024,
                   patch_size=16, window_size=14, out_chans=256,
                   mlp_dim=2048):
    """A SAM state dict in the upstream layout: the image encoder, the
    prompt encoder (with its mask-downscaling convs, which point prompts
    never read) and the mask decoder (2 two-way blocks, 4 mask tokens,
    an IoU head as wide as the decoder)."""
    sd = {}
    d, c, g = embed_dim, out_chans, img_size // patch_size
    hd = d // num_heads
    e = "image_encoder"
    sd[f"{e}.patch_embed.proj.weight"] = _kernel(rng, d, 3, patch_size,
                                                 patch_size)
    sd[f"{e}.patch_embed.proj.bias"] = _vec(rng, d)
    sd[f"{e}.pos_embed"] = _vec(rng, (1, g, g, d), 0.02)
    for i in range(depth):
        b = f"{e}.blocks.{i}"
        side = g if i in global_attn_indexes else window_size
        _norm(rng, sd, f"{b}.norm1", d)
        _linear(rng, sd, f"{b}.attn.qkv", 3 * d, d)
        _linear(rng, sd, f"{b}.attn.proj", d, d)
        sd[f"{b}.attn.rel_pos_h"] = _vec(rng, (2 * side - 1, hd), 0.02)
        sd[f"{b}.attn.rel_pos_w"] = _vec(rng, (2 * side - 1, hd), 0.02)
        _norm(rng, sd, f"{b}.norm2", d)
        _linear(rng, sd, f"{b}.mlp.lin1", 4 * d, d)
        _linear(rng, sd, f"{b}.mlp.lin2", d, 4 * d)
    sd[f"{e}.neck.0.weight"] = _kernel(rng, c, d, 1, 1)
    _norm(rng, sd, f"{e}.neck.1", c)
    sd[f"{e}.neck.2.weight"] = _kernel(rng, c, c, 3, 3)
    _norm(rng, sd, f"{e}.neck.3", c)

    p = "prompt_encoder"
    sd[f"{p}.pe_layer.positional_encoding_gaussian_matrix"] = \
        rng.standard_normal((2, c // 2), dtype=np.float32)
    for i in range(4):
        sd[f"{p}.point_embeddings.{i}.weight"] = _vec(rng, (1, c), 1.0)
    sd[f"{p}.not_a_point_embed.weight"] = _vec(rng, (1, c), 1.0)
    sd[f"{p}.no_mask_embed.weight"] = _vec(rng, (1, c), 1.0)
    m4, m16 = 4, 16  # upstream build_sam's mask_in_chans = 16
    for name, cout, cin, k in (("0", m4, 1, 2), ("3", m16, m4, 2),
                               ("6", c, m16, 1)):
        sd[f"{p}.mask_downscaling.{name}.weight"] = _kernel(rng, cout, cin,
                                                            k, k)
        sd[f"{p}.mask_downscaling.{name}.bias"] = _vec(rng, cout)
    _norm(rng, sd, f"{p}.mask_downscaling.1", m4)
    _norm(rng, sd, f"{p}.mask_downscaling.4", m16)

    m = "mask_decoder"
    sd[f"{m}.iou_token.weight"] = _vec(rng, (1, c), 1.0)
    sd[f"{m}.mask_tokens.weight"] = _vec(rng, (4, c), 1.0)
    t = f"{m}.transformer"
    for i in range(2):
        b = f"{t}.layers.{i}"
        _attn(rng, sd, f"{b}.self_attn", c, c)
        _attn(rng, sd, f"{b}.cross_attn_token_to_image", c, c // 2)
        _attn(rng, sd, f"{b}.cross_attn_image_to_token", c, c // 2)
        for n in range(1, 5):
            _norm(rng, sd, f"{b}.norm{n}", c)
        _linear(rng, sd, f"{b}.mlp.lin1", mlp_dim, c)
        _linear(rng, sd, f"{b}.mlp.lin2", c, mlp_dim)
    _attn(rng, sd, f"{t}.final_attn_token_to_image", c, c // 2)
    _norm(rng, sd, f"{t}.norm_final_attn", c)
    sd[f"{m}.output_upscaling.0.weight"] = _kernel(rng, c, c // 4, 2, 2)
    sd[f"{m}.output_upscaling.0.bias"] = _vec(rng, c // 4)
    _norm(rng, sd, f"{m}.output_upscaling.1", c // 4)
    sd[f"{m}.output_upscaling.3.weight"] = _kernel(rng, c // 4, c // 8, 2, 2)
    sd[f"{m}.output_upscaling.3.bias"] = _vec(rng, c // 8)
    for i in range(4):
        for j, (cout, cin) in enumerate(((c, c), (c, c), (c // 8, c))):
            _linear(rng, sd, f"{m}.output_hypernetworks_mlps.{i}.layers.{j}",
                    cout, cin)
    for j, (cout, cin) in enumerate(((c, c), (c, c), (4, c))):
        _linear(rng, sd, f"{m}.iou_prediction_head.layers.{j}", cout, cin)
    return sd


def sam_preset_state_dict(rng, preset="vit_h"):
    """The full-size upstream state dict of a preset (vit_h: ~641 M
    values, 2.6 GB in f32)."""
    d, depth, heads, glob = SAM_PRESETS[preset]
    return sam_state_dict(rng, d, depth, heads, glob)


def templated_landmark_msgpack(path, seed=0):
    """A full-width Landmark106 from a seeded torch.Generator with its
    head pinned to the 106-point face template, saved as the flax
    msgpack `--landmark_path` reads."""
    import torch

    from ghost_tpu_torch.convert.from_jax import flax_variables
    from ghost_tpu_torch.core.checkpoint import save_msgpack
    from ghost_tpu_torch.models.landmark import Landmark106
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.utils.face_template import inject_landmark_template

    lmk = init_weights(Landmark106(), torch.Generator().manual_seed(seed))
    save_msgpack(path, flax_variables(inject_landmark_template(lmk)))
    return path


def templated_detector_msgpack(path, seed=0, d=6.0):
    """A full-width SCRFD from a seeded torch.Generator with its heads
    pinned to a face layout (`inject_detection_template`), saved as the
    flax msgpack `--detector_path` reads."""
    import torch

    from ghost_tpu_torch.convert.from_jax import flax_variables
    from ghost_tpu_torch.core.checkpoint import save_msgpack
    from ghost_tpu_torch.models.scrfd import SCRFD
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.utils.face_template import inject_detection_template

    det = init_weights(SCRFD(), torch.Generator().manual_seed(seed))
    save_msgpack(path, flax_variables(inject_detection_template(det, d=d)))
    return path
