"""Seeded inputs of the swap CLI, made with numpy: state dicts with the
reference's parameter names and shapes (reference network/AEI_Net.py,
network/AADLayer.py, network/resnet.py, insightface iresnet), what
`G_*.pth` and `backbone.pth` hold, at any generator width, and what the
enhancer's `GFPGANv1.4.pth`, `RealESRGAN_x4plus.pth` and
`realesr-general-x4v3.pth` hold (gfpgan / basicsr / realesrgan names);
and a source png, a target png and an mp4 clip. No jax here:
`chip_smoke.py` and the card tests use them too.

The names follow `tests/test_convert.py:48-75,109-134` (unet AEI-Net,
iresnet); the linknet and resnet encoders are added. Kernels are drawn
with std 1/sqrt(fan_in) so activations keep their scale through the
deep stacks; BatchNorm is moved off identity.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ghost_tpu_torch.models.sr.gfpgan import decoder_channels, unet_channels

_DOWN_CH = (32, 64, 128, 256, 512, 1024, 1024)
_UP_OUT = (1024, 512, 256, 128, 64, 32)
_AAD_CIN = (1024, 1024, 1024, 1024, 512, 256, 128, 64)
_AAD_COUT = (1024, 1024, 1024, 512, 256, 128, 64, 3)
_RESNET_PLANES = (32, 64, 128, 256, 512, 256)


def scaled(ch: int, width: float) -> int:
    """`ghost_tpu/models/aei.py:_scaled`: a channel count at `width`."""
    if width == 1.0:
        return ch
    return max(4, int(round(ch * width / 2)) * 2)


def _kernel(rng, *shape):
    """A torch-layout kernel (out, in, ...) or (in, out, ...) for a
    deconv: std 1/sqrt(prod(shape[1:]))."""
    fan = int(np.prod(shape[1:]))
    return (rng.standard_normal(shape, dtype=np.float32)
            / np.float32(np.sqrt(fan)))


def _vec(rng, n, scale=0.05):
    return rng.standard_normal(n, dtype=np.float32) * np.float32(scale)


def _bn(rng, sd, name, ch):
    sd[f"{name}.weight"] = 1.0 + _vec(rng, ch)
    sd[f"{name}.bias"] = _vec(rng, ch)
    sd[f"{name}.running_mean"] = _vec(rng, ch)
    sd[f"{name}.running_var"] = 1.0 + np.abs(_vec(rng, ch))


def _aad(rng, sd, prefix, c_x, c_attr, c_id=512):
    sd[f"{prefix}.conv1.weight"] = _kernel(rng, c_x, c_attr, 1, 1)
    sd[f"{prefix}.conv1.bias"] = 1.0 + _vec(rng, c_x)
    sd[f"{prefix}.conv2.weight"] = _kernel(rng, c_x, c_attr, 1, 1)
    sd[f"{prefix}.conv2.bias"] = _vec(rng, c_x)
    sd[f"{prefix}.fc1.weight"] = _kernel(rng, c_x, c_id)
    sd[f"{prefix}.fc1.bias"] = 1.0 + _vec(rng, c_x)
    sd[f"{prefix}.fc2.weight"] = _kernel(rng, c_x, c_id)
    sd[f"{prefix}.fc2.bias"] = _vec(rng, c_x)
    sd[f"{prefix}.conv_h.weight"] = _kernel(rng, 1, c_x, 1, 1)
    sd[f"{prefix}.conv_h.bias"] = _vec(rng, 1)


def _unet_encoder(rng, sd, width, backbone):
    """MLAttrEncoder: conv{i} = (conv4x4, BN), deconv{i} = (deconv, bn);
    returns the 8 attribute maps' channels, coarse to fine."""
    down = [scaled(c, width) for c in _DOWN_CH]
    cin = 3
    for i, cout in enumerate(down, 1):
        sd[f"encoder.conv{i}.0.weight"] = _kernel(rng, cout, cin, 4, 4)
        _bn(rng, sd, f"encoder.conv{i}.1", cout)
        cin = cout
    attr = [down[-1]]
    h = down[-1]
    for i, ch in enumerate(_UP_OUT, 1):
        ch = scaled(ch, width)
        sd[f"encoder.deconv{i}.deconv.weight"] = _kernel(rng, h, ch, 4, 4)
        _bn(rng, sd, f"encoder.deconv{i}.bn", ch)
        h = ch + down[-1 - i] if backbone == "unet" else ch
        attr.append(h)
    return attr + [h]


def _resnet_encoder(rng, sd):
    """MLAttrEncoderResnet (full width at any generator width)."""
    sd["encoder.conv0.weight"] = _kernel(rng, 64, 3, 7, 7)
    _bn(rng, sd, "encoder.bn0", 64)
    sd["encoder.conv1.weight"] = _kernel(rng, 64, 64, 7, 7)
    _bn(rng, sd, "encoder.bn1", 64)
    inplanes = 64
    for stage, planes in enumerate(_RESNET_PLANES, 1):
        for b in range(2):
            t = f"encoder.layer{stage}.{b}"
            cin = inplanes if b == 0 else planes * 4
            sd[f"{t}.conv1.weight"] = _kernel(rng, planes, cin, 1, 1)
            sd[f"{t}.conv2.weight"] = _kernel(rng, planes, planes, 3, 3)
            sd[f"{t}.conv3.weight"] = _kernel(rng, planes * 4, planes, 1, 1)
            for n, ch in (("bn1", planes), ("bn2", planes),
                          ("bn3", planes * 4)):
                _bn(rng, sd, f"{t}.{n}", ch)
            if b == 0:
                sd[f"{t}.downsample.0.weight"] = _kernel(rng, planes * 4,
                                                         inplanes, 1, 1)
                _bn(rng, sd, f"{t}.downsample.1", planes * 4)
        inplanes = planes * 4
    return [1024, 2048, 1024, 512, 256, 128, 64, 64]


def aei_state_dict(rng, backbone="unet", num_blocks=2, width=1.0):
    """A `G_{backbone}_{num_blocks}blocks.pth` state dict at `width`."""
    sd = {}
    if backbone == "resnet":
        attr = _resnet_encoder(rng, sd)
    else:
        attr = _unet_encoder(rng, sd, width, backbone)
    c1 = scaled(1024, width)
    sd["generator.up1.weight"] = _kernel(rng, 512, c1, 2, 2)
    sd["generator.up1.bias"] = _vec(rng, c1)
    for k in range(8):
        cin = scaled(_AAD_CIN[k], width)
        cout = _AAD_COUT[k] if k == 7 else scaled(_AAD_COUT[k], width)
        pre = f"generator.AADBlk{k + 1}"
        for b in range(num_blocks):
            out_ch = cin if b < num_blocks - 1 else cout
            _aad(rng, sd, f"{pre}.add_blocks.{3 * b}", cin, attr[k])
            sd[f"{pre}.add_blocks.{3 * b + 2}.weight"] = _kernel(
                rng, out_ch, cin, 3, 3)
        if cin != cout:
            _aad(rng, sd, f"{pre}.last_add_block.0", cin, attr[k])
            sd[f"{pre}.last_add_block.2.weight"] = _kernel(rng, cout, cin,
                                                           3, 3)
    return sd


def arcface_state_dict(rng, layers=(1, 1, 1, 1)):
    """An insightface iresnet `backbone.pth` state dict."""
    sd = {"conv1.weight": _kernel(rng, 64, 3, 3, 3)}
    _bn(rng, sd, "bn1", 64)
    sd["prelu.weight"] = 0.25 + _vec(rng, 64)
    inplanes = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers), 1):
        for b in range(n):
            t = f"layer{stage}.{b}"
            cin = inplanes if b == 0 else planes
            _bn(rng, sd, f"{t}.bn1", cin)
            sd[f"{t}.conv1.weight"] = _kernel(rng, planes, cin, 3, 3)
            _bn(rng, sd, f"{t}.bn2", planes)
            sd[f"{t}.prelu.weight"] = 0.25 + _vec(rng, planes)
            sd[f"{t}.conv2.weight"] = _kernel(rng, planes, planes, 3, 3)
            _bn(rng, sd, f"{t}.bn3", planes)
            if b == 0:
                sd[f"{t}.downsample.0.weight"] = _kernel(rng, planes,
                                                         inplanes, 1, 1)
                _bn(rng, sd, f"{t}.downsample.1", planes)
        inplanes = planes
    _bn(rng, sd, "bn2", 512)
    sd["fc.weight"] = _kernel(rng, 512, 512 * 7 * 7)
    sd["fc.bias"] = _vec(rng, 512)
    _bn(rng, sd, "features", 512)
    return sd


def _conv_b(rng, sd, name, cout, cin, k):
    sd[f"{name}.weight"] = _kernel(rng, cout, cin, k, k)
    sd[f"{name}.bias"] = _vec(rng, cout)


def _style_layer(rng, sd, prefix, cin, cout, k, nsf, noise):
    """A StyleConv (noise=True) or ToRGB of the clean StyleGAN2 decoder:
    its modulated conv (weight (1, cout, cin, k, k), modulation Linear
    with a bias near 1, as upstream inits it), bias (1, cout, 1, 1) and,
    for a StyleConv, the noise weight (1,)."""
    sd[f"{prefix}.modulated_conv.weight"] = _kernel(rng, 1, cout, cin, k, k) \
        * np.float32(np.sqrt(cout))  # std 1/sqrt(cin k k)
    sd[f"{prefix}.modulated_conv.modulation.weight"] = _kernel(rng, cin, nsf)
    sd[f"{prefix}.modulated_conv.modulation.bias"] = 1.0 + _vec(rng, cin)
    if noise:
        sd[f"{prefix}.weight"] = _vec(rng, 1)
    sd[f"{prefix}.bias"] = _vec(rng, cout).reshape(1, cout, 1, 1)


def gfpgan_state_dict(rng, out_size=512, num_style_feat=512,
                      channel_multiplier=2, num_mlp=8, narrow=1.0):
    """A `GFPGANv1.4.pth` state dict (gfpganv1_clean_arch.GFPGANv1Clean's
    names, toRGB.* and stylegan_decoder.style_mlp.* included; the noise
    buffers left out), as `tests/test_enhancers.py:TGFPGANv1Clean`
    holds it."""
    uch = unet_channels(channel_multiplier, narrow)
    dch = decoder_channels(channel_multiplier, narrow)
    log_size = int(np.log2(out_size))
    nsf = num_style_feat
    sd = {}
    _conv_b(rng, sd, "conv_body_first", uch[out_size], 3, 1)
    cin = uch[out_size]
    for i in range(log_size - 2):
        cout = uch[2 ** (log_size - 1 - i)]
        _conv_b(rng, sd, f"conv_body_down.{i}.conv1", cin, cin, 3)
        _conv_b(rng, sd, f"conv_body_down.{i}.conv2", cout, cin, 3)
        sd[f"conv_body_down.{i}.skip.weight"] = _kernel(rng, cout, cin, 1, 1)
        cin = cout
    _conv_b(rng, sd, "final_conv", uch[4], cin, 3)
    sd["final_linear.weight"] = _kernel(rng, (2 * log_size - 2) * nsf,
                                        uch[4] * 16)
    sd["final_linear.bias"] = _vec(rng, (2 * log_size - 2) * nsf)
    cin = uch[4]
    for i in range(log_size - 2):
        cout = uch[2 ** (i + 3)]
        _conv_b(rng, sd, f"conv_body_up.{i}.conv1", cin, cin, 3)
        _conv_b(rng, sd, f"conv_body_up.{i}.conv2", cout, cin, 3)
        sd[f"conv_body_up.{i}.skip.weight"] = _kernel(rng, cout, cin, 1, 1)
        for kind in ("scale", "shift"):
            _conv_b(rng, sd, f"condition_{kind}.{i}.0", cout, cout, 3)
            _conv_b(rng, sd, f"condition_{kind}.{i}.2", cout, cout, 3)
        _conv_b(rng, sd, f"toRGB.{i}", 3, cout, 1)
        cin = cout
    dec = "stylegan_decoder"
    for j in range(num_mlp):
        mlp = f"{dec}.style_mlp.{2 * j}"
        sd[f"{mlp}.weight"] = _kernel(rng, nsf, nsf)
        sd[f"{mlp}.bias"] = _vec(rng, nsf)
    sd[f"{dec}.constant_input.weight"] = rng.standard_normal(
        (1, dch[4], 4, 4), dtype=np.float32)
    _style_layer(rng, sd, f"{dec}.style_conv1", dch[4], dch[4], 3, nsf, True)
    _style_layer(rng, sd, f"{dec}.to_rgb1", dch[4], 3, 1, nsf, False)
    cin = dch[4]
    for s in range(log_size - 2):
        cout = dch[2 ** (s + 3)]
        _style_layer(rng, sd, f"{dec}.style_convs.{2 * s}", cin, cout, 3,
                     nsf, True)
        _style_layer(rng, sd, f"{dec}.style_convs.{2 * s + 1}", cout, cout,
                     3, nsf, True)
        _style_layer(rng, sd, f"{dec}.to_rgbs.{s}", cout, 3, 1, nsf, False)
        cin = cout
    return sd


def rrdb_state_dict(rng, num_feat=64, num_block=23, num_grow_ch=32,
                    scale=4):
    """A `RealESRGAN_x4plus.pth` state dict (basicsr rrdbnet_arch.RRDBNet's
    names), as `tests/test_enhancers.py:TorchRRDBNet` holds it."""
    nf, gc = num_feat, num_grow_ch
    sd = {}
    _conv_b(rng, sd, "conv_first", nf, 3 * {4: 1, 2: 4, 1: 16}[scale], 3)
    for i in range(num_block):
        for m in (1, 2, 3):
            for k in range(1, 6):
                _conv_b(rng, sd, f"body.{i}.rdb{m}.conv{k}",
                        nf if k == 5 else gc, nf + (k - 1) * gc, 3)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        _conv_b(rng, sd, name, nf, nf, 3)
    _conv_b(rng, sd, "conv_last", 3, nf, 3)
    return sd


def srvgg_state_dict(rng, num_feat=64, num_conv=32, upscale=4):
    """A `realesr-general-x4v3.pth` state dict (realesrgan
    srvgg_arch.SRVGGNetCompact's flat `body` list: conv / PReLU
    alternating, the last conv at 2 * (num_conv + 1)), as
    `tests/test_enhancers.py:TorchSRVGG` holds it."""
    sd = {}
    for i in range(num_conv + 1):
        _conv_b(rng, sd, f"body.{2 * i}", num_feat, 3 if i == 0 else num_feat,
                3)
        sd[f"body.{2 * i + 1}.weight"] = 0.25 + _vec(rng, num_feat)
    _conv_b(rng, sd, f"body.{2 * (num_conv + 1)}", 3 * upscale ** 2,
            num_feat, 3)
    return sd


def save_pth(path, sd, wrapper: str | None = None) -> None:
    """torch.save a numpy state dict as tensors, as the reference ships
    it; basicsr-family checkpoints (GFPGAN, Real-ESRGAN) nest it under
    `wrapper` ("params_ema")."""
    import torch

    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save(tensors if wrapper is None else {wrapper: tensors}, str(path))


def write_media(d, rng, hw, n_frames, fps=25.0) -> dict:
    """Source and target pngs and an mp4 of `n_frames` (mp4v) of smooth
    seeded images of `hw` (gradients that move from frame to frame, with
    noise of +-20 grey levels) in directory `d`; returns their paths."""
    from ghost_tpu_torch.pipeline.image import write_image_rgb
    from ghost_tpu_torch.pipeline.video import VideoChunkWriter

    yy, xx = np.mgrid[:hw[0], :hw[1]]

    def image(i):
        base = np.stack([(xx + 13 * i) % 256, (yy * 2 + 7 * i) % 256,
                         (xx + yy) % 256], -1)
        noise = rng.integers(-20, 21, base.shape)
        return np.clip(base + noise, 0, 255).astype(np.uint8)

    paths = {"src": str(Path(d, "src.png")), "tgt": str(Path(d, "tgt.png")),
             "mp4": str(Path(d, "in.mp4"))}
    write_image_rgb(paths["src"], image(0))
    write_image_rgb(paths["tgt"], image(1))
    writer = VideoChunkWriter(paths["mp4"], fps)
    for i in range(n_frames):
        writer.write(image(i)[None])
    writer.close()
    return paths
