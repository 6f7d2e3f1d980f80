"""Seeded inputs of the swap CLI, made with numpy: state dicts with the
reference's parameter names and shapes (reference network/AEI_Net.py,
network/AADLayer.py, network/resnet.py, insightface iresnet), what
`G_*.pth` and `backbone.pth` hold, at any generator width; and a source
png, a target png and an mp4 clip. No jax here: `chip_smoke.py` and the
card tests use them too.

The names follow `tests/test_convert.py:48-75,109-134` (unet AEI-Net,
iresnet); the linknet and resnet encoders are added. Kernels are drawn
with std 1/sqrt(fan_in) so activations keep their scale through the
deep stacks; BatchNorm is moved off identity.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

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


def save_pth(path, sd) -> None:
    """torch.save a numpy state dict as tensors, as the reference ships it."""
    import torch

    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))


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
