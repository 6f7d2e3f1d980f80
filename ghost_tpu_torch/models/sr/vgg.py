"""VGG19 feature extractor for the perceptual losses, mirroring
`ghost_tpu/models/sr/vgg.py`.

The reference uses torchvision's pretrained VGG19 sliced at relu1_1,
relu2_1, relu3_1, relu4_1 and relu5_1 (reference
models/networks/architecture.py:95-125) for VGGLoss
(models/networks/loss.py:102-116) and MultiScalePerceptualColorLoss
(models/MultiScalePerceptualColorLoss.py:6-37). Same topology here: the
convs are `nn.layers.Conv` modules named `conv{i}` (cuDNN: the JAX
package runs them outside any Pallas kernel), 2x2 max pools, NHWC in and
out; weights come from a torchvision state dict through
`convert_vgg19_features` and the weight bridge.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import Conv, to_nchw, to_nhwc

# torchvision vgg19.features: conv widths and max pools ("M")
_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
# the convs whose relu ends a slice: relu1_1 .. relu5_1
_SLICE_AFTER_CONV = (0, 2, 4, 8, 12)


class VGG19Features(nn.Module):
    """(B,H,W,3) imagenet-normalized -> the 5 relu slices, NHWC, in the
    policy's compute dtype. conv13-conv15 hold torchvision's weights (the
    bridge fills every conv) and are not run."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.policy = policy
        cin, idx = 3, 0
        for item in _CFG:
            if item == "M":
                continue
            setattr(self, f"conv{idx}", Conv(cin, item, 3, padding=1,
                                             dtype=policy.compute_dtype,
                                             device=device))
            cin, idx = item, idx + 1

    def forward(self, x):
        x = to_nchw(x.to(self.policy.compute_dtype).contiguous())
        feats, idx = [], 0
        for item in _CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = torch.relu(getattr(self, f"conv{idx}")(x))
            if idx in _SLICE_AFTER_CONV:
                feats.append(to_nhwc(x))
                if idx == _SLICE_AFTER_CONV[-1]:
                    # the last three convs and the last pool feed no
                    # slice (XLA drops them from the JAX module's program)
                    return feats
            idx += 1


def convert_vgg19_features(sd: Mapping[str, np.ndarray]) -> Dict:
    """torchvision vgg19 state dict ('features.N.weight') -> the flax
    variables tree of `ghost_tpu/models/sr/vgg.py` (HWIO kernels under
    `conv{i}/Conv_0`), which `convert.from_jax.load_flax_variables`
    reads."""
    params: Dict = {}
    conv_idx = torch_idx = 0
    for item in _CFG:
        if item == "M":
            torch_idx += 1  # the pool layer
            continue
        name = f"features.{torch_idx}"
        params[f"conv{conv_idx}"] = {"Conv_0": {
            "kernel": np.transpose(np.asarray(sd[f"{name}.weight"]),
                                   (2, 3, 1, 0)),
            "bias": np.asarray(sd[f"{name}.bias"]),
        }}
        conv_idx += 1
        torch_idx += 2  # conv + relu
    return {"params": params}


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize_pm1(x_pm1):
    """[-1,1] NHWC image -> imagenet-normalized (the usual VGG input)."""
    mean = torch.tensor(IMAGENET_MEAN, device=x_pm1.device)
    std = torch.tensor(IMAGENET_STD, device=x_pm1.device)
    return (x_pm1 * 0.5 + 0.5 - mean) / std
