"""2d106det landmark net, the reference's exact MXNet topology, mirroring
`ghost_tpu/models/landmark_mxnet.py`.

The reference's 106-point landmarker is insightface's `2d106det` MXNet
model (reference coordinate_reg/image_infer.py:96-141):

  (x - 127.5) * 0.0078125
  conv_1: 3x3 s2 f16 + BN(fix_gamma) + PReLU            192 -> 96
  conv_2..14: depthwise 3x3 (+BN+PReLU) then pointwise 1x1 (+BN+PReLU)
      filters 16/32, 32/64, 64/64, 64/128, 128/128, 128/256 x6, 256/512,
      512/512; strides 2 at conv_3, conv_5, conv_7, conv_13   96 -> 6
  conv_15: 3x3 s2 pad1 f64 + BN + PReLU                       6 -> 3
  Flatten -> FC 212  (decode: (p + 1) * 96, image_infer.py:147-151)

MXNet BatchNorm semantics: eps 1e-3, and fix_gamma=True freezes gamma at
1 (the stored gamma is ignored): `nn.layers.BatchNorm(use_scale=False)`.
Depthwise convs are `Conv(groups=C)`. The modules run NCHW in
channels_last memory and take and return NHWC like the JAX model; the
FC reads the (H, W, C) flatten of the JAX model's NHWC reshape.

`convert_2d106det_params` writes the flax variables tree (the JAX
package's layout), which `convert/from_jax.py:load_flax_variables`
loads; `parse_symbol_plan` reads the Convolution plan of a symbol JSON
for the structure check against `conv_plan()`.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import (BatchNorm, Conv, Dense, PReLU, to_nchw,
                                       to_nhwc)

# (dw_filters, pw_filters, dw_stride) for conv_2..conv_14
_PAIRS: Tuple[Tuple[int, int, int], ...] = (
    (16, 32, 1), (32, 64, 2), (64, 64, 1), (64, 128, 2), (128, 128, 1),
    (128, 256, 2), (256, 256, 1), (256, 256, 1), (256, 256, 1),
    (256, 256, 1), (256, 256, 1), (256, 512, 2), (512, 512, 1),
)


def conv_plan() -> List[Tuple[str, Tuple[int, int], int, int, int, int]]:
    """[(name, kernel, stride, pad, filters, groups)]: the full
    Convolution sequence of the symbol graph, for the structure test."""
    plan = [("conv_1_conv2d", (3, 3), 2, 1, 16, 1)]
    for i, (dw, pw, s) in enumerate(_PAIRS, start=2):
        plan.append((f"conv_{i}_dw_conv2d", (3, 3), s, 1, dw, dw))
        plan.append((f"conv_{i}_conv2d", (1, 1), 1, 0, pw, 1))
    plan.append(("conv_15_conv2d", (3, 3), 2, 1, 64, 1))
    return plan


def parse_symbol_plan(path: str):
    """Extract the same plan from an MXNet symbol JSON."""
    with open(path) as f:
        nodes = json.load(f)["nodes"]
    plan = []
    for n in nodes:
        if n["op"] == "Convolution":
            a = n["attrs"]
            plan.append((
                n["name"],
                tuple(int(x) for x in a["kernel"].strip("()").split(",")),
                int(a["stride"].strip("()").split(",")[0]),
                int(a.get("pad", "(0, 0)").strip("()").split(",")[0]),
                int(a["num_filter"]),
                int(a["num_group"]),
            ))
    return plan


class _ConvBlock(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3, no scale) + PReLU."""

    def __init__(self, cin, features, kernel=3, stride=1, padding=1,
                 groups=1, policy: Policy = DEFAULT_POLICY,
                 train: bool = False, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.conv = Conv(cin, features, kernel, stride, padding=padding,
                         use_bias=False, groups=groups, dtype=cd,
                         device=device)
        self.bn = BatchNorm(features, eps=1e-3, dtype=cd, device=device,
                            train=train, use_scale=False)
        self.act = PReLU(features, device=device)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Landmark106Det(nn.Module):
    """(B,192,192,3) raw-pixel RGB (NHWC) -> (B,106,2) raw net coords
    (decode with (p+1)*96 like image_infer.py:147-151)."""

    def __init__(self, policy: Policy = DEFAULT_POLICY, train: bool = False,
                 device=None):
        super().__init__()
        self.policy = policy

        def block(name, cin, *args):
            setattr(self, name, _ConvBlock(cin, *args, policy=policy,
                                           train=train, device=device))

        block("conv_1", 3, 16, 3, 2, 1, 1)
        cin = 16
        self.names = ["conv_1"]
        for i, (dw, pw, s) in enumerate(_PAIRS, start=2):
            block(f"conv_{i}_dw", cin, dw, 3, s, 1, dw)
            block(f"conv_{i}", dw, pw, 1, 1, 0, 1)
            self.names += [f"conv_{i}_dw", f"conv_{i}"]
            cin = pw
        block("conv_15", cin, 64, 3, 2, 1, 1)
        self.names.append("conv_15")
        self.fc1 = Dense(64 * 3 * 3, 212, dtype=torch.float32, device=device)

    def forward(self, x):
        cd = self.policy.compute_dtype
        x = to_nchw(((x.to(cd) - 127.5) * 0.0078125).contiguous())
        for name in self.names:
            x = getattr(self, name)(x)
        # the JAX model's NHWC reshape: (H, W, C) order
        x = to_nhwc(x).reshape(x.shape[0], -1).float()
        return self.fc1(x).reshape(-1, 106, 2)


def convert_2d106det_params(params: Dict[str, np.ndarray],
                            aux: Dict[str, np.ndarray] | None = None):
    """MXNet arg/aux dict -> Landmark106Det variables (the flax tree).

    Accepts either a single dict with 'arg:'/'aux:' prefixed keys (the
    mx.nd.load layout) or separate arg/aux dicts. MXNet conv weights
    are (O, I/g, kh, kw); the flax tree holds (kh, kw, I/g, O)."""
    if aux is None:
        arg = {k.split(":", 1)[1]: v for k, v in params.items()
               if k.startswith("arg:")}
        aux = {k.split(":", 1)[1]: v for k, v in params.items()
               if k.startswith("aux:")}
        if not arg:
            arg = dict(params)
    else:
        arg = dict(params)

    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}

    def block(flax_name, mx_conv, mx_bn, mx_act):
        p[flax_name] = {
            "conv": {"Conv_0": {
                "kernel": np.transpose(arg[f"{mx_conv}_weight"], (2, 3, 1, 0))
            }},
            "bn": {"BatchNorm_0": {"bias": arg[f"{mx_bn}_beta"]}},
            "act": {"alpha": arg[f"{mx_act}_gamma"].reshape(-1)},
        }
        s[flax_name] = {"bn": {"BatchNorm_0": {
            "mean": aux[f"{mx_bn}_moving_mean"],
            "var": aux[f"{mx_bn}_moving_var"],
        }}}

    block("conv_1", "conv_1_conv2d", "conv_1_batchnorm", "conv_1_relu")
    for i in range(2, 15):
        block(f"conv_{i}_dw", f"conv_{i}_dw_conv2d",
              f"conv_{i}_dw_batchnorm", f"conv_{i}_dw_relu")
        block(f"conv_{i}", f"conv_{i}_conv2d",
              f"conv_{i}_batchnorm", f"conv_{i}_relu")
    block("conv_15", "conv_15_conv2d", "conv_15_batchnorm", "conv_15_relu")
    # MXNet Flatten runs over NCHW -> the FC input dim is ordered
    # (C=64, H=3, W=3); the model's flatten orders it (H, W, C)
    w = arg["fc1_weight"].reshape(212, 64, 3, 3)
    w = np.transpose(w, (0, 2, 3, 1)).reshape(212, -1)
    p["fc1"] = {"kernel": np.transpose(w, (1, 0)), "bias": arg["fc1_bias"]}
    return {"params": p, "batch_stats": s}
