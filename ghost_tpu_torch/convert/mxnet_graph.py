"""Minimal MXNet symbol-graph interpreter (inference only), mirroring
`ghost_tpu/convert/mxnet_graph.py`.

Executes the op set of the reference's ``2d106det`` landmark checkpoint
(`reference coordinate_reg/model/2d106det-symbol.json`; loaded by
coordinate_reg/image_infer.py:96-141): null, _minus_scalar,
_mul_scalar, Convolution (grouped, no_bias), BatchNorm (fix_gamma,
inference stats, eps 1e-3 unless the node says otherwise),
LeakyReLU(act_type=prelu), Flatten, FullyConnected.

This is an execution path INDEPENDENT of `models.landmark_mxnet
.Landmark106Det`: NCHW, driven by the graph JSON, MXNet's semantics op
by op, in float32 on `device` (the card unless the caller asks for the
CPU; with no card the constructor raises). The round-trip tests and
`chip_smoke.py` hold the hand-written net against it.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def _tuple_attr(attrs, key, default=None):
    v = attrs.get(key)
    if v is None:
        return default
    return tuple(int(x) for x in v.strip("()").split(",") if x.strip())


class MXNetGraphInterpreter:
    """Interpret an MXNet symbol JSON over dense f32 params."""

    def __init__(self, symbol_path: str, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MXNetGraphInterpreter: no CUDA card; pass "
                               "device='cpu' to run on the CPU")
        with open(symbol_path) as f:
            g = json.load(f)
        self.nodes: List[dict] = g["nodes"]
        self.heads = [h[0] for h in g["heads"]]

    # -------------------------------------------------- shape inference
    def param_shapes(self, data_shape=(1, 3, 192, 192)) -> Dict[str, tuple]:
        """Walk the graph once, tracking NCHW shapes, to derive every
        parameter's shape (enough for the op set above)."""
        shapes: Dict[int, tuple] = {}
        out: Dict[str, tuple] = {}
        for i, n in enumerate(self.nodes):
            op, attrs = n["op"], n.get("attrs", {})
            ins = [e[0] for e in n["inputs"]]
            if op == "null":
                if n["name"] == "data":
                    shapes[i] = tuple(data_shape)
                continue
            if op in ("_minus_scalar", "_mul_scalar"):
                shapes[i] = shapes[ins[0]]
            elif op == "Convolution":
                b, c, h, w = shapes[ins[0]]
                kh, kw = _tuple_attr(attrs, "kernel")
                sh, sw = _tuple_attr(attrs, "stride", (1, 1))
                ph, pw = _tuple_attr(attrs, "pad", (0, 0))
                nf = int(attrs["num_filter"])
                ng = int(attrs.get("num_group", "1"))
                out[self.nodes[ins[1]]["name"]] = (nf, c // ng, kh, kw)
                if attrs.get("no_bias", "False") != "True":
                    out[self.nodes[ins[2]]["name"]] = (nf,)
                shapes[i] = (b, nf, (h + 2 * ph - kh) // sh + 1,
                             (w + 2 * pw - kw) // sw + 1)
            elif op == "BatchNorm":
                c = shapes[ins[0]][1]
                for j in ins[1:]:
                    out[self.nodes[j]["name"]] = (c,)
                shapes[i] = shapes[ins[0]]
            elif op == "LeakyReLU":
                if len(ins) > 1:  # prelu gamma
                    out[self.nodes[ins[1]]["name"]] = (shapes[ins[0]][1],)
                shapes[i] = shapes[ins[0]]
            elif op == "Flatten":
                s = shapes[ins[0]]
                shapes[i] = (s[0], int(np.prod(s[1:])))
            elif op == "FullyConnected":
                nh = int(attrs["num_hidden"])
                s = shapes[ins[0]]
                flat = int(np.prod(s[1:]))
                out[self.nodes[ins[1]]["name"]] = (nh, flat)
                if attrs.get("no_bias", "False") != "True":
                    out[self.nodes[ins[2]]["name"]] = (nh,)
                shapes[i] = (s[0], nh)
            else:
                raise NotImplementedError(f"shape inference for {op}")
        return out

    def init_params(self, seed: int = 0,
                    data_shape=(1, 3, 192, 192)) -> Dict[str, np.ndarray]:
        """Random f32 params for every graph input (BN vars positive),
        numpy-seeded: the same draws as the JAX package's interpreter."""
        rng = np.random.default_rng(seed)
        params = {}
        for name, shape in self.param_shapes(data_shape).items():
            if name.endswith("moving_var"):
                params[name] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
            elif name.endswith("_gamma") and "relu" in name:
                params[name] = rng.uniform(0.05, 0.45, shape).astype(np.float32)
            elif len(shape) >= 2:  # conv / fc weights: fan-in scaled so
                # the 28-conv forward stays O(1) under random stats
                fan_in = int(np.prod(shape[1:]))
                params[name] = rng.normal(
                    0, 1.0 / np.sqrt(fan_in), shape).astype(np.float32)
            else:
                params[name] = rng.normal(0, 0.2, shape).astype(np.float32)
        return params

    # --------------------------------------------------------- execution
    def _tensor(self, a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return a.to(self.device, torch.float32)

    @torch.no_grad()
    def run(self, params: Dict[str, np.ndarray], data) -> torch.Tensor:
        """data (B,C,H,W) -> the head output, an f32 tensor on the
        interpreter's device. `params` keys are bare names (no arg:/aux:
        prefixes); values numpy arrays or tensors."""
        vals: Dict[int, torch.Tensor] = {}
        for i, n in enumerate(self.nodes):
            op, attrs = n["op"], n.get("attrs", {})
            ins = [e[0] for e in n["inputs"]]
            if op == "null":
                if n["name"] == "data":
                    vals[i] = self._tensor(data)
                elif n["name"] in params:
                    vals[i] = self._tensor(params[n["name"]])
                continue
            x = vals[ins[0]]
            if op == "_minus_scalar":
                vals[i] = x - float(attrs["scalar"])
            elif op == "_mul_scalar":
                vals[i] = x * float(attrs["scalar"])
            elif op == "Convolution":
                b = (vals[ins[2]] if attrs.get("no_bias", "False") != "True"
                     else None)
                vals[i] = F.conv2d(
                    x, vals[ins[1]], b,
                    stride=_tuple_attr(attrs, "stride", (1, 1)),
                    padding=_tuple_attr(attrs, "pad", (0, 0)),
                    groups=int(attrs.get("num_group", "1")))
            elif op == "BatchNorm":
                # inputs: data, gamma, beta, moving_mean, moving_var
                # (ndarray.cc BatchNorm): eps default 1e-3; fix_gamma
                # freezes gamma at 1 regardless of the stored array
                gamma, beta = vals[ins[1]], vals[ins[2]]
                mean, var = vals[ins[3]], vals[ins[4]]
                if attrs.get("fix_gamma", "False") == "True":
                    gamma = torch.ones_like(gamma)
                eps = float(attrs.get("eps", "1e-3"))
                sh = (1, -1, 1, 1)
                vals[i] = (x - mean.reshape(sh)) * (
                    gamma.reshape(sh) /
                    torch.sqrt(var.reshape(sh) + eps)) + beta.reshape(sh)
            elif op == "LeakyReLU":
                if attrs.get("act_type") == "prelu":
                    g = vals[ins[1]].reshape(1, -1, 1, 1)
                    vals[i] = torch.where(x > 0, x, g * x)
                else:
                    slope = float(attrs.get("slope", "0.25"))
                    vals[i] = torch.where(x > 0, x, slope * x)
            elif op == "Flatten":
                vals[i] = x.reshape(x.shape[0], -1)
            elif op == "FullyConnected":
                b = (vals[ins[2]] if attrs.get("no_bias", "False") != "True"
                     else None)
                vals[i] = F.linear(x.reshape(x.shape[0], -1), vals[ins[1]], b)
            else:
                raise NotImplementedError(f"op {op}")
        return vals[self.heads[0]]
