"""Weight bridge: a flax variables tree -> the port's modules.

Leaves are numpy (or array-like) values. Paths are the flax module
names, which the port's modules mirror as attribute names; the wrapper
levels that `ghost_tpu/nn/layers.py` adds (`Conv_0`, `Dense_0`,
`BatchNorm_0`) are stripped. Layouts (the reverse of
`ghost_tpu/convert/onnx_emit.py:12-16`):

  Conv kernel     HWIO (kh,kw,cin/g,cout) -> OIHW, transpose(3,2,0,1)
                  (depthwise (3,3,1,C) -> (C,1,3,3) by the same rule)
  ConvTranspose   (kh,kw,cin,cout) -> (cin,cout,kh,kw), transpose(2,3,0,1)
  Dense kernel    (in,out) -> (out,in)
  BatchNorm       scale/bias -> weight/bias; batch_stats mean/var ->
                  running_mean/running_var
  PReLU           alpha -> alpha
  MultiheadAttention  ln_scale/ln_bias at the module's own level (its
                  projections are Dense layers)
  WeightNormDense v (in,out) -> v as it is; g, bias
  MLP             dense{i} are Dense layers
  Conv3x3 kernel  HWIO kept as it is (the layout S2 reads); bias
  SRVGGNetCompact prelu_{i}, bare params at the module's own level
  SimplifiedLIP   in_scale/in_bias, bare params at its own level
  SpectralConv    kernel -> OIHW as Conv (its (cin, kh, kw) flatten is
                  the power-iteration order); bias; 'spectral' u, v
  BatchNorm       with affine=False (SPADE's pfn): batch_stats only
  GroupNorm       scale/bias -> weight/bias
  SCRFDHeadShared scale{level}, bare params at the module's own level
  ModulatedConv   weight HWIO (k,k,cin,cout) -> OIHW, transpose(3,2,0,1)
  StyleConv       noise_weight (1,) and bias (cout,), bare params at the
                  module's own level, as they are
  ToRGB           bias (3,), a bare param, as it is
  StyleGAN2CSFT   constant_input, a bare param kept in flax's NHWC
                  layout (1,4,4,C) (the decoder runs NHWC)

Collections read: params, batch_stats, spectral. The bridge is strict: every port tensor is filled exactly once and
every flax leaf is used exactly once, or it raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ghost_tpu_torch.models.scrfd_v1e import SCRFDHeadShared
from ghost_tpu_torch.models.sr.generator import SimplifiedLIP
from ghost_tpu_torch.models.sr.gfpgan import (ModulatedConv, StyleConv,
                                              StyleGAN2CSFT, ToRGB)
from ghost_tpu_torch.models.sr.spade import SpectralConv
from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact
from ghost_tpu_torch.nn.layers import (BatchNorm, Conv, Conv3x3, ConvTranspose,
                                       Dense, GroupNorm, PReLU)
from ghost_tpu_torch.nn.modules import MultiheadAttention, WeightNormDense

_WRAPPERS = frozenset({"Conv_0", "Dense_0", "BatchNorm_0"})

_LEAF_MAP = {
    (Conv, "kernel"): ("weight", lambda v: v.transpose(3, 2, 0, 1)),
    (Conv, "bias"): ("bias", None),
    (ConvTranspose, "kernel"): ("weight", lambda v: v.transpose(2, 3, 0, 1)),
    (ConvTranspose, "bias"): ("bias", None),
    (Dense, "kernel"): ("weight", lambda v: v.T),
    (Dense, "bias"): ("bias", None),
    (BatchNorm, "scale"): ("weight", None),
    (BatchNorm, "bias"): ("bias", None),
    (BatchNorm, "mean"): ("running_mean", None),
    (BatchNorm, "var"): ("running_var", None),
    (GroupNorm, "scale"): ("weight", None),
    (GroupNorm, "bias"): ("bias", None),
    (PReLU, "alpha"): ("alpha", None),
    (MultiheadAttention, "ln_scale"): ("ln_scale", None),
    (MultiheadAttention, "ln_bias"): ("ln_bias", None),
    (WeightNormDense, "v"): ("v", None),
    (WeightNormDense, "g"): ("g", None),
    (WeightNormDense, "bias"): ("bias", None),
    (Conv3x3, "kernel"): ("weight", None),
    (Conv3x3, "bias"): ("bias", None),
    (SpectralConv, "kernel"): ("weight", lambda v: v.transpose(3, 2, 0, 1)),
    (SpectralConv, "bias"): ("bias", None),
    (SpectralConv, "u"): ("u", None),
    (SpectralConv, "v"): ("v", None),
    (ModulatedConv, "weight"): ("weight", lambda v: v.transpose(3, 2, 0, 1)),
}
# modules whose own bare parameters are flax leaves of the same name
_BARE_PARAMS = (SRVGGNetCompact, SimplifiedLIP, SCRFDHeadShared, StyleConv,
                ToRGB, StyleGAN2CSFT)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_flax_variables(module: nn.Module, variables) -> nn.Module:
    """Copy a flax `{"params": ..., "batch_stats": ...}` tree into
    `module` in place and return it."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    filled = set()
    for collection in ("params", "batch_stats", "spectral"):
        for path, value in _flatten(variables.get(collection, {})):
            names = [p for p in path if p not in _WRAPPERS]
            where = "/".join(path)
            mod_name = ".".join(names[:-1])
            try:
                mod = module.get_submodule(mod_name)
            except AttributeError as e:
                raise KeyError(f"flax leaf {collection}/{where}: no port "
                               f"module {mod_name!r}") from e
            rule = _LEAF_MAP.get((type(mod), names[-1]))
            if (rule is None and isinstance(mod, _BARE_PARAMS)
                    and names[-1] in dict(mod.named_parameters(recurse=False))):
                rule = (names[-1], None)
            if rule is None:
                raise KeyError(f"flax leaf {collection}/{where}: "
                               f"{type(mod).__name__} has no {names[-1]!r}")
            attr, fn = rule
            key = f"{mod_name}.{attr}" if mod_name else attr
            if key in filled:
                raise KeyError(f"port tensor {key} filled twice "
                               f"(again by {collection}/{where})")
            arr = np.array(value, dtype=np.float32)
            if fn is not None:
                arr = fn(arr)
            dst = targets[key]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{collection}/{where}: shape {arr.shape} "
                                 f"does not fit {key} {tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.ascontiguousarray(arr))
                          .reshape(arr.shape))  # a 0-d leaf stays 0-d
            filled.add(key)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"port tensors left unfilled: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return module
