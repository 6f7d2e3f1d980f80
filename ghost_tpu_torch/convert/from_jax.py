"""Weight bridge: a flax variables tree -> the port's modules, and back.

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
  ConvEncoder     fc_mu/fc_var, bare flax Dense layers (no wrapper level)
  SAM             bare params at their module's own level, as they are:
                  ImageEncoderViT pos_embed (1,g,g,C) in flax's NHWC
                  layout, VitAttention rel_pos_h/rel_pos_w,
                  PromptEncoder pe_gauss, point_embed_{i}, not_a_point,
                  no_mask_embed, MaskDecoder iou_token/mask_tokens;
                  LayerNorm2d's and the bare flax LayerNorms' scale/bias
  Landmark106Det  fc1, a bare flax Dense (no wrapper level); its
                  BatchNorms have no scale (MXNet's fix_gamma)
  ArcMarginHead   weight (D, C), a bare param at the module's own level

Collections read: params, batch_stats, spectral. The bridge is strict: every port tensor is filled exactly once and
every flax leaf is used exactly once, or it raises.

`flax_variables(module)` is its exact inverse: every parameter and
buffer of the module written once, as a float32 numpy leaf, under its
flax path (the wrapper level `Conv_0` restored under an `nn.layers.Conv`
or `Conv3x3`, `Dense_0` under a `Dense`, `BatchNorm_0` under a
`BatchNorm`, except for the layers the JAX modules build as bare flax
layers, `_BARE_LAYERS`), its layout turned back (OIHW -> HWIO, Dense
transposed back, ConvTranspose's and Conv3x3's kernels and bare
parameters as they are), BatchNorm's running statistics in
`batch_stats` and the spectral-norm pairs in `spectral`. What
`save_msgpack` writes of it is what the JAX package's modules read.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ghost_tpu_torch.models.arcface import IResNet
from ghost_tpu_torch.models.landmark import Landmark106
from ghost_tpu_torch.models.landmark_mxnet import Landmark106Det
from ghost_tpu_torch.models.sam import (ImageEncoderViT, LayerNorm,
                                        LayerNorm2d, MaskDecoder,
                                        PromptEncoder, VitAttention)
from ghost_tpu_torch.models.scrfd_v1e import SCRFDHeadShared
from ghost_tpu_torch.models.sr.encoder import ConvEncoder
from ghost_tpu_torch.models.sr.generator import SimplifiedLIP
from ghost_tpu_torch.models.sr.gfpgan import (ModulatedConv, StyleConv,
                                              StyleGAN2CSFT, ToRGB)
from ghost_tpu_torch.models.sr.spade import SPADE, SpectralConv
from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact
from ghost_tpu_torch.nn.layers import (BatchNorm, Conv, Conv3x3, ConvTranspose,
                                       Dense, GroupNorm, PReLU)
from ghost_tpu_torch.nn.modules import (MLP, MultiheadAttention,
                                        WeightNormDense)
from ghost_tpu_torch.train.arcface_margin import ArcMarginHead

_WRAPPERS = frozenset({"Conv_0", "Dense_0", "BatchNorm_0"})
# the wrapper level flax's tree holds under each of nn.layers' layers
_WRAPPER_OF = {Conv: "Conv_0", Conv3x3: "Conv_0", Dense: "Dense_0",
               BatchNorm: "BatchNorm_0"}

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
# layers the JAX modules build as bare flax layers (no wrapper level):
# (parent module, attribute); and every `dense{i}` of an MLP
_BARE_LAYERS = frozenset(
    [(SPADE, n) for n in ("pfn", "mlp_shared", "mlp_gamma", "mlp_beta")]
    + [(MultiheadAttention, n) for n in ("q_proj", "k_proj", "v_proj",
                                         "out_proj")]
    + [(IResNet, "features"), (Landmark106, "fc"), (ConvEncoder, "fc_mu"),
       (ConvEncoder, "fc_var"), (Landmark106Det, "fc1")])
# the inverse of each layout change of _LEAF_MAP
_UNDO = {(Conv, "kernel"): lambda v: v.transpose(2, 3, 1, 0),
         (ConvTranspose, "kernel"): lambda v: v.transpose(2, 3, 0, 1),
         (Dense, "kernel"): lambda v: v.T,
         (SpectralConv, "kernel"): lambda v: v.transpose(2, 3, 1, 0),
         (ModulatedConv, "weight"): lambda v: v.transpose(2, 3, 1, 0)}
_COLLECTION = {"mean": "batch_stats", "var": "batch_stats", "u": "spectral",
               "v": "spectral"}
# modules whose own bare parameters are flax leaves of the same name
_BARE_PARAMS = (SRVGGNetCompact, SimplifiedLIP, SCRFDHeadShared, StyleConv,
                ToRGB, StyleGAN2CSFT, ImageEncoderViT, VitAttention,
                PromptEncoder, MaskDecoder, LayerNorm2d, LayerNorm,
                ArcMarginHead)


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


def _is_bare(module: nn.Module, mod_name: str) -> bool:
    """Whether the layer at `mod_name` mirrors a bare flax layer (no
    wrapper level in the tree)."""
    parent_name, _, child = mod_name.rpartition(".")
    parent = module.get_submodule(parent_name)
    return ((type(parent), child) in _BARE_LAYERS
            or (isinstance(parent, MLP) and child.startswith("dense")))


def _flax_leaf(mod: nn.Module, attr: str):
    """(flax leaf name, layout fn) of port tensor `attr` of `mod`."""
    for (kind, leaf), (name, _) in _LEAF_MAP.items():
        if type(mod) is kind and name == attr:
            return leaf, _UNDO.get((kind, leaf))
    if isinstance(mod, _BARE_PARAMS) and attr in dict(
            mod.named_parameters(recurse=False)):
        return attr, None
    raise KeyError(f"{type(mod).__name__}.{attr} has no flax leaf")


def flax_leaf_path(module: nn.Module, key: str):
    """(collection, flax path, layout fn) of the port tensor `key` (a
    name of `module.named_parameters()` or `named_buffers()`): the path
    runs from the collection's root to the leaf's own name, and fn (or
    None) turns the tensor's layout into the flax leaf's (numpy)."""
    mod_name, _, attr = key.rpartition(".")
    mod = module.get_submodule(mod_name)
    leaf, fn = _flax_leaf(mod, attr)
    collection = "params"
    if isinstance(mod, (BatchNorm, SpectralConv)):
        collection = _COLLECTION.get(leaf, "params")
    path = mod_name.split(".") if mod_name else []
    if type(mod) in _WRAPPER_OF and not _is_bare(module, mod_name):
        path.append(_WRAPPER_OF[type(mod)])
    return collection, path + [leaf], fn


def flax_variables(module: nn.Module) -> dict:
    """The flax variables tree of `module`, the inverse of
    `load_flax_variables`: {"params": ..., and "batch_stats" /
    "spectral" where the module holds them}, float32 numpy leaves."""
    tree: dict = {}
    tensors = list(module.named_parameters()) + list(module.named_buffers())
    for key, tensor in tensors:
        collection, path, fn = flax_leaf_path(module, key)
        # a copy: the tree must not alias the module's tensors
        arr = tensor.detach().to("cpu", torch.float32, copy=True).numpy()
        if fn is not None:
            arr = fn(arr)
        node = tree.setdefault(collection, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if path[-1] in node:
            raise KeyError(f"flax leaf {collection}/{'/'.join(path)} "
                           f"written twice (again by {key})")
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree
