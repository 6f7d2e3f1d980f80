"""Primitive layers, mirroring `ghost_tpu/nn/layers.py`.

Modules take and return NCHW tensors (the conv nets keep them in
`torch.channels_last` memory, so a pixel's C values are contiguous);
`Conv3x3` (S2, the SR trunks) and the free functions `instance_norm`,
`rms_instance_norm` and `resize*` keep the JAX package's NHWC layout. Parameters are float32 and initialised like flax's
(`xavier_normal` kernels, zero biases, BN scale 1 / bias 0 / mean 0 /
var 1, PReLU 0.25) by `init_weights`; the weight bridge
(`convert/from_jax.py`) fills the same tensors from a flax tree.

Numerics follow flax: convs and dense layers compute in the layer's
`dtype` (inputs, kernel and bias all cast to it), BatchNorm normalises
in f32 and casts the result to `dtype`, `instance_norm` keeps f32
statistics over tensors in the input dtype, and resize applies dense
(out, in) interpolation matrices cast to the activation dtype.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ghost_tpu_torch.ops.cuda.conv3x3 import conv3x3_fn


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def to_nchw(x):
    """NHWC -> NCHW view; a contiguous NHWC tensor becomes channels_last."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    """NCHW -> NHWC view; a channels_last tensor becomes contiguous."""
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Convolutions and dense layers
# ---------------------------------------------------------------------------


class Conv(nn.Module):
    """Conv2d with torch padding semantics. Weight (cout, cin/groups, kh, kw);
    the bridge maps the flax HWIO kernel via transpose(3, 2, 0, 1)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=0,
                 use_bias=True, groups=1, dtype=torch.float32, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            cout, cin // groups, kh, kw, device=device))
        self.bias = (nn.Parameter(torch.empty(cout, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator):
        nn.init.xavier_normal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        self.stride, self.padding, 1, self.groups)


class Conv3x3(nn.Module):
    """3x3 stride-1 SAME conv on NHWC tensors through S2
    (`ops/cuda/conv3x3.py:conv3x3_fn`: the CUDA kernel for CUDA tensors,
    with a backward whose dx runs S2 too). The weight
    stays in flax's HWIO layout (3, 3, cin, cout), the layout S2 reads;
    the bias stays float32 and is added in S2's f32 epilogue."""

    def __init__(self, cin, cout, use_bias=True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(3, 3, cin, cout, device=device))
        self.bias = (nn.Parameter(torch.empty(cout, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator):
        # flax xavier_normal on HWIO: fan_in 9*cin, fan_out 9*cout
        _, _, cin, cout = self.weight.shape
        std = math.sqrt(2.0 / (9 * cin + 9 * cout))
        self.weight.normal_(0.0, std, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return conv3x3_fn(x.to(self.dtype).contiguous(),
                          self.weight.to(self.dtype), self.bias)


class ConvTranspose(nn.Module):
    """ConvTranspose2d(k, s, p). Weight (cin, cout, k, k): the flax kernel
    (k, k, cin, cout) after transpose(2, 3, 0, 1), with no flip (the JAX
    layer flips at apply time, `ghost_tpu/nn/layers.py:224`)."""

    def __init__(self, cin, cout, kernel_size=4, stride=2, padding=1,
                 use_bias=True, dtype=torch.float32, device=None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            cin, cout, kernel_size, kernel_size, device=device))
        self.bias = (nn.Parameter(torch.empty(cout, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator):
        nn.init.xavier_normal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  b, self.stride, self.padding)


class Dense(nn.Module):
    """Linear layer. Weight (out, in); the bridge transposes flax (in, out)."""

    def __init__(self, cin, cout, use_bias=True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = (nn.Parameter(torch.empty(cout, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator):
        nn.init.xavier_normal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


# ---------------------------------------------------------------------------
# Normalization and activations
# ---------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1, flax numerics: (x - mean) *
    (rsqrt(var + eps) * scale) + bias in f32, cast to `dtype`.
    affine=False is flax's use_scale=False, use_bias=False."""

    def __init__(self, features, eps=1e-5, dtype=torch.float32, device=None,
                 affine=True):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = self.bias = None
        if affine:
            self.weight = nn.Parameter(torch.empty(features, device=device))
            self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean",
                             torch.empty(features, device=device))
        self.register_buffer("running_var",
                             torch.empty(features, device=device))

    def reset_parameters(self, generator):
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean = self.running_mean.view(shape)
        mul = torch.rsqrt(self.running_var + self.eps)
        if self.weight is None:
            return ((x.float() - mean) * mul.view(shape)).to(self.dtype)
        mul = mul * self.weight
        y = (x.float() - mean) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1 (init 0.25)."""

    def __init__(self, features, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator):
        nn.init.constant_(self.alpha, 0.25)

    def forward(self, x):
        a = self.alpha.to(x.dtype).view((1, -1) + (1,) * (x.ndim - 2))
        return torch.where(x >= 0, x, a * x)


def leaky_relu(x, negative_slope: float = 0.1):
    return torch.where(x >= 0, x, negative_slope * x)


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d(affine=False) over NHWC axes (1, 2): mean in f32,
    centring in the input dtype, variance in f32 over the centred
    tensor (`ghost_tpu/nn/layers.py:304-317`)."""
    mean = torch.mean(x, dim=(1, 2), keepdim=True, dtype=torch.float32)
    xc = x - mean.to(x.dtype)
    var = torch.mean(torch.square(xc), dim=(1, 2), keepdim=True,
                     dtype=torch.float32)
    return xc * torch.rsqrt(var + eps).to(x.dtype)


def rms_instance_norm(x, eps: float = 1e-8):
    """SPADE's mean-free InstanceNorm2d over NHWC axes (1, 2):
    x * rsqrt(mean(x^2) + eps) (`ghost_tpu/nn/layers.py:320-324`)."""
    ms = torch.mean(torch.square(x), dim=(1, 2), keepdim=True)
    return x * torch.rsqrt(ms + eps)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax-style random init of every layer, in module order: each of the
    port's modules with a `reset_parameters(generator)` draws its own."""
    with torch.no_grad():
        for m in model.modules():
            if (type(m).__module__.startswith("ghost_tpu_torch.")
                    and hasattr(m, "reset_parameters")):
                m.reset_parameters(generator)
    return model


def cast_to_compute_dtype(model: nn.Module) -> nn.Module:
    """Cast conv / dense weights to each layer's compute dtype, once.

    BatchNorm stays f32 (it normalises in f32), PReLU casts its slope
    per call like flax, and a Conv3x3 keeps its bias f32 (S2 adds it in
    f32). Equal to flax's per-call cast of f32 params."""
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose, Dense)):
            m.to(m.dtype)
        elif isinstance(m, Conv3x3):
            m.weight.data = m.weight.data.to(m.dtype)
    return model


# ---------------------------------------------------------------------------
# Resize (torch F.interpolate parity) as dense (out, in) matrices
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=128)
def _linear_weights(in_size: int, out_size: int, align_corners: bool):
    """1-D bilinear gather plan: (idx0, idx1, w1) as numpy constants."""
    if out_size == 1:
        src = np.zeros(1)
    elif align_corners:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = np.maximum((np.arange(out_size) + 0.5) * in_size / out_size - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int32), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    return i0, i1, w1


def _linear_matrix(in_size: int, out_size: int, align_corners: bool):
    i0, i1, w1 = _linear_weights(in_size, out_size, align_corners)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, i0), 1.0 - w1)
    np.add.at(mat, (rows, i1), w1)
    return mat


def _area_matrix(in_size: int, out_size: int):
    """adaptive_avg_pool windows [floor(o*in/out), ceil((o+1)*in/out))."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        i0 = int(np.floor(o * in_size / out_size))
        i1 = int(np.ceil((o + 1) * in_size / out_size))
        mat[o, i0:i1] = 1.0 / (i1 - i0)
    return mat


def _nearest_matrix(in_size: int, out_size: int):
    """torch's legacy nearest: src = floor(o * in / out)."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    idx = (np.arange(out_size) * in_size // out_size).astype(np.int64)
    mat[np.arange(out_size), idx] = 1.0
    return mat


@functools.lru_cache(maxsize=256)
def resize_matrix(method: str, in_size: int, out_size: int,
                  align_corners: bool, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """The (out, in) interpolation matrix, cast to the activation dtype
    like `ghost_tpu/nn/layers.py:394-398`, cached per device. Built
    outside inference mode, so a matrix first made by an inference call
    can join a later autograd graph (a training step)."""
    if method == "bilinear":
        mat = _linear_matrix(in_size, out_size, align_corners)
    elif method == "area":
        mat = _area_matrix(in_size, out_size)
    elif method == "nearest":
        mat = _nearest_matrix(in_size, out_size)
    else:
        raise ValueError(f"unknown resize method {method!r}")
    with torch.inference_mode(False):
        return torch.from_numpy(mat).to(device=device, dtype=dtype)


def apply_matrix_axis(x, mat, axis: int):
    """Contract `axis` of x with an (out, in) matrix; the result is
    contiguous with `axis` resized to out."""
    shape = x.shape
    p = math.prod(shape[:axis])
    n = shape[axis]
    q = math.prod(shape[axis + 1:])
    x3 = x.reshape(p, n, q)
    if q >= 8:
        y = torch.matmul(mat, x3)  # p GEMMs of (out, n) @ (n, q)
    else:
        # a few trailing values (the W axis of an NHWC image): p GEMMs of
        # width q < 8 would be p unaligned, nearly empty products, so
        # contract as one (p*q, n) @ (n, out) product instead
        y = (x3.transpose(1, 2).reshape(p * q, n) @ mat.T)
        y = y.reshape(p, q, -1).transpose(1, 2)
    return y.reshape(*shape[:axis], mat.shape[0], *shape[axis + 1:])


def resize(x, size, method: str = "bilinear", align_corners: bool = False):
    """Resize NHWC (or HWC) images; method in {bilinear, area, nearest}.

    F.interpolate semantics per mode (no antialias); 'nearest' uses
    torch's legacy floor convention. An axis already at its size is
    left as it is (every mode's matrix is then the identity)."""
    hw_axes = (1, 2) if x.ndim == 4 else (0, 1)
    for axis, out_size in zip(hw_axes, size):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        mat = resize_matrix(method, in_size, out_size,
                            align_corners and method == "bilinear",
                            x.device, x.dtype)
        x = apply_matrix_axis(x, mat, axis)
    return x


def resize_like_torch(x, scale_factor: float, method="bilinear",
                      align_corners=True):
    """F.interpolate(scale_factor=...) parity: out = floor(in * factor)."""
    hw_axes = (1, 2) if x.ndim == 4 else (0, 1)
    h = int(np.floor(x.shape[hw_axes[0]] * scale_factor))
    w = int(np.floor(x.shape[hw_axes[1]] * scale_factor))
    return resize(x, (h, w), method=method, align_corners=align_corners)
