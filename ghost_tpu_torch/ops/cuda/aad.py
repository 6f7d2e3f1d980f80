"""Fused AAD modulation: the CUDA kernels `csrc/aad_modulate.cu` and their
plain PyTorch version, mirroring `ghost_tpu/ops/pallas/aad.py`.

`aad_modulate` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernels (two statistics passes and the modulate
pass; one kernel for a map of at most SMALL_ROWS pixels; one library
call) or raises. `aad_modulate.launches` counts the calls that launched
them. h, gamma_attr, beta_attr and id_gb share one dtype: float32,
bfloat16 or float16; C <= 16384. It has no gradient, like
the JAX kernel (a Pallas call with no VJP, which the JAX package keeps
out of training): where a gradient could flow, the call goes through an
autograd Function whose backward raises on every device, so a loss
through the fused path never trains silently on zeros. AEI-Net trains
through its unfused AADLayer (`models/aei.py`, `fused_aad=False`).

The host work per call is what a launch needs and little more (it is
the whole time of the generator's small maps): no autograd Function
where no input requires grad or grad mode is off, checks without
per-call containers, the entry point and each device's SM count
resolved once, two allocations (the output and one f32 scratch; the
output alone for a small map), the raw stream handle, and the device
context only when h is not on the current device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ghost_tpu_torch.ops.cuda._build import launch, load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# widest row (`csrc/aad_modulate.cu`: the modulate pass holds 3 C floats
# in shared memory)
C_MAX = 16384
# the most blocks the statistics take over a sample's rows: at most
# MAX_SPLITS, each at least SPLIT_ROWS rows (the kernels pick as many as
# fill the card in one wave; the scratch holds this many)
SPLIT_ROWS = 256
MAX_SPLITS = 64
# maps of at most SMALL_ROWS pixels with C <= SMALL_C_MAX take the
# one-launch route: a block a sample does both statistics passes and the
# modulate, with no scratch
SMALL_ROWS = 64
SMALL_C_MAX = 1024


def aad_modulate_plain(h, gamma_attr, beta_attr, id_gb, mask_kernel,
                       mask_bias, eps: float = 1e-5):
    """Torch ops with the kernel's numerics: f32 two-pass statistics, the
    normalized tensor rounded to h's dtype, mask dot and blend in f32,
    output in h's dtype.

    h, gamma_attr, beta_attr (B,H,W,C); id_gb (B,2C) = [gamma_id|beta_id];
    mask_kernel: C values (the (1,1,C,1) conv kernel); mask_bias (1,)."""
    c = h.shape[-1]
    mean = torch.mean(h, dim=(1, 2), keepdim=True, dtype=torch.float32)
    xc = h - mean.to(h.dtype)
    var = torch.mean(torch.square(xc), dim=(1, 2), keepdim=True,
                     dtype=torch.float32)
    rstd = torch.rsqrt(var + eps)
    xf = ((h - mean.to(h.dtype)) * rstd.to(h.dtype)).float()
    mpre = (torch.sum(xf * mask_kernel.reshape(c).float(), dim=-1, keepdim=True)
            + mask_bias.reshape(()).float())
    m = torch.sigmoid(mpre)
    gi = id_gb[:, None, None, :c].float()
    bi = id_gb[:, None, None, c:].float()
    out = ((1.0 - m) * (gamma_attr.float() * xf + beta_attr.float())
           + m * (gi * xf + bi))
    return out.to(h.dtype)


def _pixel_stride(name, x, shape):
    """The pixel stride ld of a (B,H,W,C) view laid out as rows of ld
    elements (C contiguous), or raise. Size-1 dims may carry any stride."""
    if x.shape != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    b, hh, ww, c = shape
    sb, sh, sw, sc = x.stride()
    # the stride of the innermost pixel dim that has extent
    ld = sw if ww > 1 else sh if hh > 1 else sb if b > 1 else c
    if (ld < c or (c > 1 and sc != 1) or (hh > 1 and sh != ww * ld)
            or (b > 1 and sb != hh * ww * ld)):
        raise ValueError(f"{name} must be (B,H,W,C) rows with unit channel "
                         f"stride; got strides {x.stride()}")
    return ld


def _check(h, gamma_attr, beta_attr, id_gb, mask_kernel, mask_bias):
    """(dtype code, ld of gamma_attr, ld of beta_attr) of arguments the
    kernels take, or raise. Cheap calls only: it runs on every launch."""
    code = _DTYPE_CODE.get(h.dtype)
    if code is None:
        raise TypeError(f"aad_modulate takes float32, bfloat16 or float16, "
                        f"got {h.dtype}")
    if not h.dtype == gamma_attr.dtype == beta_attr.dtype == id_gb.dtype:
        raise TypeError(f"gamma_attr, beta_attr and id_gb must be h's "
                        f"{h.dtype}; got {gamma_attr.dtype}, "
                        f"{beta_attr.dtype}, {id_gb.dtype}")
    dev = h.device
    if not (gamma_attr.device == beta_attr.device == id_gb.device
            == mask_kernel.device == mask_bias.device == dev):
        raise ValueError(f"every argument must be on h's device {dev}")
    if h.dim() != 4 or not h.is_contiguous():
        raise ValueError("h must be a contiguous (B,H,W,C) tensor")
    shape = h.shape
    b, c = shape[0], shape[3]
    if c > C_MAX:
        raise ValueError(f"aad_modulate takes C <= {C_MAX}, got {c}")
    ld_ga = _pixel_stride("gamma_attr", gamma_attr, shape)
    ld_bb = _pixel_stride("beta_attr", beta_attr, shape)
    if id_gb.shape != (b, 2 * c) or not id_gb.is_contiguous():
        raise ValueError(f"id_gb must be contiguous ({b}, {2 * c})")
    if (mask_kernel.dtype != torch.float32 or mask_kernel.numel() != c
            or not mask_kernel.is_contiguous()):
        raise ValueError(f"mask_kernel must be {c} contiguous float32 values")
    if (mask_bias.dtype != torch.float32 or mask_bias.numel() != 1):
        raise ValueError("mask_bias must be one float32 value")
    return code, ld_ga, ld_bb


class _Launcher:
    """The library's entry point, with its argtypes set, and the SM count
    of each device, resolved once per process (on the first CUDA call)."""

    def __init__(self):
        fn = load_library("aad_modulate").aad_modulate_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, p, ll, p, ll, p, p, p, p, p, i, ll, i, i, i,
                       ll, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        self.fn = fn
        self.sms = {}

    def sm_count(self, index):
        sms = self.sms.get(index)
        if sms is None:
            sms = self.sms[index] = torch.cuda.get_device_properties(
                index).multi_processor_count
        return sms


@functools.cache
def _launcher():
    return _Launcher()


def _launch(h, gamma_attr, beta_attr, id_gb, mask_kernel, mask_bias, eps):
    """One call of the library on CUDA tensors: it launches the kernels
    into the output and (unless the map is small) one f32 scratch for the
    statistics, each allocated here."""
    code, ld_ga, ld_bb = _check(h, gamma_attr, beta_attr, id_gb, mask_kernel,
                                mask_bias)
    b, hh, ww, c = h.shape
    hw = hh * ww
    index = h.get_device()
    launcher = _launcher()
    sms = launcher.sm_count(index)
    splits = max(1, min(hw // SPLIT_ROWS, MAX_SPLITS))
    out = torch.empty_like(h)
    scratch = (None if hw <= SMALL_ROWS and c <= SMALL_C_MAX else
               h.new_empty((2 * splits + 1) * b * c, dtype=torch.float32))
    launch(index, "aad_modulate_launch", launcher.fn, code, h.data_ptr(),
           gamma_attr.data_ptr(), ld_ga, beta_attr.data_ptr(), ld_bb,
           id_gb.data_ptr(), mask_kernel.data_ptr(), mask_bias.data_ptr(),
           0 if scratch is None else scratch.data_ptr(), out.data_ptr(), b,
           hw, c, splits, sms, SMALL_ROWS, eps)
    aad_modulate.launches += 1
    return out


def _modulate(h, gamma_attr, beta_attr, id_gb, mask_kernel, mask_bias, eps):
    """The plain version for CPU tensors, else the kernels."""
    if h.is_cuda:
        return _launch(h, gamma_attr, beta_attr, id_gb, mask_kernel,
                       mask_bias, eps)
    if h.device.type != "cpu":
        raise ValueError(f"aad_modulate has no kernel for {h.device}")
    return aad_modulate_plain(h, gamma_attr, beta_attr, id_gb, mask_kernel,
                              mask_bias, eps)


class _AADModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, gamma_attr, beta_attr, id_gb, mask_kernel,
                mask_bias, eps):
        return _modulate(h, gamma_attr, beta_attr, id_gb, mask_kernel,
                         mask_bias, eps)

    @staticmethod
    def backward(ctx, dout):
        raise RuntimeError(
            "aad_modulate has no gradient: the fused AAD kernel is "
            "inference-only, as in the JAX package (its Pallas call has no "
            "VJP); build AEI-Net with fused_aad=False to train")


def aad_modulate(h, gamma_attr, beta_attr, id_gb, mask_kernel, mask_bias,
                 eps: float = 1e-5):
    """Fused AAD modulation (one AAD layer minus its projections), for
    inference: a backward through it raises.

    h (B,H,W,C) contiguous; gamma_attr, beta_attr (B,H,W,C) with unit
    channel stride and a pixel stride >= C (the two halves of a packed
    (B,H,W,2C) tensor qualify); id_gb (B,2C) packed [gamma_id|beta_id];
    mask_kernel C float32 values; mask_bias (1,) float32.
    """
    # the autograd Function only where a gradient could reach its
    # backward, which raises; elsewhere the kernels are called directly
    if torch.is_grad_enabled() and (
            h.requires_grad or gamma_attr.requires_grad
            or beta_attr.requires_grad or id_gb.requires_grad
            or mask_kernel.requires_grad or mask_bias.requires_grad):
        return _AADModulate.apply(h, gamma_attr, beta_attr, id_gb,
                                  mask_kernel, mask_bias, eps)
    return _modulate(h, gamma_attr, beta_attr, id_gb, mask_kernel, mask_bias,
                     eps)


aad_modulate.launches = 0
