"""Fused AAD modulation: the CUDA kernel `csrc/aad_modulate.cu` and its
plain PyTorch version, mirroring `ghost_tpu/ops/pallas/aad.py`.

`aad_modulate` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. `aad_modulate.launches`
counts the calls that launched the kernel. It has no gradient, like the
JAX kernel (a Pallas call with no VJP, which the JAX package keeps out
of training): its backward raises on every device, so a loss through
the fused path never trains silently on zeros. AEI-Net trains through
its unfused AADLayer (`models/aei.py`, `fused_aad=False`).
"""

from __future__ import annotations

import ctypes

import torch

from ghost_tpu_torch.ops.cuda._build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    elements (C contiguous), or raise."""
    b, hh, ww, c = shape
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    # the stride of the innermost pixel dim that has extent (size-1 dims
    # may carry any stride)
    ld = next((x.stride(d) for d in (2, 1, 0) if shape[d] > 1), c)
    want = (hh * ww * ld, ww * ld, ld, 1)
    if ld < c or any(n > 1 and x.stride(d) != want[d]
                     for d, n in enumerate(shape)):
        raise ValueError(f"{name} must be (B,H,W,C) rows with unit channel "
                         f"stride; got strides {x.stride()}")
    return ld


def _check(h, gamma_attr, beta_attr, id_gb, mask_kernel, mask_bias):
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"aad_modulate takes float32 or bfloat16, got {h.dtype}")
    tensors = dict(h=h, gamma_attr=gamma_attr, beta_attr=beta_attr,
                   id_gb=id_gb, mask_kernel=mask_kernel, mask_bias=mask_bias)
    for name, t in tensors.items():
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    for name in ("gamma_attr", "beta_attr", "id_gb"):
        if tensors[name].dtype != h.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}, h is {h.dtype}")
    if h.ndim != 4 or not h.is_contiguous():
        raise ValueError("h must be a contiguous (B,H,W,C) tensor")
    b, _, _, c = h.shape
    ld_ga = _pixel_stride("gamma_attr", gamma_attr, h.shape)
    ld_bb = _pixel_stride("beta_attr", beta_attr, h.shape)
    if tuple(id_gb.shape) != (b, 2 * c) or not id_gb.is_contiguous():
        raise ValueError(f"id_gb must be contiguous ({b}, {2 * c})")
    for name, t, n in (("mask_kernel", mask_kernel, c),
                       ("mask_bias", mask_bias, 1)):
        if t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name} must be {n} contiguous float32 values")
    return ld_ga, ld_bb


def _kernel_lib():
    lib = load_library("aad_modulate")
    fn = lib.aad_modulate_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        ll = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int, p, p, ll, p, ll, p, p, p, p, p,
                       ctypes.c_int, ll, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _modulate(h, gamma_attr, beta_attr, id_gb, mask_kernel, mask_bias, eps):
    """The plain version for CPU tensors, else one kernel launch."""
    if h.device.type == "cpu":
        return aad_modulate_plain(h, gamma_attr, beta_attr, id_gb,
                                  mask_kernel, mask_bias, eps)
    if h.device.type != "cuda":
        raise ValueError(f"aad_modulate has no kernel for {h.device}")
    ld_ga, ld_bb = _check(h, gamma_attr, beta_attr, id_gb, mask_kernel,
                          mask_bias)
    fn = _kernel_lib()
    b, hh, ww, c = h.shape
    out = torch.empty_like(h)
    stats = torch.empty((b, 2, c), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = fn(_DTYPE_CODE[h.dtype], h.data_ptr(), gamma_attr.data_ptr(),
                ld_ga, beta_attr.data_ptr(), ld_bb, id_gb.data_ptr(),
                mask_kernel.data_ptr(), mask_bias.data_ptr(),
                stats.data_ptr(), out.data_ptr(), b, hh * ww, c, eps, stream)
    if rc != 0:
        raise RuntimeError(f"aad_modulate kernel launch failed: cudaError {rc}")
    aad_modulate.launches += 1
    return out


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
    return _AADModulate.apply(h, gamma_attr, beta_attr, id_gb, mask_kernel,
                              mask_bias, eps)


aad_modulate.launches = 0
