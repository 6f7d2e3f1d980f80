"""Fused LayerNorm: the CUDA kernels `csrc/layer_norm.cu` (forward and
backward) and their plain PyTorch versions, mirroring
`ghost_tpu/ops/pallas/layer_norm.py`.

`fused_layer_norm` is a `torch.autograd.Function` over the last axis of
any ND input: the forward saves per-row mean and rstd (f32), the
backward uses them in the three-term gradient. The two wrappers,
`fused_layer_norm_fwd` and `fused_layer_norm_bwd`, take their plain
versions only for CPU tensors; for CUDA tensors they launch their
kernels or raise, and their `.launches` count the calls that launched.
The kernels read rows of contiguous memory: on the card the wrappers
copy a non-contiguous x (and dy) into that layout first, so any layout
is taken, as by the JAX function, and the gradient comes back in x's
shape. The JAX row-block fitting (`_fit_rows`, `block_rows`) tunes TPU
VMEM and has no counterpart: the forward runs one block per row, the backward a
fixed grid of row chunks.
"""

from __future__ import annotations

import ctypes

import torch

from ghost_tpu_torch.ops.cuda._build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the backward keeps two f32 rows of dgamma/dbeta sums in shared memory
H_MAX = 16384
# backward blocks: two per SM of the H100's 132, each a chunk of rows
BWD_BLOCKS = 264


def layer_norm_plain(x, gamma, beta, eps: float = 1e-5):
    """`layer_norm_reference`: LayerNorm over the last axis in x's dtype."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def layer_norm_fwd_plain(x, gamma, beta, eps: float = 1e-5):
    """The forward kernel's function: y in x's dtype from f32 math, and
    the per-row mean and rstd, f32 (rows,)."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mean.reshape(-1), rstd.reshape(-1)


def layer_norm_bwd_plain(x, gamma, mean, rstd, dy):
    """The backward kernels' function: dx in dy's dtype, dgamma and
    dbeta summed over rows in f32 and cast to gamma's dtype."""
    h = x.shape[-1]
    xhat = (x.reshape(-1, h).float() - mean[:, None]) * rstd[:, None]
    dyf = dy.reshape(-1, h).float()
    wdy = dyf * gamma.float()
    c1 = torch.mean(xhat * wdy, dim=-1, keepdim=True)
    c2 = torch.mean(wdy, dim=-1, keepdim=True)
    dx = (wdy - c2 - xhat * c1) * rstd[:, None]
    return (dx.to(dy.dtype).reshape(dy.shape),
            torch.sum(dyf * xhat, dim=0).to(gamma.dtype),
            torch.sum(dyf, dim=0).to(gamma.dtype))


def _check(x, gamma, *vectors):
    if x.dtype not in _DTYPE_CODE or gamma.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_layer_norm takes float32 or bfloat16, got x "
                        f"{x.dtype}, gamma {gamma.dtype}")
    h = x.shape[-1]
    if not x.is_contiguous() or h > H_MAX:
        raise ValueError(f"x must be contiguous with h <= {H_MAX}; got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    rows = x.numel() // max(h, 1)
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the kernels' grid")
    for t in (gamma, *vectors):
        if t.device != x.device:
            raise ValueError(f"gamma/beta on {t.device}, x on {x.device}")
        if tuple(t.shape) != (h,):
            raise ValueError(f"gamma/beta must be ({h},), got {tuple(t.shape)}")
    return rows, h


def _fn(name, argtypes):
    fn = getattr(load_library("layer_norm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def fused_layer_norm_fwd(x, gamma, beta, eps: float = 1e-5):
    """Forward kernel: (y in x's dtype, mean (rows,) f32, rstd (rows,) f32)."""
    if x.device.type == "cpu":
        return layer_norm_fwd_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm has no kernel for {x.device}")
    x = x.contiguous()
    rows, h = _check(x, gamma, beta)
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    y = torch.empty_like(x)
    stats = torch.empty((2, rows), dtype=torch.float32, device=x.device)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _fn("layer_norm_fwd_launch",
             [i, p, p, p, p, p, p, ll, i, ctypes.c_float, p])
    with torch.cuda.device(x.device):
        rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), g32.data_ptr(),
                b32.data_ptr(), y.data_ptr(), stats[0].data_ptr(),
                stats[1].data_ptr(), rows, h, eps, _stream(x))
    if rc != 0:
        raise RuntimeError(f"layer_norm_fwd_launch failed: cudaError {rc}")
    fused_layer_norm_fwd.launches += 1
    return y, stats[0], stats[1]


def fused_layer_norm_bwd(x, gamma, mean, rstd, dy):
    """Backward kernels: (dx in dy's dtype, dgamma, dbeta in gamma's
    dtype). Per-block partial sums of dgamma/dbeta go to an f32
    (blocks, h) scratch that a second kernel adds up in block order."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm has no kernel for {x.device}")
    x, dy = x.contiguous(), dy.contiguous()
    rows, h = _check(x, gamma)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("dy must be contiguous with x's shape and dtype")
    for t in (mean, rstd):
        if t.dtype != torch.float32 or t.numel() != rows or not t.is_contiguous():
            raise ValueError("mean/rstd must be contiguous float32 (rows,)")
    rpb = -(-rows // min(rows, BWD_BLOCKS)) if rows else 1
    n_blocks = -(-rows // rpb)
    g32 = gamma.float().contiguous()
    dx = torch.empty_like(dy)
    part = torch.empty((2, n_blocks, h), dtype=torch.float32, device=x.device)
    dgb = torch.empty((2, h), dtype=gamma.dtype, device=x.device)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _fn("layer_norm_bwd_launch",
             [i, i, p, p, p, p, p, p, p, p, p, p, ll, i, i, i, p])
    with torch.cuda.device(x.device):
        rc = fn(_DTYPE_CODE[x.dtype], _DTYPE_CODE[gamma.dtype], x.data_ptr(),
                dy.data_ptr(), g32.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), dx.data_ptr(), part[0].data_ptr(),
                part[1].data_ptr(), dgb[0].data_ptr(), dgb[1].data_ptr(),
                rows, h, rpb, n_blocks, _stream(x))
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd_launch failed: cudaError {rc}")
    fused_layer_norm_bwd.launches += 1
    return dx, dgb[0], dgb[1]


fused_layer_norm_fwd.launches = 0
fused_layer_norm_bwd.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        if x.device.type == "cuda":  # the layout the kernels read, saved once
            x = x.contiguous()
        y, mean, rstd = fused_layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = fused_layer_norm_bwd(x, gamma, mean, rstd, dy)
        return dx, dgamma, dbeta, None


def fused_layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis with a saved-stat backward; kernels
    on the card, plain versions on the CPU."""
    return _FusedLayerNorm.apply(x, gamma, beta, eps)
