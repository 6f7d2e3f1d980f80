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
shape. x (and dy) and gamma may each be float32, bfloat16 or float16;
gamma and beta are read in their own dtype. The JAX row-block fitting
(`_fit_rows`, `block_rows`) tunes TPU VMEM and has no counterpart: the
kernels pick their route from h and alignment (`csrc/layer_norm.cu`).

The wrappers' host work per call is what a launch needs and little more
(it competes with the kernels' ~10-30 us at 8192 x 1024, PERF.md): the
library's entry points and argtypes are resolved once, the backward's
grid is cached per (device, dtypes, h), no cast runs for a 16-bit gamma,
and the device context is entered only when x is not on the current
device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ghost_tpu_torch.ops.cuda._build import launch, load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# widest row: 512 threads of 32 columns each (`csrc/layer_norm.cu`)
H_MAX = 16384


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
    """(rows, h, dtype code, gamma's code) of a contiguous x that the
    kernels take, with contiguous gamma (and beta) (h,) on x's device;
    raises on anything else. Cheap calls only: it runs on every launch."""
    code, gcode = _DTYPE_CODE.get(x.dtype), _DTYPE_CODE.get(gamma.dtype)
    if code is None or gcode is None:
        raise TypeError(f"fused_layer_norm takes float32, bfloat16 or "
                        f"float16, got x {x.dtype}, gamma {gamma.dtype}")
    h = x.shape[-1]
    if not 0 < h <= H_MAX or not x.is_contiguous():
        raise ValueError(f"x must be contiguous with 0 < h <= {H_MAX}; got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    rows = x.numel() // h
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the kernels' grid")
    index = x.get_device()
    for t in (gamma, *vectors):
        if t.get_device() != index or t.shape != (h,) or not t.is_contiguous():
            raise ValueError(f"gamma/beta must be contiguous ({h},) on "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")
    return rows, h, code, gcode


class _Launchers:
    """The library's entry points, with their argtypes set, resolved
    once per process (on the first CUDA call)."""

    def __init__(self):
        lib = load_library("layer_norm")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.fwd = lib.layer_norm_fwd_launch
        self.fwd.argtypes = [i, i, p, p, p, p, p, p, ll, i, ctypes.c_float, p]
        self.bwd = lib.layer_norm_bwd_launch
        self.bwd.argtypes = [i, i, p, p, p, p, p, p, p, p, p, ll, i, i, p]
        self.grid = lib.layer_norm_bwd_grid
        self.grid.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        for fn in (self.fwd, self.bwd, self.grid):
            fn.restype = ctypes.c_int
        # (device, dtype code, gamma's code, h) -> (blocks resident at
        # once, rows a block takes at a time) of the backward
        self.bwd_grids = {}

    def bwd_blocks(self, index, code, gcode, h, rows):
        """The backward's grid: n_blocks = min(resident, ceil(rows / rows
        a block takes)), queried from the library once per key."""
        grid = self.bwd_grids.get((index, code, gcode, h))
        if grid is None:
            most, per = ctypes.c_int(), ctypes.c_int()
            with torch.cuda.device(index):
                rc = self.grid(code, gcode, h, ctypes.byref(most),
                               ctypes.byref(per))
            if rc != 0:
                raise RuntimeError(f"layer_norm_bwd_grid failed: cudaError "
                                   f"{rc}")
            grid = self.bwd_grids[index, code, gcode, h] = (most.value,
                                                            per.value)
        return min(grid[0], -(-rows // grid[1]))


@functools.cache
def _launchers():
    return _Launchers()


def _no_kernel(x):
    if x.device.type != "cpu":
        raise ValueError(f"fused_layer_norm has no kernel for {x.device}")


def fused_layer_norm_fwd(x, gamma, beta, eps: float = 1e-5):
    """Forward kernel: (y in x's dtype, mean (rows,) f32, rstd (rows,) f32).
    gamma and beta are read in their own dtype; where the two differ both
    are widened to f32 first (exact)."""
    if not x.is_cuda:
        _no_kernel(x)
        return layer_norm_fwd_plain(x, gamma, beta, eps)
    x, gamma, beta = x.contiguous(), gamma.contiguous(), beta.contiguous()
    if beta.dtype != gamma.dtype:
        gamma, beta = gamma.float(), beta.float()
    rows, h, code, gcode = _check(x, gamma, beta)
    y = torch.empty_like(x)
    mean = x.new_empty(rows, dtype=torch.float32)
    rstd = x.new_empty(rows, dtype=torch.float32)
    launch(x.get_device(), "layer_norm_fwd_launch", _launchers().fwd, code,
           gcode, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
           y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, h, eps)
    fused_layer_norm_fwd.launches += 1
    return y, mean, rstd


def fused_layer_norm_bwd(x, gamma, mean, rstd, dy):
    """Backward kernels: (dx in dy's dtype, dgamma, dbeta in gamma's
    dtype). Per-block partial sums of dgamma/dbeta go to an f32
    (blocks, h) scratch that a second kernel adds up in a fixed order.
    Where dy's dtype differs from x's, both are widened to f32 (exact) and
    dx is rounded once to dy's dtype."""
    if not x.is_cuda:
        _no_kernel(x)
        return layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
    out_dtype = dy.dtype
    if dy.dtype != x.dtype:
        x, dy = x.float(), dy.float()
    x, dy, gamma = x.contiguous(), dy.contiguous(), gamma.contiguous()
    rows, h, code, gcode = _check(x, gamma)
    index = x.get_device()
    if dy.shape != x.shape or dy.get_device() != index:
        raise ValueError("dy must have x's shape and device")
    for t in (mean, rstd):
        if (t.dtype != torch.float32 or t.numel() != rows
                or not t.is_contiguous() or t.get_device() != index):
            raise ValueError("mean/rstd must be contiguous float32 (rows,) "
                             "on x's device")
    launchers = _launchers()
    n_blocks = launchers.bwd_blocks(index, code, gcode, h, rows)
    dx = torch.empty_like(dy)
    part = x.new_empty((2, n_blocks, h), dtype=torch.float32)
    dgamma = gamma.new_empty(h)
    dbeta = gamma.new_empty(h)
    launch(index, "layer_norm_bwd_launch", launchers.bwd, code, gcode,
           x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
           rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
           dgamma.data_ptr(), dbeta.data_ptr(), rows, h, n_blocks)
    fused_layer_norm_bwd.launches += 1
    if dx.dtype != out_dtype:
        dx = dx.to(out_dtype)
    return dx, dgamma, dbeta


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
