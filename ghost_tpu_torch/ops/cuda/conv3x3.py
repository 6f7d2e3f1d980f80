"""3x3 stride-1 SAME convolution (S2): the CUDA kernel `csrc/conv3x3.cu`
and its plain PyTorch version.

It replaces the Pallas conv of `scripts/profile_chain.py:conv_pallas`
and `scripts/profile_kernels_ab.py:make_conv_pallas`, whose golden is
`lax.conv_general_dilated(x, k, (1,1), ((1,1),(1,1)), ("NHWC", "HWIO",
"NHWC"))`. x is NHWC, k is HWIO (3, 3, Cin, Cout); the sum runs in f32,
an optional f32 bias is added, and the result is cast once to x's dtype.

`conv3x3` takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises: bf16 on the tensor cores, float32 on
f32 FMAs. `conv3x3.launches` counts the calls that launched the kernel.

`conv3x3_fn` is the differentiable op (`nn.layers.Conv3x3` calls it):
its forward is `conv3x3`, its backward computes the gradient and never
falls back: dx = conv3x3(dy, k') with k' the kernel turned by 180
degrees in its two spatial axes, Cin and Cout swapped (S2 itself, in
the input's dtype); dk the plain weight gradient (the zero-padded input
patches times dy, summed over pixels in f32, cast to k's dtype; the JAX
package takes it from XLA's conv gradient, outside any Pallas kernel);
dbias dy summed in f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ghost_tpu_torch.ops.cuda._build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_reference(x, k, bias=None):
    """The plain version: an f32 `F.conv2d` with padding 1 on the NCHW
    view of x, the bias added in f32, one cast to x's dtype. Returns a
    contiguous NHWC tensor."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), k.float().permute(3, 2, 0, 1),
                 None if bias is None else bias.float(), padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check(x, k, bias):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv3x3 takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B,H,W,Cin) tensor")
    b, _, _, cin = x.shape
    if k.dtype != x.dtype:
        raise TypeError(f"k is {k.dtype}, x is {x.dtype}")
    if (k.ndim != 4 or tuple(k.shape[:3]) != (3, 3, cin)
            or not k.is_contiguous()):
        raise ValueError(f"k must be a contiguous (3,3,{cin},Cout) tensor, "
                         f"got {tuple(k.shape)}")
    cout = k.shape[3]
    if cin < 1 or cout < 1:
        raise ValueError("conv3x3 needs Cin >= 1 and Cout >= 1")
    if k.device != x.device:
        raise ValueError(f"k is on {k.device}, x on {x.device}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (cout,)
                             or not bias.is_contiguous()
                             or bias.device != x.device):
        raise ValueError(f"bias must be {cout} contiguous float32 values on "
                         f"{x.device}")
    if b > 65535 or -(-cout // 32) > 65535:
        raise ValueError("conv3x3 takes at most 65535 images and "
                         "65535 * 32 output channels")


def _kernel_lib():
    lib = load_library("conv3x3")
    fn = lib.conv3x3_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def conv3x3(x, k, bias=None):
    """y = conv(x, k) (+ bias): x (B,H,W,Cin) contiguous, k (3,3,Cin,Cout)
    contiguous in x's dtype (float32 or bfloat16), bias None or (Cout,)
    float32. Returns (B,H,W,Cout) in x's dtype."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, k, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 has no kernel for {x.device}")
    _check(x, k, bias)
    fn = _kernel_lib()
    b, h, w, cin = x.shape
    cout = k.shape[3]
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), k.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(),
                b, h, w, cin, cout, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError {rc}")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0


def conv3x3_dx_kernel(k):
    """The kernel of dx = conv(dy, k'): k (3,3,Cin,Cout) turned by 180
    degrees in its spatial axes, (3,3,Cout,Cin), contiguous."""
    return k.flip(0, 1).transpose(2, 3).contiguous()


def conv3x3_dk(x, dy, k_dtype):
    """The weight gradient (3,3,Cin,Cout) in k_dtype: sum over pixels of
    the zero-padded 3x3 input patches times dy, in f32."""
    cin, cout = x.shape[-1], dy.shape[-1]
    dk = torch.nn.grad.conv2d_weight(
        x.float().permute(0, 3, 1, 2), (cout, cin, 3, 3),
        dy.float().permute(0, 3, 1, 2), padding=1)
    return dk.permute(2, 3, 1, 0).to(k_dtype)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, bias):
        ctx.save_for_backward(x, k)
        ctx.has_bias = bias is not None
        return conv3x3(x, k, bias)

    @staticmethod
    def backward(ctx, dy):
        x, k = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dk = dbias = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3(dy, conv3x3_dx_kernel(k))
        if ctx.needs_input_grad[1]:
            dk = conv3x3_dk(x, dy, k.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            dbias = dy.float().sum(dim=(0, 1, 2))
        return dx, dk, dbias


def conv3x3_fn(x, k, bias=None):
    """`conv3x3` with a gradient: x (B,H,W,Cin) contiguous, k (3,3,Cin,
    Cout) in x's dtype, bias None or (Cout,) float32."""
    return _Conv3x3.apply(x, k, bias)
