"""Flash attention: the CUDA kernels `csrc/flash_attention.cu` (forward,
dq, dk/dv) and their plain PyTorch versions, mirroring
`ghost_tpu/ops/pallas/attention.py`.

Layout (B, H, S, D) as in the JAX package. `flash_attention` is a
`torch.autograd.Function`: its forward saves the row log-sum-exp and its
backward computes delta = rowsum(dO * O) in plain torch (as the JAX
`_bwd` does outside its kernels), then dq and dk/dv in two kernels, one
per q tile and one per k tile: no atomics, the same sums on every run.

Each of the three wrappers takes its plain version only for CPU tensors;
for CUDA tensors it launches its kernel or raises. Their `.launches`
count the calls that launched. The kernels take float32, bfloat16 and
float16 with D <= 256 (`D_MAX`). In the 16-bit types the forward (any
such D) and dq and dk/dv (D <= 128, `MMA_D_MAX`) run on the tensor
cores and round p (and ds) to the inputs' type where they enter a
product, as FlashAttention-2 does; `.tensor_core_launches` counts those
launches, and the plain versions round at the same places (float32,
and dq and dk/dv with D > 128, keep f32 on the FMA kernels). The
kernels take the inputs' b/h/s strides (unit D stride), so the split
heads of a projection are passed without a copy. The JAX block-size
fitting (`_fit_block`, `DEFAULT_BLOCK_*`, `DKV_BLOCK_CAP`) tunes TPU
VMEM and has no counterpart: the CUDA kernels pick their tiles from the
head dim.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ghost_tpu_torch.ops.cuda._build import load_library

NEG_INF = -1e30
D_MAX = 256
MMA_D_MAX = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _causal_mask(logits, causal):
    if not causal:
        return logits
    s = logits.shape[-2]
    mask = torch.ones((s, s), dtype=torch.bool, device=logits.device).tril()
    return torch.where(mask, logits, NEG_INF)


def flash_attention_plain(q, k, v, causal: bool = False,
                          sm_scale: float | None = None):
    """Golden attention (B,H,S,D) -> (B,H,S,D) with f32 math, output in
    q's dtype: a copy of `flash_attention_reference`, which the JAX
    module's plain core calls, so MultiheadAttention's plain core is the
    same function. `flash_attention_fwd_plain` is the forward kernel's
    own function (q scaled before the product, the LSE kept), which the
    kernel is held to."""
    sm_scale = _scale(q, sm_scale)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    probs = torch.softmax(_causal_mask(logits, causal), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def flash_attention_fwd_plain(q, k, v, causal: bool = False,
                              sm_scale: float | None = None):
    """The forward kernel's function: output in q's dtype and the row
    LSE (B,H,S,1) f32; q is scaled before the product, as the kernel.
    The unnormalised p = exp(s - rowmax) goes into p v and the row sum l
    divides after, as in the kernel; on the tensor cores p is rounded to
    q's dtype before p v (at the kernel's scale wherever its running max
    is the row max: always for rows of one k tile)."""
    sm_scale = _scale(q, sm_scale)
    logits = _causal_mask(torch.einsum("bhqd,bhkd->bhqk",
                                       q.float() * sm_scale, k.float()),
                          causal)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    (p,) = _product_operands(q, p, forward=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / denom
    return out.to(q.dtype), m + torch.log(denom)


def _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale):
    """p = exp(s - lse) and ds = p * (dO v^T - delta) over whole rows
    (the JAX backward recurrence, `attention.py:202-291`)."""
    s = _causal_mask(torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
                     * sm_scale, causal)
    p = torch.exp(s - lse.reshape(*q.shape[:3], 1))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.reshape(*q.shape[:3], 1))


def on_tensor_cores(q, forward: bool = False):
    """Whether the forward (forward=True: every D the card takes), or dq
    and dk/dv (D <= MMA_D_MAX), of these inputs run on the 16-bit tensor
    cores."""
    return (q.dtype in (torch.bfloat16, torch.float16)
            and (forward or q.shape[-1] <= MMA_D_MAX))


def _product_operands(q, *ts, forward: bool = False):
    """p (and ds) as the kernels feed them to their products: rounded to
    q's 16-bit type on the tensor cores, f32 otherwise."""
    if not on_tensor_cores(q, forward):
        return ts
    return tuple(t.to(q.dtype).float() for t in ts)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale):
    """The dq kernel's function."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale)
    (ds,) = _product_operands(q, ds)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
            * sm_scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale):
    """The dk/dv kernel's function."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale)
    p, ds = _product_operands(q, p, ds)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o, do):
    """delta = rowsum(dO * O) in f32, (B,H,S,1)."""
    return torch.sum(do.float() * o.float(), dim=-1, keepdim=True)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False,
                              sm_scale: float | None = None):
    """The backward kernels' function: (dq, dk, dv) from the forward's
    output and LSE and the output gradient dO."""
    args = (q, k, v, do, lse, attention_delta(o, do), causal,
            _scale(q, sm_scale))
    return (flash_attention_bwd_dq_plain(*args),
            *flash_attention_bwd_dkv_plain(*args))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _strides(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} needs a unit stride along D; got strides "
                         f"{t.stride()}")
    return list(t.stride()[:3])


def _check(q, k, v, do=None, lse=None, delta=None, block_q=64):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"q must be (B,H,S,D), got {tuple(q.shape)}")
    b, h, s, d = q.shape
    if d > D_MAX:
        raise ValueError(f"head dim {d} > {D_MAX}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernels' grid")
    if block_q not in (64, 48) or (block_q == 48 and (
            d > 64 or q.dtype != torch.float32)):
        raise ValueError("block_q is 64, or 48 for float32 with D <= 64")
    tensors = dict(q=q, k=k, v=v)
    if do is not None:
        tensors["do"] = do
    strides = []
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        strides += _strides(name, t, q.shape)
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != b * h * s
                              or not t.is_contiguous()
                              or t.device != q.device):
            raise ValueError(f"{name} must be contiguous float32 (B,H,S) on "
                             f"{q.device}")
    return (ctypes.c_longlong * len(strides))(*strides)


def _fn(name, n_ptrs):
    fn = getattr(load_library("flash_attention"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i, i] + [p] * n_ptrs
                       + [i, i, i, i, ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
    return fn


def _launch(fn, q, block_q, ptrs, causal, sm_scale):
    b, h, s, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODE[q.dtype], block_q, *ptrs, b, h, s, d,
                float(sm_scale), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")


def _on_card(q, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what} has no kernel for {q.device}")


def _fwd_launch(q, k, v, causal, sm_scale, block_q):
    strides = _check(q, k, v, block_q=block_q)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((*q.shape[:3], 1), dtype=torch.float32, device=q.device)
    _launch(_fn("flash_attention_fwd_launch", 6), q, block_q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(),
             ctypes.addressof(strides), out.data_ptr(), lse.data_ptr()),
            causal, sm_scale)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.tensor_core_launches += on_tensor_cores(q, True)
    return out, lse


def _dq_launch(q, k, v, do, lse, delta, causal, sm_scale, block_q):
    strides = _check(q, k, v, do, lse, delta, block_q)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_fn("flash_attention_dq_launch", 8), q, block_q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             ctypes.addressof(strides), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr()), causal, sm_scale)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.tensor_core_launches += on_tensor_cores(q)
    return dq


def _dkv_launch(q, k, v, do, lse, delta, causal, sm_scale, block_q):
    strides = _check(q, k, v, do, lse, delta, block_q)
    dk = torch.empty(q.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    _launch(_fn("flash_attention_dkv_launch", 9), q, block_q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             ctypes.addressof(strides), lse.data_ptr(), delta.data_ptr(),
             dk.data_ptr(), dv.data_ptr()), causal, sm_scale)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.tensor_core_launches += on_tensor_cores(q)
    return dk, dv


def flash_attention_fwd(q, k, v, causal: bool = False,
                        sm_scale: float | None = None):
    """Forward kernel: (out (B,H,S,D) in q's dtype, lse (B,H,S,1) f32)."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale)
    _on_card(q, "flash_attention_fwd")
    return _fwd_launch(q, k, v, causal, sm_scale, 64)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                           sm_scale: float | None = None):
    """dq kernel: one block per q tile streams the K/V tiles."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            sm_scale)
    _on_card(q, "flash_attention_bwd_dq")
    return _dq_launch(q, k, v, do, lse, delta, causal, sm_scale, 64)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                            sm_scale: float | None = None):
    """dk/dv kernel: one block per k tile streams the Q/dO tiles."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                             sm_scale)
    _on_card(q, "flash_attention_bwd_dkv")
    return _dkv_launch(q, k, v, do, lse, delta, causal, sm_scale, 64)


def _flash_attention_tiles(q, k, v, do, causal, block_q):
    """The three kernels on card tensors with q tiles of `block_q` rows
    (64, or 48 for float32 with D <= 64) against k tiles of 64:
    (out, lse, delta, dq, dk, dv). Tiles of 48 do not divide those of
    64, which checks the causal loop bounds; the wrappers use 64. The
    tensor-core kernels pick their own tiles (block_q 64)."""
    _on_card(q, "_flash_attention_tiles")
    sm_scale = _scale(q, None)
    out, lse = _fwd_launch(q, k, v, causal, sm_scale, block_q)
    delta = attention_delta(out, do)
    args = (q, k, v, do, lse, delta, causal, sm_scale, block_q)
    return (out, lse, delta, _dq_launch(*args), *_dkv_launch(*args))


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_fwd.tensor_core_launches = 0
flash_attention_bwd_dq.tensor_core_launches = 0
flash_attention_bwd_dkv.tensor_core_launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # the kernels need a unit D stride
            do = do.contiguous()
        delta = attention_delta(out, do)
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        dq = flash_attention_bwd_dq(*args)
        dk, dv = flash_attention_bwd_dkv(*args)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: float | None = None):
    """(B,H,S,D) attention with kernel forward and backward on the card
    (plain versions on the CPU). q, k and v share one shape."""
    return _FlashAttention.apply(q, k, v, causal, _scale(q, sm_scale))
