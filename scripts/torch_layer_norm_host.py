"""Host cost per call of the port's fused LayerNorm wrappers on one CUDA card.

    python3 scripts/torch_layer_norm_host.py [--root DIR] [--rows R] [--h H]

Imports `ghost_tpu_torch` from DIR (default: the checkout holding this
script; another commit's tree unpacked elsewhere compares the two) and
times, with time.perf_counter over N calls and no sync between them (what
the caller pays to enqueue work, not the device's time), after warm calls:

- `fused_layer_norm_fwd` and `fused_layer_norm_bwd` at (R, H) bf16 with
  an f32 gamma and with a bf16 gamma, and F.layer_norm and aten's
  native_layer_norm_backward on the same tensors;
- each piece of host work the wrappers do or did: resolving the ctypes
  function, the ctypes call itself (rows = 0, so the library returns at
  once), `_check`, casting gamma to f32, the `torch.cuda.device` context,
  the current stream (Stream object and raw handle), the output
  allocations and views, `contiguous()` on a contiguous x.

The device is drained after each clock stops. Prints the card's name and
power limit, then one JSON line of host us per call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path


def per_call_us(fn, iters):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / iters * 1e6


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--h", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_layer_norm_host: needs a CUDA card", file=sys.stderr)
        return 1
    from ghost_tpu_torch.ops.cuda import layer_norm as L

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0])
    dev = torch.device("cuda", 0)
    rows, h, n = args.rows, args.h, args.iters
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(rows, h, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(rows, h, generator=g, device=dev).to(torch.bfloat16)
    gamma = torch.randn(h, generator=g, device=dev)
    beta = torch.randn(h, generator=g, device=dev)
    g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    _, mean, rstd = L.fused_layer_norm_fwd(x, gamma, beta)
    _, ml, rl = torch.ops.aten.native_layer_norm(x, [h], g16, b16, 1e-5)
    stats = torch.empty((2, rows), dtype=torch.float32, device=dev)
    out = {"root": str(Path(args.root).resolve()), "rows": rows, "h": h,
           "iters": n, "card": card.splitlines()[0]}
    calls = {
        "fused_layer_norm_fwd": lambda: L.fused_layer_norm_fwd(x, gamma, beta),
        "fused_layer_norm_bwd": lambda: L.fused_layer_norm_bwd(
            x, gamma, mean, rstd, dy),
        "F.layer_norm": lambda: F.layer_norm(x, (h,), g16, b16),
        "aten.native_layer_norm_backward": lambda:
            torch.ops.aten.native_layer_norm_backward(
                dy, x, [h], ml, rl, g16, b16, [True, True, True]),
    }
    # a bf16 gamma: the parent's wrapper refused float16 but took bf16
    # gamma through a cast; the change reads it as it is
    calls["fused_layer_norm_fwd, bf16 gamma"] = lambda: L.fused_layer_norm_fwd(
        x, g16, b16)
    calls["fused_layer_norm_bwd, bf16 gamma"] = lambda: L.fused_layer_norm_bwd(
        x, g16, mean, rstd, dy)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # x, gamma, beta, y, mean, rstd: ints taken once, so that the piece
    # below times the ctypes call alone
    ptrs = [t.data_ptr() for t in (x, gamma, beta, x, stats[0], stats[1])]
    if hasattr(L, "_launchers"):  # this tree's wrapper
        fwd_fn = L._launchers().fwd
        resolve = L._launchers
        empty_call = lambda: fwd_fn(1, 0, *ptrs, 0, h, 1e-5, 0)  # noqa: E731
    else:  # the wrapper before it: _fn(name, argtypes) on every call
        types = [i, p, p, p, p, p, p, ll, i, ctypes.c_float, p]
        resolve = lambda: L._fn("layer_norm_fwd_launch", types)  # noqa: E731
        fwd_fn = resolve()
        empty_call = lambda: fwd_fn(1, *ptrs, 0, h, 1e-5, 0)  # noqa: E731

    def in_device():
        with torch.cuda.device(dev):
            pass

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    pieces = {
        "resolve the ctypes function": resolve,
        "ctypes call (rows = 0)": empty_call,
        "_check(x, gamma, beta)": lambda: L._check(x, gamma, beta),
        "gamma.float().contiguous(), f32 gamma": lambda: gamma.float().contiguous(),
        "gamma.float().contiguous(), bf16 gamma (a cast kernel)":
            lambda: g16.float().contiguous(),
        "torch.cuda.device context": in_device,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)": (lambda: raw(0)) if raw else None,
        "x.is_cuda": lambda: x.is_cuda,
        "x.device": lambda: x.device,
        "x.get_device()": x.get_device,
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "x.new_empty(rows, dtype=f32)": lambda: x.new_empty(
            rows, dtype=torch.float32),
        "x.new_empty((2, rows), dtype=f32)": lambda: x.new_empty(
            (2, rows), dtype=torch.float32),
        "torch.empty((2, rows), f32)": lambda: torch.empty(
            (2, rows), dtype=torch.float32, device=dev),
        "stats[0], stats[1]": lambda: (stats[0], stats[1]),
        "stats.unbind()": stats.unbind,
        "x.contiguous(), contiguous x": x.contiguous,
    }
    out["calls_us"] = {k: per_call_us(f, n) for k, f in calls.items()}
    out["pieces_us"] = {k: per_call_us(f, 20 * n)
                        for k, f in pieces.items() if f is not None}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
