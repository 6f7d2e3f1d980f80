"""Host cost per call of the port's fused AAD modulate wrapper on one CUDA card.

    python3 scripts/torch_aad_host.py [--root DIR] [--iters N]

Imports `ghost_tpu_torch` from DIR (default: the checkout holding this
script; another commit's tree unpacked elsewhere compares the two) and
times, with time.perf_counter over N calls and no sync between them (what
the caller pays to enqueue work, not the device's time), after warm calls:

- `aad_modulate` in bf16 at blk3 of the generator, (8,8,8,1024) (a small
  map, where the host is the whole call) and blk8, (8,256,256,64), under
  inference_mode (as the swap path calls it) and, at blk3, with grad mode
  on and a gamma_attr that requires grad (through the autograd Function);
- each piece of host work the wrapper does or did: resolving the ctypes
  function, the ctypes call itself (b = 0, so the library returns at
  once), `_check`, the grad probe, the `torch.cuda.device` context, the
  current stream (Stream object and raw handle), the output and scratch
  allocations.

blk3 takes the one-launch route in a tree that has it (one kernel, no
scratch), the split route (three kernels) in one that does not.

The device is drained after each clock stops. Prints the card's name and
power limit, then one JSON line of host us per call.
"""

from __future__ import annotations

import argparse
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


def _inputs(b, hw, c, dev, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(b, hw, hw, c, generator=g, device=dev).to(torch.bfloat16)
    packed = torch.randn(b, hw, hw, 2 * c, generator=g,
                         device=dev).to(torch.bfloat16)
    idgb = torch.randn(b, 2 * c, generator=g, device=dev).to(torch.bfloat16)
    mk = torch.randn(1, c, 1, 1, generator=g, device=dev) / c ** 0.5
    mb = torch.randn(1, generator=g, device=dev)
    return h, packed[..., :c], packed[..., c:], idgb, mk, mb


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_aad_host: needs a CUDA card", file=sys.stderr)
        return 1
    from ghost_tpu_torch.ops.cuda import aad as A

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0])
    dev = torch.device("cuda", 0)
    n = args.iters
    small = _inputs(8, 8, 1024, dev, 0)
    big = _inputs(8, 256, 64, dev, 1)
    ga_grad = small[1].detach().requires_grad_()
    out = {"root": str(Path(args.root).resolve()), "iters": n,
           "card": card.splitlines()[0]}

    def inference(a):
        def call():
            with torch.inference_mode():
                A.aad_modulate(*a)
        return call

    calls = {
        "aad_modulate (8,8,8,1024) bf16, inference_mode": inference(small),
        "aad_modulate (8,256,256,64) bf16, inference_mode": inference(big),
        "aad_modulate (8,8,8,1024) bf16, gamma_attr requires grad":
            lambda: A.aad_modulate(small[0], ga_grad, *small[2:]),
    }
    h, ga, bb, idgb, mk, mb = small
    b, _, _, c = h.shape
    ptrs = [t.data_ptr() for t in (h, ga, bb, idgb, mk, mb, h, h)]
    if hasattr(A, "_launcher"):  # this tree's wrapper
        resolve = A._launcher
        fn = resolve().fn
        # b = 0: the library returns before any launch
        empty_call = lambda: fn(1, ptrs[0], ptrs[1], 2 * c, ptrs[2],  # noqa: E731
                                2 * c, *ptrs[3:], 0, 64, c, 1, 132, 64, 1e-5,
                                0)
    else:  # the wrapper before it
        resolve = A._kernel_lib
        fn = resolve()
        empty_call = lambda: fn(1, ptrs[0], ptrs[1], 2 * c, ptrs[2],  # noqa: E731
                                2 * c, *ptrs[3:], 0, 64, c, 1e-5, 0)

    def in_device():
        with torch.cuda.device(dev):
            pass

    def grad_probe():
        return torch.is_grad_enabled() and (
            h.requires_grad or ga.requires_grad or bb.requires_grad
            or idgb.requires_grad or mk.requires_grad or mb.requires_grad)

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    pieces = {
        "resolve the ctypes function": resolve,
        "ctypes call (b = 0)": empty_call,
        "_check": lambda: A._check(h, ga, bb, idgb, mk, mb),
        "grad probe (is_grad_enabled, six requires_grad)": grad_probe,
        "torch.cuda.device context": in_device,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)": (lambda: raw(0)) if raw else None,
        "torch.empty_like(h)": lambda: torch.empty_like(h),
        "h.new_empty((2 * 4 + 1) * b * c, dtype=f32)": lambda: h.new_empty(
            9 * b * c, dtype=torch.float32),
        "torch.empty((b, 2, c), f32)": lambda: torch.empty(
            (b, 2, c), dtype=torch.float32, device=dev),
        "h.contiguous(), contiguous h": h.contiguous,
    }
    out["calls_us"] = {k: per_call_us(f, n) for k, f in calls.items()}
    out["pieces_us"] = {k: per_call_us(f, 20 * n)
                        for k, f in pieces.items() if f is not None}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
