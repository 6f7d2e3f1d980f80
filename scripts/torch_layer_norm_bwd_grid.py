"""Device time of the port's LayerNorm backward kernels against the size
of the main kernel's persistent grid, on one CUDA card.

    python3 scripts/torch_layer_norm_bwd_grid.py [--rows R] [--h H]

Calls the library's `layer_norm_bwd_launch` directly at (R, H) bf16 with
an f32 gamma, for each of several block counts (the wrapper launches as
many blocks as fit on the card at once, `layer_norm_bwd_grid`), on 8
rotating input sets so each call reads HBM; checks dx, dgamma and dbeta
against the plain version once per grid, and prints each kernel's device
time per call from torch.profiler over 20 calls, after the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--h", type=int, default=1024)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_layer_norm_bwd_grid: needs a CUDA card", file=sys.stderr)
        return 1
    from ghost_tpu_torch.ops.cuda import layer_norm as L

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    rows, h = args.rows, args.h
    g = torch.Generator(device=dev).manual_seed(1)
    gamma = torch.randn(h, generator=g, device=dev)
    sets = []
    for _ in range(8):
        x = torch.randn(rows, h, generator=g, device=dev).to(torch.bfloat16)
        dy = torch.randn(rows, h, generator=g, device=dev).to(torch.bfloat16)
        _, mean, rstd = L.layer_norm_fwd_plain(x, gamma, gamma)
        sets.append((x, dy, mean, rstd))
    want = L.layer_norm_bwd_plain(sets[0][0], gamma, sets[0][2], sets[0][3],
                                  sets[0][1])
    launchers = L._launchers()
    resident = launchers.bwd_blocks(0, 1, 0, h, 1 << 40)
    print(f"({rows},{h}) bf16, f32 gamma; blocks resident at once: "
          f"{resident}")
    stream = torch.cuda.current_stream().cuda_stream
    for n_blocks in sorted({132, 264, 396, 528, 660, 792, 1024, resident}):
        dx = torch.empty(rows, h, dtype=torch.bfloat16, device=dev)
        part = torch.empty(2, n_blocks, h, device=dev)
        dg, db = torch.empty(h, device=dev), torch.empty(h, device=dev)

        def call(i):
            x, dy, mean, rstd = sets[i % 8]
            rc = launchers.bwd(1, 0, x.data_ptr(), dy.data_ptr(),
                               gamma.data_ptr(), mean.data_ptr(),
                               rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
                               dg.data_ptr(), db.data_ptr(), rows, h, n_blocks,
                               stream)
            if rc != 0:
                raise RuntimeError(f"layer_norm_bwd_launch: cudaError {rc}")

        call(0)
        torch.cuda.synchronize()
        err = [float((a.float() - b.float()).abs().max())
               for a, b in ((dx, want[0]), (dg, want[1]), (db, want[2]))]
        call(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(20):
                call(i)
            torch.cuda.synchronize()
        times = {}
        for e in prof.key_averages():
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if e.device_type == torch.autograd.DeviceType.CUDA and us:
                name = "reduce" if "reduce" in e.key else "main"
                times[name] = times.get(name, 0.0) + us / 20
        print(f"  {n_blocks:5d} blocks ({rows / (4 * n_blocks):.2f} rows a "
              f"warp): main {times.get('main', 0):.2f} us, reduce "
              f"{times.get('reduce', 0):.2f} us; max err dx {err[0]:.1e} "
              f"dgamma {err[1]:.1e} dbeta {err[2]:.1e}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
