"""Drive the PyTorch/CUDA port (`ghost_tpu_torch`) on one CUDA card and
check it end to end.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --profile  # also one torch.profiler'd chunk and
                                     # video call, and their stage times

Phases, each on an explicit device; any failure raises and the script
exits non-zero without its result lines:

  1. device   card name, count, power limit, torch/CUDA versions, TF32 off
  2. build    nvcc builds K1, K2, K3 and S2 for sm_90a, one process per
              source, all at once
  3. K1       kernels vs their plain PyTorch version at the 8 AAD shapes
              of the full-width generator at B=8, bf16, f32 and float16:
              error bound; per shape, each call on the next of input sets
              past the L2, the call time (CUDA events, turns plain,
              kernel, kernel, plain) and host us per call (no sync); the
              small maps (one launch) also through the split route; the
              sums per generator pass (device times: phase 16)
  4. parity   the test config (tests/test_torch_pipeline.py), f32, same
              weights and frames, CPU (plain AAD) vs card (kernel)
  5. main     `_detect_swap` at full width (SCRFD 640, iresnet100, AEI-Net
              unet 2 blocks, bf16) on a chunk of 8 seeded 1080p frames:
              output shape, 21 K1 launches per call, a real blend, frames/s
  6. K2       HMMA counts of each tensor-core kernel in the built K2
              and S2 libraries and LDG.E.128 counts of each K3 kernel
              (cuobjdump -sass; every vector-route K3 kernel must have
              128-bit loads); flash attention
              forward, dq and dk/dv vs their plain versions at
              (8,8,1024|4096,64) bf16 causal and not and (8,8,4096,128)
              bf16 causal, (1,1,2560,64) causal f32 with q tiles of 48
              against k tiles of 64, (2,2,640,128) f32, in bf16 S=1000,
              S=2560 causal, D=128, split heads and D=256, and in float16
              S=1000, D=128 and D=256, with the kernel family that ran;
              each 16-bit case's out, dq, dk, dv against the f32 result
              beside aten's flash fwd+bwd; times beside SDPA, aten's
              flash backward and the bounds
  7. K3       fused LayerNorm forward and backward vs plain at 8192x1024
              and 32768x512 (bf16, f32), 8192x1024 float16, 1000x768,
              37x8192, 1000x1000 (element accesses), 4x16384 and 16-bit
              gammas; at the first five, each call on one of 8 input sets
              so it reads HBM: call time (CUDA events around 20
              back-to-back calls) and host us per call (no sync), the
              same for F.layer_norm / its aten backward, the plain
              versions and the bytes bounds (device times: phase 15)
  8. train    the slice's path at full width: MultiheadAttention (8 heads
              x 64, causal, norm_add) + MLP (2048, 512), bf16 compute, on
              seeded x (8,4096,512), cross-entropy, 3 ghost_adam steps:
              the losses, one K2 fwd, dq and dk/dv launch per step, all
              three on the bf16 tensor-core kernels
  9. K3 path  fused_layer_norm fwd+bwd through autograd at 8192x1024
 10. parity   the tiny f32 block, 3 steps on the CPU and on the card
 11. S2       the 3x3 conv vs its plain version at the scripts' blk8
              (8,256,256,64) and blk7 (8,128,128,128), the SR student's
              3->32, 32->32 and 32->12 at 16 crops of 128x128 and an odd
              (2,37,53,5->7), bf16 (tensor cores) and f32 (FMA); times
              (rotating input sets past the L2) beside F.conv2d (cuDNN,
              channels_last) and the bounds; each bf16 case's dx (S2 on
              the turned kernel) against the plain gradient
 12. seat     the SR student on its bundled weights
              (assets/srvgg_student_x2_r05.msgpack), f32, CPU vs card
 13. video    the --use_sr video path at full width: the phase 5 models
              with the student seat, 2 identities, 20 seeded 1080p frames
              in chunks of 8 (the last padded): swap_video_frames
              (smooth), swap_video_stream (smooth; equal to the frames
              output) and swap_video_stream (fused); frames/s, peak
              memory, S2 launches (18 per present lane per group);
              then swap_video_frames with the LIPSPADE seat on seeded
              weights, crop_faces and swap_image_fused once each
 14. grads    gradients on the card: AEINet(fused_aad=False) at full
              width (no K1), f32, one backward against the same model's
              on the CPU, as a whole within 5x the CPU's own f32 noise
              (against an f64 run); AEINet(fused_aad=True): 21 K1
              launches, then a backward that must raise; the SR
              student on its bundled weights, one backward in f32 and one
              in bf16 with S2 launched for every conv's dx, each as
              accurate as the plain path (against an f64 run)
 15. K3 dev   device time per kernel of phase 7's timed K3 cases and of
              their library calls (torch.profiler; the backward's main
              and reduction kernels apart), last, so that the
              profiler's hooks time no other phase
 16. K1 dev   device time per kernel of K1 at phase 3's shapes, in all
              three dtypes (torch.profiler), and the kernels that run just
              before each K1 call in a full-width bf16 generator pass (no
              copy of h may run there)

Each path (5, 8, 9, 13, 14) runs with every launch count set to 0 just
before it and read just after; the counts of 5, 8, 9 and 13 go into the
kernels line.

The last two lines are the kernels JSON and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# the 8 AAD blocks of the full-width generator: (spatial size, channels)
# and the AAD layers per block (blocks 4-8 add the shortcut's)
AAD_BLOCKS = [(2 ** (k + 1), c, 2 if k < 3 else 3)
              for k, c in enumerate((1024, 1024, 1024, 1024, 512, 256, 128, 64))]
AAD_B = 8
K1_DTYPES = ("bfloat16", "float32", "float16")
# K1 per bf16 generator pass in the first design of csrc/aad_modulate.cu
# (a (B, C/32) statistics grid, 2-byte loads; CUDA events on reused
# inputs), NVIDIA H100 80GB HBM3 at 700.00 W
K1_FIRST_DESIGN_PASS_MS = 3.689
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, same sheet
F32_FLOPS = 67e12          # f32 outside the tensor cores, same sheet
# K2 kernel-vs-plain cases: (B, H, S, D, dtype, causal, block_q, timed,
# strided); S=2560 causal in f32 with q tiles of 48 against k tiles of 64;
# in bf16 S=1000 (no multiple of any tile), S=2560 causal, D=128, the
# split heads of a (B, S, H*D) projection (strided, no copy), D=256 (the
# tensor-core forward, the FMA dq and dk/dv) and D=128 timed at full
# size; in float16 S=1000, D=128 and D=256
K2_CASES = [(8, 8, 1024, 64, "bfloat16", False, 64, True, False),
            (8, 8, 1024, 64, "bfloat16", True, 64, True, False),
            (8, 8, 4096, 64, "bfloat16", False, 64, True, False),
            (8, 8, 4096, 64, "bfloat16", True, 64, True, False),
            (1, 1, 2560, 64, "float32", True, 48, False, False),
            (2, 2, 640, 128, "float32", False, 64, False, False),
            (2, 4, 1000, 64, "bfloat16", False, 64, False, False),
            (2, 4, 1000, 64, "bfloat16", True, 64, False, False),
            (1, 4, 2560, 64, "bfloat16", True, 64, False, False),
            (2, 4, 1024, 128, "bfloat16", False, 64, False, False),
            (2, 4, 1024, 128, "bfloat16", True, 64, False, False),
            (2, 8, 1024, 64, "bfloat16", False, 64, False, True),
            (2, 8, 1024, 64, "bfloat16", True, 64, False, True),
            (1, 2, 384, 256, "bfloat16", True, 64, False, False),
            (8, 8, 4096, 128, "bfloat16", True, 64, True, False),
            (2, 4, 1000, 64, "float16", True, 64, False, False),
            (2, 4, 1024, 128, "float16", False, 64, False, False),
            (1, 2, 384, 256, "float16", True, 64, False, False)]
# K3 cases: (rows, h, dtype, gamma's dtype, timed): the apex-style
# 8192 x 1024, the training block's LayerNorm (8 x 4096 tokens of 512),
# float16, ragged rows, h = 1000 (element accesses), the wide route up
# to h = 16384 and 16-bit gammas
K3_CASES = [(8192, 1024, "bfloat16", "float32", True),
            (8192, 1024, "float32", "float32", True),
            (32768, 512, "bfloat16", "float32", True),
            (32768, 512, "float32", "float32", True),
            (8192, 1024, "float16", "float16", True),
            (1000, 768, "bfloat16", "float32", False),
            (1000, 768, "float32", "float32", False),
            (37, 8192, "bfloat16", "float32", False),
            (37, 8192, "float32", "float32", False),
            (1000, 1000, "float16", "float32", False),
            (4, 16384, "bfloat16", "bfloat16", False),
            (1000, 768, "bfloat16", "float16", False)]
# input sets the timed K3 cases rotate through (each call reads HBM)
K3_SETS = 8
# the training slice at full width, and cut down for CPU-vs-card parity
TRAIN = dict(batch=8, seq=4096, heads=8, head_dim=64, hidden=2048, steps=3,
             lr=4e-4)
# the training losses with f32 p in the forward and f32 p and ds in the
# backward (the FMA kernels). Now that the forward rounds p to bf16 before
# p v, the first loss may move within TRAIN_FIRST_LOSS_TOL (the block's
# bf16 output moves by about one ulp in places, the mean over 32768
# tokens by far less); the next two, whose backward rounds p and ds too,
# within TRAIN_LOSS_TOL
TRAIN_LOSSES = (6.395020, 6.303970, 6.231132)
TRAIN_FIRST_LOSS_TOL = 1e-3
TRAIN_LOSS_TOL = 1e-2
TRAIN_PARITY = dict(batch=2, seq=128, heads=2, head_dim=16, hidden=64)
PARITY_CFG = dict(det_size=320, chunk_size=2, max_faces=4, match_faces=2,
                  similarity_th=-2.0)
# S2 cases: (B, H, W, Cin, Cout, tag); the seat's three at 16 crops
# (chunk 8 x 2 identities) of the 256 generator output over the x2 student
S2_CASES = [(8, 256, 256, 64, 64, "blk8"), (8, 128, 128, 128, 128, "blk7"),
            (16, 128, 128, 3, 32, "seat 3->32"),
            (16, 128, 128, 32, 32, "seat 32->32"),
            (16, 128, 128, 32, 12, "seat 32->12"),
            (2, 37, 53, 5, 7, "odd")]
# convs of each seat shape in one student pass (conv_0, 16 body, conv_last)
S2_SEAT_PASS = {"seat 3->32": 1, "seat 32->32": 16, "seat 32->12": 1}
# a timed S2 case rotates through input sets of at least this many bytes
S2_ROTATE_BYTES = 128 * 2 ** 20
STUDENT = Path(__file__).resolve().parent / "assets" / \
    "srvgg_student_x2_r05.msgpack"
# the video phase: frames of (H, W), chunk, identities
VIDEO = dict(frames=20, hw=(1080, 1920), chunk=8, identities=2)


# each kernel: its source and the TPU kernel it replaces
KERNELS = {
    "aad_modulate": ("ghost_tpu_torch/csrc/aad_modulate.cu",
                     "ghost_tpu/ops/pallas/aad.py:77"),
    "flash_attention_fwd": ("ghost_tpu_torch/csrc/flash_attention.cu",
                            "ghost_tpu/ops/pallas/attention.py:85"),
    "flash_attention_bwd_dq": ("ghost_tpu_torch/csrc/flash_attention.cu",
                               "ghost_tpu/ops/pallas/attention.py:202"),
    "flash_attention_bwd_dkv": ("ghost_tpu_torch/csrc/flash_attention.cu",
                                "ghost_tpu/ops/pallas/attention.py:247"),
    "fused_layer_norm_fwd": ("ghost_tpu_torch/csrc/layer_norm.cu",
                             "ghost_tpu/ops/pallas/layer_norm.py:30"),
    "fused_layer_norm_bwd": ("ghost_tpu_torch/csrc/layer_norm.cu",
                             "ghost_tpu/ops/pallas/layer_norm.py:42"),
    "conv3x3": ("ghost_tpu_torch/csrc/conv3x3.cu",
                "scripts/profile_kernels_ab.py:90 and "
                "scripts/profile_chain.py:228"),
}


# the one PyTorch call that computes each kernel's function (timed only)
LIBRARY = {
    "aad_modulate": None,
    "flash_attention_fwd": "torch.nn.functional.scaled_dot_product_attention",
    "flash_attention_bwd_dq": None,
    "flash_attention_bwd_dkv":
        "aten._scaled_dot_product_flash_attention_backward: dq, dk and dv "
        "together, the yardstick of the dq + dk/dv pair",
    "fused_layer_norm_fwd": "torch.nn.functional.layer_norm",
    "fused_layer_norm_bwd": "aten.native_layer_norm_backward",
    "conv3x3": "torch.nn.functional.conv2d (cuDNN, channels_last input, "
               "OIHW weight)",
}


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def phase_device(device):
    import torch

    from ghost_tpu_torch.core.precision import disable_tf32

    disable_tf32()
    log(f"device: {torch.cuda.get_device_name(device)} "
        f"(count {torch.cuda.device_count()})")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return card


def phase_build():
    from ghost_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.build()
    for name in _build.SOURCES:
        report = _build.BUILD_REPORTS.get(name)
        if report is None:
            log(f"build: {name} loaded from {_build.BUILD_DIR} (built earlier)")
            continue
        log(f"build: {name} in {report['seconds']:.2f} s: nvcc "
            f"{' '.join(report['cmd'][1:])}")
        lines = report["ptxas"].splitlines()
        if sum("entry function" in line for line in lines) > 60:
            _ptxas_summary(lines)  # K3's instantiations: one line a kernel
            continue
        # each kernel's name, registers and shared memory, and any spills
        for line in lines:
            nonzero_spill = "spill" in line and " 0 bytes spill" not in line
            if "entry function" in line or "Used" in line or nonzero_spill:
                log(f"  ptxas: {line.strip()[:150]}")
    log(f"build: {len(_build.SOURCES)} sources, one nvcc each in parallel, "
        f"in {time.perf_counter() - t0:.2f} s")


def _ptxas_summary(lines):
    """Per kernel template of a library with many instantiations: how
    many, their register range, and how many spill."""
    import re

    kinds, kind = {}, None
    for line in lines:
        m = re.search(r"entry function '_ZN(\w+)'", line)
        if m:
            # the nested name's length-prefixed parts: the last is the
            # kernel's, before its template arguments
            rest, name = m.group(1), None
            while (part := re.match(r"(\d+)", rest)):
                n, rest = int(part.group(1)), rest[part.end():]
                name, rest = rest[:n], rest[n:]
            kind = kinds.setdefault(name, {"regs": [], "spills": 0})
        elif kind is not None and (m := re.search(r"Used (\d+) registers",
                                                   line)):
            kind["regs"].append(int(m.group(1)))
        elif kind is not None and "spill" in line \
                and " 0 bytes spill" not in line:
            kind["spills"] += 1
    for name, k in kinds.items():
        log(f"  ptxas: {name}: {len(k['regs'])} kernels, "
            f"{min(k['regs'])}-{max(k['regs'])} registers, "
            f"{k['spills']} with spills")


def _time_turns(fns, iters, device):
    """Per-call ms of each fn, timed in the turns plain, kernel, kernel,
    plain (fns = (plain, kernel)) with CUDA events."""
    import torch

    total = {0: 0.0, 1: 0.0}
    for which in (0, 1, 1, 0):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fns[which]()
        end.record()
        torch.cuda.synchronize(device)
        total[which] += start.elapsed_time(end) / iters
    return total[0] / 2, total[1] / 2


def _k1_sets(hw, c, dt, device):
    """Input sets of a K1 generator shape at B=AAD_B, seeded by the shape
    (so a later phase makes the same ones): as many as it takes for the
    sets to hold S2_ROTATE_BYTES, so that timed calls, each on the next
    set, read their inputs from HBM and not from the 50 MB L2."""
    import torch

    dtype = getattr(torch, dt)
    g = torch.Generator(device=device).manual_seed(hw * 4096 + c)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=device)

    mk, mb = rnd(1, c, 1, 1) / c ** 0.5, rnd(1)
    per_set = 3 * AAD_B * hw * hw * c * dtype.itemsize
    sets = []
    for _ in range(max(1, math.ceil(S2_ROTATE_BYTES / per_set))):
        h = (rnd(AAD_B, hw, hw, c) * 2 + 1).to(dtype)
        packed = rnd(AAD_B, hw, hw, 2 * c).to(dtype)
        sets.append((h, packed[..., :c], packed[..., c:],
                     rnd(AAD_B, 2 * c).to(dtype), mk, mb))
    return sets


def _k1_bound_ms(args):
    """The function's least traffic over the HBM rate: h, gamma_attr and
    beta_attr read once, the output written once, the id and mask
    vectors read once."""
    h = args[0]
    nbytes = (4 * h.numel() * h.element_size()
              + sum(a.numel() * a.element_size() for a in args[3:]))
    return nbytes / HBM_BYTES_PER_S * 1e3


def _k1_error(args, dt):
    """(max abs error, within bound) of K1 against its plain version:
    0.1 + 2^-6 |ref| in the 16-bit types (the JAX kernel test's bf16
    bound plus two bf16 ulps at the value's magnitude), 1e-4 + 1e-5 |ref|
    in f32."""
    import torch

    from ghost_tpu_torch.ops.cuda.aad import aad_modulate, aad_modulate_plain

    out = aad_modulate(*args)
    ref = aad_modulate_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    if dt == "float32":
        bound = 1e-4 + 1e-5 * ref.float().abs()
    else:
        bound = 0.1 + 2 ** -6 * ref.float().abs()
    return float(err.max()), bool((err <= bound).all())


def _k1_small(hw, c):
    """Whether a generator shape takes K1's one-launch route."""
    from ghost_tpu_torch.ops.cuda import aad

    return hw * hw <= aad.SMALL_ROWS and c <= aad.SMALL_C_MAX


@contextlib.contextmanager
def _k1_split_route():
    """K1 with its one-launch route off: small maps take the split route."""
    from ghost_tpu_torch.ops.cuda import aad

    keep = aad.SMALL_ROWS
    aad.SMALL_ROWS = 0
    try:
        yield
    finally:
        aad.SMALL_ROWS = keep


def phase_k1(device, card):
    """K1 against its plain version at the 8 AAD shapes of the generator
    in bf16, f32 and float16; per shape the call time (CUDA events around
    20 back-to-back calls, turns plain, kernel, kernel, plain, each call
    on the next of input sets past the L2) and the host us per call (no
    sync); the small maps also through the split route. Device times come
    last (phase_k1_device)."""
    import torch

    from ghost_tpu_torch.ops.cuda.aad import aad_modulate, aad_modulate_plain

    max_err = 0.0
    passes = {}
    log(f"K1 aad_modulate vs plain, B={AAD_B} ({card}):")
    log("  dtype    shape              layers  err      bound-ok  plain_us  "
        "call_us  host_us  bytes_bound_us  sets")
    for dt in K1_DTYPES:
        weighted = passes[dt] = {"call": 0.0, "plain": 0.0, "bound": 0.0}
        for hw, c, layers in AAD_BLOCKS:
            sets = _k1_sets(hw, c, dt, device)
            args = sets[0]
            e, ok = _k1_error(args, dt)
            max_err = max(max_err, e)
            kern = _rotating(aad_modulate, sets)
            plain = _rotating(aad_modulate_plain, sets)
            for _ in range(3):
                kern()
                plain()
            plain_ms, call_ms = _time_turns((plain, kern), 20, device)
            host = _host_us(kern, 20, device)
            bound_ms = _k1_bound_ms(args)
            shape = f"({AAD_B},{hw},{hw},{c})"
            log(f"  {dt:8s} {shape:18s} {layers:6d}  {e:.3e}  {ok!s:8s}  "
                f"{plain_ms * 1e3:8.1f}  {call_ms * 1e3:7.1f}  {host:7.1f}  "
                f"{bound_ms * 1e3:14.1f}  {len(sets)}")
            if _k1_small(hw, c):
                with _k1_split_route():
                    e2, ok2 = _k1_error(args, dt)
                    split_ms = _time_one(kern, 20, device)
                    split_host = _host_us(kern, 20, device)
                max_err = max(max_err, e2)
                ok = ok and ok2
                log(f"  {'':8s} {'':18s} the split route: err {e2:.3e} "
                    f"{ok2}, call {split_ms * 1e3:.1f} us, host "
                    f"{split_host:.1f} us (the one-launch route above)")
            weighted["call"] += layers * call_ms
            weighted["plain"] += layers * plain_ms
            weighted["bound"] += layers * bound_ms
            if not ok:
                raise AssertionError(f"K1 disagrees with plain at {dt} "
                                     f"{shape}")
            del sets, args, kern, plain
        torch.cuda.empty_cache()
    for dt, w in passes.items():
        log(f"K1 per 8-frame generator pass (21 layers, {dt}): call "
            f"{w['call']:.3f} ms, plain {w['plain']:.3f} ms, bytes bound "
            f"{w['bound']:.3f} ms" + (f" (the first design: "
                                      f"{K1_FIRST_DESIGN_PASS_MS} ms)"
                                      if dt == "bfloat16" else "")
            + f" ({card})")
    w = passes["bfloat16"]
    return dict(max_abs_err=max_err, call_ms=w["call"], plain_ms=w["plain"],
                bound_ms=w["bound"], bound_by="bytes", library_ms=None,
                library_call=None)


def phase_k1_device(device, card, stats):
    """Device time per kernel of K1 at each generator shape (torch.profiler
    over 20 calls on the rotating input sets of phase 3), and the kernels
    that run just before each K1 call in one full-width generator pass
    (bf16, fused AAD): no copy of h may run there. Runs after every other
    phase, beside phase 15. Sets stats' ms (per pass, bf16)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ghost_tpu_torch.core.precision import DEFAULT_POLICY
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.ops.cuda.aad import aad_modulate

    log(f"K1 device times (torch.profiler, {card}):")
    for dt in K1_DTYPES:
        per_pass = 0.0
        for hw, c, layers in AAD_BLOCKS:
            sets = _k1_sets(hw, c, dt, device)
            kern = _rotating(aad_modulate, sets)
            small = _k1_small(hw, c)
            dev = _device_times(kern, 20, device,
                                kernels_per_call=1 if small else 3)
            dev_ms = sum(dev.values()) / 1e3
            bound_ms = _k1_bound_ms(sets[0])
            per_pass += layers * dev_ms
            log(f"  {dt:8s} ({AAD_B},{hw},{hw},{c}): device "
                f"{dev_ms * 1e3:.1f} us ({_fmt_times(dev)}), "
                f"{bound_ms / dev_ms:.0%} of the {bound_ms * 1e3:.1f} us "
                f"bound (bytes)")
            if small:
                with _k1_split_route():
                    dev = _device_times(kern, 20, device, kernels_per_call=3)
                log(f"  {'':8s} the split route: device "
                    f"{sum(dev.values()):.1f} us ({_fmt_times(dev)})")
            del sets, kern
        torch.cuda.empty_cache()
        log(f"K1 device time per 8-frame generator pass ({dt}): "
            f"{per_pass:.3f} ms ({card})")
        if dt == "bfloat16":
            stats["ms"] = per_pass

    gen = init_weights(AEINet("unet", num_blocks=2, policy=DEFAULT_POLICY,
                              fused_aad=True),
                       torch.Generator().manual_seed(0)).to(device)
    g = torch.Generator(device=device).manual_seed(5)
    xt = torch.rand(8, 256, 256, 3, generator=g, device=device) * 2 - 1
    zid = torch.randn(8, 512, generator=g, device=device)
    with torch.inference_mode():
        gen(xt, zid)
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            gen(xt, zid)
            torch.cuda.synchronize(device)
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    names = [_kernel_name(e.name) for e in kernels]
    # a K1 call's first kernel: pass 1 of the split route, or the
    # one-launch route's only one
    firsts = [i for i, n in enumerate(names)
              if n.startswith("aad_small_kernel")
              or n.startswith("aad_stats_kernel") and n.endswith("false>")]
    before = [names[i - 1] if i else "" for i in firsts]
    copies = [n for n in before if "copy" in n.lower()]
    log(f"K1 in a full-width generator pass (B=8, bf16): {len(firsts)} "
        f"calls, {len(names)} kernels; {len(copies)} copy kernels just "
        f"before a K1 call, {sum('copy' in n.lower() for n in names)} in "
        f"the pass; kernels just before K1: "
        f"{sorted(set(before))}")
    if len(firsts) != 21 or copies:
        raise AssertionError("the generator must run K1 21 times with no "
                             "copy of h before it")


def phase_parity(device):
    """The test config in f32 on the CPU (plain AAD) and on the card."""
    import numpy as np
    import torch

    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.ops.cuda.aad import aad_modulate
    from ghost_tpu_torch.pipeline.swap import (SwapConfig, SwapPipeline,
                                               build_random_pipeline)

    cpu = build_random_pipeline(SwapConfig(**PARITY_CFG),
                                policy=FULL_PRECISION, gen_width=1 / 8,
                                inject_templates=True, seed=0, device="cpu")
    card = SwapPipeline(*[copy.deepcopy(m).to(device) for m in
                          (cpu.det_mod, cpu.arc_mod, cpu.gen_mod,
                           cpu.lmk_mod)], config=cpu.cfg)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (2, 256, 320, 3), dtype=np.uint8)
    sources = rng.integers(0, 255, (1, 224, 224, 3), dtype=np.uint8)
    mp = np.array([[5.0, 5.0, 5.0, 2.0]], np.float32)
    res = {}
    for name, pipe in (("cpu", cpu), ("card", card)):
        src = pipe.embed_sources(sources)
        tgt = pipe.embed_targets(sources)
        before = aad_modulate.launches
        kps, sim, _, _ = pipe._detect_match(frames, tgt)
        out = pipe._detect_swap(frames, tgt, src, mp)
        res[name] = (kps.cpu().numpy(), sim.cpu().numpy(), out.cpu().numpy(),
                     aad_modulate.launches - before)
    kps_d = float(np.abs(res["cpu"][0] - res["card"][0]).max())
    sim_d = float(np.abs(res["cpu"][1] - res["card"][1]).max())
    diff = np.abs(res["cpu"][2].astype(np.int16)
                  - res["card"][2].astype(np.int16))
    changed = float((res["card"][2] != frames).mean())
    log(f"parity cpu vs card (f32, 2x256x320): kps {kps_d:.2e} (<=1e-3), "
        f"sim {sim_d:.2e} (<=1e-4), frames max {int(diff.max())} (<=3) on "
        f"{(diff > 0).mean():.4%} of values (<5%), changed {changed:.2%}, "
        f"K1 launches cpu {res['cpu'][3]} card {res['card'][3]}")
    if not (kps_d <= 1e-3 and sim_d <= 1e-4 and diff.max() <= 3
            and (diff > 0).mean() < 0.05 and changed > 0.01):
        raise AssertionError("card run disagrees with the CPU run")
    if res["cpu"][3] != 0 or res["card"][3] != 21:
        raise AssertionError("K1 launches: CPU must take the plain path, "
                             "the card one kernel per AAD layer (21)")


def phase_main(device, card, iters=5, profile=False):
    """`_detect_swap` at full width on 8 seeded 1080p frames."""
    import torch

    from ghost_tpu_torch.core.precision import DEFAULT_POLICY
    from ghost_tpu_torch.ops.cuda.aad import aad_modulate
    from ghost_tpu_torch.pipeline.swap import SwapConfig, build_random_pipeline

    t0 = time.perf_counter()
    cfg = SwapConfig(chunk_size=8, max_faces=4, match_faces=2, crop_size=224,
                     fused_group=0, similarity_th=-2.0)
    pipe = build_random_pipeline(cfg, policy=DEFAULT_POLICY,
                                 arcface_layers=(3, 13, 30, 3), seed=0,
                                 inject_templates=True, device=device)
    n_params = sum(p.numel() for m in (pipe.det_mod, pipe.arc_mod,
                                       pipe.gen_mod, pipe.lmk_mod)
                   for p in m.parameters())
    g = torch.Generator(device=device).manual_seed(0)
    frames = torch.randint(0, 256, (8, 1080, 1920, 3), generator=g,
                           device=device, dtype=torch.uint8)
    sources = torch.randint(0, 256, (1, 224, 224, 3), generator=g,
                            device=device, dtype=torch.uint8)
    src = pipe.embed_sources(sources)
    tgt = pipe.embed_targets(sources)
    mp = torch.tensor([[5.0, 5.0, 5.0, 2.0]], device=device)
    torch.cuda.synchronize(device)
    log(f"main: built full-width pipeline ({n_params / 1e6:.1f} M params) "
        f"in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    times = []
    for i in range(iters + 1):
        before = aad_modulate.launches
        t = time.perf_counter()
        out = pipe._detect_swap(frames, tgt, src, mp)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t)
        if aad_modulate.launches - before != 21:
            raise AssertionError(f"call {i}: {aad_modulate.launches - before}"
                                 " K1 launches, expected 21")
    launches = aad_modulate.launches
    peak = torch.cuda.max_memory_allocated(device)
    if tuple(out.shape) != (8, 1080, 1920, 3) or out.dtype != torch.uint8:
        raise AssertionError(f"output {tuple(out.shape)} {out.dtype}")
    if not (torch.isfinite(src).all() and torch.isfinite(tgt).all()):
        raise AssertionError("non-finite embeddings")
    changed = float((out != frames).float().mean())
    if not changed > 0:
        raise AssertionError("the blend changed no pixel")
    steady = sorted(times[1:])
    med = steady[len(steady) // 2]
    log(f"main: _detect_swap chunk 8 @1080p bf16: first call "
        f"{times[0] * 1e3:.1f} ms, then "
        f"{', '.join(f'{x * 1e3:.1f}' for x in times[1:])} ms "
        f"({card})")
    log(f"main: {8 / med:.2f} frames/s at the median call "
        f"({8 * iters / sum(times[1:]):.2f} over all {iters}); peak "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; {changed:.2%} of "
        f"values changed; K1 launches {launches} ({card})")
    if profile:
        phase_profile(pipe, frames, tgt, src, mp, device)
    return launches


def phase_profile(pipe, frames, tgt, src, mp, device):
    """One profiled chunk: device time by kernel and the busy share."""
    _profile(lambda: pipe._detect_swap(frames, tgt, src, mp), device)
    phase_stages(pipe, frames, tgt, src, mp, device)


def _dev_us(e):
    """A profiler event's own device time, us."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def _profile(fn, device):
    """Run fn once under torch.profiler: wall, device busy share and the
    top device kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_dev_us(e) for e in kernels)
    log(f"profile: wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{busy / 1e3:.1f} ms ({busy / 1e6 / wall:.1%})")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:25]:
        log(f"  {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")


def _stage(name, fn, device):
    """Host-clock ms of fn (median of 3 synced calls after a warm one)."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    ts = []
    for _ in range(3):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        ts.append(time.perf_counter() - t)
    log(f"  {sorted(ts)[1] * 1e3:8.2f} ms  {name}")


def phase_stages(pipe, frames, tgt, src, mp, device):
    """Host-clock time of each stage of one chunk (median of 3, synced)."""
    import torch

    from ghost_tpu_torch.models.landmark import landmarks_from_crops
    from ghost_tpu_torch.models.scrfd import decode_detections, preprocess_frames
    from ghost_tpu_torch.nn.layers import resize
    from ghost_tpu_torch.ops.mask import soft_face_mask_dynamic
    from ghost_tpu_torch.ops.umeyama import estimate_norm
    from ghost_tpu_torch.ops.warp import (warp_affine_similarity,
                                          warp_and_blend_similarity)

    def stage(name, fn):
        _stage(name, fn, device)

    cfg = pipe.cfg
    b, cs = frames.shape[0], cfg.crop_size
    with torch.inference_mode():
        kps, sim, _, _ = pipe._detect_match_impl(frames, tgt)
        present = sim > cfg.similarity_th
        m = estimate_norm(kps.reshape(b, 5, 2), cs).reshape(b, 1, 2, 3)
        crops = warp_affine_similarity(frames, m, cs, subpix=cfg.crop_subpix,
                                       interp=cfg.crop_interp)
        gen_in = (resize(crops / 255.0, (256, 256)) - 0.5) / 0.5
        z = src.expand(b, -1)
        y, _ = pipe.gen_mod(gen_in, z)
        swap = resize((y * 0.5 + 0.5) * 255.0, (cs, cs))
        lmks = landmarks_from_crops(pipe.lmk_mod, swap, cs)
        mask = soft_face_mask_dynamic(lmks, cs, *mp[0])[..., None]
        log("stages (chunk 8, 1080p, bf16):")
        stage("detect_match (all)", lambda: pipe._detect_match_impl(frames, tgt))
        stage("  letterbox + SCRFD + decode/NMS", lambda: decode_detections(
            pipe.det_mod(preprocess_frames(frames, cfg.det_size)[0]),
            input_size=cfg.det_size, score_thresh=cfg.det_thresh,
            max_faces=cfg.max_faces))
        stage("swap_blend (all)", lambda: pipe._swap_blend_impl(
            frames, kps, present, src, mp, groups=1))
        stage("  224 crops (warp_affine_similarity)", lambda:
              warp_affine_similarity(frames, m, cs, subpix=cfg.crop_subpix,
                                     interp=cfg.crop_interp))
        stage("  AEI-Net (encoder + generator)", lambda: pipe.gen_mod(gen_in, z))
        stage("  landmarks + soft mask", lambda: soft_face_mask_dynamic(
            landmarks_from_crops(pipe.lmk_mod, swap, cs), cs, *mp[0]))
        stage("  paste-back (warp_and_blend_similarity)", lambda:
              warp_and_blend_similarity(frames.to(torch.bfloat16), swap, mask,
                                        m[:, 0], present=present[:, 0],
                                        rot_subpix=cfg.blend_rot_subpix))


# ---------------------------------------------------------------------------
# Launch counts: every kernel wrapper's counter
# ---------------------------------------------------------------------------


def _wrappers():
    from ghost_tpu_torch.ops.cuda import attention, layer_norm
    from ghost_tpu_torch.ops.cuda.aad import aad_modulate
    from ghost_tpu_torch.ops.cuda.conv3x3 import conv3x3

    return {"aad_modulate": aad_modulate, "conv3x3": conv3x3,
            "flash_attention_fwd": attention.flash_attention_fwd,
            "flash_attention_bwd_dq": attention.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": attention.flash_attention_bwd_dkv,
            "fused_layer_norm_fwd": layer_norm.fused_layer_norm_fwd,
            "fused_layer_norm_bwd": layer_norm.fused_layer_norm_bwd}


def zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "tensor_core_launches"):
            fn.tensor_core_launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def read_tensor_core_counts():
    """The K2 backward launches that ran on the bf16 tensor cores."""
    return {name: fn.tensor_core_launches for name, fn in _wrappers().items()
            if hasattr(fn, "tensor_core_launches")}


# ---------------------------------------------------------------------------
# K2 flash attention and K3 fused LayerNorm against their plain versions
# ---------------------------------------------------------------------------


def _close(name, got, ref, dtype, worst, slack=None):
    """Hold got to ref: one ulp of the 16-bit type (2^-7 |ref| in bf16,
    2^-10 |ref| in float16) plus 1e-3 max|ref| for 16-bit tensors (both
    sides round one f32 result), 1e-4 |ref| plus 1e-4 max|ref| for f32
    ones (the same f32 math, sums in another order). `slack` adds twice
    the type's unit roundoff times it (see `_fwd_slack`). Records the
    max abs error under `name` in `worst`."""
    import torch

    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    if dtype == torch.bfloat16:
        bound = 2 ** -7 * ref.abs() + 1e-3 * scale
    elif dtype == torch.float16:
        bound = 2 ** -10 * ref.abs() + 1e-3 * scale
    else:
        bound = 1e-4 * ref.abs() + 1e-4 * scale
    if slack is not None:
        bound = bound + (2 ** -8 if dtype == torch.bfloat16
                         else 2 ** -10) * slack
    e = float(err.max())
    worst[name] = max(worst.get(name, 0.0), e)
    if not (bool(torch.isfinite(got).all()) and bool((err <= bound).all())):
        raise AssertionError(f"{name}: max err {e} (max |ref| {scale})")
    return e


def _fwd_slack(q, k, v, lse, causal, scale):
    """sum_j p_j |v_j|, (B,H,S,D) f32: how far rounding each p to the
    16-bit type can move a forward output. The tensor-core forward rounds
    p = exp(s - m) at its running row max m, the plain version at the row
    max: where the two maxima differ (a row's max found in a later k
    tile) the two round at different scales, and each rounding moves a
    term by at most half an ulp of p."""
    import torch

    from ghost_tpu_torch.ops.cuda import attention as A

    s = A._causal_mask(torch.einsum("bhqd,bhkd->bhqk", q.float() * scale,
                                    k.float()), causal)
    return torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse),
                        v.float().abs())


def _time_one(fn, iters, device):
    """Per-call ms of one fn (the library yardstick), CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def _rotating(fn, sets):
    """A no-argument call of fn on the next of `sets` each time."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def _bound(nbytes, flops, peak_flops):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the peak for the inputs' type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_k2(device, card):
    """K2 forward, dq and dk/dv against their plain versions, and times
    at the training block's shapes beside SDPA and the bounds."""
    import torch
    import torch.nn.functional as F

    from ghost_tpu_torch.ops.cuda import attention as A

    worst, main = {}, {}
    log(f"K2 flash attention vs plain ({card}):")
    phase_sass()
    for b, h, s, d, dt, causal, bq, timed, strided in K2_CASES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=device).manual_seed(s + d)
        if strided:  # heads split from (B, S, H*D) projections, no copy
            q, k, v, do = (torch.randn(b, s, h * d, generator=g,
                                       device=device).to(dtype)
                           .view(b, s, h, d).transpose(1, 2)
                           for _ in range(4))
        else:
            q, k, v, do = (torch.randn(b, h, s, d, generator=g, device=device)
                           .to(dtype) for _ in range(4))
        scale = 1 / d ** 0.5
        before = read_tensor_core_counts()
        out, lse, delta, dq, dk, dv = A._flash_attention_tiles(q, k, v, do,
                                                               causal, bq)
        tc = {n: c - before[n] for n, c in read_tensor_core_counts().items()}
        want_tc = {"flash_attention_fwd": int(A.on_tensor_cores(q, True)),
                   "flash_attention_bwd_dq": int(A.on_tensor_cores(q)),
                   "flash_attention_bwd_dkv": int(A.on_tensor_cores(q))}
        if tc != want_tc:
            raise AssertionError(f"tensor-core launches {tc} for {dt} D={d}")
        fam = {1: "tensor-core", 0: "FMA"}
        route = (f"fwd on the {fam[tc['flash_attention_fwd']]} kernel, dq and "
                 f"dk/dv on the {fam[tc['flash_attention_bwd_dq']]}")
        ref, ref_lse = A.flash_attention_fwd_plain(q, k, v, causal)
        args = (q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize(device)
        want_dq = A.flash_attention_bwd_dq_plain(*args)
        want_dk, want_dv = A.flash_attention_bwd_dkv_plain(*args)
        tag = (f"({b},{h},{s},{d}) {dt} causal={causal} block_q={bq}"
               + (" strided heads" if strided else ""))
        slack = (_fwd_slack(q, k, v, ref_lse, causal, scale)
                 if A.on_tensor_cores(q, True) else None)
        errs = [_close("flash_attention_fwd", out, ref, dtype, worst, slack),
                _close("flash_attention_fwd", lse, ref_lse, torch.float32,
                       worst),
                _close("flash_attention_bwd_dq", dq, want_dq, dtype, worst),
                _close("flash_attention_bwd_dkv", dk, want_dk, dtype, worst),
                _close("flash_attention_bwd_dkv", dv, want_dv, dtype, worst)]
        log(f"  {tag}: max err out {errs[0]:.2e} lse {errs[1]:.2e} dq "
            f"{errs[2]:.2e} dk {errs[3]:.2e} dv {errs[4]:.2e} (within bound; "
            f"{route} kernels)")
        del ref, ref_lse, want_dq, want_dk, want_dv, slack
        if dtype != torch.float32:
            _vs_f32(tag, q, k, v, do, causal, scale, (out, dq, dk, dv))
        if not timed:
            continue
        iters = 3 if s <= 1024 else 2
        pairs = s * (s + 1) // 2 if causal else s * s
        mm = 2 * b * h * pairs * d  # one (S x S x D) product's flops
        row = b * h * s * d * q.element_size()
        stats = b * h * s * 4
        # aten's flash-attention backward computes dq, dk and dv together
        # from its forward's saved LSE: the one library call for the pair,
        # reported on the dk/dv row
        lib_fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, causal, False, scale=scale)
        lib_o, lib_lse, cq, ck, mq, mk, seed, offset = lib_fwd[:8]

        def lib_bwd():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                do, q, k, v, lib_o, lib_lse, cq, ck, mq, mk, 0.0, causal, seed,
                offset, scale=scale)

        lib_dq = lib_bwd()[0]
        log(f"  {tag} aten flash backward: max |dq - kernel dq| "
            f"{float((lib_dq.float() - dq.float()).abs().max()):.2e}")
        del lib_dq
        rows = {
            "flash_attention_fwd": (
                lambda: A.flash_attention_fwd_plain(q, k, v, causal),
                lambda: A.flash_attention_fwd(q, k, v, causal),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal),
                _bound(4 * row + stats, 2 * mm, BF16_FLOPS)),
            "flash_attention_bwd_dq": (
                lambda: A.flash_attention_bwd_dq_plain(*args),
                lambda: A.flash_attention_bwd_dq(*args), None,
                _bound(5 * row + 2 * stats, 3 * mm, BF16_FLOPS)),
            "flash_attention_bwd_dkv": (
                lambda: A.flash_attention_bwd_dkv_plain(*args),
                lambda: A.flash_attention_bwd_dkv(*args), lib_bwd,
                _bound(6 * row + 2 * stats, 4 * mm, BF16_FLOPS)),
        }
        with torch.no_grad():
            for name, (plain, kern, lib, (bound, by)) in rows.items():
                plain_ms, kern_ms = _time_turns((plain, kern), iters, device)
                lib_ms = None if lib is None else _time_one(lib, iters, device)
                lib_txt = ("none" if lib_ms is None
                           else f"{lib_ms:.3f} ms ({LIBRARY[name]})")
                log(f"  {tag} {name}: kernel {kern_ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, library {lib_txt}, bound "
                    f"{bound:.3f} ms ({by})")
                if (s, d, causal) == (TRAIN["seq"], TRAIN["head_dim"], True):
                    main[name] = dict(ms=kern_ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=bound,
                                      bound_by=by, library_call=LIBRARY[name])

        def plain_all():
            o, l_ = A.flash_attention_fwd_plain(q, k, v, causal)
            a = (q, k, v, do, l_, A.attention_delta(o, do), causal, scale)
            A.flash_attention_bwd_dq_plain(*a)
            A.flash_attention_bwd_dkv_plain(*a)

        def kern_all():
            o, l_ = A.flash_attention_fwd(q, k, v, causal)
            a = (q, k, v, do, l_, A.attention_delta(o, do), causal, scale)
            A.flash_attention_bwd_dq(*a)
            A.flash_attention_bwd_dkv(*a)

        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

        def sdpa_all():
            F.scaled_dot_product_attention(qg, kg, vg,
                                           is_causal=causal).backward(do)

        with torch.no_grad():
            plain_ms, kern_ms = _time_turns((plain_all, kern_all), iters,
                                            device)
        lib_ms = _time_one(sdpa_all, iters, device)
        bound, by = _bound(10 * row + 2 * stats, 7 * mm, BF16_FLOPS)
        log(f"  {tag} fwd+bwd: kernels {kern_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, SDPA fwd+bwd {lib_ms:.3f} ms, bound "
            f"{bound:.3f} ms ({by}; 2 + 5 products)")
        del qg, kg, vg, lib_fwd, lib_o, lib_lse
        torch.cuda.empty_cache()
    for name in main:
        main[name]["max_abs_err"] = worst[name]
    return main


def _vs_f32(tag, q, k, v, do, causal, scale, results):
    """The kernels' 16-bit (out, dq, dk, dv) against the f32 result (the
    plain functions on the same 16-bit values in f32, with the f32
    forward's LSE and delta), beside aten's flash forward + backward on
    the same 16-bit inputs. Each may err at most twice as much as aten's
    plus 1e-4 max|ref|: both round p (and ds) to the 16-bit type for
    their products."""
    import torch

    from ghost_tpu_torch.ops.cuda import attention as A

    f32 = [t.float() for t in (q, k, v, do)]
    o32, lse32 = A.flash_attention_fwd_plain(*f32[:3], causal, scale)
    a32 = (*f32, lse32, A.attention_delta(o32, f32[3]), causal, scale)
    ref = (o32, A.flash_attention_bwd_dq_plain(*a32),
           *A.flash_attention_bwd_dkv_plain(*a32))
    del f32, lse32, a32
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    lib_o, lib_lse, cq, ck, mq, mk, seed, offset = \
        torch.ops.aten._scaled_dot_product_flash_attention(
            qc, kc, vc, 0.0, causal, False, scale=scale)[:8]
    lib = (lib_o, *torch.ops.aten._scaled_dot_product_flash_attention_backward(
        doc, qc, kc, vc, lib_o, lib_lse, cq, ck, mq, mk, 0.0, causal, seed,
        offset, scale=scale)[:3])
    parts, ok = [], True
    for name, got, lg, r in zip(("out", "dq", "dk", "dv"), results, lib,
                                ref):
        ek = float((got.float() - r).abs().max())
        el = float((lg.float() - r).abs().max())
        ok = ok and ek <= 2 * el + 1e-4 * float(r.abs().max())
        parts.append(f"{name} {ek:.3e} (aten {el:.3e})")
    log(f"  {tag} vs the f32 result, max err: {', '.join(parts)}; "
        f"within 2 x aten + 1e-4 max|ref|: {ok}")
    if not ok:
        raise AssertionError(f"{tag}: less accurate than aten's flash "
                             "backward allows")


def _sass(lib):
    """cuobjdump -sass of a built library: {mangled kernel name: its
    instruction lines}."""
    import re

    from ghost_tpu_torch.ops.cuda import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path(lib))],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    fns, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            fns[fn] = []
        elif fn is not None:
            fns[fn].append(line)
    return fns


def phase_sass():
    """HMMA/HGMMA instructions in each kernel of the built K2 and S2
    libraries (cuobjdump -sass): every tensor-core kernel (K2's forward,
    dq and dk/dv in bf16 and float16, S2's bf16 conv) must have some, the
    FMA kernels none. Then the 128-bit global loads (LDG.E.128) of each
    K3 kernel: every vector-route forward and backward kernel must have
    some."""
    import re

    from ghost_tpu_torch.ops.cuda import _build

    counts = {}
    for lib, pattern in (
            ("flash_attention", r"(flash_(?:fwd|dq|dkv)(?:_mma)?_kernel)"),
            ("conv3x3", r"(conv3x3(?:_mma)?_kernel)")):
        for mangled, lines in _sass(lib).items():
            m = re.search(r"\S*?" + pattern + r"I(\w+?)EEv", mangled)
            if not m:
                continue
            targs = (re.sub(r"^f(?=L|$)", "f32,", m.group(2))
                     .replace("13__nv_bfloat16", "bf16,")
                     .replace("6__half", "f16,")
                     .replace("Lb1E", "vec").replace("Lb0E", "elem"))
            targs = re.sub(r"Li(\d+)E", r"\1,", targs)
            fn = f"{m.group(1)}<{targs.rstrip(',')}>"
            counts[fn] = sum(bool(re.search(r"\bH(?:G)?MMA\b", line))
                             for line in lines)
        log(f"tensor-core instructions (HMMA/HGMMA in cuobjdump -sass of "
            f"{_build._lib_path(lib).name}):")
        for name, n in counts.items():
            if name.startswith(lib[:4]):
                log(f"  {name}: {n}")
    mma = {fn: n for fn, n in counts.items() if "_mma_kernel" in fn}
    fma = {fn: n for fn, n in counts.items() if "_mma_kernel" not in fn}
    # K2: fwd (3 head-dim tiles), dq and dk/dv (2 each) x vec/elem x
    # bf16/f16; S2: 3 output-channel tiles x vec/elem
    if len(mma) != 34 or not all(mma.values()) or any(fma.values()):
        raise AssertionError(f"tensor-core kernels without HMMA, or FMA "
                             f"kernels with it: {counts}")
    # K3: ln_{fwd,bwd}_kernel<T, G, W, NV, wide>; W > 1 is a vector route
    routes = {}
    for mangled, lines in _sass("layer_norm").items():
        m = re.search(r"(ln_(?:fwd|bwd|bwd_reduce)_kernel)I(\w+)", mangled)
        if not m:
            continue
        w = re.search(r"Li(\d+)E", m.group(2))
        route = ("vector" if w and int(w.group(1)) > 1 else
                 "element" if w else "-")
        n = sum(bool(re.search(r"\bLDG\.E[\w.]*?\.128\b", line))
                for line in lines)
        routes.setdefault((m.group(1), route), []).append(n)
    log(f"128-bit global loads (LDG.E.128 in cuobjdump -sass of "
        f"{_build._lib_path('layer_norm').name}), per kernel:")
    for (kind, route), ns in sorted(routes.items()):
        log(f"  {kind} {route}: {len(ns)} kernels, LDG.E.128 {min(ns)}-"
            f"{max(ns)} per kernel")
    vec = [n for (kind, route), ns in routes.items() if route == "vector"
           for n in ns]
    # forward and backward: 3 warp-route widths + the wide route, x 3
    # dtypes x 3 gamma dtypes
    if len(vec) != 72 or not all(vec):
        raise AssertionError(f"K3 vector kernels without 128-bit loads: "
                             f"{routes}")
    return mma


def _kernel_name(key):
    """A profiler kernel name without its namespaces' noise and its
    argument list."""
    import re

    key = re.sub(r"\(anonymous namespace\)::", "", key)
    key = re.sub(r"^void ", "", key)
    return key.split("(")[0][:100]


def _device_times(fn, iters, device, kernels_per_call=None):
    """Each kernel's device us per call of fn, from torch.profiler over
    `iters` calls after a warm one: {kernel name: us}. With
    kernels_per_call, a session that recorded another number of kernels
    (the profiler can drop events) is run again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize(device)
        times, count = {}, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and _dev_us(e):
                name = _kernel_name(e.key)
                times[name] = times.get(name, 0.0) + _dev_us(e) / iters
                count += e.count
        if kernels_per_call is None or count == kernels_per_call * iters:
            break
    else:
        raise AssertionError(f"torch.profiler recorded {count} kernels in "
                             f"{iters} calls, {kernels_per_call} expected "
                             f"a call")
    if not times:
        raise AssertionError("torch.profiler recorded no device time")
    return times


def _host_us(fn, iters, device):
    """Host us per call of fn: time.perf_counter over `iters` calls with
    no sync between them (the caller's cost to enqueue), after a warm
    call; the device is drained after the clock stops."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize(device)
    return t / iters * 1e6


def _fmt_times(times):
    return ", ".join(f"{k} {v:.1f}" for k, v in times.items())


def _k3_inputs(rows, h, dt, gdt, device):
    """x, dy, gamma, beta of a K3 case, and the generator that made them
    (seeded by the shape, so a later phase can make them again)."""
    import torch

    dtype, gdtype = getattr(torch, dt), getattr(torch, gdt)
    g = torch.Generator(device=device).manual_seed(rows + h)
    x = (torch.randn(rows, h, generator=g, device=device) * 2 + 1).to(dtype)
    dy = torch.randn(rows, h, generator=g, device=device).to(dtype)
    gamma = torch.randn(h, generator=g, device=device).to(gdtype)
    beta = torch.randn(h, generator=g, device=device).to(gdtype)
    return x, dy, gamma, beta, g


def _k3_timed(rows, h, dt, gdt, device):
    """The timed calls of a K3 case on K3_SETS input sets, each call on the
    next, so that every call reads its inputs from HBM (all of them,
    >= 268 MB, overflow the 50 MB L2, where one set of 17-67 MB would stay
    between calls): {name: (plain, kernel, library, (bound ms, by))},
    each a no-argument call."""
    import torch
    import torch.nn.functional as F

    from ghost_tpu_torch.ops.cuda import layer_norm as L

    x, _, gamma, beta, g = _k3_inputs(rows, h, dt, gdt, device)
    dtype = x.dtype
    gl, bl = gamma.to(dtype), beta.to(dtype)
    sets = []
    for _ in range(K3_SETS):
        xs = (torch.randn(rows, h, generator=g, device=device) * 2 + 1).to(dtype)
        dys = torch.randn(rows, h, generator=g, device=device).to(dtype)
        _, ms, rs = L.fused_layer_norm_fwd(xs, gamma, beta)
        _, ml, rl = torch.ops.aten.native_layer_norm(xs, [h], gl, bl, 1e-5)
        sets.append((xs, dys, ms, rs, ml, rl))
    xb = rows * h * x.element_size()
    gb = h * gamma.element_size()
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    fns = {
        "fused_layer_norm_fwd": (
            lambda xs, dys, ms, rs, ml, rl: L.layer_norm_fwd_plain(
                xs, gamma, beta),
            lambda xs, dys, ms, rs, ml, rl: L.fused_layer_norm_fwd(
                xs, gamma, beta),
            lambda xs, dys, ms, rs, ml, rl: F.layer_norm(xs, (h,), gl, bl),
            _bound(2 * xb + 2 * gb + 2 * rows * 4, 8 * rows * h, peak)),
        "fused_layer_norm_bwd": (
            lambda xs, dys, ms, rs, ml, rl: L.layer_norm_bwd_plain(
                xs, gamma, ms, rs, dys),
            lambda xs, dys, ms, rs, ml, rl: L.fused_layer_norm_bwd(
                xs, gamma, ms, rs, dys),
            lambda xs, dys, ms, rs, ml, rl:
                torch.ops.aten.native_layer_norm_backward(
                    dys, xs, [h], ml, rl, gl, bl, [True, True, True]),
            _bound(3 * xb + 3 * gb + 2 * rows * 4, 12 * rows * h, peak)),
    }
    return {name: (_rotating(plain, sets), _rotating(kern, sets),
                   _rotating(lib, sets), bound)
            for name, (plain, kern, lib, bound) in fns.items()}


def phase_k3(device, card):
    """K3 forward and backward against their plain versions at every
    K3_CASES shape; for the timed ones, the call time (CUDA events around
    20 back-to-back calls) and the wrapper's host us per call, beside
    F.layer_norm / aten's backward (the same two), the plain versions and
    the bounds. Device times come last (phase_k3_device)."""
    import torch

    from ghost_tpu_torch.ops.cuda import layer_norm as L

    worst, main = {}, {}
    log(f"K3 fused LayerNorm vs plain ({card}):")
    for rows, h, dt, gdt, timed in K3_CASES:
        x, dy, gamma, beta, _ = _k3_inputs(rows, h, dt, gdt, device)
        y, mean, rstd = L.fused_layer_norm_fwd(x, gamma, beta)
        dx, dg, db = L.fused_layer_norm_bwd(x, gamma, mean, rstd, dy)
        torch.cuda.synchronize(device)
        ref = L.layer_norm_fwd_plain(x, gamma, beta)
        want = L.layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
        f32 = torch.float32
        errs = [_close("fused_layer_norm_fwd", y, ref[0], x.dtype, worst),
                _close("fused_layer_norm_fwd", mean, ref[1], f32, worst),
                _close("fused_layer_norm_fwd", rstd, ref[2], f32, worst),
                _close("fused_layer_norm_bwd", dx, want[0], x.dtype, worst),
                _close("fused_layer_norm_bwd", dg, want[1], gamma.dtype,
                       worst),
                _close("fused_layer_norm_bwd", db, want[2], gamma.dtype,
                       worst)]
        tag = f"({rows},{h}) {dt} gamma {gdt}"
        log(f"  {tag}: max err y {errs[0]:.2e} mean {errs[1]:.2e} rstd "
            f"{errs[2]:.2e} dx {errs[3]:.2e} dgamma {errs[4]:.2e} dbeta "
            f"{errs[5]:.2e} (within bound)")
        if not timed:
            continue
        for name, (plain, kern, lib, (bound, by)) in _k3_timed(
                rows, h, dt, gdt, device).items():
            plain_ms, call_ms = _time_turns((plain, kern), 20, device)
            lib_call_ms = _time_one(lib, 20, device)
            host, lib_host = (_host_us(kern, 20, device),
                              _host_us(lib, 20, device))
            log(f"  {tag} {name}: call {call_ms * 1e3:.1f} us, host "
                f"{host:.1f} us/call; library call {lib_call_ms * 1e3:.1f} "
                f"us, host {lib_host:.1f} us/call; plain "
                f"{plain_ms * 1e3:.1f} us; bound {bound * 1e3:.1f} us ({by})")
            if (rows, h, dt) == (8192, 1024, "bfloat16"):
                main[name] = dict(call_ms=call_ms, plain_ms=plain_ms,
                                  library_call_ms=lib_call_ms,
                                  bound_ms=bound, bound_by=by,
                                  library_call=LIBRARY[name])
    for name in main:
        main[name]["max_abs_err"] = worst[name]
    return main


def phase_k3_device(device, card, main):
    """Device time per kernel of each timed K3 case and of its library
    call, from torch.profiler (the backward's main and reduction kernels
    apart). Runs after every other phase: a profiler session can leave
    the host slower for the rest of the process, which would move the
    host-bound numbers of the later phases. Sets main's ms and
    library_ms (8192 x 1024 bf16)."""
    log(f"K3 device times (torch.profiler, {card}):")
    for rows, h, dt, gdt, timed in K3_CASES:
        if not timed:
            continue
        tag = f"({rows},{h}) {dt} gamma {gdt}"
        for name, (_, kern, lib, (bound, by)) in _k3_timed(
                rows, h, dt, gdt, device).items():
            dev, lib_dev = (_device_times(kern, 20, device),
                            _device_times(lib, 20, device))
            dev_ms, lib_ms = (sum(dev.values()) / 1e3,
                              sum(lib_dev.values()) / 1e3)
            log(f"  {tag} {name}: device {dev_ms * 1e3:.1f} us "
                f"({_fmt_times(dev)}), {bound / dev_ms:.0%} of the "
                f"{bound * 1e3:.1f} us bound ({by}); library device "
                f"{lib_ms * 1e3:.1f} us ({_fmt_times(lib_dev)})")
            if (rows, h, dt) == (8192, 1024, "bfloat16"):
                main[name].update(ms=dev_ms, library_ms=lib_ms)


def phase_k3_path(device):
    """K3's own op, fused_layer_norm, forward and backward through
    autograd at 8192 x 1024 bf16, every count zeroed just before."""
    import torch

    from ghost_tpu_torch.ops.cuda.layer_norm import fused_layer_norm

    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(8192, 1024, generator=g, device=device).to(torch.bfloat16)
    x.requires_grad_()
    gamma = torch.ones(1024, device=device, requires_grad=True)
    beta = torch.zeros(1024, device=device, requires_grad=True)
    zero_counts()
    y = fused_layer_norm(x, gamma, beta)
    y.float().square().sum().backward()
    torch.cuda.synchronize(device)
    counts = read_counts()
    ok = all(bool(torch.isfinite(t).all())
             for t in (y, x.grad, gamma.grad, beta.grad))
    log(f"K3 path: fused_layer_norm fwd+bwd (8192,1024) bf16: launches fwd "
        f"{counts['fused_layer_norm_fwd']} bwd "
        f"{counts['fused_layer_norm_bwd']}, finite {ok}")
    if not ok or (counts["fused_layer_norm_fwd"],
                  counts["fused_layer_norm_bwd"]) != (1, 1):
        raise AssertionError(f"K3 path: {counts}, finite {ok}")
    return counts


# ---------------------------------------------------------------------------
# The training slice: norm-add causal attention + MLP, 3 ghost_adam steps
# ---------------------------------------------------------------------------


def _block(d, heads, head_dim, hidden, policy, seed):
    """MultiheadAttention (causal, norm_add) then MLP((hidden, d)), with
    a seeded flax-style init on the CPU."""
    import torch

    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.nn.modules import MLP, MultiheadAttention

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = MultiheadAttention(d, heads, head_dim, causal=True,
                                           norm_add=True, policy=policy)
            self.mlp = MLP(d, (hidden, d), policy=policy)

        def forward(self, x):
            return self.mlp(self.attn(x))

    return init_weights(Block(), torch.Generator().manual_seed(seed))


def _train(block, x, labels, steps, lr, on_step=None):
    """`steps` ghost_adam steps on the mean cross-entropy; the losses."""
    import torch

    from ghost_tpu_torch.nn.modules import softmax_cross_entropy
    from ghost_tpu_torch.train.optimizers import ghost_adam

    opt = ghost_adam(block.parameters(), lr=lr)
    losses = []
    for i in range(steps):
        opt.zero_grad()
        logits = block(x)
        loss = torch.mean(softmax_cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if on_step is not None:
            on_step(i)
    return losses


def phase_train(device, card):
    """The slice's path at full width: 3 training steps of the block,
    one K2 forward, dq and dk/dv launch each per step."""
    import torch

    from ghost_tpu_torch.core.precision import DEFAULT_POLICY

    t = TRAIN
    d = t["heads"] * t["head_dim"]
    block = _block(d, t["heads"], t["head_dim"], t["hidden"],
                   DEFAULT_POLICY, seed=0).to(device)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(t["batch"], t["seq"], d, generator=g, device=device)
    labels = torch.randint(0, d, (t["batch"] * t["seq"],), generator=g,
                           device=device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    stamps = [time.perf_counter()]
    per_step = []
    k2 = ("flash_attention_fwd", "flash_attention_bwd_dq",
          "flash_attention_bwd_dkv")

    def on_step(i):
        torch.cuda.synchronize(device)
        stamps.append(time.perf_counter())
        c = read_counts()
        per_step.append(tuple(c[n] for n in k2))

    zero_counts()
    losses = _train(block, x, labels, t["steps"], t["lr"], on_step)
    counts = read_counts()
    steps_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    peak = torch.cuda.max_memory_allocated(device)
    log(f"train: MHA(8x64, causal, norm_add) + MLP(2048, 512), bf16 compute, "
        f"x (8,4096,512), ghost_adam lr 4e-4: losses "
        f"{', '.join(f'{v:.6f}' for v in losses)}; step ms "
        f"{', '.join(f'{v:.1f}' for v in steps_ms)}; peak "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; launches {counts} "
        f"({card})")
    tc = read_tensor_core_counts()
    log(f"train: fwd, dq and dk/dv launches on the bf16 tensor-core kernels "
        f"{tc}; losses against the f32-p/ds run {TRAIN_LOSSES}: first "
        f"within {TRAIN_FIRST_LOSS_TOL}, then within {TRAIN_LOSS_TOL}")
    want = [(i + 1,) * 3 for i in range(t["steps"])]
    if per_step != want:
        raise AssertionError(f"K2 launches after each step {per_step}, "
                             f"want {want}")
    if set(tc.values()) != {t["steps"]}:
        raise AssertionError(f"tensor-core launches {tc}, want {t['steps']}")
    if not all(abs(v) < float("inf") for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if (abs(losses[0] - TRAIN_LOSSES[0]) > TRAIN_FIRST_LOSS_TOL
            or any(abs(a - b) > TRAIN_LOSS_TOL
                   for a, b in zip(losses[1:], TRAIN_LOSSES[1:]))):
        raise AssertionError(f"losses {losses}, want {TRAIN_LOSSES}")
    return counts


def phase_train_parity(device):
    """The tiny f32 block (tests/test_torch_modules.py): 3 steps on the
    CPU (plain core) and on the card (K2) from the same weights."""
    import numpy as np
    import torch

    from ghost_tpu_torch.core.precision import FULL_PRECISION

    s = TRAIN_PARITY
    d = s["heads"] * s["head_dim"]
    cpu = _block(d, s["heads"], s["head_dim"], s["hidden"], FULL_PRECISION,
                 seed=1)
    card = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(
        (s["batch"], s["seq"], d)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, d, (s["batch"] * s["seq"],)))
    res = {}
    for name, blk, dev in (("cpu", cpu, "cpu"), ("card", card, device)):
        zero_counts()
        losses = _train(blk, x.to(dev), labels.to(dev), 3, 4e-4)
        res[name] = (losses, read_counts()["flash_attention_fwd"],
                     {k: p.detach().cpu() for k, p in blk.named_parameters()})
    loss_d = max(abs(a - b) for a, b in zip(res["cpu"][0], res["card"][0]))
    # the key bias's gradient is zero in exact arithmetic (it shifts each
    # score row by a constant): Adam steps it on rounding noise, so it is
    # held to 3 steps of 2 lr; every other tensor to 1e-4
    worst = 0.0
    for k, p in res["cpu"][2].items():
        err = float((p - res["card"][2][k]).abs().max())
        if err > (6 * 4e-4 if k == "attn.k_proj.bias" else 1e-4):
            raise AssertionError(f"train parity: {k} differs by {err}")
        if k != "attn.k_proj.bias":
            worst = max(worst, err)
    log(f"train parity cpu vs card (f32, B2 S128 2x16, MLP (64, 32)): losses "
        f"{res['cpu'][0]} vs {res['card'][0]} (max diff {loss_d:.2e} <= "
        f"1e-4), params max diff {worst:.2e} (<= 1e-4), K2 fwd launches cpu "
        f"{res['cpu'][1]} card {res['card'][1]}")
    if loss_d > 1e-4 or res["cpu"][1] != 0 or res["card"][1] != 3:
        raise AssertionError("train parity failed")


# ---------------------------------------------------------------------------
# S2, the SR seats and the --use_sr video path
# ---------------------------------------------------------------------------


def phase_s2(device, card):
    """S2 against its plain version at the scripts' and the seat's
    shapes; times beside F.conv2d and the bounds. The kernels line takes
    one student pass (18 convs at 16 crops, bf16)."""
    import torch
    import torch.nn.functional as F

    from ghost_tpu_torch.ops.cuda.conv3x3 import (conv3x3, conv3x3_dx_kernel,
                                                  conv3x3_reference)

    worst = 0.0
    seat = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0}
    log(f"S2 conv3x3 vs plain ({card}):")
    for b, h, w, cin, cout, tag in S2_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=device).manual_seed(b * h + cin + cout)

            def inputs():
                return (torch.randn(b, h, w, cin, generator=g,
                                    device=device).to(dtype),)

            k = (torch.randn(3, 3, cin, cout, generator=g, device=device)
                 / (9 * cin) ** 0.5).to(dtype)
            bias = torch.randn(cout, generator=g, device=device) * 0.1
            (x,) = inputs()
            y = conv3x3(x, k, bias)
            torch.cuda.synchronize(device)
            ref = conv3x3_reference(x, k, bias).float()
            err = (y.float() - ref).abs()
            # the card bound of tests/test_torch_conv3x3.py: the f32 sums
            # of 9*Cin products in another order part by ~1e-5 of the
            # sums' scale (max |ref|), plus one bf16 rounding step
            scale = float(ref.abs().max())
            rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
            bound = rel * ref.abs() + 1e-5 * scale
            e = float(err.max())
            worst = max(worst, e)
            name = str(dtype).replace("torch.", "")
            shape = f"({b},{h},{w},{cin}->{cout})"
            if not (bool(torch.isfinite(y).all()) and bool((err <= bound).all())):
                raise AssertionError(f"S2 disagrees with plain at {name} "
                                     f"{shape}: max err {e}")
            dx_txt = ""
            if dtype == torch.bfloat16:
                # dx = S2 on the turned kernel, against the plain gradient
                # (autograd of the plain version: an f32 conv of the same
                # bf16 values, cast once), under the same bound
                dy = torch.randn(b, h, w, cout, generator=g,
                                 device=device).to(dtype)
                k_dx = conv3x3_dx_kernel(k)
                dx = conv3x3(dy, k_dx)
                xr = x.detach().requires_grad_()
                conv3x3_reference(xr, k, bias).backward(dy)
                ref_dx = xr.grad.float()
                torch.cuda.synchronize(device)
                err_dx = (dx.float() - ref_dx).abs()
                e_dx = float(err_dx.max())
                worst = max(worst, e_dx)
                if not (bool(torch.isfinite(dx).all()) and bool(
                        (err_dx <= 2.0 ** -7 * ref_dx.abs()
                         + 1e-5 * float(ref_dx.abs().max())).all())):
                    raise AssertionError(f"S2 dx disagrees with the plain "
                                         f"gradient at {shape}: {e_dx}")
                dx_ms = _time_one(lambda: conv3x3(dy, k_dx), 5, device)
                dx_txt = (f"; dx err {e_dx:.2e} (within bound), dx kernel "
                          f"{dx_ms * 1e3:.1f} us")
                del dy, dx, xr, ref_dx, err_dx
            esize = x.element_size()
            io = (b * h * w * (cin + cout)) * esize
            nbytes = io + k.numel() * esize + cout * 4
            flops = 2 * b * h * w * 9 * cin * cout
            peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
            bound_ms, by = _bound(nbytes, flops, peak)
            # enough input sets that every call reads its input from HBM
            sets = [(x,)] + [inputs() for _ in range(
                min(7, max(0, math.ceil(S2_ROTATE_BYTES / io) - 1)))]
            iters = 5 if b * h * w * cin * cout > 2 ** 30 else 20
            plain_ms, kern_ms = _time_turns(
                (_rotating(lambda xs: conv3x3_reference(xs, k, bias), sets),
                 _rotating(lambda xs: conv3x3(xs, k, bias), sets)),
                iters, device)
            k_oihw = k.permute(3, 2, 0, 1).contiguous()
            b_lib = bias.to(dtype)
            lib_sets = [(xs.permute(0, 3, 1, 2),) for (xs,) in sets]
            lib = F.conv2d(lib_sets[0][0], k_oihw, b_lib, padding=1)
            lib_err = float((lib.permute(0, 2, 3, 1).float() - ref).abs().max())
            lib_ms = _time_one(_rotating(
                lambda xs: F.conv2d(xs, k_oihw, b_lib, padding=1), lib_sets),
                iters, device)
            log(f"  {name:8s} {shape:22s} {tag:12s} err {e:.2e} (within "
                f"bound); kernel {kern_ms * 1e3:9.1f} us, plain "
                f"{plain_ms * 1e3:9.1f} us, F.conv2d {lib_ms * 1e3:8.1f} us "
                f"(|d| vs plain {lib_err:.1e}), bound {bound_ms * 1e3:7.1f} "
                f"us ({by}); {len(sets)} input sets{dx_txt}")
            if dtype == torch.bfloat16 and tag in S2_SEAT_PASS:
                n = S2_SEAT_PASS[tag]
                seat["ms"] += n * kern_ms
                seat["plain_ms"] += n * plain_ms
                seat["library_ms"] += n * lib_ms
                seat["bound_ms"] += n * bound_ms
                seat["bytes_ms"] += n * nbytes / HBM_BYTES_PER_S * 1e3
                seat["ops_ms"] += n * flops / BF16_FLOPS * 1e3
            del sets, lib_sets, lib, y, ref, err, bound
            torch.cuda.empty_cache()
    by = "bytes" if seat["bytes_ms"] >= seat["ops_ms"] else "operations"
    log(f"S2 per student pass (18 convs, 16 crops of 128x128, bf16): kernel "
        f"{seat['ms']:.3f} ms, plain {seat['plain_ms']:.3f} ms, F.conv2d "
        f"{seat['library_ms']:.3f} ms, bound {seat['bound_ms']:.3f} ms "
        f"({by}) ({card})")
    return dict(max_abs_err=worst, ms=seat["ms"], plain_ms=seat["plain_ms"],
                bound_ms=seat["bound_ms"], bound_by=by,
                library_ms=seat["library_ms"],
                library_call=LIBRARY["conv3x3"])


def _student(policy):
    """The SR student seat on its bundled weights, on the CPU."""
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.core.checkpoint import load_msgpack
    from ghost_tpu_torch.models.sr.srvgg import (SRVGGStudentSeat,
                                                 srvgg_from_variables)

    variables = load_msgpack(STUDENT)
    student = srvgg_from_variables(variables, policy=policy)
    return SRVGGStudentSeat(load_flax_variables(student, variables)).eval()


def phase_seat_parity(device, card):
    """The student seat in f32 on the CPU (plain conv) and on the card
    (S2), same weights and inputs."""
    import numpy as np
    import torch

    from ghost_tpu_torch.core.precision import FULL_PRECISION

    cpu = _student(FULL_PRECISION)
    on_card = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.uniform(-1, 1, (4, 256, 256, 3)).astype(
        np.float32))
    res = {}
    with torch.inference_mode():
        for name, seat, dev in (("cpu", cpu, "cpu"),
                                ("card", on_card, device)):
            zero_counts()
            out = seat(y.to(dev)).cpu()
            res[name] = (out, read_counts()["conv3x3"])
    err = float((res["cpu"][0] - res["card"][0]).abs().max())
    log(f"seat parity cpu vs card (bundled student 32f/16c x2, f32, "
        f"4x256x256): max |d| {err:.2e} (<= 1e-4), S2 launches cpu "
        f"{res['cpu'][1]} card {res['card'][1]} ({card})")
    if not (err <= 1e-4 and bool(torch.isfinite(res["card"][0]).all())):
        raise AssertionError(f"seat parity: max |d| {err}")
    if (res["cpu"][1], res["card"][1]) != (0, 18):
        raise AssertionError("S2 launches: the CPU must take the plain "
                             "path, the card one launch per conv (18)")


def _seat_calls(valid, chunk, groups):
    """SR seat calls per lane of one swap-blend call on a chunk whose
    first `valid` frames are real (the rest padding, absent), split into
    `groups` micro-batch groups: a group with no present frame skips
    the lane."""
    size = chunk // groups
    return sum(1 for i in range(groups) if i * size < valid)


def phase_video(device, card, profile=False):
    """The --use_sr video path at full width with the student seat on
    its bundled weights; the S2 launches of its first entry point."""
    import numpy as np
    import torch

    from ghost_tpu_torch.core.precision import DEFAULT_POLICY
    from ghost_tpu_torch.models.sr.generator import LIPSPADEGenerator
    from ghost_tpu_torch.nn.layers import cast_to_compute_dtype, init_weights
    from ghost_tpu_torch.pipeline.swap import (SwapConfig, SwapPipeline,
                                               build_random_pipeline)

    v = VIDEO
    n, chunk, t = v["frames"], v["chunk"], v["identities"]
    cfg = SwapConfig(chunk_size=chunk, max_faces=4, match_faces=2,
                     crop_size=224, fused_group=0, similarity_th=-2.0,
                     use_sr=True)
    seat = cast_to_compute_dtype(_student(DEFAULT_POLICY).to(device))
    convs = seat.student.num_conv + 2
    pipe = build_random_pipeline(cfg, policy=DEFAULT_POLICY,
                                 arcface_layers=(3, 13, 30, 3), seed=0,
                                 inject_templates=True, device=device,
                                 sr=seat)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n, *v["hw"], 3), dtype=np.uint8)
    sources = rng.integers(0, 256, (t, 224, 224, 3), dtype=np.uint8)
    chunks = [frames[i:i + chunk] for i in range(0, n, chunk)]
    valid = [len(c) for c in chunks]
    g = cfg.gen_groups
    # every lane is present in every real frame (similarity_th -2): the
    # probe runs on chunk 0, stage B on every chunk; the fused stream
    # runs chunk 0 split (probe + stage B), then one group per chunk
    split = _seat_calls(valid[0], chunk, g)
    want = {"frames": split + sum(_seat_calls(c, chunk, g) for c in valid),
            "stream": split + sum(_seat_calls(c, chunk, g) for c in valid),
            "stream_fused": 2 * split + len(chunks) - 1}
    want = {k: c * t * convs for k, c in want.items()}

    def run(name, fn):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(device)
        changed = float((out != frames[:len(out)]).mean())
        log(f"video {name}: {len(out)} frames in {wall * 1e3:.1f} ms "
            f"({len(out) / wall:.2f} frames/s); peak max_memory_allocated "
            f"{peak / 2 ** 30:.2f} GiB; S2 launches {counts['conv3x3']} "
            f"({counts['conv3x3'] / len(chunks):.1f} per chunk), K1 "
            f"{counts['aad_modulate']}; {changed:.2%} of values changed "
            f"({card})")
        if out.shape != frames[:len(out)].shape or out.dtype != np.uint8:
            raise AssertionError(f"video {name}: output {out.shape} "
                                 f"{out.dtype}")
        if not changed > 0:
            raise AssertionError(f"video {name}: the blend changed no pixel")
        return out, counts

    def stream(smooth):
        return np.concatenate(list(pipe.swap_video_stream(
            iter(chunks), sources, sources, smooth=smooth)), 0)

    t0 = time.perf_counter()
    warm = pipe.swap_video_frames(frames, sources, sources, smooth=True)
    log(f"video: warm-up swap_video_frames in "
        f"{time.perf_counter() - t0:.1f} s")
    out_frames, counts = run("swap_video_frames(smooth=True)", lambda:
                             pipe.swap_video_frames(frames, sources, sources,
                                                    smooth=True))
    launches = counts["conv3x3"]
    out_stream, c_stream = run("swap_video_stream(smooth=True)",
                               lambda: stream(True))
    out_fused, c_fused = run("swap_video_stream(smooth=False)",
                             lambda: stream(False))
    got = {"frames": launches, "stream": c_stream["conv3x3"],
           "stream_fused": c_fused["conv3x3"]}
    if got != want:
        raise AssertionError(f"S2 launches {got}, want {want} ({convs} per "
                             "present lane per group call)")
    if not (np.array_equal(out_frames, warm)
            and np.array_equal(out_stream, out_frames)):
        raise AssertionError("swap_video_stream(smooth=True) or a second "
                             "swap_video_frames differs from the first "
                             "swap_video_frames")
    log("video: swap_video_stream(smooth=True) equals swap_video_frames "
        "bit for bit, as does a second swap_video_frames")

    lip = LIPSPADEGenerator(policy=DEFAULT_POLICY)
    init_weights(lip, torch.Generator().manual_seed(1))
    lip = cast_to_compute_dtype(lip.to(device).eval())
    pipe_l = SwapPipeline(pipe.det_mod, pipe.arc_mod, pipe.gen_mod,
                          pipe.lmk_mod, cfg, sr=lip)
    run("swap_video_frames(smooth=True), LIPSPADE seat (ngf 48, seeded)",
        lambda: pipe_l.swap_video_frames(frames[:chunk], sources, sources,
                                         smooth=True))
    t0 = time.perf_counter()
    crops, scores = pipe.crop_faces(frames[0])
    image = pipe.swap_image_fused(frames[0], sources, sources)
    torch.cuda.synchronize(device)
    changed = float((image != frames[0]).mean())
    log(f"video: crop_faces -> {crops.shape} {crops.dtype} (scores "
        f"{[round(float(x), 3) for x in scores]}); swap_image_fused -> "
        f"{image.shape}, "
        f"{changed:.2%} changed; both in {time.perf_counter() - t0:.2f} s")
    if (crops.ndim != 4 or crops.shape[0] < 1 or crops.shape[1:] != (224, 224, 3)
            or image.shape != frames[0].shape or not changed > 0):
        raise AssertionError("crop_faces / swap_image_fused")
    if profile:
        phase_video_profile(pipe, frames, sources, out_frames, device)
    return launches


def phase_video_profile(pipe, frames, sources, out, device):
    """One profiled swap_video_frames call, then the host-clock time of
    its stages on one chunk."""
    import numpy as np
    import torch

    from ghost_tpu_torch.pipeline.smoothing import smooth_tracks

    cfg = pipe.cfg
    chunk, t = cfg.chunk_size, len(sources)
    log(f"video profile: one swap_video_frames(smooth=True), "
        f"{len(frames)} frames")
    _profile(lambda: pipe.swap_video_frames(frames, sources, sources,
                                            smooth=True), device)
    fr = frames[:chunk]
    src = pipe.embed_sources(sources)
    tgt = pipe.embed_targets(sources)
    kps, sim, _, _ = pipe._detect_match(fr, tgt)
    kps = kps.cpu().numpy()
    present = np.ones(sim.shape, bool)
    mp = np.asarray([cfg.mask_params] * t, np.float32)
    lane = chunk // cfg.gen_groups
    g = torch.Generator(device=device).manual_seed(0)
    y = torch.rand(lane, cfg.gen_size, cfg.gen_size, 3, generator=g,
                   device=device) * 2 - 1
    gen_in = y.to(torch.bfloat16)
    z = src[:1].expand(lane, -1)
    out_dev = torch.as_tensor(out[:chunk], device=device)
    kps_all = np.repeat(kps, len(frames) // chunk + 1, 0)[:len(frames)]
    log(f"video stages (chunk {chunk}, {fr.shape[1]}x{fr.shape[2]}, bf16, "
        f"T={t}, gen_groups "
        f"{cfg.gen_groups}; host clock, median of 3):")
    with torch.inference_mode():
        _stage("embed sources + targets", lambda: (
            pipe.embed_sources(sources), pipe.embed_targets(sources)), device)
        _stage("upload one chunk (numpy -> card)",
               lambda: torch.as_tensor(fr).to(device), device)
        _stage("stage A: _detect_match (upload included)",
               lambda: pipe._detect_match(fr, tgt), device)
        _stage("stage B: _swap_blend, probe", lambda: pipe._swap_blend(
            fr, kps, present, src, mp, probe=True), device)
        _stage("stage B: _swap_blend", lambda: pipe._swap_blend(
            fr, kps, present, src, mp), device)
        _stage(f"  AEI-Net, one lane of one group ({lane} crops)",
               lambda: pipe.gen_mod(gen_in, z), device)
        _stage(f"  SR seat, one lane of one group ({lane} crops, "
               f"{pipe.sr.student.num_conv + 2} S2 launches)",
               lambda: pipe.sr(y), device)
        _stage("download one chunk (card -> numpy)",
               lambda: out_dev.cpu().numpy(), device)
        _stage(f"smooth_tracks ({len(frames)} frames, T={t}, host)",
               lambda: smooth_tracks(kps_all, np.ones(kps_all.shape[:2],
                                                      bool)), device)


# ---------------------------------------------------------------------------
# Gradients on the card: AEI-Net's training route, the fused route's
# refusal, the SR student through S2's backward
# ---------------------------------------------------------------------------


def _srvgg_plain(student, x, dtype=None):
    """The SR student's forward with every conv on S2's plain version
    (differentiable torch ops): the plain path its gradients are held to.
    dtype=torch.float64 runs all of it in f64 (F.conv2d on f64 values),
    the yardstick of both paths."""
    import torch
    import torch.nn.functional as F

    from ghost_tpu_torch.models.sr.srvgg import nearest_up, pixel_shuffle
    from ghost_tpu_torch.ops.cuda.conv3x3 import conv3x3_reference

    cd = dtype or student.policy.compute_dtype

    def conv(out, layer):
        if dtype is None:
            return conv3x3_reference(out, layer.weight.to(cd), layer.bias)
        return F.conv2d(out.permute(0, 3, 1, 2),
                        layer.weight.to(cd).permute(3, 2, 0, 1),
                        layer.bias.to(cd), padding=1).permute(0, 2, 3, 1)

    x = x.to(cd).contiguous()
    out = x
    for i in range(student.num_conv + 1):
        out = conv(out, getattr(student, f"conv_{i}"))
        alpha = getattr(student, f"prelu_{i}").to(cd)
        out = torch.where(out >= 0, out, alpha * out)
    out = conv(out, student.conv_last)
    return pixel_shuffle(out, student.upscale) + nearest_up(x, student.upscale)


def _student_grads(student, fwd, x, w):
    """Gradients of sum(fwd(student, x) * w) for x and every parameter."""
    import torch

    student.zero_grad(set_to_none=True)
    xg = x.detach().requires_grad_()
    torch.sum(fwd(student, xg).float() * w).backward()
    grads = {n: p.grad.float() for n, p in student.named_parameters()}
    grads["x"] = xg.grad.float()
    return grads


def phase_grads(device, card):
    """One backward of each trainable model on the card, every count
    zeroed just before each run and read just after."""
    import numpy as np
    import torch

    from ghost_tpu_torch.core.precision import (DEFAULT_POLICY,
                                                FULL_PRECISION, Policy)
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.nn.layers import init_weights

    rng = np.random.default_rng(0)

    def arr(*shape, lo=None):
        a = (rng.uniform(lo, 1, shape) if lo is not None
             else rng.standard_normal(shape))
        return torch.from_numpy(a.astype(np.float32))

    xt, zid, w = arr(1, 256, 256, 3, lo=-1), arr(1, 512), arr(1, 256, 256, 3)

    # AEINet(fused_aad=False) at full width, f32: the card against the
    # same model on the CPU in f32, with an f64 run of it (its norms keep
    # f32 statistics) to measure the f32 noise. The f32 gradients of this
    # net are ill-conditioned (instance norms over 2x2 and 4x4 maps, bias
    # sums over whole maps that cancel, a bias whose exact gradient is 0):
    # a few small tensors carry noise of the order of their own size, and
    # the gradient as a whole ~1e-3 of its norm. So the card is held as a
    # whole: the relative L2 distance of its gradient (every parameter
    # and Xt) from the CPU's at most 5 times the CPU's own distance from
    # the f64 run, plus 1e-4; a wrong term (mask, blend, a missing norm)
    # moves every gradient upstream of it by O(1) of its size. Every
    # tensor's gradient must exist and be finite.
    cpu = init_weights(AEINet("unet", num_blocks=2, policy=FULL_PRECISION),
                       torch.Generator().manual_seed(0))
    f64 = Policy(torch.float64, torch.float64, torch.float64)
    cpu64 = AEINet("unet", num_blocks=2, policy=f64)
    cpu64.load_state_dict(cpu.state_dict())
    res = {}
    for name, mod, dev, dt in (
            ("cpu64", cpu64.double(), "cpu", torch.float64),
            ("cpu", cpu, "cpu", torch.float32),
            ("card", copy.deepcopy(cpu).to(device), device, torch.float32)):
        zero_counts()
        x = xt.detach().to(dev, dt).requires_grad_()
        t0 = time.perf_counter()
        y, _ = mod(x, zid.to(dev, dt))
        torch.sum(y * w.to(dev, dt)).backward()
        if dev != "cpu":
            torch.cuda.synchronize(device)
        g = {n: p.grad.cpu().double() for n, p in mod.named_parameters()}
        g["xt"] = x.grad.cpu().double()
        res[name] = (g, read_counts(), time.perf_counter() - t0)
        del mod, x, y
    exact, cpu32, got = (res[n][0] for n in ("cpu64", "cpu", "card"))

    def rel_l2(a, b):
        num = sum(float((a[n] - b[n]).square().sum()) for n in b)
        return (num / sum(float(b[n].square().sum()) for n in b)) ** 0.5

    e_card, e_cpu = rel_l2(got, cpu32), rel_l2(cpu32, exact)
    worst = max((float((got[n] - r).norm() / r.norm()), n)
                for n, r in cpu32.items() if float(r.norm()) > 0)
    finite = all(bool(torch.isfinite(t).all()) for t in got.values())
    ok = finite and len(got) == len(cpu32) and e_card <= 5 * e_cpu + 1e-4
    n_params = sum(t.numel() for k, t in exact.items() if k != "xt")
    log(f"grads AEINet(fused_aad=False) unet 2 blocks, full width "
        f"({n_params / 1e6:.1f} M params), f32, B=1: card "
        f"{res['card'][2]:.2f} s (first call), CPU {res['cpu'][2]:.2f} s, "
        f"CPU f64 {res['cpu64'][2]:.2f} s; {len(got)} tensors, all finite: "
        f"{finite}; relative L2 of the whole gradient: card vs CPU f32 "
        f"{e_card:.3e}, CPU f32 vs f64 {e_cpu:.3e} (bound 5 x that + 1e-4: "
        f"{ok}); the noisiest tensor {worst[1]} at {worst[0]:.2e} of its "
        f"norm; launches on the card {res['card'][1]} ({card})")
    if not ok or any(res["card"][1].values()):
        raise AssertionError("AEINet gradients on the card")
    del cpu, cpu64, res, exact, cpu32, got

    # AEINet(fused_aad=True) as the pipeline builds it: K1 runs, and a
    # backward through it raises
    fused = init_weights(AEINet("unet", num_blocks=2, policy=DEFAULT_POLICY,
                                fused_aad=True),
                         torch.Generator().manual_seed(0)).to(device)
    zero_counts()
    y, _ = fused(xt.to(device), zid.to(device))
    k1 = read_counts()["aad_modulate"]
    try:
        y.float().sum().backward()
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    log(f"grads AEINet(fused_aad=True), bf16: K1 launches {k1}; backward "
        f"raised: {raised!r}")
    if k1 != 21 or "fused_aad=False" not in raised:
        raise AssertionError("the fused AAD route must run K1 21 times and "
                             "refuse a backward")
    del fused, y

    # the SR student on its bundled weights, f32 and bf16: the S2 path
    # (forward and dx through the kernel) and the plain path, each against
    # an f64 run of the same student; per tensor, the relative L2 error of
    # the S2 path at most twice the plain path's plus 1e-5. Even f32 is
    # not exact here: a PReLU kink takes the other slope wherever a sum in
    # another order crosses 0, and cuDNN's f32 algorithms round more than
    # S2's exact FMAs (both part from f64 by ~1e-6 to ~1e-3).
    x = arr(8, 128, 128, 3, lo=0).to(device)
    w2 = arr(8, 256, 256, 3).to(device)
    student = _student(FULL_PRECISION).student.to(device)
    exact = _student_grads(student, lambda m, xs: _srvgg_plain(
        m, xs, torch.float64), x, w2)

    def rel(g):
        return {n: float((g[n].double() - r).norm() / r.norm())
                for n, r in exact.items()}

    parts, ok, launches = [], True, {}
    for name, policy in (("f32", FULL_PRECISION), ("bf16", DEFAULT_POLICY)):
        student = _student(policy).student.to(device)
        zero_counts()
        kern = rel(_student_grads(student, lambda m, xs: m(xs), x, w2))
        torch.cuda.synchronize(device)
        launches[name] = read_counts()["conv3x3"]
        plain = rel(_student_grads(student, _srvgg_plain, x, w2))
        worst = max((kern[n] / (2 * plain[n] + 1e-5), n) for n in kern)
        ok = ok and worst[0] <= 1.0
        parts.append(f"{name}: S2 path {max(kern.values()):.2e}, plain "
                     f"{max(plain.values()):.2e} at most, S2 at {worst[0]:.2f} "
                     f"of its bound ({worst[1]})")
    convs = student.num_conv + 2
    log(f"grads SR student (bundled, {convs} convs), x (8,128,128,3), "
        f"relative L2 error against f64 per tensor: {'; '.join(parts)}; "
        f"within 2 x plain + 1e-5: {ok}; S2 launches {launches} ({convs} "
        f"forward + {convs} dx each) ({card})")
    if not ok or set(launches.values()) != {2 * convs}:
        raise AssertionError("SR student gradients on the card")


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import ghost_tpu_torch  # noqa: F401  (fails outside the repository)

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = phase_device(device)
    phase_build()
    stats = {"aad_modulate": phase_k1(device, card)}
    phase_parity(device)
    launches = {"aad_modulate": phase_main(device, card,
                                           profile="--profile" in argv)}
    stats.update(phase_k2(device, card))
    stats.update(phase_k3(device, card))
    train = phase_train(device, card)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        launches[name] = train[name]
    launches.update({k: v for k, v in phase_k3_path(device).items()
                     if k.startswith("fused_layer_norm")})
    phase_train_parity(device)
    stats["conv3x3"] = phase_s2(device, card)
    phase_seat_parity(device, card)
    launches["conv3x3"] = phase_video(device, card,
                                      profile="--profile" in argv)
    phase_grads(device, card)
    phase_k3_device(device, card, stats)
    phase_k1_device(device, card, stats["aad_modulate"])
    log(f"total {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        st = stats[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **{k: st[k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "library_ms", "library_call")},
                        # K1, K3: ms/library_ms are device times, these
                        # the CUDA-event times of back-to-back calls
                        **{k: st[k] for k in ("call_ms", "library_call_ms")
                           if k in st}})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
