"""Drive the PyTorch/CUDA port (`ghost_tpu_torch`) on one CUDA card and
check it end to end.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --profile  # also one torch.profiler'd chunk

Phases, each on an explicit device; any failure raises and the script
exits non-zero without its result lines:

  1. device   card name, count, power limit, torch/CUDA versions, TF32 off
  2. build    nvcc builds the AAD modulate kernel (K1) for sm_90a
  3. K1       kernel vs its plain PyTorch version at the 8 AAD shapes of
              the full-width generator at B=8, bf16 and f32: error bound
              and CUDA-event times (turns plain, kernel, kernel, plain)
  4. parity   the test config (tests/test_torch_pipeline.py), f32, same
              weights and frames, CPU (plain AAD) vs card (kernel)
  5. main     `_detect_swap` at full width (SCRFD 640, iresnet100, AEI-Net
              unet 2 blocks, bf16) on a chunk of 8 seeded 1080p frames:
              output shape, 21 K1 launches per call, a real blend, frames/s

The last two lines are the kernels JSON and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

# the 8 AAD blocks of the full-width generator: (spatial size, channels)
# and the AAD layers per block (blocks 4-8 add the shortcut's)
AAD_BLOCKS = [(2 ** (k + 1), c, 2 if k < 3 else 3)
              for k, c in enumerate((1024, 1024, 1024, 1024, 512, 256, 128, 64))]
AAD_B = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PARITY_CFG = dict(det_size=320, chunk_size=2, max_faces=4, match_faces=2,
                  similarity_th=-2.0)


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
    _build.load_library("aad_modulate")
    report = _build.BUILD_REPORTS.get("aad_modulate")
    if report is None:
        log(f"build: aad_modulate loaded from {_build.BUILD_DIR} (built "
            f"earlier) in {time.perf_counter() - t0:.2f} s")
        return
    log(f"build: nvcc {' '.join(report['cmd'][1:])}")
    log(f"build: aad_modulate in {report['seconds']:.2f} s")
    for line in report["ptxas"].splitlines():
        log(f"  ptxas: {line}")


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


def phase_k1(device, card):
    """K1 against its plain version at the generator's shapes."""
    import torch

    from ghost_tpu_torch.ops.cuda.aad import aad_modulate, aad_modulate_plain

    g = torch.Generator(device=device).manual_seed(0)
    max_err = 0.0
    weighted = {"kernel": 0.0, "plain": 0.0}
    log(f"K1 aad_modulate vs plain, B={AAD_B} ({card}):")
    log("  dtype    shape              layers  err      bound-ok  plain_us  "
        "kernel_us  bytes_bound_us")
    for dtype in (torch.bfloat16, torch.float32):
        for hw, c, layers in AAD_BLOCKS:
            def rnd(*s):
                return torch.randn(*s, generator=g, device=device)
            h = (rnd(AAD_B, hw, hw, c) * 2 + 1).to(dtype)
            packed = rnd(AAD_B, hw, hw, 2 * c).to(dtype)
            args = (h, packed[..., :c], packed[..., c:],
                    rnd(AAD_B, 2 * c).to(dtype), rnd(1, c, 1, 1) / c ** 0.5,
                    rnd(1))
            out = aad_modulate(*args)
            ref = aad_modulate_plain(*args)
            torch.cuda.synchronize(device)
            err = (out.float() - ref.float()).abs()
            if dtype == torch.bfloat16:
                # 0.1 absolute (the JAX kernel test's bf16 bound) plus two
                # bf16 ulps at the value's magnitude
                bound = 0.1 + 2 ** -6 * ref.float().abs()
            else:
                bound = 1e-4 + 1e-5 * ref.float().abs()
            ok = bool((err <= bound).all())
            e = float(err.max())
            max_err = max(max_err, e)
            for _ in range(3):
                aad_modulate(*args)
                aad_modulate_plain(*args)
            plain_ms, kern_ms = _time_turns(
                (lambda: aad_modulate_plain(*args), lambda: aad_modulate(*args)),
                20, device)
            nbytes = 6 * h.numel() * h.element_size()
            name = str(dtype).replace("torch.", "")
            shape = f"({AAD_B},{hw},{hw},{c})"
            log(f"  {name:8s} {shape:18s} {layers:6d}  {e:.3e}  {ok!s:8s}  "
                f"{plain_ms * 1e3:8.1f}  "
                f"{kern_ms * 1e3:9.1f}  {nbytes / HBM_BYTES_PER_S * 1e6:10.1f}")
            if dtype == torch.bfloat16:
                weighted["kernel"] += layers * kern_ms
                weighted["plain"] += layers * plain_ms
            if not ok:
                raise AssertionError(f"K1 disagrees with plain at {name} "
                                     f"({AAD_B},{hw},{hw},{c}): max err {e}")
    log(f"K1 per 8-frame generator pass (21 layers, bf16): kernel "
        f"{weighted['kernel']:.3f} ms, plain {weighted['plain']:.3f} ms "
        f"({card})")
    return dict(max_abs_err=max_err, ms=weighted["kernel"],
                plain_ms=weighted["plain"])


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
                                inject_templates=True, seed=0)
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
    aad_modulate.launches = 0
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
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pipe._detect_swap(frames, tgt, src, mp)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    events = prof.key_averages()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels)
    log(f"profile: wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{busy / 1e3:.1f} ms ({busy / 1e6 / wall:.1%})")
    for e in sorted(kernels, key=dev_us, reverse=True)[:25]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    phase_stages(pipe, frames, tgt, src, mp, device)


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
        fn()
        torch.cuda.synchronize(device)
        ts = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            ts.append(time.perf_counter() - t)
        log(f"  {sorted(ts)[1] * 1e3:8.2f} ms  {name}")

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
    k1 = phase_k1(device, card)
    phase_parity(device)
    launches = phase_main(device, card, profile="--profile" in argv)
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "aad_modulate", "route": "cuda",
        "source": "ghost_tpu_torch/csrc/aad_modulate.cu",
        "replaces": "ghost_tpu/ops/pallas/aad.py:77",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
