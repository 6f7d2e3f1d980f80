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
 17. cli      the user's swap CLI (`ghost_tpu_torch/cli/inference.py`):
              cv2 must import and libghost_rt must build
              (`native_available()`); seeded full-width `.pth` files with
              the reference's names (G unet 2 blocks, iresnet100), a 1080p
              png pair and a 20-frame 1080p mp4; `main(argv)` for the
              image, the streaming and the frames video paths and
              streaming with the SRVGG student seat (`--use_sr 1`), the
              random detector and landmark heads pinned to face
              templates: each output decoded back (20 frames at
              1920x1080), K1 launched (and S2 with the seat), the
              streaming runs on the native ring, wall and frames/s end to
              end; then `run(args, pipe)` on a loaded pipeline: its png
              equals `swap_image_fused` bit for bit and changes the face
              box
 18. routes   the reference's own packs behind the CLI's `.onnx` / `.pth`
              routes (`tests/torch_route_inputs.py`, on phase 17's
              files): ArcFaceOnnx on the full-width iresnet100 graph
              emitted from phase 17's backbone.pth against IResNet (f32,
              8 crops, 1e-4 relative), SCRFDOnnx on a full-width graph
              emitted from the templated SCRFD against that module (8
              letterboxed 1080p frames at 640: the same faces, kps within
              1e-2 px), each timed beside the native module (CUDA
              events; host us per call and per node); every float the
              executor returns on the card; SCRFDV1e at both archs from
              seeded mmdet `.pth` files, card vs CPU (f32, 1e-4); then
              `main(argv)` with `--detector_path *.onnx --arcface_path
              *.onnx`: image (21 K1 launches) and 20-frame streaming
              (147), each decoded back, wall and frames/s; the image
              again in f32 against the same run through the native
              modules (< 5% of values differ, all but 0.1% of them by at
              most 3 grey levels: the rest are the hull mask's edge
              pixels, whose hard threshold a 1e-5 relative change of the
              embedding can move), and with the detector route alone;
              and an image run with an mmdet `--detector_path *.pth`
              that completes with its no-kps warning
 19. enhance  the output enhancer (`--enhance_output face|full`,
              `pipeline/enhance.py`) on phase 17's files and seeded
              full-width GFPGANv1.4 / RealESRGAN_x4plus /
              realesr-general-x4v3 `.pth` files with the reference's
              names: (a) FaceEnhancer in f32 on one 240x320 frame (one
              lane, 2x2 background tiles with a 10-px halo) on the card
              against the same modules on the CPU, phase 4's frame bound,
              for face, full + rrdb and full + srvgg (S2 on every SRVGG
              conv); (b) the CLI's enhancer (bf16, the templated
              pipeline's detector) on a chunk of 8 1080p frames per mode:
              warm ms a chunk, frames/s, peak memory, lanes present, S2
              launches (exactly 1088 with srvgg: 34 convs x 32 tiles of
              270x240; 0 otherwise), and the RRDB background pass under
              torch.profiler (cuDNN's share); (c) `main(argv)`: an image
              with face, an image with full rrdb and a 20-frame stream
              with full srvgg, each decoded back, frames/s end to end,
              K1 as in phase 17, S2 1088 a chunk; then `run(args, pipe)`
              equal to `enhance(swap_image_fused(...))` bit for bit

 20. gan      the GAN train step and the code around it (train_step.py,
              loop.py, core/checkpoint.py, preempt.py): (a) the tier-1
              tests' narrow config (AEI-Net width 1/16, 1 block; D ndf 8,
              3 layers, 2 scales; ArcFace (1,1,1,1); B=2), card against
              CPU from the same seeded state: one G and one D step,
              canonical and round_trip, in f32 beside the CPU's own
              spread (the batch's samples in the other order) and in
              bf16 against the CPU's f32 step beside the CPU's own bf16
              error (loss terms, gradients as Adam's moments, parameters,
              BN statistics), and train_loop round_trip in f32 for 3 G
              and 2 D steps; (b) full width as
              ghost_tpu/cli/train.py builds it (AEI-Net unet 2 blocks,
              MultiscaleDiscriminator n_layers 5 x 3 scales, instance
              norm, iresnet100 ArcFace frozen, 256 px, batch 16) in f32
              and bf16: canonical, then round_trip with a seeded
              teacher_y, 6 G and 3 D steps each through train_loop: all
              losses finite, every G tensor and encoder BN statistic
              changed by every step, D changed by the D steps only;
              G-step and D-step wall, peak memory and one G step under
              torch.profiler; (c) resume at full width, f32, canonical,
              deterministic cuDNN: saved at step 3, restored into a
              state of other seeded weights, step 4 equal to the
              uninterrupted run's bit for bit; (d) SIGTERM from a timer
              thread during a run in a directory holding an older run's
              later steps, at the default keep: a forced checkpoint of
              the step it stopped on, kept as the latest, and the stop.
              The path runs none of the
              table's kernels, as in JAX (`fused_aad=False`): its counts
              must read 0

 21. train cli the user's train CLI (`ghost_tpu_torch/cli/train.py`) on
              seeded files (`tests/torch_train_cli_inputs.py`): 128 jpgs
              of 256x256, flat and in 8 identity folders, phase 17's G
              and backbone.pth, a full-width D_*.pth, a FAN msgpack (4 x
              256), a LIPSPADE 10_net_G.pth (ngf 48) and a graph with
              inswapper_128's signature: (a) the narrow config's
              `main(argv)` on the card against `main(argv,
              device="cpu")`, f32, 2 steps, beside the CPU's own spread
              (phase 20 (a2)'s bounds); (b0) the loader alone, ms a
              batch at 8 threads; (b) `main(argv)` with the CLI's
              defaults (bf16, batch 16, --d_interval 10, 8 loader
              workers), 12 steps: canonical with the eye loss, roundtrip,
              self, distill with --teacher_upsample: finite losses, every
              G and D tensor changed, a checkpoint and the grids written,
              wall, time to the end of step 0, median iteration and
              loader-wait ms, peak memory; (c) resume at full width from
              step 3 to step 5; (d) every launch count 0

 22. distill  the enhancer-distillation CLI
              (`ghost_tpu_torch/cli/distill_enhancer.py`) and the
              auxiliary-trainer CLI (`cli/train_extras.py`) on seeded
              files: (a1) distillation at the tier-1 tests' narrow config
              (hq 32 background on the full-size RRDB teacher, hq 64 face
              on GFPGAN at 64; student 4 x 1, batch 2, 2 steps, f32) on the
              card against the CPU on the same draws, beside the CPU's
              own spread; (b) distillation at full width in bf16:
              background at the CLI's defaults (hq 256, batch 8, student
              64 x 32) on RealESRGAN_x4plus, face at hq 512 on
              GFPGANv1.4, 20 steps each: finite l1, every student tensor
              moved, S2 exactly 34 forward and 33 dx launches a step, the
              msgpack served by the SR seat, the student step and the
              teacher pass timed apart, peak memory; (a2) the three
              trainer modes at tests/test_train_extras_cli.py's narrow
              flags, card against CPU; (c) the three modes at full width
              (bf16, batch 16, G unet 2 blocks, iresnet100, D 5 x 3,
              LIPSPADE ngf 48), 6 steps each, chained through --G_path
              msgpacks: finite losses, the trained tensors moved, the
              msgpacks bit for bit, step ms, peak memory, every count 0

 23. sr/masks the SR-training library and the mask-target and
              preprocessing CLIs: (a0) card against CPU in f32 at
              tests/test_torch_sr_train.py's narrow configs (a Pix2PixSR
              ngf 4 G + D step at 64 px with VGG19; SubAdd's and
              Contrasive's steps on LIPEncoder(4, 3)); (a)
              Pix2PixSR(SRConfig()) train mode at 256 px, batch 4, VGG19
              on, bf16 and f32: 1 warm + 5 timed G + D steps (every G
              and D tensor, running statistic and spectral pair moved),
              a HiFaceGANGenerator(ngf=48) forward, SubAdd and
              Contrasive steps on LIPEncoder(48, 5) at batch 8: step
              ms, peak memory; (b0) the tests' tiny SAM card vs CPU;
              (b) `precompute_masks.main(argv)`: hull at --batch_size 32
              on 64 seeded crops with a templated Landmark106 msgpack
              (ms a crop, peak; 8 crops card vs CPU), SAM vit_h through
              a seeded full-size `.pth` in the upstream layout on 16
              crops (load s, ms a crop, peak) and its image encoder
              against the bf16 bound; (c0) `preprocess.main(argv)`
              celeba on a narrow f32 pipeline, card vs CPU; (c) celeba
              --max_darken 2, vgg (2 folders x 4) and gender on seeded
              1080p jpgs with a templated full-width detector: ms an
              image, crop_faces ms; every count 0
 24. weights  the weight-conversion and export CLIs
              (`ghost_tpu_torch/cli/convert.py`, `cli/export.py`) and the
              single-card rest, on the files of phases 17-23 (the SAM
              vit_h `.pth` among them) and seeded 2d106det `.params`,
              WFLW_4HG and VGG19 files: (a) `convert.main(argv)` for all
              12 kinds, seconds each; each msgpack bridged into its port
              model on the card gives the output of the tree converted
              straight from the `.pth` (max abs diff 0): AEI-Net bf16
              with K1 at batch 8 (42 launches), SRVGG x4v3 on S2 (68);
              (b) Landmark106Det (32 x 192) f32 card vs CPU and against
              the MXNet graph interpreter on the card, bf16 ms; (c)
              FANAWL(4, 98, 256) (8 x 256) f32 card vs CPU, bf16 ms; (d)
              `export.main(argv)` for AEI-Net and iresnet100: onnx through
              OnnxExecutor against the eager f32 module, pt2 reloaded at
              batch 1 and 8 against eager, export s, bytes, ms a call;
              (e) 2:4 masks card vs CPU, ArcMarginHead(512 -> 85742),
              colour, quality (iresnet100, VGG19), trace() + annotate()
              around the pt2 call, StageTimer, flop_estimate, the LSTM
              beside cuDNN's, GRU, mLSTM, the transducer loss against
              f64 beside the CPU; peak memory each
 25. parallel the parallel layer (`core/mesh.py`, `parallel/`): (a) four
              logical shards of cuda:0 at full width: ring_attention at
              the train cell's shape (x (8, 4096, 512), 8 heads of 64,
              causal) in f32 and bf16 against attention_reference, and
              MultiheadAttention(seq_mesh) against its local core (K2;
              bypassed with seq_mesh, as in JAX); moe_apply_expert_parallel
              (512 / 2048, 8 experts, top 2, 32768 tokens) against
              moe_apply; rrdb_forward_pipelined on RealESRGAN x4plus (23
              blocks over 4 stages) on one tile batch (8, 290, 260) in 4
              microbatches, f32 and bf16, against net(x); FaceEnhancer
              (bg_mesh) full rrdb and srvgg on phase 19's 1080p chunk of
              8 against bg_mesh=None, bit for bit, S2 1088 with srvgg;
              each timed, with peak memory and launches; the port's
              examples/swap_example.py (16 frames and an image); (b) the
              data-parallel GAN step at phase 20's full width, batch 16
              split 8 + 8 over two ranks spawned on cuda:0 over gloo
              (`tests/torch_ddp_ranks.py`), synchronised BatchNorm and
              ZeRO GhostAdam, f32 then bf16: the first f32 step against
              the single-process step on the global batch (masks split
              unevenly), ranks equal bit for bit, step ms per rank, peak
              memory per process; NCCL a rank a card where there are two
              cards (one line saying so otherwise)

Each path (5, 8, 9, 13, 14, each CLI run of 17, 18 and 19, each enhancer
chunk of 19, each train run of 20, each train CLI run of 21, each CLI
run of 22, each run of 23, each convert run of 24 and each run of 25)
runs with every
launch count set to 0 just before it and read just after; the counts of
5, 8, 9 and 13 go into the kernels line as `launches`, those of 17 and
19's CLI runs as `cli_launches`, those of 18 as `route_launches`, those
of 19's chunks as `enhance_launches`, those of 21 as
`train_cli_launches`, those of 22 as `distill_launches` and
`train_extras_launches`, those of 23 as `sr_masks_launches`, those of
24 as `weights_launches`, those of 25 as `parallel_launches`.

The last two lines are the kernels JSON and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import shutil
import subprocess
import sys
import tempfile
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
# torch.profiler sessions per measurement before a dropped session fails
# the phase
PROFILE_TRIES = 8
# _device_times' one entry when no session held the kernels: the calls'
# time from CUDA events
EVENTS_KEY = "whole call (CUDA events, profiler empty)"
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
            (2, 37, 53, 5, 7, "odd"),
            # --bg_model srvgg: a chunk of 8 frames in 270x240 tiles with
            # the 10-px halo, through SRVGG x4v3 (64 features, x4: 48 out)
            (8, 290, 260, 3, 64, "srvgg 3->64"),
            (8, 290, 260, 64, 64, "srvgg 64->64"),
            (8, 290, 260, 64, 48, "srvgg 64->48"),
            # the distillation student (64 features, 32 body convs) at the
            # CLI's batch 8: background reads LQ 64x64 (hq 256 / 4, x4:
            # 48 out), face 256x256 (hq 512 / 2, x2: 12 out)
            (8, 64, 64, 3, 64, "distill bg 3->64"),
            (8, 64, 64, 64, 64, "distill bg 64->64"),
            (8, 64, 64, 64, 48, "distill bg 64->48"),
            (8, 256, 256, 3, 64, "distill face 3->64"),
            (8, 256, 256, 64, 64, "distill face 64->64"),
            (8, 256, 256, 64, 12, "distill face 64->12")]
# convs of each seat shape in one student pass (conv_0, 16 body, conv_last)
S2_SEAT_PASS = {"seat 3->32": 1, "seat 32->32": 16, "seat 32->12": 1}
# convs of each SRVGG x4v3 shape in one background tile (conv_0, 32 body,
# conv_last): 34 launches
S2_SRVGG_TILE = {"srvgg 3->64": 1, "srvgg 64->64": 32, "srvgg 64->48": 1}
# convs of each shape in one distillation step: forward conv_0, 32 body
# convs and conv_last (34), dx of all but conv_0, which reads the data (33)
S2_DISTILL_STEP = {task: {f"distill {task} 3->64": (1, 0),
                          f"distill {task} 64->64": (32, 32),
                          f"distill {task} 64->{cout}": (1, 1)}
                   for task, cout in (("bg", 48), ("face", 12))}
# a timed S2 case rotates through input sets of at least this many bytes
S2_ROTATE_BYTES = 128 * 2 ** 20
STUDENT = Path(__file__).resolve().parent / "assets" / \
    "srvgg_student_x2_r05.msgpack"
# the video phase: frames of (H, W), chunk, identities
VIDEO = dict(frames=20, hw=(1080, 1920), chunk=8, identities=2)

# the CLI phase: a 1080p source/target png pair and a clip of 20 1080p
# frames; the runs of `main` (extra flags after the shared ones)
CLI = dict(frames=20, hw=(1080, 1920), fps=25.0, batch=8, width=1.0,
           arcface_depth="iresnet100", arcface_layers=(3, 13, 30, 3))
# the routes phase: crops for ArcFaceOnnx, 1080p frames for SCRFDOnnx,
# timed calls, and the K1 launches of its image and 20-frame streaming
# runs (as phase 17's: one generator pass, then 7)
ROUTES = dict(crops=8, frames=8, iters=10, k1={"image": 21, "stream": 147})
# the share of an image's values that may differ by more than 3 grey
# levels from the native modules' run: the hull mask's edge pixels (see
# `phase_routes`)
ROUTE_EDGE_SHARE = 1e-3
CLI_RUNS = (("image", ("--image_to_image", "1")),
            ("stream", ("--streaming", "1")),
            ("frames", ("--streaming", "0")),
            ("stream_sr", ("--streaming", "1", "--use_sr", "1",
                           "--sr_model", "srvgg_student")))

# the enhancer phase: the card-vs-CPU frame (f32) and its background
# tiles (a 2x2 grid with a 10-px halo), the timed chunk of 1080p frames
# (bf16) and its warm calls
ENHANCE = dict(parity_hw=(240, 320), parity_tile=(120, 160), chunk=8,
               iters=3)
ENHANCE_FLAGS = {"face": ("--enhance_output", "face"),
                 "rrdb": ("--enhance_output", "full", "--bg_model", "rrdb"),
                 "srvgg": ("--enhance_output", "full", "--bg_model",
                           "srvgg")}

# the GAN train phase (20): full width as ghost_tpu/cli/train.py:260-348
# builds it (AEI-Net unet 2 blocks at width 1, the multiscale
# discriminator n_layers 5 x 3 scales with instance norm, iresnet100, 256
# px, the CLI's default batch 16); G steps per run and the D cadence. The
# tier-1 tests' narrow config is tests/torch_train_parity.py's NARROW
GAN = dict(batch=16, steps=6, d_interval=2, num_blocks=2, width=1.0, ndf=64,
           n_layers=5, num_D=3, arcface_layers=(3, 13, 30, 3))

# the train CLI phase (21): the dataset (`cli/preprocess.py`'s crop size,
# flat and in identity folders), the full-width runs' steps, and the
# checkpoints' sizes as ghost_tpu/cli/train.py reads them (FAN WFLW_4HG:
# 4 stacks x 256; LIPSPADE ngf 48)
TRAIN_CLI = dict(images=128, identities=8, size=256, steps=12, fan_stacks=4,
                 fan_features=256, sr_ngf=48)

# the distillation and auxiliary-trainer phase (22): steps of each
# full-width distillation run; S2 launches a distillation step (forward:
# conv_0, 32 body convs, conv_last; dx: all but conv_0); the trainers'
# dataset (128 crops of 256 px with a mask each), steps a mode, LIPSPADE
DISTILL = dict(steps=20, hq={"background": 256, "face": 512})
# the parallel layer's phase (25): logical shards of cuda:0; timed calls a
# case; the MoE at d_model 512, hidden 2048, 8 experts, top 2 on 32768
# tokens; one enhancer tile batch (8 tiles of 270x240 with the 10-px halo)
# through RealESRGAN x4plus's trunk in 4 microbatches; the data-parallel
# step's ranks, timed steps a policy and the ranks' join timeout (s)
PARALLEL = dict(shards=4, iters=3,
                moe=dict(d_model=512, hidden=2048, experts=8, top_k=2,
                         tokens=32768),
                rrdb_tile=(8, 290, 260), micro=4, ranks=2, dp_steps=3,
                dp_timeout=600)
DISTILL_S2 = {"forward": 34, "dx": 33}
EXTRAS = dict(images=128, steps=6, sr_ngf=48)

# the SR-training and mask-target phase (23): Pix2PixSR at SRConfig()'s
# widths (ngf 48, ndf 64) on 256-px batches of 4, the encoder pretraining
# (LIPEncoder(ngf, 5)) at batch 8, timed steps after a warm one; the hull
# masks' crops and --batch_size, SAM's crops and --sam_preset; the
# preprocessing CLI's 1080p images (flat, and folders x images)
SR23 = dict(hw=256, batch=4, steps=5, pre_batch=8, ngf=48, ndf=64)
MASKS = dict(crops=64, batch=32, sam_crops=16, preset="vit_h")
PREP = dict(hw=(1080, 1920), flat=4, dirs=2, per_dir=4)

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
        # again while a session misses K1 calls (the profiler can drop
        # events, or a whole session's)
        for _ in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                gen(xt, zid)
                torch.cuda.synchronize(device)
            kernels = sorted(
                (e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
            names = [_kernel_name(e.name) for e in kernels]
            # a K1 call's first kernel: pass 1 of the split route, or the
            # one-launch route's only one
            firsts = [i for i, n in enumerate(names)
                      if n.startswith("aad_small_kernel")
                      or n.startswith("aad_stats_kernel")
                      and n.endswith("false>")]
            if len(firsts) == 21:
                break
            log(f"  (torch.profiler recorded {len(firsts)} K1 calls in "
                f"{len(names)} kernels, 21 expected: again)")
            time.sleep(0.5)
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
    `iters` calls after a warm one: {kernel name: us}. A session that
    recorded no device time, or with kernels_per_call another number of
    kernels (the profiler can drop events, or a whole session's: seen on
    the card's machine), is run again, up to PROFILE_TRIES times in all;
    after that the `iters` calls are timed with CUDA events instead, as
    {EVENTS_KEY: us per call}, which holds the gaps between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    for attempt in range(PROFILE_TRIES):
        if attempt:
            log(f"  (torch.profiler recorded {count} kernels in {iters} "
                f"calls, {kernels_per_call or 'some'} expected a call: "
                f"again)")
            time.sleep(0.5)
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
        if times and (kernels_per_call is None
                      or count == kernels_per_call * iters):
            return times
    log(f"  (torch.profiler recorded {count} kernels in {iters} calls in "
        f"each of {PROFILE_TRIES} sessions, {kernels_per_call or 'some'} "
        f"expected a call: timed with CUDA events instead)")
    return {EVENTS_KEY: _time_one(fn, iters, device) * 1e3}


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
    """S2 against its plain version at the scripts', the seat's and the
    SRVGG background's shapes; times beside F.conv2d and the bounds. The
    kernels line takes one student pass (18 convs at 16 crops, bf16)."""
    import torch
    import torch.nn.functional as F

    from ghost_tpu_torch.ops.cuda.conv3x3 import (conv3x3, conv3x3_dx_kernel,
                                                  conv3x3_reference)

    worst = 0.0
    seat = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0}
    tile = dict.fromkeys(seat, 0.0)
    distill = {task: {"ms": 0.0, "dx_ms": 0.0, "plain_ms": 0.0,
                      "library_ms": 0.0, "bound_ms": 0.0}
               for task in S2_DISTILL_STEP}
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
            dx_txt, dx_ms = "", 0.0
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
            for task, counts in S2_DISTILL_STEP.items():
                if dtype == torch.bfloat16 and tag in counts:
                    n, n_dx = counts[tag]
                    acc = distill[task]
                    acc["ms"] += n * kern_ms
                    acc["dx_ms"] += n_dx * dx_ms
                    acc["plain_ms"] += n * plain_ms
                    acc["library_ms"] += n * lib_ms
                    acc["bound_ms"] += (n + n_dx) * bound_ms
            for acc, counts in ((seat, S2_SEAT_PASS), (tile, S2_SRVGG_TILE)):
                if dtype == torch.bfloat16 and tag in counts:
                    n = counts[tag]
                    acc["ms"] += n * kern_ms
                    acc["plain_ms"] += n * plain_ms
                    acc["library_ms"] += n * lib_ms
                    acc["bound_ms"] += n * bound_ms
                    acc["bytes_ms"] += n * nbytes / HBM_BYTES_PER_S * 1e3
                    acc["ops_ms"] += n * flops / BF16_FLOPS * 1e3
            del sets, lib_sets, lib, y, ref, err, bound
            torch.cuda.empty_cache()
    for acc, what in ((tile, "srvgg background tile (34 convs, 8 frames "
                              "of 290x260"),
                      (seat, "student pass (18 convs, 16 crops of 128x128")):
        by = "bytes" if acc["bytes_ms"] >= acc["ops_ms"] else "operations"
        log(f"S2 per {what}, bf16): kernel {acc['ms']:.3f} ms, plain "
            f"{acc['plain_ms']:.3f} ms, F.conv2d {acc['library_ms']:.3f} ms, "
            f"bound {acc['bound_ms']:.3f} ms ({by}) ({card})")
    for task, acc in distill.items():
        # dx reads dy and k' and writes dx: the forward's bytes and
        # operations with Cin and Cout swapped, so the same bound
        log(f"S2 per distillation step ({task}, 8 images, bf16): forward "
            f"34 convs {acc['ms']:.3f} ms (plain {acc['plain_ms']:.3f}, "
            f"F.conv2d {acc['library_ms']:.3f}) + dx 33 convs "
            f"{acc['dx_ms']:.3f} ms; bound {acc['bound_ms']:.3f} ms for the "
            f"67 ({card})")
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


# ---------------------------------------------------------------------------
# The user's swap CLI
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _templated_cli():
    """`inference.load_pipeline` pins the random landmark head, and a
    native SCRFD's head, to face templates (as `build_random_pipeline(
    inject_templates=True)` does): a random SCRFD scores no anchor above
    det_thresh, so no lane would be present and no generator would run.
    An ONNX detector (phase 18's graph was emitted from a templated
    SCRFD) or an mmdet `.pth` one is left as loaded."""
    from ghost_tpu_torch.cli import inference
    from ghost_tpu_torch.models.scrfd import SCRFD
    from ghost_tpu_torch.utils.face_template import (
        inject_detection_template, inject_landmark_template)

    load = inference.load_pipeline

    def load_templated(*args, **kwargs):
        pipe = load(*args, **kwargs)
        if isinstance(pipe.det_mod, SCRFD):
            inject_detection_template(pipe.det_mod)
        inject_landmark_template(pipe.lmk_mod)
        return pipe

    inference.load_pipeline = load_templated
    try:
        yield load_templated
    finally:
        inference.load_pipeline = load


def _test_inputs(name):
    """`tests/{name}.py` (`torch_cli_inputs`: the reference's state dicts
    and the media files; `torch_route_inputs`: the mmdet dicts and the
    SCRFD graph emitter, which imports the first), loaded from its path
    and registered under its name: on the card's machine `import tests`
    finds another package than the repository's directory."""
    import importlib.util

    if name not in sys.modules:
        path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def cli_files(d):
    """Phase 17's inputs, which phase 18 reuses, in directory d: a 1080p
    source/target png pair, a 20-frame 1080p mp4 and seeded full-width
    `.pth` files with the reference's names (G unet 2 blocks, iresnet100
    `backbone.pth`). Returns their paths (and d as "dir")."""
    import numpy as np

    inputs = _test_inputs("torch_cli_inputs")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    f = inputs.write_media(d, rng, CLI["hw"], CLI["frames"], CLI["fps"])
    f["G"], f["arc"] = f"{d}/G_unet_2blocks.pth", f"{d}/backbone.pth"
    inputs.save_pth(f["G"], inputs.aei_state_dict(rng, "unet", 2,
                                                  CLI["width"]))
    inputs.save_pth(f["arc"],
                    inputs.arcface_state_dict(rng, CLI["arcface_layers"]))
    mib = sum(Path(f[k]).stat().st_size for k in ("G", "arc")) / 2 ** 20
    log(f"cli: wrote the .pth files ({mib:.0f} MiB), the {CLI['hw']} "
        f"pngs and the {CLI['frames']}-frame mp4 in "
        f"{time.perf_counter() - t0:.1f} s")
    f["dir"] = d
    return f


def _cli_call(fn):
    """fn() with its standard output captured, synced; returns (wall s,
    lines, fn's result)."""
    import io

    import torch

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, buf.getvalue().splitlines(), result


def _face_box(pipe, image):
    """The best-scored detection box of an RGB image, (x0, y0, x1, y1)
    in pixels, as crop_faces detects."""
    import torch

    from ghost_tpu_torch.models.scrfd import (decode_detections,
                                              preprocess_frames)

    cfg = pipe.cfg
    with torch.inference_mode():
        canvas, scale = preprocess_frames(pipe._tensor(image[None]),
                                          cfg.det_size)
        scores, boxes, _ = decode_detections(
            pipe.det_mod(canvas), input_size=cfg.det_size,
            score_thresh=cfg.det_thresh, max_faces=cfg.max_faces)
    if not float(scores[0, 0]) > 0:
        raise AssertionError("cli: no face detected in the target")
    h, w = image.shape[:2]
    x0, y0, x1, y1 = (boxes[0, 0] / scale).cpu().tolist()
    return (max(int(x0), 0), max(int(y0), 0), min(int(x1) + 1, w),
            min(int(y1) + 1, h))


def phase_cli(card, f):
    """The swap CLI (`python -m ghost_tpu_torch.cli.inference`) through
    `main(argv)` on `cli_files` `f` (seeded full-width `.pth` files with
    the reference's names, G unet 2 blocks and iresnet100, a 1080p png
    pair and a 20-frame 1080p mp4): the image path, the streaming
    and the frames video paths, and streaming with the SRVGG student
    seat; each output decoded back, K1 (and S2 with the seat) launched,
    wall and frames/s end to end (weights, decode, swap, encode). The
    random detector and landmark heads are pinned to face templates
    (`_templated_cli`). Then the split-off `run` on such a loaded
    pipeline: the written png must equal `swap_image_fused` bit for bit
    and differ from the target inside the detected face box. Returns the
    launches of each run."""
    import logging
    import logging.handlers

    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("cli: cv2 does not import on this machine; the "
                           "CLI's image and video IO need it") from e
    import shutil

    log(f"cli: cv2 {cv2.__version__} imports; ffmpeg "
        f"{shutil.which('ffmpeg') or 'absent (the audio remux returns False)'}")
    from ghost_tpu_torch.data import frames

    log(f"cli: native_available() {frames.native_available()} "
        f"({frames.library_path()}; {frames.native_error()})")
    if not frames.native_available():
        raise AssertionError("cli: libghost_rt did not build: "
                             f"{frames.native_error()}")
    # stream_video_chunks logs the ring it takes
    ring_log = logging.handlers.BufferingHandler(100)
    frames_logger = logging.getLogger(frames.__name__)
    frames_logger.addHandler(ring_log)
    frames_logger.setLevel(logging.INFO)
    try:
        return _cli_runs(card, ring_log, f)
    finally:
        frames_logger.removeHandler(ring_log)


def _cli_base(f):
    """The flags every CLI run of phases 17 and 18 shares."""
    return ["--G_path", f["G"], "--width", str(CLI["width"]),
            "--arcface_path", f["arc"],
            "--arcface_depth", CLI["arcface_depth"],
            "--allow_random_weights", "1",
            "--batch_size", str(CLI["batch"]), "--source_paths", f["src"]]


def _cli_runs(card, ring_log, f):
    import numpy as np

    from ghost_tpu_torch.cli import inference
    from ghost_tpu_torch.pipeline.image import read_image_rgb
    from ghost_tpu_torch.pipeline.video import read_video

    launches = {}
    d = f["dir"]
    base = _cli_base(f)
    target = read_image_rgb(f["tgt"])
    for name, extra in CLI_RUNS:
        out = f"{d}/{name}." + ("png" if name == "image" else "mp4")
        io_args = (["--target_image", f["tgt"], "--out_image_name", out]
                   if name == "image" else
                   ["--target_video", f["mp4"], "--out_video_name", out])
        argv = base + list(extra) + io_args
        zero_counts()
        with _templated_cli():
            wall, lines, _ = _cli_call(lambda: inference.main(argv))
        counts = read_counts()
        launches[name] = counts
        for line in lines:
            log(f"  cli {name} | {line}")
        if name == "image":
            got = read_image_rgb(out)
            n = 1
            if got.shape != target.shape:
                raise AssertionError(f"cli image: {got.shape}")
        else:
            got, fps = read_video(out)
            n = got.shape[0]
            if got.shape != (CLI["frames"], *CLI["hw"], 3) \
                    or fps != CLI["fps"]:
                raise AssertionError(f"cli {name}: decoded {got.shape} "
                                     f"at {fps} fps")
        total = [ln for ln in lines if ln.startswith("Total time")]
        log(f"cli {name}: main() {wall:.2f} s wall, {n / wall:.2f} "
            f"frames/s end to end (weights, decode, swap, encode; "
            f"{total[0] if total else 'no Total time line'}); K1 "
            f"launches {counts['aad_modulate']}, S2 "
            f"{counts['conv3x3']}; {n} frames of "
            f"{got.shape[-3]}x{got.shape[-2]} decoded back ({card})")
        if counts["aad_modulate"] <= 0:
            raise AssertionError(f"cli {name}: K1 never launched")
        if name == "stream_sr" and counts["conv3x3"] <= 0:
            raise AssertionError("cli stream_sr: S2 never launched")
    rings = [r.getMessage() for r in ring_log.buffer]
    log(f"cli: the streaming runs' rings: {rings}")
    if len(rings) != 2 or not all("native ring" in r for r in rings):
        raise AssertionError("cli: a streaming run did not take the "
                             "native ring")

    # a real blend through the split-off run, bit for bit
    out = f"{d}/real.png"
    args = inference.build_parser().parse_args(
        base + ["--image_to_image", "1", "--target_image", f["tgt"],
                "--out_image_name", out])
    with _templated_cli() as load:
        load_s, _, pipe = _cli_call(lambda: load(args))
    zero_counts()
    wall, _, _ = _cli_call(lambda: inference.run(args, pipe))
    counts = read_counts()
    written = read_image_rgb(out)
    sources = inference.crop_or_center(pipe, f["src"])[None]
    ref = pipe.swap_image_fused(target, sources)
    x0, y0, x1, y1 = _face_box(pipe, target)
    inside = float((written[y0:y1, x0:x1] != target[y0:y1, x0:x1]).mean())
    log(f"cli run(args, pipe) with face templates: {wall:.2f} s, K1 "
        f"launches {counts['aad_modulate']}; equal to swap_image_fused: "
        f"{np.array_equal(written, ref)}; {inside:.2%} of the values in "
        f"the face box ({x0},{y0})-({x1},{y1}) changed; "
        f"{float((written != target).mean()):.2%} of the image ({card})")
    if not np.array_equal(written, ref):
        raise AssertionError("cli: the written image differs from "
                             "swap_image_fused")
    if not inside > 0 or counts["aad_modulate"] <= 0:
        raise AssertionError("cli: no blend inside the face box")
    _cli_breakdown(card, f, pipe, sources, load_s, d)
    return launches


def _cli_breakdown(card, f, pipe, sources, load_s, d):
    """Where a streaming run's wall goes, each piece alone on the same
    20 frames: the pipeline load, decode through the native ring and
    through `read_video`, `swap_video_stream(smooth=True)` on chunks in
    memory (warm), and the encode."""
    from ghost_tpu_torch.data.frames import stream_video_chunks
    from ghost_tpu_torch.pipeline.video import VideoChunkWriter, read_video

    chunk = CLI["batch"]
    ring_s, _, chunks = _cli_call(
        lambda: list(stream_video_chunks(f["mp4"], chunk)))
    read_s, _, _ = _cli_call(lambda: read_video(f["mp4"]))

    def swap():
        return list(pipe.swap_video_stream(iter(chunks), sources,
                                           smooth=True))
    swap()  # warm
    swap_s, _, outs = _cli_call(swap)

    def encode():
        writer = VideoChunkWriter(f"{d}/encode.mp4", CLI["fps"])
        for out in outs:
            writer.write(out)
        writer.close()
    encode_s, _, _ = _cli_call(encode)
    n = sum(c.shape[0] for c in chunks)
    log(f"cli breakdown ({n} frames, {CLI['hw']}, chunk {chunk}): "
        f"load_pipeline {load_s:.2f} s; decode through the ring "
        f"{ring_s:.3f} s ({n / ring_s:.1f} frames/s), read_video "
        f"{read_s:.3f} s; swap_video_stream(smooth=True) warm {swap_s:.3f} s "
        f"({n / swap_s:.2f} frames/s); encode (mp4v) {encode_s:.3f} s "
        f"({n / encode_s:.1f} frames/s) ({card})")


# ---------------------------------------------------------------------------
# The reference's own detector and recognizer packs (phase 18)
# ---------------------------------------------------------------------------


def _call_times(fn):
    """(ms per call by CUDA events, host us per call without a sync)."""
    return (_time_one(fn, ROUTES["iters"], "cuda"),
            _host_us(fn, ROUTES["iters"], "cuda"))


def _floats_on_card(ex, feeds, what):
    """Every float the executor returns lies on the card."""
    import torch

    outs = ex(feeds)
    bad = [i for i, o in enumerate(outs)
           if not (isinstance(o, torch.Tensor) and o.is_floating_point()
                   and o.device.type == "cuda")]
    log(f"routes: {what}: {len(outs)} outputs, every one a float tensor on "
        f"the card: {not bad}")
    if bad:
        raise AssertionError(f"routes: {what}: outputs {bad} are not float "
                             "tensors on the card")


def _routes_arcface(card, f, d):
    """ArcFaceOnnx on the full-width iresnet100 graph emitted from phase
    17's backbone.pth against the port's IResNet on the same weights,
    f32, 8 crops of 112; returns the graph's path."""
    import numpy as np
    import torch

    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.onnx_emit import emit_arcface
    from ghost_tpu_torch.convert.onnx_writer import save_onnx
    from ghost_tpu_torch.convert.torch_loader import (
        convert_arcface_state_dict, load_torch_checkpoint)
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.arcface import IResNet
    from ghost_tpu_torch.models.arcface_onnx import ArcFaceOnnx

    layers = CLI["arcface_layers"]
    t0 = time.perf_counter()
    tree = convert_arcface_state_dict(load_torch_checkpoint(f["arc"]),
                                      layers=layers)
    path = f"{d}/glintr100.onnx"
    save_onnx(path, emit_arcface(tree, layers=layers))
    t1 = time.perf_counter()
    arc = ArcFaceOnnx(path)
    t2 = time.perf_counter()
    native = load_flax_variables(IResNet(layers, policy=FULL_PRECISION),
                                 tree).cuda().eval()
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (ROUTES["crops"], 112, 112, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        got, ref = arc(x), native(x)
        err = float((got - ref).abs().max() / ref.abs().max())
        onnx_ms, onnx_host = _call_times(lambda: arc(x))
        nat_ms, nat_host = _call_times(lambda: native(x))
        _floats_on_card(arc._ex, {arc.input_name: x.permute(0, 3, 1, 2)},
                        "ArcFaceOnnx's executor")
    n = len(arc._ex.graph.nodes)
    log(f"routes: iresnet100 graph {Path(path).stat().st_size / 2 ** 20:.0f}"
        f" MiB, {n} nodes, written in {t1 - t0:.1f} s, ArcFaceOnnx built "
        f"in {t2 - t1:.1f} s")
    log(f"routes: ArcFaceOnnx vs IResNet (f32, {ROUTES['crops']} crops of "
        f"112): max err {err:.2e} of max|ref| (<= 1e-4); per call "
        f"{onnx_ms:.3f} ms (host {onnx_host:.0f} us, "
        f"{onnx_host / n:.1f} us a node) vs native {nat_ms:.3f} ms (host "
        f"{nat_host:.0f} us) ({card})")
    if not err <= 1e-4 or tuple(got.shape) != (ROUTES["crops"], 512):
        raise AssertionError("routes: ArcFaceOnnx disagrees with IResNet")
    return path


def _routes_scrfd(card, routes_in, d):
    """SCRFDOnnx on graph (c), emitted from the port's templated
    full-width SCRFD (f32), against that module on a chunk of 8
    letterboxed 1080p frames at 640: the same faces, kps within 1e-2 px
    in frame pixels. Returns the graph's path and the native module."""
    import torch

    from ghost_tpu_torch.convert.onnx_writer import save_onnx
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.scrfd import (SCRFD, decode_detections,
                                              preprocess_frames)
    from ghost_tpu_torch.models.scrfd_onnx import SCRFDOnnx
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.utils.face_template import inject_detection_template

    native = inject_detection_template(init_weights(
        SCRFD(policy=FULL_PRECISION), torch.Generator().manual_seed(0)))
    path = f"{d}/scrfd_10g_bnkps.onnx"
    save_onnx(path, routes_in.emit_scrfd(native.eval()))
    native.cuda()
    det = SCRFDOnnx(path, input_size=640)
    g = torch.Generator(device="cuda").manual_seed(2)
    frames = torch.randint(0, 256, (ROUTES["frames"], 1080, 1920, 3),
                           generator=g, device="cuda", dtype=torch.uint8)
    with torch.inference_mode():
        canvas, scale = preprocess_frames(frames, 640)
        got = decode_detections(det(canvas), 640, max_faces=4)
        ref = decode_detections(native(canvas), 640, max_faces=4)
        s_err = float((got[0] - ref[0]).abs().max())
        b_err = float((got[1] - ref[1]).abs().max() / scale)
        k_err = float((got[2] - ref[2]).abs().max() / scale)
        faces = int((ref[0] > 0).sum())
        onnx_ms, onnx_host = _call_times(lambda: det(canvas))
        nat_ms, nat_host = _call_times(lambda: native(canvas))
        _floats_on_card(det._ex, {det.input_name: canvas.float().permute(
            0, 3, 1, 2)}, "SCRFDOnnx's executor")
    n = len(det._ex.graph.nodes)
    log(f"routes: SCRFDOnnx vs SCRFD (f32, graph of {n} nodes, "
        f"{ROUTES['frames']} letterboxed 1080p frames at 640): {faces} "
        f"faces each; scores {s_err:.2e}, boxes {b_err:.2e} px, kps "
        f"{k_err:.2e} px (<= 1e-2); per call {onnx_ms:.3f} ms (host "
        f"{onnx_host:.0f} us, {onnx_host / n:.1f} us a node) vs native "
        f"{nat_ms:.3f} ms (host {nat_host:.0f} us) ({card})")
    if not (faces > 0 and bool(((got[0] > 0) == (ref[0] > 0)).all())
            and s_err <= 1e-5 and k_err <= 1e-2):
        raise AssertionError("routes: SCRFDOnnx's faces differ from SCRFD's")
    return path, native


def _routes_v1e(card, routes_in, d):
    """SCRFDV1e at both archs from seeded mmdet `.pth` files, the card
    against the CPU in f32; returns the 2.5GF file's path."""
    import numpy as np
    import torch

    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.torch_loader import (
        convert_scrfd_state_dict, load_torch_checkpoint)
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models import scrfd_v1e

    inputs = _test_inputs("torch_cli_inputs")
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (2, 640, 640, 3)).astype(np.float32))
    paths = {}
    for name in ("SCRFD_2_5GF", "SCRFD_10GF_KPS"):
        arch = getattr(scrfd_v1e, name)
        paths[name] = f"{d}/{name}.pth"
        inputs.save_pth(paths[name], routes_in.scrfd_mmdet_state_dict(
            np.random.default_rng(4), arch))
        tree = convert_scrfd_state_dict(load_torch_checkpoint(paths[name]),
                                        arch=arch)
        cpu = load_flax_variables(scrfd_v1e.SCRFDV1e(
            arch, policy=FULL_PRECISION), tree).eval()
        card_mod, x_card = copy.deepcopy(cpu).cuda(), x.cuda()
        with torch.inference_mode():
            ref = [m for lvl in cpu(x) for m in lvl]
            got = [m.cpu() for lvl in card_mod(x_card) for m in lvl]
            ms = _time_one(lambda: card_mod(x_card), ROUTES["iters"], "cuda")
        err = max(float((g - r).abs().max() / max(1.0, r.abs().max()))
                  for g, r in zip(got, ref))
        log(f"routes: SCRFDV1e {name} card vs CPU (f32, 2x640): max err "
            f"{err:.2e} (<= 1e-4, of max(1, max|ref|)); {ms:.3f} ms a "
            f"call on the card ({card})")
        if not err <= 1e-4:
            raise AssertionError(f"routes: SCRFDV1e {name} card vs CPU")
    return paths["SCRFD_2_5GF"]


def phase_routes(card, f):
    """The reference's packs behind the CLI's `.onnx` / `.pth` routes, on
    phase 17's files: ArcFaceOnnx, SCRFDOnnx and SCRFDV1e against the
    native modules, then `main(argv)` through the routes (image and
    streaming video, each decoded back; the image against the same run
    through the native modules) and an mmdet `.pth` image run. Returns
    the launches of each CLI run."""
    import numpy as np
    import torch

    from ghost_tpu_torch.cli import inference
    from ghost_tpu_torch.pipeline.image import read_image_rgb
    from ghost_tpu_torch.pipeline.video import read_video
    from ghost_tpu_torch.utils.face_template import inject_landmark_template

    _test_inputs("torch_cli_inputs")
    routes_in = _test_inputs("torch_route_inputs")
    d = f["dir"]
    arc_onnx = _routes_arcface(card, f, d)
    det_onnx, det_native = _routes_scrfd(card, routes_in, d)
    mmdet = _routes_v1e(card, routes_in, d)

    base = _cli_base(f)
    routes = ["--detector_path", det_onnx, "--arcface_path", arc_onnx]
    target = read_image_rgb(f["tgt"])
    launches = {}
    for name, io_args, n in (
            ("image", ["--image_to_image", "1", "--target_image", f["tgt"],
                       "--out_image_name", f"{d}/route.png"], 1),
            ("stream", ["--streaming", "1", "--target_video", f["mp4"],
                        "--out_video_name", f"{d}/route.mp4"],
             CLI["frames"])):
        argv = base + routes + io_args
        zero_counts()
        with _templated_cli():
            wall, lines, _ = _cli_call(lambda: inference.main(argv))
        launches[name] = read_counts()
        for line in lines:
            log(f"  routes {name} | {line}")
        got = read_image_rgb(f"{d}/route.png") if name == "image" else \
            read_video(f"{d}/route.mp4")[0]
        k1 = launches[name]["aad_modulate"]
        log(f"routes cli {name} (--detector_path *.onnx --arcface_path "
            f"*.onnx): main() {wall:.2f} s wall, {n / wall:.2f} frames/s end "
            f"to end; K1 launches {k1}; decoded {tuple(got.shape)} ({card})")
        want = (target.shape if name == "image"
                else (CLI["frames"], *CLI["hw"], 3))
        if tuple(got.shape) != tuple(want) or k1 != ROUTES["k1"][name]:
            raise AssertionError(f"routes cli {name}: {tuple(got.shape)}, "
                                 f"K1 {k1} (want {ROUTES['k1'][name]})")
        if any("random detector" in ln or "random ArcFace" in ln
               for ln in lines):
            raise AssertionError(f"routes cli {name}: a random model loaded")

    # the image run again in f32 (--bf16 ""), and the same run through the
    # native modules: the SCRFD the graph was emitted from and IResNet on
    # backbone.pth. In bf16 the generator rounds z_id, so the embeddings'
    # 1e-5 relative difference can move a rounding and the frame by more
    # than the bound; in f32 it moves the frame by far less, except where
    # it moves an edge pixel of the hull mask across its hard threshold
    # (`ops/mask.py`: sd >= erode, then the blur): there a few hundred
    # values near the face's edge move by up to ~10 grey levels. So phase
    # 4's bound (<= 3 grey levels, < 5% of values differing) holds on all
    # but ROUTE_EDGE_SHARE of the values.
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.torch_loader import (
        convert_arcface_state_dict, load_torch_checkpoint)
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.arcface import IResNet
    from ghost_tpu_torch.models.scrfd_onnx import SCRFDOnnx

    f32_image = ["--bf16", "", "--image_to_image", "1", "--target_image",
                 f["tgt"]]
    argv = base + routes + f32_image + ["--out_image_name",
                                        f"{d}/route_f32.png"]
    zero_counts()
    with _templated_cli():
        _cli_call(lambda: inference.main(argv))
    k1_f32 = read_counts()["aad_modulate"]
    args = inference.build_parser().parse_args(
        base + f32_image + ["--out_image_name", f"{d}/native.png"])
    _, _, pipe = _cli_call(lambda: inference.load_pipeline(args))
    pipe.det_mod = det_native
    pipe.arc_mod = load_flax_variables(
        IResNet(CLI["arcface_layers"], policy=FULL_PRECISION),
        convert_arcface_state_dict(load_torch_checkpoint(f["arc"]),
                                   layers=CLI["arcface_layers"])).cuda().eval()
    inject_landmark_template(pipe.lmk_mod)
    _cli_call(lambda: inference.run(args, pipe))
    native = read_image_rgb(f"{d}/native.png")
    # the detector route alone (the native ArcFace): where the difference
    # comes from
    pipe.det_mod = SCRFDOnnx(det_onnx, input_size=pipe.cfg.det_size)
    args.out_image_name = f"{d}/det_only.png"
    _cli_call(lambda: inference.run(args, pipe))
    for what, path in (("the routes' image", "route_f32.png"),
                       ("the detector route alone", "det_only.png")):
        route = read_image_rgb(f"{d}/{path}")
        diff = np.abs(route.astype(np.int16) - native.astype(np.int16))
        over = float((diff > 3).mean())
        log(f"routes: {what} (f32) vs the native modules' run: "
            f"{(diff > 0).mean():.4%} of values differ (< 5%), "
            f"{int((diff > 3).sum())} by more than 3 grey levels "
            f"({over:.4%}, < {ROUTE_EDGE_SHARE:.2%}), max {int(diff.max())}"
            f"; {float((route != target).mean()):.2%} of the target "
            f"changed ({card})")
        if not ((diff > 0).mean() < 0.05 and over < ROUTE_EDGE_SHARE
                and (route != target).any()):
            raise AssertionError(f"routes: {what} differs from the native "
                                 "run")
    if k1_f32 != ROUTES["k1"]["image"]:
        raise AssertionError(f"routes: the f32 image run launched K1 "
                             f"{k1_f32} times")

    # the mmdet route: boxes only
    argv = base + ["--detector_path", mmdet, "--image_to_image", "1",
                   "--target_image", f["tgt"], "--out_image_name",
                   f"{d}/mmdet.png"]
    zero_counts()
    with _templated_cli():
        wall, lines, _ = _cli_call(lambda: inference.main(argv))
    launches["mmdet_image"] = read_counts()
    for line in lines:
        log(f"  routes mmdet | {line}")
    warned = any("SCRFD-2.5GF has no kps branch" in ln for ln in lines)
    written = read_image_rgb(f"{d}/mmdet.png")
    log(f"routes cli mmdet image (--detector_path *.pth): main() {wall:.2f} "
        f"s wall; K1 launches {launches['mmdet_image']['aad_modulate']}; "
        f"no-kps warning printed: {warned}; wrote {written.shape} ({card})")
    if not warned or written.shape != target.shape:
        raise AssertionError("routes: the mmdet .pth run")
    torch.cuda.synchronize()
    return launches


# ---------------------------------------------------------------------------
# The output enhancer (phase 19)
# ---------------------------------------------------------------------------


def enhance_files(d):
    """Seeded full-width enhancer checkpoints with the reference's names
    in directory d: GFPGANv1.4.pth (toRGB.* and style_mlp.* included) and
    RealESRGAN_x4plus.pth under params_ema, realesr-general-x4v3.pth under
    params, as the real files nest them. Returns their paths."""
    import numpy as np

    inputs = _test_inputs("torch_cli_inputs")
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    ef = {"gfpgan": f"{d}/GFPGANv1.4.pth", "rrdb": f"{d}/RealESRGAN_x4plus.pth",
          "srvgg": f"{d}/realesr-general-x4v3.pth"}
    inputs.save_pth(ef["gfpgan"], inputs.gfpgan_state_dict(rng), "params_ema")
    inputs.save_pth(ef["rrdb"], inputs.rrdb_state_dict(rng), "params_ema")
    inputs.save_pth(ef["srvgg"], inputs.srvgg_state_dict(rng), "params")
    mib = sum(Path(p).stat().st_size for p in ef.values()) / 2 ** 20
    log(f"enhance: wrote the GFPGAN, RRDB and SRVGG .pth files ({mib:.0f} "
        f"MiB) in {time.perf_counter() - t0:.1f} s")
    return ef


def _enhance_argv(f, ef, mode):
    bg = "srvgg" if mode == "srvgg" else "rrdb"
    return _cli_base(f) + ["--gfpgan_path", ef["gfpgan"],
                           "--bg_upsampler_path", ef[bg],
                           *ENHANCE_FLAGS[mode]]


def _s2_per_call(enh, hw):
    """S2's launches in one `enh.enhance` call on frames of `hw`: every
    conv of an SRVGG background (num_conv + 2) once per tile; 34 x 32 =
    1088 for realesr-general-x4v3 on 1080p in 270x240 tiles."""
    from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact
    from ghost_tpu_torch.pipeline.enhance import _fit_tile

    if not isinstance(enh.bg_mod, SRVGGNetCompact):
        return 0
    th, tw = _fit_tile(enh.bg_tile, *hw)
    return (enh.bg_mod.num_conv + 2) * (hw[0] // th) * (hw[1] // tw)


def _lanes_present(enh, frames):
    """The face lanes of `enh` present in at least one of `frames`."""
    import torch

    from ghost_tpu_torch.models.scrfd import (decode_detections,
                                              preprocess_frames)

    with torch.inference_mode():
        canvas, _ = preprocess_frames(
            torch.from_numpy(frames).to(enh.device), enh.det_size)
        scores = decode_detections(
            enh.det_mod(canvas), input_size=enh.det_size,
            score_thresh=enh.det_thresh, max_faces=enh.max_faces)[0]
    return int((scores > 0).any(dim=0).sum())


def phase_enhance(card, f, cli):
    """The enhancer post-pass (`--enhance_output face|full`) on phase 17's
    files and seeded full-width GFPGANClean, RRDBNet x4plus and SRVGG
    x4v3 checkpoints: (a) card against CPU in f32, (b) a chunk of 8
    1080p frames in bf16, timed, (c) the CLI. Returns the launches of the
    chunk runs and of the CLI runs."""
    ef = f["enhance_files"] = enhance_files(f["dir"])
    _enhance_parity(card, f, ef)
    chunk = _enhance_chunk(card, f, ef)
    return chunk, _enhance_cli(card, f, ef, cli, chunk["srvgg"]["conv3x3"])


def _enhance_parity(card, f, ef):
    """FaceEnhancer with the full-width models on one frame of
    ENHANCE["parity_hw"] (the target png's corner; one face lane, 2x2
    background tiles with a 10-px halo), f32, on the card against the
    same modules on this machine's CPU: phase 4's frame bound (<= 3 grey
    levels, < 5% of values differing). S2 runs every SRVGG conv on the
    card: 34 a tile."""
    import numpy as np
    import torch

    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.torch_loader import (
        convert_gfpgan_state_dict, convert_rrdbnet_state_dict,
        convert_srvgg_state_dict, load_torch_checkpoint)
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.scrfd import SCRFD
    from ghost_tpu_torch.models.sr.gfpgan import (GFPGANClean,
                                                  drop_unread_leaves)
    from ghost_tpu_torch.models.sr.rrdb import RRDBNet
    from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.pipeline.enhance import FaceEnhancer
    from ghost_tpu_torch.pipeline.image import read_image_rgb
    from ghost_tpu_torch.utils.face_template import inject_detection_template

    p = FULL_PRECISION
    gfp = GFPGANClean(policy=p)
    gfp_vars, dropped = drop_unread_leaves(convert_gfpgan_state_dict(
        load_torch_checkpoint(ef["gfpgan"])), gfp)
    load_flax_variables(gfp, gfp_vars)
    bgs = {"rrdb": load_flax_variables(RRDBNet(policy=p),
                                       convert_rrdbnet_state_dict(
                                           load_torch_checkpoint(ef["rrdb"]))),
           "srvgg": load_flax_variables(SRVGGNetCompact(policy=p),
                                        convert_srvgg_state_dict(
                                            load_torch_checkpoint(
                                                ef["srvgg"])))}
    det = inject_detection_template(init_weights(
        SCRFD(policy=p), torch.Generator().manual_seed(0)))
    cpu = {"det": det.eval(), "gfp": gfp.eval(),
           **{k: m.eval() for k, m in bgs.items()}}
    on_card = {k: copy.deepcopy(m).cuda() for k, m in cpu.items()}
    h, w = ENHANCE["parity_hw"]
    frame = np.ascontiguousarray(read_image_rgb(f["tgt"])[None, :h, :w])
    log(f"enhance (a): GFPGANClean {sum(x.numel() for x in gfp.parameters()) / 1e6:.1f} "
        f"M params (dropped {len(dropped)} unread leaves: toRGB_*, mlp_*), "
        f"RRDBNet {sum(x.numel() for x in bgs['rrdb'].parameters()) / 1e6:.1f} M, "
        f"SRVGG {sum(x.numel() for x in bgs['srvgg'].parameters()) / 1e6:.2f} M; "
        f"f32, one {h}x{w} frame, {torch.get_num_threads()} CPU threads")
    for mode in ("face", "rrdb", "srvgg"):
        kw = dict(max_faces=1, bg_tile=ENHANCE["parity_tile"])
        bg = None if mode == "face" else mode
        t0 = time.perf_counter()
        ref = FaceEnhancer(cpu["det"], cpu["gfp"], bg and cpu[bg],
                           **kw).enhance(frame)
        cpu_s = time.perf_counter() - t0
        enh = FaceEnhancer(on_card["det"], on_card["gfp"],
                           bg and on_card[bg], **kw)
        zero_counts()
        t0 = time.perf_counter()
        got = enh.enhance(frame)
        card_s = time.perf_counter() - t0
        s2 = read_counts()["conv3x3"]
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        log(f"enhance (a) {mode}: card vs CPU max {int(diff.max())} grey "
            f"levels, {(diff > 0).mean():.4%} of values differ (bound: <= 3 "
            f"on < 5%); CPU {cpu_s:.2f} s, card {card_s:.2f} s (first "
            f"call); {(ref != frame).mean():.2%} of the frame changed; S2 "
            f"launches {s2} ({card})")
        want_s2 = _s2_per_call(enh, (h, w))
        if not (diff.max() <= 3 and (diff > 0).mean() < 0.05
                and (ref != frame).mean() > 0.01 and s2 == want_s2):
            raise AssertionError(f"enhance (a) {mode}: card vs CPU, or S2 "
                                 f"launches {s2} (want {want_s2})")
    del on_card
    torch.cuda.empty_cache()


def _enhance_chunk(card, f, ef):
    """`FaceEnhancer.enhance` as the CLI builds it (bf16, the templated
    pipeline's detector) on a chunk of 8 seeded 1080p frames (phase 17's
    clip) per mode: warm ms a chunk (median of ENHANCE["iters"] synced
    calls, numpy in and out), frames/s, peak memory, lanes present and S2
    launches (1088 with srvgg, 0 otherwise: `_s2_per_call`); the RRDB
    background pass once under torch.profiler (cuDNN's share of its
    device time). Returns each mode's launches."""
    import numpy as np
    import torch

    from ghost_tpu_torch.cli import inference
    from ghost_tpu_torch.pipeline.video import read_video

    frames = read_video(f["mp4"])[0][:ENHANCE["chunk"]]
    n = frames.shape[0]
    args = inference.build_parser().parse_args(_enhance_argv(f, ef, "face"))
    with _templated_cli() as load:
        pipe = load(args)
    launches = {}
    for mode in ENHANCE_FLAGS:
        args = inference.build_parser().parse_args(_enhance_argv(f, ef, mode))
        load_s, _, enh = _cli_call(lambda: inference.build_enhancer(args,
                                                                    pipe))
        enh.enhance(frames)  # warm
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        out = enh.enhance(frames)
        launches[mode] = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ts = []
        for _ in range(ENHANCE["iters"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enh.enhance(frames)
            ts.append(time.perf_counter() - t0)
        ms = sorted(ts)[len(ts) // 2] * 1e3
        lanes = _lanes_present(enh, frames)
        s2 = launches[mode]["conv3x3"]
        log(f"enhance (b) {mode}: {ms:.1f} ms a chunk of {n} "
            f"{frames.shape[1]}x{frames.shape[2]} (median of "
            f"{len(ts)}: {', '.join(f'{t * 1e3:.1f}' for t in ts)}), "
            f"{n / ms * 1e3:.2f} frames/s; peak memory {peak:.2f} GiB; "
            f"{lanes} of {enh.max_faces} lanes present; S2 launches {s2}; "
            f"build_enhancer {load_s:.2f} s ({card})")
        want_s2 = _s2_per_call(enh, frames.shape[1:3])
        if out.shape != frames.shape or out.dtype != np.uint8 \
                or not (out != frames).mean() > 0.01 or s2 != want_s2 \
                or lanes < 1:
            raise AssertionError(f"enhance (b) {mode}: {out.shape} "
                                 f"{out.dtype}, S2 {s2} (want {want_s2}), "
                                 f"{lanes} lanes")
        if mode == "rrdb":
            _enhance_bg_profile(card, enh, frames)
    return launches


def _enhance_bg_profile(card, enh, frames):
    """The RRDB background pass of one chunk under torch.profiler: device
    busy time, cuDNN's convolutions' share of it, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(frames).cuda()
    with torch.inference_mode():
        enh._bg_base(x)
        torch.cuda.synchronize()
        for _ in range(PROFILE_TRIES):  # a session can come back empty
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                enh._bg_base(x)
                torch.cuda.synchronize()
            events = prof.key_averages()
            kernels = [e for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(_dev_us(e) for e in kernels)
            if busy > 0:
                break
    if not busy > 0:
        log(f"enhance (b) rrdb background pass: torch.profiler recorded no "
            f"device time in {PROFILE_TRIES} sessions: busy time and "
            f"cuDNN's share not measured ({card})")
        return
    conv = sum(getattr(e, "device_time_total", 0) or
               getattr(e, "cuda_time_total", 0) for e in events
               if e.key == "aten::cudnn_convolution")
    log(f"enhance (b) rrdb background pass (profiled): device busy "
        f"{busy / 1e3:.1f} ms, aten::cudnn_convolution {conv / 1e3:.1f} ms "
        f"({conv / max(busy, 1e-9):.1%} of it) ({card})")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:8]:
        log(f"  {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:100]}")


def _enhance_cli(card, f, ef, cli, s2_chunk):
    """`main(argv)` with the enhancer: an image with face, an image with
    full rrdb, a 20-frame stream with full srvgg; each decoded back,
    K1 launched as in phase 17's run of the same path, S2 exactly
    s2_chunk (phase (b)'s 1080p chunk: 1088) a chunk with srvgg; then
    `run(args, pipe)` must write `enhance(swap_image_fused(...))` bit for
    bit. Returns the launches of each run."""
    import numpy as np

    from ghost_tpu_torch.cli import inference
    from ghost_tpu_torch.pipeline.image import read_image_rgb
    from ghost_tpu_torch.pipeline.video import read_video

    d = f["dir"]
    target = read_image_rgb(f["tgt"])
    chunks = -(-CLI["frames"] // CLI["batch"])
    launches = {}
    for name, mode, path, n in (
            ("enhance_image_face", "face", "image", 1),
            ("enhance_image_rrdb", "rrdb", "image", 1),
            ("enhance_stream_srvgg", "srvgg", "stream", CLI["frames"])):
        out = f"{d}/{name}." + ("png" if path == "image" else "mp4")
        io_args = (["--image_to_image", "1", "--target_image", f["tgt"],
                    "--out_image_name", out] if path == "image" else
                   ["--streaming", "1", "--target_video", f["mp4"],
                    "--out_video_name", out])
        argv = _enhance_argv(f, ef, mode) + io_args
        zero_counts()
        with _templated_cli():
            wall, lines, _ = _cli_call(lambda: inference.main(argv))
        launches[name] = counts = read_counts()
        for line in lines:
            log(f"  {name} | {line}")
        got = read_image_rgb(out) if path == "image" else read_video(out)[0]
        want = (target.shape if path == "image"
                else (CLI["frames"], *CLI["hw"], 3))
        k1, s2 = counts["aad_modulate"], counts["conv3x3"]
        want_s2 = s2_chunk * chunks if mode == "srvgg" else 0
        log(f"cli {name}: main() {wall:.2f} s wall, {n / wall:.2f} frames/s "
            f"end to end; K1 launches {k1} (phase 17's {path} run: "
            f"{cli[path]['aad_modulate']}), S2 {s2} (want {want_s2}); "
            f"decoded {tuple(got.shape)} ({card})")
        if tuple(got.shape) != tuple(want) or s2 != want_s2 \
                or k1 != cli[path]["aad_modulate"] \
                or any("random GFPGAN" in ln or "random rrdb" in ln
                       or "random srvgg" in ln for ln in lines):
            raise AssertionError(f"cli {name}: {tuple(got.shape)}, K1 {k1}, "
                                 f"S2 {s2}")

    # the split-off run writes the post-pass of swap_image_fused
    out = f"{d}/enhance_run.png"
    args = inference.build_parser().parse_args(
        _enhance_argv(f, ef, "face") + ["--image_to_image", "1",
                                        "--target_image", f["tgt"],
                                        "--out_image_name", out])
    with _templated_cli() as load:
        pipe = load(args)
    _cli_call(lambda: inference.run(args, pipe))
    written = read_image_rgb(out)
    sources = inference.crop_or_center(pipe, f["src"])[None]
    swapped = pipe.swap_image_fused(target, sources)
    ref = inference.build_enhancer(args, pipe).enhance(swapped[None])[0]
    log(f"cli run(args, pipe) --enhance_output face: equal to "
        f"enhance(swap_image_fused): {np.array_equal(written, ref)}; "
        f"{float((written != swapped).mean()):.2%} of the swapped image "
        f"changed by the post-pass ({card})")
    if not np.array_equal(written, ref) or not (written != swapped).any():
        raise AssertionError("cli: run(args, pipe) with the enhancer differs "
                             "from enhance(swap_image_fused)")
    return launches


# ---------------------------------------------------------------------------
# The GAN train step (phase 20)
# ---------------------------------------------------------------------------


def _tp():
    """tests/torch_train_parity.py: the narrow config, the seeded models
    and batches, and the card-against-CPU step check the card tests
    share."""
    return _test_inputs("torch_train_parity")


def _gan_models(device, policy, full, seed):
    """G (AEINet, train mode), D and the frozen ArcFace: full width as
    `ghost_tpu/cli/train.py:260-300` builds them, or the tier-1 tests'
    narrow config; seeded weights, drawn on `device`."""
    tp = _tp()
    return tp.gan_models(GAN if full else tp.NARROW, policy, seed, device)


def _loop_cfg(**kw):
    from ghost_tpu_torch.train.loop import LoopConfig

    base = dict(d_interval=GAN["d_interval"], print_interval=10 ** 9,
                show_step=10 ** 9, save_interval=10 ** 9)
    base.update(kw)
    return LoopConfig(**base)


def _gan_parity(device, card):
    """(a) The tier-1 tests' narrow config on the card against the CPU
    from the same seeded state, each beside a yardstick of the CPU's own.

    (a1) One G and one D step, canonical and round_trip, in f32 and in
    bf16 (DEFAULT_POLICY, the CLI's --bf16): `card_against_cpu` of
    tests/torch_train_parity.py, whose docstring gives the bounds and
    their reasons (in bf16 beside the CPU's own bf16 error against the
    f32 step; the card tests run the same check).
    (a2) train_loop, round_trip with the ratchets, f32, 3 G and 2 D steps
    (d_interval 2): step 0's metrics 1e-4 relative; later steps' metrics
    within 5x the CPU's spread + 1e-2, the end state's parameters and BN
    stats (relative L2) within 5x the spread + 1e-3. After the first
    step two f32 runs part where a gradient's sign was not settled, and
    Adam carries that through every later gradient: one reordering of
    the CPU run is one sample of that spread (measured 1.5e-2 in step 2's
    metrics)."""
    from ghost_tpu_torch.train.loop import train_loop

    tp = _tp()
    batches = tp.gan_batches(3, tp.NARROW["batch"], seed=2)
    ok, parts = True, []
    zero_counts()
    for name, policy in tp.POLICIES.items():
        for mode in ("canonical", "round_trip"):
            good, report = tp.card_against_cpu(batches[0], device, mode,
                                               policy, seed=1)
            ok &= good
            parts.append(f"{name} {report}: {good}")
    cpu = _gan_models("cpu", tp.POLICIES["f32"], False, seed=1)
    runs = {}
    for name, dev, bs in (("cpu", "cpu", batches),
                          ("spread", "cpu", [tp.swapped(b) for b in batches]),
                          ("card", device, batches)):
        seen = []
        st, g2, d2 = tp.gan_state([copy.deepcopy(m).to(dev) for m in cpu],
                                  "round_trip", GAN["d_interval"])
        st, _ = train_loop(st, g2, d2, bs, _loop_cfg(distill=True),
                           max_steps=3,
                           on_step=lambda i, m, mu: seen.append(m))
        runs[name] = (seen, tp.state_tensors(st))
    (cseen, cend), (sseen, send), (kseen, kend) = (
        runs[n] for n in ("cpu", "spread", "card"))
    steps = []
    for i, (a, sp, k) in enumerate(zip(cseen, sseen, kseen)):
        e_card = max(abs(k[key] / v - 1) for key, v in a.items())
        e_cpu = max(abs(sp[key] / v - 1) for key, v in a.items())
        steps.append(f"{e_card:.2e} ({e_cpu:.2e})")
        ok &= a.keys() == k.keys() and e_card <= (
            1e-4 if i == 0 else 5 * e_cpu + 1e-2)
    params = [n for n in cend if n.startswith(("g.", "d."))
              and "running" not in n]
    stats = [n for n in cend if "running" in n]
    loop = {}
    for what, keys in (("params", params), ("stats", stats)):
        loop[what] = (tp.rel_l2(kend, cend, keys), tp.rel_l2(send, cend, keys))
        ok &= loop[what][0] <= 5 * loop[what][1] + 1e-3
    ok &= [("lossD" in m) for m in kseen] == [True, False, True]
    counts = read_counts()
    log(f"gan parity (a) narrow, card vs CPU (the yardstick in brackets): "
        f"one G+D step, {'; '.join(parts)}; train_loop f32 "
        f"round_trip 3 G + 2 D: metrics by step {', '.join(steps)}, end "
        f"parameters {loop['params'][0]:.2e} ({loop['params'][1]:.2e}), BN "
        f"stats {loop['stats'][0]:.2e} ({loop['stats'][1]:.2e}) relative "
        f"L2; launches {counts}: {ok} ({card})")
    if not ok or any(counts.values()):
        raise AssertionError("GAN train step: card against CPU")


def _changed(cur, prev):
    import torch

    return [bool(x) for x in torch.stack(
        [(a != b).any() for a, b in zip(cur, prev)]).tolist()]


def _gan_full(device, card, policy_name):
    """(b) Full width, batch 16: canonical, then round_trip with a seeded
    teacher_y, 6 G and 3 D steps each through train_loop: every loss
    finite, every G parameter tensor and encoder BN statistic changed by
    every step, D's parameters changed by the D steps only; G-step and
    D-step wall (synced), peak memory, and one profiled G step."""
    import torch

    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.nn.layers import BatchNorm
    from ghost_tpu_torch.train.loop import train_loop

    policy = FULL_PRECISION if policy_name == "f32" else DEFAULT_POLICY
    batches = _tp().gan_batches(GAN["steps"], GAN["batch"], seed=3)
    out = {}
    for mode in ("canonical", "round_trip"):
        torch.cuda.empty_cache()
        models = _gan_models(device, policy, True, seed=0)
        st, g_step, d_step = _tp().gan_state(models, mode)
        g, d = st.g, st.d
        n_g = sum(p.numel() for p in g.parameters())
        n_d = sum(p.numel() for p in d.parameters())
        stats = [b for m in g.encoder.modules() if isinstance(m, BatchNorm)
                 for b in (m.running_mean, m.running_var)]
        times = {"g": [], "d": []}

        def timed(fn, key):
            def run(*a, **k):
                torch.cuda.synchronize(device)
                t = time.perf_counter()
                res = fn(*a, **k)
                torch.cuda.synchronize(device)
                times[key].append(time.perf_counter() - t)
                return res
            return run

        snap = {"g": [p.detach().clone() for p in g.parameters()],
                "s": [t.clone() for t in stats],
                "d": [p.detach().clone() for p in d.parameters()]}
        problems, seen = [], []

        def on_step(i, metrics, mults):
            cur = {"g": list(g.parameters()), "s": stats,
                   "d": list(d.parameters())}
            ch = {k: _changed(cur[k], snap[k]) for k in cur}
            d_ran = i % GAN["d_interval"] == 0
            if not all(ch["g"]):
                problems.append(f"step {i}: {ch['g'].count(False)} G tensors "
                                f"unchanged")
            if not all(ch["s"]):
                problems.append(f"step {i}: BN stats unchanged")
            if d_ran and not any(ch["d"]) or not d_ran and any(ch["d"]):
                problems.append(f"step {i}: D changed {sum(ch['d'])} tensors, "
                                f"D step {d_ran}")
            bad = [k for k, v in metrics.items() if not math.isfinite(v)]
            if bad:
                problems.append(f"step {i}: non-finite {bad}")
            for k in cur:
                for a, b in zip(snap[k], cur[k]):
                    a.copy_(b.detach())
            seen.append(metrics)

        torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        t0 = time.perf_counter()
        st, _ = train_loop(st, timed(g_step, "g"), timed(d_step, "d"),
                           batches, _loop_cfg(distill=mode != "canonical"),
                           max_steps=GAN["steps"], on_step=on_step)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        gt, dt = times["g"], times["d"]
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        last = seen[-1]
        log(f"gan {policy_name} {mode}: G {n_g / 1e6:.1f} M params, D "
            f"{n_d / 1e6:.2f} M, batch {GAN['batch']} at 256 px: "
            f"{len(gt)} G steps {', '.join(f'{t * 1e3:.1f}' for t in gt)} ms "
            f"(median after the first {med(gt[1:]) * 1e3:.1f} ms), "
            f"{len(dt)} D steps {', '.join(f'{t * 1e3:.1f}' for t in dt)} ms; "
            f"loop wall {wall:.2f} s; peak memory {peak:.2f} GiB; last "
            f"metrics {json.dumps({k: round(v, 5) for k, v in last.items()})};"
            f" launches {counts} ({card})")
        n_d = len(range(0, GAN["steps"], GAN["d_interval"]))
        if problems or len(gt) != GAN["steps"] or len(dt) != n_d \
                or any(counts.values()):
            raise AssertionError(f"GAN train {policy_name} {mode}: "
                                 f"{problems}")
        b = {k: torch.as_tensor(v, device=device)
             for k, v in batches[0].items()}
        log(f"gan {policy_name} {mode}: one G step under torch.profiler")
        _profile(lambda: g_step(st, b), device)
        out[mode] = (med(gt[1:]), med(dt), peak)
        del st, models, g, d, snap, stats
    return out


def _gan_resume(device, card, d):
    """(c) Full width, f32, canonical, deterministic cuDNN: 5 iterations
    (D at 0, 2, 4) saving at step 3; a state of other seeded weights,
    restored from step 3, takes iteration 4 (the frozen ArcFace, which
    no checkpoint holds, is the same): every tensor (parameters,
    BN statistics, Adam moments and step counts, the EMA) equal to the
    uninterrupted run's, bit for bit, and the same step, update counts
    and ratchets."""
    import torch

    from ghost_tpu_torch.core.checkpoint import CheckpointManager
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.train.loop import train_loop

    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        batches = _tp().gan_batches(5, GAN["batch"], seed=4)
        mgr = CheckpointManager(Path(d) / "gan_ck")
        models = _gan_models(device, FULL_PRECISION, True, seed=0)
        arc = models[2]  # frozen, outside the state: the same in both runs
        st, g_step, d_step = _tp().gan_state(models, "canonical")
        t0 = time.perf_counter()
        st, _ = train_loop(st, g_step, d_step, batches,
                           _loop_cfg(save_interval=3, distill=True),
                           checkpoint_manager=mgr, max_steps=5)
        full = _tp().state_tensors(st)
        full_meta = (st.step, st.mults, st.g_opt.count, st.d_opt.count)
        t_full = time.perf_counter() - t0
        del st, models
        torch.cuda.empty_cache()
        g, dis, _ = _gan_models(device, FULL_PRECISION, True, seed=5)
        st, g_step, d_step = _tp().gan_state((g, dis, arc), "canonical")
        t0 = time.perf_counter()
        st = mgr.restore(3, like=st)
        t_restore = time.perf_counter() - t0
        st, _ = train_loop(st, g_step, d_step, batches[4:],
                           _loop_cfg(distill=True), start_iteration=4,
                           max_steps=5)
        res = _tp().state_tensors(st)
        meta = (st.step, st.mults, st.g_opt.count, st.d_opt.count)
        del st
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            prev
    size = sum(p.stat().st_size for p in (Path(d) / "gan_ck").rglob("*")
               if p.is_file())
    differ = [k for k in full if not torch.equal(full[k], res[k])]
    log(f"gan resume (c) full width f32 canonical: 5 iterations in "
        f"{t_full:.2f} s with the step-3 save ({size / 2 ** 30:.2f} GiB on "
        f"disk), restore {t_restore:.2f} s; step 4 of the resumed run equal "
        f"bit for bit in {len(full) - len(differ)} of {len(full)} tensors; "
        f"step / ratchets / update counts {meta} vs {full_meta} ({card})")
    if differ or meta != full_meta or full.keys() != res.keys():
        raise AssertionError(f"resume differs: {differ[:8]}")


def _gan_preempt(device, card, d):
    """(d) SIGTERM sent to this process by a timer thread during a run
    (narrow config on the card), in a directory holding an older run's
    steps 0-11, at the default keep: the loop saves a forced checkpoint
    of the step it was on, over the stale snapshot of that step, and
    stops; that step is the latest and stays (orbax's save-order
    eviction), with the four last-saved stale ones."""
    import os
    import signal
    import threading

    import torch

    from ghost_tpu_torch.core.checkpoint import CheckpointManager
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.train.loop import train_loop
    from ghost_tpu_torch.train.preempt import PreemptionGuard

    old = CheckpointManager(Path(d) / "gan_preempt", keep=12)
    for step in range(12):  # an older run's snapshots, all later
        old.save(step, {"stale": True})
    mgr = CheckpointManager(Path(d) / "gan_preempt")  # keep 5
    st, g_step, d_step = _tp().gan_state(
        _gan_models(device, FULL_PRECISION, False, seed=6), "canonical")

    def on_step(i, metrics, mults):
        if i == 0:
            threading.Timer(0.01, os.kill,
                            (os.getpid(), signal.SIGTERM)).start()

    with PreemptionGuard() as guard:
        st, _ = train_loop(st, g_step, d_step,
                           _tp().gan_batches(10, seed=7),
                           _loop_cfg(), checkpoint_manager=mgr,
                           preemption=guard, on_step=on_step)
    stopped = st.step - 1
    saved = mgr.restore(stopped)
    same = all(torch.equal(saved["g"][k], v.cpu())
               for k, v in st.g.state_dict().items())
    kept = [s for s in range(12) if s != stopped][-4:] + [stopped]
    log(f"gan preemption (d): SIGTERM from a timer thread 10 ms after step "
        f"0's observer; the loop stopped after {st.step} G steps and saved "
        f"step {stopped} (forced, over a stale snapshot of that step, "
        f"below 12 stale ones, keep 5): equal to the live state {same}; "
        f"steps kept in save order {mgr.all_steps()}, expected {kept}")
    if not guard.triggered or st.step >= 10 or "stale" in saved or not same \
            or mgr.all_steps() != kept or mgr.latest_step() != stopped:
        raise AssertionError("preemption did not save and stop")


def phase_gan(device, card):
    """Phase 20: the GAN train step and the code around it (loop,
    checkpoints, preemption). The path launches none of the table's
    kernels, as in JAX (`fused_aad=False`): each run's counts, zeroed
    just before it, must read 0."""
    import torch

    t0 = time.perf_counter()
    _gan_parity(device, card)
    full = {p: _gan_full(device, card, p) for p in ("f32", "bf16")}
    with tempfile.TemporaryDirectory() as d:
        _gan_resume(device, card, d)
        _gan_preempt(device, card, d)
    torch.cuda.empty_cache()
    log(f"gan: phase 20 in {time.perf_counter() - t0:.1f} s; median G / D "
        f"step ms and peak GiB: " + "; ".join(
            f"{p} {m} {v[0] * 1e3:.1f} / {v[1] * 1e3:.1f}, {v[2]:.2f}"
            for p, r in full.items() for m, v in r.items()) + f" ({card})")


# ------------------------------------------------------------ phase 21
def train_cli_files(d, files):
    """Phase 21's inputs in directory d, beside phase 17's full-width G
    (unet 2 blocks) and iresnet100 `backbone.pth`: 128 seeded 256x256
    jpgs (`cli/preprocess.py`'s crop size), flat and in 8 identity
    folders; a full-width `D_*.pth` (n_layers 5 x 3 scales), a LIPSPADE
    `10_net_G.pth` (ngf 48), a FAN msgpack (4 stacks x 256 features), an
    inswapper-signature graph, and a narrow G `.pth` (width 1/16, 1
    block) for the card-vs-CPU part. Returns their paths."""
    import numpy as np

    from ghost_tpu_torch.core.checkpoint import save_msgpack

    cin = _test_inputs("torch_cli_inputs")
    tin = _test_inputs("torch_train_cli_inputs")
    c = TRAIN_CLI
    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    f = {"G": files["G"], "arc": files["arc"], "D": f"{d}/D_unet_2blocks.pth",
         "sr": f"{d}/10_net_G.pth", "fan": f"{d}/WFLW_4HG.msgpack",
         "onnx": f"{d}/inswapper_stand_in.onnx",
         "narrow_G": f"{d}/G_unet_1blocks_w16.pth",
         "flat": tin.write_faces(f"{d}/faces", rng, c["images"], c["size"]),
         "vgg": tin.write_faces(f"{d}/vgg", rng, c["images"], c["size"],
                                identities=c["identities"])}
    cin.save_pth(f["D"], tin.disc_state_dict(rng, num_D=3, n_layers=5,
                                             ndf=64))
    cin.save_pth(f["sr"], tin.spade_state_dict(rng, ngf=c["sr_ngf"]))
    save_msgpack(f["fan"], tin.fan_variables(rng, c["fan_stacks"],
                                             c["fan_features"]))
    with open(f["onnx"], "wb") as fh:
        fh.write(tin.inswapper_graph(rng))
    cin.save_pth(f["narrow_G"], cin.aei_state_dict(rng, "unet", 1, 1 / 16))
    mib = sum(Path(f[k]).stat().st_size
              for k in ("D", "sr", "fan", "onnx")) / 2 ** 20
    log(f"train cli: wrote {c['images']} jpgs twice, D, LIPSPADE, FAN and "
        f"the teacher graph ({mib:.0f} MiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return f


def _train_spy(rec, swap=False, start=None):
    """Spy on the port's train CLI's `train_loop` (the shared spy of
    `tests/torch_train_cli_inputs.py`); the batches are not kept, so the
    runs' peak memory is the CLI's own."""
    from ghost_tpu_torch.train import loop

    return _test_inputs("torch_train_cli_inputs").train_loop_spy(
        loop, rec, start=start, swap=swap, keep_batches=False)


def _param_clones(state):
    """Copies of G's and D's parameters (the starting state of a run)."""
    return [[p.detach().clone() for p in m.parameters()]
            for m in (state.g, state.d)]


def _train_cli_parity(card, tf, d):
    """(a) The narrow config (G width 1/16, 1 block, from `.pth`; the
    CLI's full-width D; tiny ArcFace, seeded), f32, batch 2, one loader
    worker (the same batches), --d_interval 1, 2 steps: `main(argv)` on
    the card against `main(argv, device="cpu")`, with phase 20 (a2)'s
    bounds beside the CPU's own spread (its run with each batch's samples
    in the other order): step 0's metrics 1e-4 relative, step 1's within
    5x the spread + 1e-2, the end state's parameters and BN statistics
    (relative L2) within 5x the spread + 1e-3. Returns the card run's
    launch counts."""
    from ghost_tpu_torch.cli import train as tcli

    tp = _tp()
    argv = ["--dataset_path", tf["flat"], "--G_path", tf["narrow_G"],
            "--D_path", tf["D"], "--arcface_path", f"{d}/none.pth",
            "--arcface_depth", "tiny", "--width", "0.0625", "--num_blocks",
            "1", "--batch_size", "2", "--bf16", "", "--num_workers", "1",
            "--d_interval", "1", "--max_steps", "2", "--save_interval",
            "100000", "--show_step", "100000", "--output_dir", f"{d}/out_a"]
    runs, counts = {}, None
    for name, dev, swap in (("card", "cuda", False), ("cpu", "cpu", False),
                            ("spread", "cpu", True)):
        rec = {}
        zero_counts()
        with _train_spy(rec, swap):
            _cli_call(lambda: tcli.main(argv + ["--run_name",
                                                f"{d}/a_{name}"],
                                        device=dev))
        if name == "card":
            counts = read_counts()
        runs[name] = ([m for _, m in rec["metrics"]],
                      tp.state_tensors(rec["final"]))
    (cseen, cend), (sseen, send), (kseen, kend) = (
        runs[n] for n in ("cpu", "spread", "card"))
    ok, steps = len(kseen) == len(cseen) == 2, []
    # relative, or absolute where the CPU's value is 0 (L_rec of a batch
    # with no same-person pair)
    rel = lambda x, v: abs(x - v) / abs(v) if v else abs(x)  # noqa: E731
    for i, (a, sp, k) in enumerate(zip(cseen, sseen, kseen)):
        e_card = max(rel(k[key], v) for key, v in a.items())
        e_cpu = max(rel(sp[key], v) for key, v in a.items())
        steps.append(f"{e_card:.2e} ({e_cpu:.2e})")
        ok &= a.keys() == k.keys() and e_card <= (
            1e-4 if i == 0 else 5 * e_cpu + 1e-2)
    params = [n for n in cend if n.startswith(("g.", "d."))
              and "running" not in n]
    stats = [n for n in cend if "running" in n]
    end = {}
    for what, keys in (("params", params), ("stats", stats)):
        end[what] = (tp.rel_l2(kend, cend, keys), tp.rel_l2(send, cend, keys))
        ok &= end[what][0] <= 5 * end[what][1] + 1e-3
    log(f"train cli (a) narrow main(argv), card vs CPU (the CPU's spread in "
        f"brackets): metrics by step {', '.join(steps)}; end parameters "
        f"{end['params'][0]:.2e} ({end['params'][1]:.2e}), BN stats "
        f"{end['stats'][0]:.2e} ({end['stats'][1]:.2e}) relative L2; "
        f"launches {counts}: {ok} ({card})")
    if not ok:
        raise AssertionError("train CLI: card against CPU")
    return counts


def _train_cli_loader(card, tf):
    """The loader alone as the CLI builds it (`FaceEmbedDataset` on the
    flat 128 jpgs, batch 16, 8 worker threads), two epochs with no
    consumer work: ms per batch after each epoch's first; and one item's
    assembly on one thread (three colour jitters, four resizes). Returns
    the median ms per batch."""
    from ghost_tpu_torch.data.datasets import FaceEmbedDataset
    from ghost_tpu_torch.data.loader import PrefetchLoader

    ds = FaceEmbedDataset([tf["flat"]], same_prob=0.8)
    t0 = time.perf_counter()
    for i in range(16):
        ds[i]
    item = (time.perf_counter() - t0) / 16 * 1e3
    loader = PrefetchLoader(ds, 16, num_workers=8)
    per = []
    for _ in range(2):
        t = time.perf_counter()
        for j, _b in enumerate(loader):
            now = time.perf_counter()
            if j:
                per.append((now - t) * 1e3)
            t = now
    med = sorted(per)[len(per) // 2]
    log(f"train cli (b0) the loader alone, batch 16, 8 threads: "
        f"{', '.join(f'{p:.1f}' for p in per)} ms a batch after each "
        f"epoch's first (median {med:.1f}); one item on one thread "
        f"{item:.1f} ms ({card})")
    return med


def _train_cli_full(card, tf, d):
    """(b) `main(argv)` as a user runs it: the defaults (bf16, batch 16,
    --d_interval 10, --num_workers 8), --pretrained from the full-width
    `.pth` files, --max_steps 12, --show_step 5, --save_interval 10, in
    canonical with the eye loss (FAN 4 x 256 from its msgpack), roundtrip
    (identity folders, --same_identity), self and distill with
    --teacher_upsample (the inswapper-signature graph on the executor,
    LIPSPADE ngf 48). Each run: every loss finite, every G and D tensor
    changed, the step-10 checkpoint and the grids of iterations 0, 5 and
    10 written; wall, time to the end of step 0, median iteration and
    loader-wait ms over iterations 2-11, peak memory. Returns each run's
    launch counts."""
    import torch

    from ghost_tpu_torch.cli import train as tcli
    from ghost_tpu_torch.core.checkpoint import CheckpointManager

    c = TRAIN_CLI
    base = ["--G_path", tf["G"], "--D_path", tf["D"], "--arcface_path",
            tf["arc"], "--max_steps", str(c["steps"]), "--show_step", "5",
            "--save_interval", "10", "--output_dir", f"{d}/out_b"]
    extra = {
        "canonical_eyes": ["--dataset_path", tf["flat"],
                           "--eye_detector_loss", "1", "--weight_eyes", "1",
                           "--fan_path", tf["fan"]],
        "roundtrip": ["--dataset_path", tf["vgg"], "--mode", "roundtrip",
                      "--vgg_dataset", "1", "--same_identity", "1"],
        "self": ["--dataset_path", tf["flat"], "--mode", "self"],
        "distill_upsample": ["--dataset_path", tf["flat"], "--mode",
                             "distill", "--teacher_onnx", tf["onnx"],
                             "--teacher_upsample", "1", "--sr_path",
                             tf["sr"], "--sr_ngf", str(c["sr_ngf"])]}
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    counts, out = {}, {}
    for name, flags in extra.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = {}
        zero_counts()
        t0 = time.perf_counter()
        with _train_spy(rec, start=_param_clones), contextlib.chdir(d):
            wall, lines, _ = _cli_call(lambda: tcli.main(
                base + flags + ["--run_name", name]))
        counts[name] = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ends, waits = rec["ends"], rec["waits"]
        iters = [(b - a) * 1e3 for a, b in zip(ends[1:-1], ends[2:])]
        wait = [w * 1e3 for w in waits[2:len(ends)]]
        bad = [(i, k) for i, m in rec["metrics"]
               for k, v in m.items() if not math.isfinite(v)]
        g0, d0 = rec["start"]
        g_same = sum(bool(torch.equal(a, b)) for a, b in zip(
            g0, rec["final"].g.parameters()))
        d_same = sum(bool(torch.equal(a, b)) for a, b in zip(
            d0, rec["final"].d.parameters()))
        images = sorted(p.name for p in Path(d, "out_b", "images").glob(
            f"generated_{name}_*.jpg"))
        steps = CheckpointManager(Path(d, f"{name}_ckpt")).all_steps()
        out[name] = (wall, ends[0] - t0, med(iters), med(wait), peak)
        last = {k: round(v, 4) for k, v in rec["metrics"][-1][1].items()}
        log(f"train cli (b) {name}: {len(ends)} steps, wall {wall:.2f} s, "
            f"to the end of step 0 {ends[0] - t0:.2f} s, iterations 2-11 "
            f"{', '.join(f'{t:.1f}' for t in iters)} ms (median "
            f"{med(iters):.1f}), loader wait "
            f"{', '.join(f'{w:.2f}' for w in wait)} ms (median "
            f"{med(wait):.2f}, {sum(wait) / sum(iters):.2%} of the "
            f"iterations); peak memory {peak:.2f} GiB; last metrics "
            f"{json.dumps(last)}; G tensors unchanged {g_same}, D "
            f"{d_same}; checkpoints "
            f"{steps}; grids {images}; launches {counts[name]} ({card})")
        if len(ends) != c["steps"] or bad or g_same or d_same \
                or steps != [10] or len(images) != 3 \
                or not any(ln.startswith("final:") for ln in lines):
            raise AssertionError(f"train CLI {name}: non-finite {bad[:4]}, "
                                 f"checkpoints {steps}, grids {images}")
        del rec
    return counts, out


def _train_cli_resume(card, tf, d):
    """(c) Resume at full width (bf16, batch 16, canonical) with
    --save_interval 1: 4 steps, then a rerun to --max_steps 6 that prints
    `resuming from checkpoint step 3` and ends with step 5 the latest
    (steps 1-5 kept, the state of step 5 after 6 G steps). Returns the
    two runs' launch counts."""
    from ghost_tpu_torch.cli import train as tcli
    from ghost_tpu_torch.core.checkpoint import CheckpointManager

    argv = ["--dataset_path", tf["flat"], "--G_path", tf["G"], "--D_path",
            tf["D"], "--arcface_path", tf["arc"], "--save_interval", "1",
            "--show_step", "100000", "--run_name", "resume",
            "--output_dir", f"{d}/out_c"]
    counts, walls, said = {}, [], []
    for steps in (4, 6):
        zero_counts()
        with contextlib.chdir(d):
            wall, lines, _ = _cli_call(lambda: tcli.main(
                argv + ["--max_steps", str(steps)]))
        counts[f"resume_{steps}"] = read_counts()
        walls.append(wall)
        said += [ln for ln in lines if ln.startswith("resuming")]
    mgr = CheckpointManager(Path(d, "resume_ckpt"))
    last = mgr.restore(mgr.latest_step())
    ok = (said == ["resuming from checkpoint step 3"]
          and mgr.all_steps() == [1, 2, 3, 4, 5] and last["step"] == 6)
    log(f"train cli (c) resume, full width: 4 steps in {walls[0]:.2f} s, "
        f"the rerun to 6 in {walls[1]:.2f} s, said {said}; checkpoints "
        f"{mgr.all_steps()}, the latest's G step count {last['step']}: "
        f"{ok} ({card})")
    if not ok:
        raise AssertionError("train CLI resume")
    return counts


def phase_train_cli(card, files):
    """Phase 21: the user's train CLI (`python -m
    ghost_tpu_torch.cli.train`) through `main(argv)`: (a) card against
    CPU at the narrow config, (b0) the loader alone, (b) the four modes
    at full width as a user runs them, (c) resume at full width. The path
    runs none of the table's kernels (`fused_aad=False`; FAN, the
    executor and LIPSPADE are plain convolutions): each run's counts,
    zeroed just before it, must read 0 (d). Returns the counts by run."""
    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tf = train_cli_files(d, files)
        counts = {"parity_card": _train_cli_parity(card, tf, d)}
        loader_ms = _train_cli_loader(card, tf)
        full, out = _train_cli_full(card, tf, d)
        counts.update(full)
        counts.update(_train_cli_resume(card, tf, d))
    torch.cuda.empty_cache()
    launched = {run: c for run, c in counts.items() if any(c.values())}
    log(f"train cli: phase 21 in {time.perf_counter() - t0:.1f} s; wall / "
        f"to step 0 s, median iteration / loader wait ms, peak GiB: "
        + "; ".join(f"{n} {v[0]:.2f} / {v[1]:.2f}, {v[2]:.1f} / "
                    f"{v[3]:.2f}, {v[4]:.2f}" for n, v in out.items())
        + f"; the loader alone {loader_ms:.1f} ms a batch; runs that "
        f"launched a kernel of the table: {launched} ({card})")
    if launched:
        raise AssertionError(f"train CLI launched kernels: {launched}")
    return counts


# ------------------------------------------------------------ phase 22
def distill_files(d, files):
    """Phase 22's inputs in directory d, beside phase 17's full-width G
    (unet 2 blocks) and iresnet100 `backbone.pth`: seeded full-size
    `RealESRGAN_x4plus.pth` (23 blocks) and `GFPGANv1.4.pth` (512), a
    GFPGAN at out_size 64 and a narrow G (width 1/16, 1 block) for the
    card-vs-CPU part, a full-width `D_*.pth` (n_layers 5 x 3 scales), a
    LIPSPADE `10_net_G.pth` (ngf 48); jpgs: 128 crops of 256 px and a
    mask png for each (paired by basename), 16 crops of 512 px, and 3
    images each of 32 and 64 px. Returns their paths."""
    import cv2
    import numpy as np

    cin = _test_inputs("torch_cli_inputs")
    tin = _test_inputs("torch_train_cli_inputs")
    t0 = time.perf_counter()
    rng = np.random.default_rng(22)
    f = {"G": files["G"], "arc": files["arc"], "dir": d,
         "rrdb": f"{d}/RealESRGAN_x4plus.pth",
         "gfpgan": f"{d}/GFPGANv1.4.pth", "gfpgan64": f"{d}/GFPGAN_64.pth",
         "narrow_G": f"{d}/G_unet_1blocks_w16.pth",
         "D": f"{d}/D_unet_2blocks.pth", "sr": f"{d}/10_net_G.pth",
         "faces": tin.write_faces(f"{d}/faces", rng, EXTRAS["images"], 256),
         "faces512": tin.write_faces(f"{d}/faces512", rng, 16, 512),
         "hq32": tin.write_faces(f"{d}/hq32", rng, 3, 32),
         "hq64": tin.write_faces(f"{d}/hq64", rng, 3, 64),
         "masks": f"{d}/masks"}
    Path(f["masks"]).mkdir()
    yy, xx = np.mgrid[:256, :256]
    for i in range(EXTRAS["images"]):
        soft = np.exp(-((yy - 128 - i % 7) ** 2 + (xx - 128) ** 2) / 4e3)
        cv2.imwrite(f"{f['masks']}/{i:05d}.png",
                    (soft * 255).astype(np.uint8))
    cin.save_pth(f["rrdb"], cin.rrdb_state_dict(rng), wrapper="params_ema")
    cin.save_pth(f["gfpgan"], cin.gfpgan_state_dict(rng),
                 wrapper="params_ema")
    cin.save_pth(f["gfpgan64"], cin.gfpgan_state_dict(rng, out_size=64),
                 wrapper="params_ema")
    cin.save_pth(f["narrow_G"], cin.aei_state_dict(rng, "unet", 1, 1 / 16))
    cin.save_pth(f["D"], tin.disc_state_dict(rng, num_D=3, n_layers=5,
                                             ndf=64))
    cin.save_pth(f["sr"], tin.spade_state_dict(rng, ngf=EXTRAS["sr_ngf"]))
    mib = sum(Path(f[k]).stat().st_size for k in (
        "rrdb", "gfpgan", "gfpgan64", "D", "sr")) / 2 ** 20
    log(f"distill: wrote the teachers, D and LIPSPADE ({mib:.0f} MiB) and "
        f"the images in {time.perf_counter() - t0:.1f} s")
    return f


@contextlib.contextmanager
def _distill_spy(rec, draws_on_cpu=False, swap=False):
    """Spy on the port's distillation while `main` runs: per step the
    metrics, the student step's and the teacher pass's synced ms, and the
    S2 launches of the step's forward and of its backward (dx) apart;
    the student module and its starting parameters. With
    `draws_on_cpu`, the degradation draws come from a CPU generator
    seeded as the CLI's and move to the batch's device (the card and the
    CPU see the same LQ); with `swap`, each batch's samples and their
    draws in the other order (the CPU's own spread)."""
    import torch

    from ghost_tpu_torch.cli import distill_enhancer as dcli
    from ghost_tpu_torch.ops.cuda import conv3x3 as s2
    from ghost_tpu_torch.train import distill_enhancer as tde

    real_make, real_teacher = tde.make_enhancer_distill_step, \
        tde.make_teacher_fn
    real_draws, real_back = tde.degrade_draws, s2._Conv3x3.backward
    real_batches = dcli._image_batches
    dx = [0]
    rec.update(metrics=[], step_ms=[], teacher_ms=[], fwd=[], dx=[],
               ends=[])

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def backward(ctx, dy):
        n = s2.conv3x3.launches
        out = real_back(ctx, dy)
        dx[0] += s2.conv3x3.launches - n
        return out

    def make(student, *a, **kw):
        step, opt = real_make(student, *a, **kw)
        rec["student"] = student
        rec["start"] = [p.detach().clone() for p in student.parameters()]

        def spy(lq, target):
            sync()
            n, dx[0] = s2.conv3x3.launches, 0
            t = time.perf_counter()
            m = step(lq, target)
            sync()
            rec["ends"].append(time.perf_counter())
            rec["step_ms"].append((rec["ends"][-1] - t) * 1e3)
            rec["dx"].append(dx[0])
            rec["fwd"].append(s2.conv3x3.launches - n - dx[0])
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            return m

        return spy, opt

    def teacher_fn(mod, *a, **kw):
        fn = real_teacher(mod, *a, **kw)

        def timed(lq):
            sync()
            t = time.perf_counter()
            out = fn(lq)
            sync()
            rec["teacher_ms"].append((time.perf_counter() - t) * 1e3)
            return out

        return timed

    cpu_gen = {}

    def draws(generator, shape, *a, **kw):
        if draws_on_cpu:
            g = cpu_gen.setdefault("g", torch.Generator().manual_seed(0))
            d = real_draws(g, shape, *a, **kw)
            dev = generator.device
            d = tde.DegradeDraws(d.sigma.to(dev), d.wobble, d.std.to(dev),
                                 d.noise.to(dev), d.area)
        else:
            d = real_draws(generator, shape, *a, **kw)
        if swap:
            d = tde.DegradeDraws(d.sigma.flip(0), d.wobble, d.std.flip(0),
                                 d.noise.flip(0), d.area)
        return d

    def batches(*a):
        for b in real_batches(*a):
            yield b[::-1].copy() if swap else b

    patches = ((tde, "make_enhancer_distill_step", make),
               (tde, "make_teacher_fn", teacher_fn),
               (tde, "degrade_draws", draws),
               (dcli, "_image_batches", batches))
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        s2._Conv3x3.backward = staticmethod(backward)
        yield rec
    finally:
        for (mod, name, _), real in zip(patches, (
                real_make, real_teacher, real_draws, real_batches)):
            setattr(mod, name, real)
        s2._Conv3x3.backward = staticmethod(real_back)


def _distill_narrow_argv(df, task, out):
    hq = 32 if task == "background" else 64
    return ["--task", task, "--dataset_path", df[f"hq{hq}"],
            "--teacher_path", df["rrdb" if task == "background"
                                 else "gfpgan64"],
            "--out", out, "--steps", "2", "--hq_size", str(hq),
            "--batch_size", "2", "--student_feats", "4", "--student_convs",
            "1", "--save_every", "0", "--log_every", "1", "--bf16", "false"]


def _tree_rel_l2(a, b, c):
    """Relative L2 of flax trees a and b against c (numpy leaves)."""
    import numpy as np

    def leaves(t):
        return [np.asarray(v, np.float64) for v in _flat(t).values()]

    num = sum(float(((x - y) ** 2).sum())
              for x, y in zip(leaves(a), leaves(b)))
    den = sum(float((y ** 2).sum()) for y in leaves(c))
    return (num / den) ** 0.5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _distill_parity(card, df):
    """(a1) `distill_enhancer.main(argv)` at the tier-1 tests' narrow
    config (hq 32 background with the full-size RRDB teacher, hq 64 face
    with GFPGAN at out_size 64; batch 2, student 4 x 1, 2 steps, f32),
    on the card against `main(argv, device="cpu")`, the same draws on
    both (made on the CPU), beside the CPU's own spread (its run with
    each batch's samples and draws in the other order), with phase 21's
    bounds: step 0's loss terms 1e-4 relative, step 1's within 5x the
    spread + 1e-2, the end student (relative L2) within 5x the spread +
    1e-3. Returns the card runs' launch counts."""
    from ghost_tpu_torch.cli import distill_enhancer as dcli
    from ghost_tpu_torch.core.checkpoint import load_msgpack

    d = df["dir"]
    counts, ok, lines = {}, True, []
    for task in ("background", "face"):
        runs = {}
        for name, dev, swap in (("card", "cuda", False), ("cpu", "cpu", False),
                                ("spread", "cpu", True)):
            out = f"{d}/a_{task}_{name}.msgpack"
            rec = {}
            zero_counts()
            with _distill_spy(rec, draws_on_cpu=True, swap=swap):
                _cli_call(lambda: dcli.main(_distill_narrow_argv(
                    df, task, out), device=dev))
            if name == "card":
                counts[f"parity_{task}"] = read_counts()
            runs[name] = (rec["metrics"], load_msgpack(out))
        (cm, ct), (sm, st), (km, kt) = (runs[n] for n in
                                        ("cpu", "spread", "card"))
        steps = []
        for i, (a, s, k) in enumerate(zip(cm, sm, km)):
            e_card = max(abs(k[x] / v - 1) for x, v in a.items())
            e_cpu = max(abs(s[x] / v - 1) for x, v in a.items())
            steps.append(f"{e_card:.2e} ({e_cpu:.2e})")
            ok &= a.keys() == k.keys() and e_card <= (
                1e-4 if i == 0 else 5 * e_cpu + 1e-2)
        end = (_tree_rel_l2(kt, ct, ct), _tree_rel_l2(st, ct, ct))
        ok &= len(km) == len(cm) == 2 and end[0] <= 5 * end[1] + 1e-3
        lines.append(f"{task}: l1 by step {', '.join(steps)}; end student "
                     f"{end[0]:.2e} ({end[1]:.2e})")
    log(f"distill (a1) narrow main(argv), card vs CPU, f32 (the CPU's "
        f"spread in brackets): {'; '.join(lines)}: {ok} ({card})")
    if not ok:
        raise AssertionError("distill_enhancer: card against CPU")
    return counts


def _distill_full(card, df):
    """(b) `distill_enhancer.main(argv)` at full width in bf16, as a user
    runs it: background at the CLI's defaults (hq 256, batch 8, student
    64 x 32, x4) on the full-size RealESRGAN_x4plus teacher, face at
    --hq_size 512 (student x2 reading 256) on GFPGANv1.4; 20 steps each,
    --save_every 10. Each: every l1 finite, every student tensor moved,
    S2 launched exactly DISTILL_S2 times a step (forward and dx apart),
    the msgpack written, equal to the trained student, and served by
    `srvgg_from_variables` + `SRVGGStudentSeat` on a bf16 batch; the
    median student step and teacher pass (synced), the median iteration
    (host clock between step ends: batch decode, degrade and teacher
    included), peak memory. Returns each run's launch counts and
    timings."""
    import numpy as np
    import torch

    from ghost_tpu_torch.cli import distill_enhancer as dcli
    from ghost_tpu_torch.convert.from_jax import (flax_variables,
                                                  load_flax_variables)
    from ghost_tpu_torch.core.checkpoint import load_msgpack
    from ghost_tpu_torch.core.precision import DEFAULT_POLICY
    from ghost_tpu_torch.models.sr.srvgg import (SRVGGStudentSeat,
                                                 srvgg_from_variables)

    d, c = df["dir"], DISTILL
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    counts, out = {}, {}
    for task, data, teacher in (("background", df["faces"], df["rrdb"]),
                                ("face", df["faces512"], df["gfpgan"])):
        hq = c["hq"][task]
        path = f"{d}/student_{task}.msgpack"
        argv = ["--task", task, "--dataset_path", data, "--teacher_path",
                teacher, "--out", path, "--hq_size", str(hq), "--steps",
                str(c["steps"]), "--save_every", "10", "--log_every", "5"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = {}
        zero_counts()
        with _distill_spy(rec):
            wall, lines, _ = _cli_call(lambda: dcli.main(argv))
        counts[task] = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        student = rec["student"]
        student = getattr(student, "student_mod", student)
        moved = sum(not torch.equal(a, b) for a, b in zip(
            rec["start"], rec["student"].parameters()))
        n_params = len(rec["start"])
        saved = load_msgpack(path)
        written = _flat(flax_variables(student))
        same = _flat(saved).keys() == written.keys() and all(
            np.array_equal(v, written[k]) for k, v in _flat(saved).items())
        dev = next(student.parameters()).device
        seat = SRVGGStudentSeat(load_flax_variables(srvgg_from_variables(
            saved, policy=DEFAULT_POLICY), saved)).to(dev).eval()
        g = torch.Generator(device=dev).manual_seed(22)
        y = torch.rand(8, 256, 256, 3, generator=g, device=dev) * 2 - 1
        with torch.no_grad():
            served = seat(y)
        # iterations 2.. (the first two carry the teacher's and the
        # student's first calls)
        iters = [(b - a) * 1e3 for a, b in zip(rec["ends"][1:],
                                               rec["ends"][2:])] or [0.0]
        l1 = [m["l1"] for m in rec["metrics"]]
        s2_ok = (rec["fwd"] == [DISTILL_S2["forward"]] * c["steps"]
                 and rec["dx"] == [DISTILL_S2["dx"]] * c["steps"])
        out[task] = (med(rec["step_ms"]), med(rec["teacher_ms"][2:]
                                              or rec["teacher_ms"]),
                     med(iters), peak, wall)
        log(f"distill (b) {task} at full width, bf16, {c['steps']} steps: "
            f"wall {wall:.2f} s; student step "
            f"{', '.join(f'{t:.1f}' for t in rec['step_ms'])} ms (median "
            f"{out[task][0]:.2f}), teacher pass median {out[task][1]:.2f} "
            f"ms, iteration median {out[task][2]:.2f} ms; peak memory "
            f"{peak:.2f} GiB; l1 {l1[0]:.5f} -> {l1[-1]:.5f}; student "
            f"tensors moved {moved} of {n_params}; S2 per step forward "
            f"{sorted(set(rec['fwd']))}, dx {sorted(set(rec['dx']))} "
            f"(pinned {DISTILL_S2['forward']} + {DISTILL_S2['dx']}); saved "
            f"== trained {same}; served by the seat "
            f"{tuple(served.shape)} {served.dtype}; launches "
            f"{counts[task]} ({card})")
        if not (all(math.isfinite(v) for v in l1) and len(l1) == c["steps"]
                and moved == n_params and s2_ok and same
                and bool(torch.isfinite(served).all())
                and tuple(served.shape) == (8, 256, 256, 3)
                and any(ln.startswith("saved student") for ln in lines)):
            raise AssertionError(f"distill_enhancer {task} at full width")
        del rec, seat, student
    return counts, out


@contextlib.contextmanager
def _extras_spy(rec, swap=False):
    """Spy on the port's auxiliary trainers while `main` runs: the
    trained module and its starting parameters and buffers, per step the
    loss terms and the synced step ms; with `swap`, each batch's samples
    in the other order (the CPU's own spread)."""
    import torch

    from ghost_tpu_torch.cli import train_extras as xcli
    from ghost_tpu_torch.train import extra_trainers as xt

    names = ("make_discriminator_pretrain_step",
             "make_upsampler_finetune_step", "make_mask_train_step")
    reals = {n: getattr(xt, n) for n in names}
    real_batches = xcli._epoch_batches
    rec.update(metrics=[], step_ms=[])

    def wrap(make):
        def wrapped(mod, *a, **kw):
            step, opt = make(mod, *a, **kw)
            rec["module"] = mod
            rec["start"] = {k: v.detach().clone()
                            for k, v in mod.state_dict().items()}

            def spy(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                m = step(*args)
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - t) * 1e3)
                m = m if isinstance(m, dict) else {"loss": m}
                rec["metrics"].append({k: float(v) for k, v in m.items()})
                return m if len(m) > 1 else m["loss"]

            return spy, opt

        return wrapped

    def batches(*a):
        for b in real_batches(*a):
            yield {k: v.flip(0) for k, v in b.items()} if swap else b

    try:
        for n in names:
            setattr(xt, n, wrap(reals[n]))
        xcli._epoch_batches = batches
        yield rec
    finally:
        for n in names:
            setattr(xt, n, reals[n])
        xcli._epoch_batches = real_batches


def _extras_argv(df, mode, run, narrow):
    argv = ["--mode", mode, "--dataset_path", df["faces"], "--run_name", run,
            "--allow_random_weights", "1", "--show_step", "1"]
    if narrow:
        # tests/test_train_extras_cli.py's flags; ArcFace tiny and random
        # (the default path is absent in the run's directory)
        argv += ["--G_path", df["narrow_G"], "--batch_size", "2",
                 "--max_steps", "2", "--width", "0.0625", "--arcface_depth",
                 "tiny", "--bf16", "", "--num_blocks", "1", "--num_workers",
                 "1"]
    else:
        argv += ["--arcface_path", df["arc"], "--max_steps",
                 str(EXTRAS["steps"])]
    return argv + {"discriminator": ["--D_path", df["D"]],
                   "upsampler": ["--sr_path", df["sr"], "--sr_ngf",
                                 str(EXTRAS["sr_ngf"])],
                   "mask": ["--mask_source", df["masks"]]}[mode]


def _extras_parity(card, df):
    """(a2) `train_extras.main(argv)` in each mode at
    tests/test_train_extras_cli.py's narrow flags (G width 1/16 from
    `.pth`, tiny ArcFace, batch 2, f32, 2 steps; the CLI's full-width D
    from `.pth`, LIPSPADE ngf 48) on the card against `main(argv,
    device="cpu")`, beside the CPU's own spread (each batch's samples in
    the other order), with phase 21's bounds: step 0's loss terms 1e-4
    relative, step 1's within 5x the spread + 1e-2, the written msgpack
    (relative L2) within 5x the spread + 1e-3. Returns the card runs'
    launch counts."""
    from ghost_tpu_torch.cli import train_extras as xcli
    from ghost_tpu_torch.core.checkpoint import load_msgpack

    d = df["dir"]
    counts, ok, lines = {}, True, []
    for mode in ("discriminator", "upsampler", "mask"):
        runs = {}
        for name, dev, swap in (("card", "cuda", False), ("cpu", "cpu", False),
                                ("spread", "cpu", True)):
            run = f"a_{name}"
            rec = {}
            zero_counts()
            with _extras_spy(rec, swap), contextlib.chdir(d):
                _cli_call(lambda: xcli.main(_extras_argv(df, mode, run, True),
                                            device=dev))
            if name == "card":
                counts[f"parity_{mode}"] = read_counts()
            runs[name] = (rec["metrics"],
                          load_msgpack(f"{d}/{run}_{mode}.msgpack"))
        (cm, ct), (sm, st), (km, kt) = (runs[n] for n in
                                        ("cpu", "spread", "card"))
        steps = []
        for i, (a, s, k) in enumerate(zip(cm, sm, km)):
            e_card = max(abs(k[x] / v - 1) for x, v in a.items())
            e_cpu = max(abs(s[x] / v - 1) for x, v in a.items())
            steps.append(f"{e_card:.2e} ({e_cpu:.2e})")
            ok &= a.keys() == k.keys() and e_card <= (
                1e-4 if i == 0 else 5 * e_cpu + 1e-2)
        end = (_tree_rel_l2(kt, ct, ct), _tree_rel_l2(st, ct, ct))
        ok &= len(km) == len(cm) == 2 and end[0] <= 5 * end[1] + 1e-3
        lines.append(f"{mode}: losses by step {', '.join(steps)}; written "
                     f"tree {end[0]:.2e} ({end[1]:.2e})")
    log(f"extras (a2) narrow main(argv), card vs CPU, f32 (the CPU's "
        f"spread in brackets): {'; '.join(lines)}: {ok} ({card})")
    if not ok:
        raise AssertionError("train_extras: card against CPU")
    return counts


def _extras_full(card, df):
    """(c) `train_extras.main(argv)` at full width as a user runs it (the
    CLI's defaults: bf16, batch 16, AEI-Net unet 2 blocks, iresnet100
    from `backbone.pth`, D n_layers 5 x 3 scales, LIPSPADE ngf 48),
    EXTRAS["steps"] steps a mode, chained: upsampler from phase 17's G
    `.pth`, mask from the upsampler's msgpack, discriminator from the
    mask's msgpack through --G_path (and D from `.pth`). Each: every loss
    finite, every tensor the mode trains moved (and G's BN statistics in
    the G modes), the G a run read through --G_path equal to the msgpack
    before it bit for bit, the written msgpack equal to the trained
    module; the median synced step, peak memory. Returns each run's
    launch counts and timings."""
    import numpy as np
    import torch

    from ghost_tpu_torch.cli import train_extras as xcli
    from ghost_tpu_torch.convert.from_jax import flax_variables
    from ghost_tpu_torch.core.checkpoint import load_msgpack

    d = df["dir"]
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    counts, out, g_path = {}, {}, df["G"]
    for mode in ("upsampler", "mask", "discriminator"):
        argv = _extras_argv(df, mode, "full", False) + ["--G_path", g_path]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec, loaded = {}, {}
        real_load = xcli._load_gen

        def load_gen(*a, **kw):
            gen = real_load(*a, **kw)
            loaded["g"] = flax_variables(gen)
            return gen

        zero_counts()
        xcli._load_gen = load_gen
        try:
            with _extras_spy(rec), contextlib.chdir(d):
                wall, lines, _ = _cli_call(lambda: xcli.main(argv))
        finally:
            xcli._load_gen = real_load
        counts[mode] = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mod = rec["module"]
        end = mod.state_dict()
        same = [torch.equal(v, end[k]) for k, v in rec["start"].items()]
        path = f"{d}/full_{mode}.msgpack"
        saved = _flat(load_msgpack(path))
        written = _flat(flax_variables(mod))
        if mode == "discriminator":
            written = _flat({"params": flax_variables(mod)["params"]})
        equal = saved.keys() == written.keys() and all(
            np.array_equal(saved[k], written[k]) for k in saved)
        reread = True
        if g_path.endswith(".msgpack"):
            before = _flat(load_msgpack(g_path))
            got = _flat(loaded["g"])
            reread = before.keys() == got.keys() and all(
                np.array_equal(before[k], got[k]) for k in before)

        bad = [m for m in rec["metrics"] for v in m.values()
               if not math.isfinite(v)]
        out[mode] = (med(rec["step_ms"]), peak, wall)
        log(f"extras (c) {mode} at full width, bf16, batch 16: wall "
            f"{wall:.2f} s; step {', '.join(f'{t:.1f}' for t in rec['step_ms'])} "
            f"ms (median {out[mode][0]:.1f}); peak memory {peak:.2f} GiB; "
            f"losses {[round(m['loss'], 4) for m in rec['metrics']]}; "
            f"tensors unchanged {sum(same)} of {len(same)}; --G_path "
            f"{Path(g_path).name} read bit for bit {reread}; written == "
            f"trained {equal}; launches {counts[mode]} ({card})")
        if bad or any(same) or not (equal and reread) \
                or len(rec["metrics"]) != EXTRAS["steps"] \
                or not any(ln.startswith("saved ") for ln in lines):
            raise AssertionError(f"train_extras {mode} at full width")
        if mode != "discriminator":
            g_path = path
        del rec, mod
    return counts, out


def phase_distill(card, files):
    """Phase 22: the enhancer-distillation CLI (`python -m
    ghost_tpu_torch.cli.distill_enhancer`) and the auxiliary-trainer CLI
    (`python -m ghost_tpu_torch.cli.train_extras`) through `main(argv)`:
    (a) card against CPU at the narrow configs, (b) distillation at full
    width with S2 counted a step, (c) the three trainer modes at full
    width. The trainers run none of the table's kernels
    (`fused_aad=False`, cuDNN convs): their counts must read 0. Returns
    the distillation runs' counts and the trainers' counts."""
    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        df = distill_files(d, files)
        distill = _distill_parity(card, df)
        full, d_out = _distill_full(card, df)
        distill.update(full)
        extras = _extras_parity(card, df)
        full, x_out = _extras_full(card, df)
        extras.update(full)
        if "kept" in files:  # phase 24 converts D and the LIPSPADE G
            for key in ("D", "sr"):
                shutil.move(df[key], files["kept"])
    torch.cuda.empty_cache()
    launched = {run: c for run, c in extras.items() if any(c.values())}
    wrong = {run: {k: v for k, v in c.items() if v and k != "conv3x3"}
             for run, c in distill.items()}
    wrong = {run: c for run, c in wrong.items() if c}
    log(f"distill: phase 22 in {time.perf_counter() - t0:.1f} s; distill "
        f"student step / teacher pass / iteration ms, peak GiB: "
        + "; ".join(f"{n} {v[0]:.2f} / {v[1]:.2f} / {v[2]:.2f}, {v[3]:.2f}"
                    for n, v in d_out.items())
        + "; trainer step ms, peak GiB: "
        + "; ".join(f"{n} {v[0]:.1f}, {v[1]:.2f}" for n, v in x_out.items())
        + f"; trainer runs that launched a kernel of the table: {launched}; "
        f"distill runs that launched another kernel than S2: {wrong} "
        f"({card})")
    if launched or wrong:
        raise AssertionError(f"phase 22 launched kernels: {launched} {wrong}")
    return distill, extras


# ---------------------------------------------------------------------------
# Phase 23: the SR-training library and the mask-target and preprocessing
# CLIs
# ---------------------------------------------------------------------------


def _sr_vgg(device, policy, seed=0):
    """`vgg_apply` over a seeded full-width VGG19 (frozen): [-1, 1] NHWC
    -> the 5 relu slices, as the reference's VGGLoss reads them."""
    import torch

    from ghost_tpu_torch.models.sr.vgg import (VGG19Features,
                                               imagenet_normalize_pm1)
    from ghost_tpu_torch.nn.layers import init_weights

    vgg = init_weights(VGG19Features(policy=policy),
                       torch.Generator().manual_seed(seed))
    vgg = vgg.to(device).eval().requires_grad_(False)
    return lambda x: vgg(imagenet_normalize_pm1(x))


def _sr_batches(device, n, batch, hw, seed):
    """n seeded (degraded, real) pairs of (batch, hw, hw, 3) in [-1, 1]:
    real smooth images, degraded = real downscaled 4x and back plus
    noise."""
    import torch

    from ghost_tpu_torch.nn.layers import resize

    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        low = torch.rand(batch, hw // 16, hw // 16, 3, generator=g) * 2 - 1
        real = resize(low, (hw, hw), method="bilinear")
        deg = resize(resize(real, (hw // 4, hw // 4), method="area"),
                     (hw, hw), method="bilinear")
        deg = deg + 0.05 * torch.randn(deg.shape, generator=g)
        out.append((deg.clamp(-1, 1).to(device), real.to(device)))
    return out


def _sr_steps(model, state, batches):
    """One G step then one D step per batch; per step (g ms, d ms,
    metrics with the D loss as floats), synced."""
    import torch

    g_step, d_step = model.make_steps()
    rows = []
    for deg, real in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met, gen = g_step(state, deg, real)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, ld = d_step(state, deg, gen, real)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                     {**{k: float(v) for k, v in met.items()},
                      "D": float(ld)}))
    return state, rows


def _sr_full(card, device, policy_name):
    """(a) Pix2PixSR(SRConfig()) with train=True, VGG19 on: 1 warm and
    SR23["steps"] timed G + D steps at 256 px, batch 4: finite losses,
    every G and D tensor moved, G's running statistics and spectral
    pairs moved; step ms, peak memory."""
    import torch

    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.models.sr import pix2pix

    policy = {"bf16": DEFAULT_POLICY, "f32": FULL_PRECISION}[policy_name]
    c = SR23
    torch.cuda.empty_cache()
    model = pix2pix.Pix2PixSR(pix2pix.SRConfig(ngf=c["ngf"], ndf=c["ndf"]),
                              policy=policy,
                              vgg_apply=_sr_vgg(device, policy), train=True)
    state = model.init(torch.Generator().manual_seed(23), device)
    batches = _sr_batches(device, 1 + c["steps"], c["batch"], c["hw"], 23)
    state, _ = _sr_steps(model, state, batches[:1])
    before = {k: v.detach().clone() for k, v in
              list(state.gen.state_dict().items())
              + [("D." + k, v) for k, v in state.disc.state_dict().items()]}
    torch.cuda.reset_peak_memory_stats()
    state, rows = _sr_steps(model, state, batches[1:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = dict(state.gen.state_dict())
    after.update({"D." + k: v for k, v in state.disc.state_dict().items()})
    still = [k for k, v in before.items() if torch.equal(v, after[k])]
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    g_ms, d_ms = med([r[0] for r in rows]), med([r[1] for r in rows])
    finite = all(math.isfinite(v) for r in rows for v in r[2].values())
    log(f"sr (a) Pix2PixSR {policy_name} at {c['hw']} px, batch "
        f"{c['batch']}, VGG19 on: G step {', '.join(f'{r[0]:.1f}' for r in rows)}"
        f" ms (median {g_ms:.1f}), D step "
        f"{', '.join(f'{r[1]:.1f}' for r in rows)} ms (median {d_ms:.1f}); "
        f"peak memory {peak:.2f} GiB; losses {rows[-1][2]}; tensors "
        f"unchanged {len(still)} of {len(before)} ({card})")
    if not finite or still or len(rows) != c["steps"]:
        raise AssertionError(f"Pix2PixSR {policy_name}: finite {finite}, "
                             f"unchanged {still[:8]}")
    g_step = model.make_steps()[0]
    probe = lambda: g_step(state, *batches[1])  # noqa: E731
    return {"g_ms": g_ms, "d_ms": d_ms, "peak_gib": peak}, probe


def _grad_rel(opt_a, mod_a, opt_b, mod_b):
    """Relative L2 of module a's Adam first moments against module b's
    (b1 = 0: the gradients)."""
    def moments(opt, mod):
        names = {id(p): n for n, p in mod.named_parameters()}
        return {names[id(p)]: s["exp_avg"].double().cpu()
                for p, s in opt.state.items()}

    a, b = moments(opt_a, mod_a), moments(opt_b, mod_b)
    num = sum(float((a[k] - v).square().sum()) for k, v in b.items())
    return (num / sum(float(v.square().sum()) for v in b.values())) ** 0.5


def _sr_parity(card, device):
    """(a0) card against CPU in f32 at tests/test_torch_sr_train.py's
    narrow configs, from one seeded state: a Pix2PixSR(ngf 4, ndf 4) G +
    D step at 64 px, batch 2, VGG19 on (losses 1e-4 relative, G's and
    D's whole gradients 5e-3 relative L2, the spectral pairs 1e-5, the
    running statistics 1e-5 of their largest + 1e-6), and SubAdd's and
    Contrasive's steps on LIPEncoder(4, 3) at 32 px (losses 1e-4
    relative + SubAdd's feature-ratio term, the encoder's and the
    adversary's gradients 5e-3). Returns the card's launch counts."""
    import copy

    import torch

    from ghost_tpu_torch.core.precision import FULL_PRECISION as F32
    from ghost_tpu_torch.models.sr import pix2pix, pretrain
    from ghost_tpu_torch.models.sr.generator import LIPEncoder
    from ghost_tpu_torch.nn.layers import init_weights

    cpu = torch.device("cpu")
    counts, lines, ok = {}, [], True
    model = {dev: pix2pix.Pix2PixSR(pix2pix.SRConfig(ngf=4, ndf=4),
                                    policy=F32, vgg_apply=_sr_vgg(dev, F32),
                                    train=True) for dev in (cpu, device)}
    base = model[cpu].init(torch.Generator().manual_seed(5), cpu)
    batch = _sr_batches(cpu, 1, 2, 64, 5)
    runs = {}
    for name, dev in (("cpu", cpu), ("card", device)):
        st = model[dev].init(None, dev, modules=tuple(
            copy.deepcopy(m).to(dev) for m in (base.gen, base.disc)))
        zero_counts()
        st, rows = _sr_steps(model[dev], st, [tuple(t.to(dev)
                                                    for t in batch[0])])
        if name == "card":
            counts["sr_parity"] = read_counts()
        runs[name] = (st, rows[0][2])
    (sc, mc), (sk, mk) = runs["cpu"], runs["card"]
    e_loss = max(abs(mk[k] / v - 1) for k, v in mc.items())
    e_g = _grad_rel(sk.g_opt, sk.gen, sc.g_opt, sc.gen)
    e_d = _grad_rel(sk.d_opt, sk.disc, sc.d_opt, sc.disc)
    bufs = dict(sc.gen.named_buffers())
    # each buffer's error over its bound: 1e-5 for a (u, v) unit vector,
    # 1e-5 of the largest value + 1e-6 for a running statistic
    e_buf = max(float((b.cpu() - bufs[k]).abs().max())
                / (1e-5 if k.endswith((".u", ".v"))
                   else 1e-5 * float(bufs[k].abs().max()) + 1e-6)
                for k, b in sk.gen.named_buffers())
    ok &= e_loss <= 1e-4 and e_g <= 5e-3 and e_d <= 5e-3 and e_buf <= 1
    lines.append(f"Pix2PixSR losses {e_loss:.2e}, G gradient {e_g:.2e}, D "
                 f"gradient {e_d:.2e}, G's (u, v) and statistics at "
                 f"{e_buf:.2f} of their bounds")

    enc0 = init_weights(LIPEncoder(4, 3, F32),
                        torch.Generator().manual_seed(6))
    disc0 = init_weights(pretrain.NoiseIntensityPredictor(
        sw=4, policy=F32, in_ch=32), torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    clean = torch.rand(2, 32, 32, 3, generator=g) * 2 - 1
    noisy = clean + 0.3 * torch.randn(clean.shape, generator=g)
    label = torch.tensor([0.5, 0.25])
    with torch.no_grad():
        feats = enc0(torch.cat([clean, noisy]))
    cond = float(feats.abs().max() / feats[:2].abs().min())
    pre = {}
    for name, dev in (("cpu", cpu), ("card", device)):
        x = [t.to(dev) for t in (clean, noisy, label)]
        # each step from the shared starting modules
        mods = {k: tuple(copy.deepcopy(m).to(dev) for m in (enc0, disc0))
                for k in ("e", "d")}
        e_step, _, e_opt, _ = pretrain.make_subadd_pretrain_steps(*mods["e"])
        _, d_step, _, d_opt = pretrain.make_subadd_pretrain_steps(*mods["d"])
        cenc = copy.deepcopy(enc0).to(dev)
        c_step, c_opt = pretrain.make_contrasive_pretrain_step(cenc)
        zero_counts()
        met = {**e_step(x[0], x[1]), **d_step(*x),
               "contrasive": c_step(x[0], x[1])}
        if name == "card":
            counts["pretrain_parity"] = read_counts()
        pre[name] = ({k: float(v) for k, v in met.items()},
                     [(e_opt, mods["e"][0]), (d_opt, mods["d"][1]),
                      (c_opt, cenc)])
    (mc, oc), (mk, ocard) = pre["cpu"], pre["card"]
    e_loss = max(abs(mk[k] / v - 1) for k, v in mc.items())
    e_grads = [_grad_rel(*a, *b) for a, b in zip(ocard, oc)]
    ok &= e_loss <= 1e-4 + 1e-6 * cond and max(e_grads) <= 5e-3
    lines.append(f"pretraining losses {e_loss:.2e} (feature ratio "
                 f"{cond:.1f}), encoder / adversary / contrasive encoder "
                 f"gradients {', '.join(f'{e:.2e}' for e in e_grads)}")
    log(f"sr (a0) narrow configs, card vs CPU, f32: {'; '.join(lines)}: "
        f"{ok} ({card})")
    if not ok:
        raise AssertionError("the SR-training library: card against CPU")
    return counts


def _hifacegan(card, device):
    """(a) HiFaceGANGenerator(ngf=48) at 256 px, batch 4, bf16, train
    mode (batch statistics: seeded running statistics would let the
    activations grow without bound), its state kept: warm ms, peak
    memory."""
    import torch

    from ghost_tpu_torch.models.sr.generator import HiFaceGANGenerator
    from ghost_tpu_torch.nn.layers import frozen_batch_stats, init_weights

    torch.cuda.empty_cache()
    gen = init_weights(HiFaceGANGenerator(ngf=SR23["ngf"], train=True),
                       torch.Generator().manual_seed(9)).to(device)
    x = _sr_batches(device, 1, SR23["batch"], SR23["hw"], 9)[0][0]
    with torch.no_grad(), frozen_batch_stats(gen):
        gen(x)
        torch.cuda.reset_peak_memory_stats()
        ms = _time_one(lambda: gen(x), 5, device)
        y = gen(x)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ok = bool(torch.isfinite(y).all()) and tuple(y.shape) == tuple(x.shape)
    log(f"sr (a) HiFaceGANGenerator(ngf={SR23['ngf']}) bf16 forward, batch "
        f"{SR23['batch']} at {SR23['hw']} px: {ms:.2f} ms, peak "
        f"{peak:.2f} GiB, output {tuple(y.shape)} finite {ok} ({card})")
    if not ok:
        raise AssertionError("HiFaceGAN forward")
    return {"ms": ms, "peak_gib": peak}


def _pretrain_full(card, device):
    """(a) SubAdd (encoder, then adversary) and Contrasive steps on
    LIPEncoder(ngf=48, n_2xdown=5) in bf16 at 256 px, batch 8 (the
    encoder's 8x8 map of 768 channels; the adversary a
    NoiseIntensityPredictor on it): 1 warm and SR23["steps"] timed steps
    each, finite losses, the trained tensors moved; median ms, peak."""
    import torch

    from ghost_tpu_torch.models.sr import pretrain
    from ghost_tpu_torch.models.sr.generator import LIPEncoder
    from ghost_tpu_torch.nn.layers import init_weights

    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(10)
    ngf, hw = SR23["ngf"], SR23["hw"]
    enc = init_weights(LIPEncoder(ngf, 5), gen).to(device)
    disc = init_weights(pretrain.NoiseIntensityPredictor(
        sw=hw // 32, in_ch=16 * ngf), gen).to(device)
    cenc = init_weights(LIPEncoder(ngf, 5), gen).to(device)
    e_step, d_step, _, _ = pretrain.make_subadd_pretrain_steps(enc, disc)
    c_step, _ = pretrain.make_contrasive_pretrain_step(cenc)
    b = SR23["pre_batch"]
    g = torch.Generator().manual_seed(11)
    data = []
    for _ in range(1 + SR23["steps"]):
        clean = torch.rand(b, hw, hw, 3, generator=g) * 2 - 1
        noisy = clean + 0.2 * torch.randn(clean.shape, generator=g)
        data.append([t.to(device) for t in (clean, noisy,
                                            torch.rand(b, generator=g))])
    out, ok = {}, True
    torch.cuda.reset_peak_memory_stats()
    for name, mods, fn in (("subadd_e", (enc,), lambda x: e_step(x[0], x[1])),
                           ("subadd_d", (disc,), lambda x: d_step(*x)),
                           ("contrasive", (cenc,),
                            lambda x: c_step(x[0], x[1]))):
        fn(data[0])
        start = [p.detach().clone() for m in mods for p in m.parameters()]
        ms, losses = [], []
        for x in data[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = fn(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses += [float(v) for v in (m.values() if isinstance(m, dict)
                                          else [m])]
        moved = all(not torch.equal(a, p) for a, p in zip(
            start, [p for m in mods for p in m.parameters()]))
        ok &= moved and all(math.isfinite(v) for v in losses)
        out[name] = sorted(ms)[len(ms) // 2]
        log(f"sr (a) pretraining {name} step, LIPEncoder({ngf}, 5) bf16, batch "
            f"{b} at {hw} px: {', '.join(f'{t:.1f}' for t in ms)} ms "
            f"(median {out[name]:.1f}); every tensor moved {moved}; losses "
            f"finite {all(math.isfinite(v) for v in losses)} ({card})")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if not ok:
        raise AssertionError("the encoder pretraining steps")
    return out


def prep_files(d):
    """Phase 23's inputs in directory d: 64 seeded 256-px crops (and 8 of
    them for the card-vs-CPU runs), a templated Landmark106 msgpack, a
    seeded full-size SAM `.pth` (the preset's upstream names; vit_h: ~641
    M values), a templated full-width SCRFD msgpack, and seeded 1080p
    jpgs, flat and in identity folders. Returns their paths."""
    import cv2
    import numpy as np

    cin = _test_inputs("torch_cli_inputs")
    tin = _test_inputs("torch_train_cli_inputs")
    pin = _test_inputs("torch_prep_inputs")
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    f = {"dir": d, "crops": tin.write_faces(f"{d}/crops", rng,
                                            MASKS["crops"], 256),
         "crops8": tin.write_faces(f"{d}/crops8", rng, 8, 256),
         "lmk": pin.templated_landmark_msgpack(f"{d}/lmk.msgpack"),
         "det": pin.templated_detector_msgpack(f"{d}/det.msgpack"),
         "sam": f"{d}/sam_{MASKS['preset']}.pth"}
    sd = pin.sam_preset_state_dict(rng, MASKS["preset"])
    values = sum(v.size for v in sd.values())
    cin.save_pth(f["sam"], sd)
    del sd
    t1 = time.perf_counter()
    h, w = PREP["hw"]
    yy, xx = np.mgrid[:h, :w]

    def image(i):
        base = np.stack([(xx + 37 * i) % 256, (yy + 11 * i) % 256,
                         (xx + yy + 5 * i) % 256], -1)
        return np.clip(base + rng.integers(-20, 21, base.shape), 0,
                       255).astype(np.uint8)

    f["flat"], f["tree"] = f"{d}/raw", f"{d}/vgg"
    Path(f["flat"]).mkdir()
    for i in range(PREP["flat"]):
        cv2.imwrite(f"{f['flat']}/img{i}.jpg", image(i))
    for k in range(PREP["dirs"]):
        Path(f"{f['tree']}/id{k}").mkdir(parents=True)
        for i in range(PREP["per_dir"]):
            cv2.imwrite(f"{f['tree']}/id{k}/{i}.jpg", image(10 * k + i))
    log(f"masks: wrote the {MASKS['preset']} .pth ({values / 1e6:.1f} M "
        f"values, {Path(f['sam']).stat().st_size / 2 ** 30:.2f} GiB) in "
        f"{t1 - t0:.1f} s with the crops and msgpacks, the 1080p jpgs in "
        f"{time.perf_counter() - t1:.1f} s")
    return f


def _pngs(d):
    return sorted(p.name for p in Path(d).iterdir())


def _read_image(path):
    import cv2

    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


def _dirs_close(got, want, grey=3, share=ROUTE_EDGE_SHARE):
    """Every image of directory tree `want` in `got`, within `grey` levels
    on all but `share` of its values; (files, worst share)."""
    import numpy as np

    names = sorted(str(p.relative_to(want)) for p in Path(want).rglob("*")
                   if p.is_file())
    got_names = sorted(str(p.relative_to(got)) for p in Path(got).rglob("*")
                       if p.is_file())
    worst = 1.0 if names != got_names or not names else 0.0
    for n in names if not worst else []:
        a, b = (_read_image(Path(r) / n).astype(np.int32) for r in (got, want))
        worst = max(worst, float((np.abs(a - b) > grey).mean())
                    if a.shape == b.shape else 1.0)
    return len(names), worst


def _masks_hull(card, f):
    """(b) `precompute_masks.main(argv)` hull route on the card at
    --batch_size 32 over 64 crops with the templated Landmark106: 64
    masks, each a real face mask; wall, ms per crop, peak memory; then
    on 8 crops the card against `main(argv, device="cpu")` (all but
    ROUTE_EDGE_SHARE of each mask's values within 3 grey levels: the
    hull's hard threshold). Returns (counts, numbers)."""
    import numpy as np
    import torch

    from ghost_tpu_torch.cli import precompute_masks as pm

    d = f["dir"]
    argv = ["--landmark_path", f["lmk"], "--batch_size",
            str(MASKS["batch"])]
    counts = {}
    torch.cuda.empty_cache()
    for warm in (True, False):
        out = f"{d}/hull{'_warm' if warm else ''}"
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        wall, lines, _ = _cli_call(lambda: pm.main(
            ["--input_dir", f["crops"], "--output_dir", out] + argv))
        counts["hull"] = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    names = _pngs(out)
    cover = [float((_read_image(f"{out}/{n}") > 127).mean()) for n in names]
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = f"{d}/hull8_{dev}"
        zero_counts()
        _cli_call(lambda: pm.main(["--input_dir", f["crops8"],
                                   "--output_dir", runs[dev]] + argv,
                                  device=dev))
        if dev == "cuda":
            counts["hull_parity"] = read_counts()
    n8, share = _dirs_close(runs["cuda"], runs["cpu"])
    ms = wall * 1e3 / MASKS["crops"]
    ok = (lines == ["done"] and len(names) == MASKS["crops"]
          and min(cover) > 0.05 and max(cover) < 0.95 and n8 == 8
          and share <= ROUTE_EDGE_SHARE)
    log(f"masks (b) hull main(argv) at --batch_size {MASKS['batch']}: "
        f"{len(names)} masks, warm wall {wall:.2f} s, {ms:.2f} ms a crop, "
        f"peak {peak:.2f} GiB, face cover {min(cover):.3f}-"
        f"{max(cover):.3f}; card vs CPU on 8 crops: {share:.2e} of values "
        f"beyond 3 grey levels (bound {ROUTE_EDGE_SHARE}): {ok} ({card})")
    if not ok:
        raise AssertionError(f"precompute_masks hull: {lines[-3:]}")
    return counts, {"hull_ms_per_crop": ms, "hull_peak_gib": peak}


def _sam_flops(preset, img=1024, patch=16, ws=14):
    """Multiply-adds x 2 of ImageEncoderViT(preset) on one image: patch
    embed, per block qkv, proj, MLP, windowed or global attention (QK^T
    and PV over the padded windows), the rel-pos einsums, the neck."""
    d, depth, heads, glob = _test_inputs("torch_prep_inputs").SAM_PRESETS[
        preset]
    g = img // patch
    n = g * g
    hd = d // heads
    fl = 2 * n * d * 3 * patch * patch
    gp = -(-g // ws) * ws
    for i in range(depth):
        fl += 2 * n * d * (3 * d + d + 8 * d)
        if i in glob:
            fl += 2 * 2 * n * n * d + 2 * 2 * n * g * d
        else:
            t = ws * ws
            fl += (gp // ws) ** 2 * (2 * 2 * t * t * d + 2 * 2 * t * ws * d)
    fl += 2 * n * d * 256 + 2 * n * 256 * 256 * 9
    return fl


def _masks_sam(card, f, device):
    """(b) `precompute_masks.main(argv)` SAM route at the default
    --sam_preset (vit_h) on the seeded full-size `.pth` over 16 crops:
    16 masks of 0/255 with both values present; the load (torch.load,
    convert, bridge, cast) and each `predict_points` call timed apart,
    peak memory; then the image encoder alone on one 1024 image (CUDA
    events) against its bf16 operations bound. Returns (counts,
    numbers)."""
    import numpy as np
    import torch

    from ghost_tpu_torch.cli import precompute_masks as pm
    from ghost_tpu_torch.models import sam as sam_mod

    d = f["dir"]
    crops = f"{d}/sam_crops"
    Path(crops).mkdir()
    for n in sorted(Path(f["crops"]).iterdir())[:MASKS["sam_crops"]]:
        (Path(crops) / n.name).write_bytes(n.read_bytes())
    rec = {"calls": []}
    real_load, real_pred = pm.load_sam, sam_mod.SamPredictor.predict_points

    def load(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["model"] = real_load(*a, **kw)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t0
        return rec["model"]

    def pred(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = real_pred(self, *a, **kw)
        rec["calls"].append((time.perf_counter() - t0) * 1e3)
        return r

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pm.load_sam, sam_mod.SamPredictor.predict_points = load, pred
    zero_counts()
    try:
        wall, lines, _ = _cli_call(lambda: pm.main(
            ["--input_dir", crops, "--output_dir", f"{d}/sam_masks",
             "--sam_path", f["sam"], "--sam_preset", MASKS["preset"]]))
    finally:
        pm.load_sam, sam_mod.SamPredictor.predict_points = real_load, real_pred
    counts = {"sam": read_counts()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    names = _pngs(f"{d}/sam_masks")
    vals = set()
    for n in names:
        vals |= set(np.unique(_read_image(f"{d}/sam_masks/{n}")).tolist())
    model = rec.pop("model")
    side = model.image_encoder.img_size
    x = torch.randn(1, side, side, 3, device=device,
                    generator=torch.Generator(device=device).manual_seed(12))
    with torch.inference_mode():
        enc_ms = _time_one(lambda: model.image_encoder(x), 5, device)
    flops = _sam_flops(MASKS["preset"], img=side)
    bound_ms = flops / BF16_FLOPS * 1e3
    calls = rec["calls"]
    med = sorted(calls[1:])[len(calls[1:]) // 2]
    ok = (lines == ["done (SAM)"] and len(names) == MASKS["sam_crops"]
          and vals == {0, 255} and len(calls) == MASKS["sam_crops"])
    log(f"masks (b) SAM {MASKS['preset']} main(argv) on "
        f"{MASKS['sam_crops']} crops, bf16: wall {wall:.2f} s, load "
        f"{rec['load_s']:.2f} s, predict_points first {calls[0]:.1f} ms, "
        f"then median {med:.2f} ms a crop; peak {peak:.2f} GiB; mask "
        f"values {sorted(vals)}; image encoder alone {enc_ms:.2f} ms a "
        f"{side}-px image against {bound_ms:.2f} ms ({flops / 1e12:.2f} TFLOP at the "
        f"bf16 dense peak {BF16_FLOPS / 1e12:.0f} TFLOP/s: "
        f"{bound_ms / enc_ms:.1%}): {ok} ({card})")
    if not ok:
        raise AssertionError(f"precompute_masks SAM: {lines[-3:]} {vals}")
    nums = {"sam_load_s": rec["load_s"], "sam_ms_per_crop": med,
            "sam_peak_gib": peak, "sam_encoder_ms": enc_ms,
            "sam_encoder_bound_ms": bound_ms}
    return counts, nums, lambda: model.image_encoder(x)


def _profiled(name, fn, card):
    """fn once under torch.profiler (again while a session comes back
    empty): wall, device busy time and share, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_dev_us(e) for e in kernels)
        if busy > 0:
            break
    else:
        log(f"sr/masks profile of {name}: torch.profiler recorded no device "
            f"time in {PROFILE_TRIES} sessions: busy share not measured "
            f"({card})")
        return math.nan
    log(f"sr/masks profile of {name}: wall {wall * 1e3:.1f} ms (profiled), "
        f"device busy {busy / 1e3:.1f} ms ({busy / 1e6 / wall:.1%}), "
        f"{sum(e.count for e in kernels)} kernels ({card})")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:8]:
        log(f"  {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:100]}")
    return busy / 1e6 / wall


def _sam_parity(card, device):
    """(b0) the tiny SAM of tests/test_torch_sam.py (48 px, depth 2) in
    f32, card against CPU on one seeded state dict: predict_points'
    logits within 2e-4 of their largest, the masks equal except where
    |logit| <= 2e-4 of the largest (at most ROUTE_EDGE_SHARE)."""
    import numpy as np

    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.torch_loader import convert_sam_state_dict
    from ghost_tpu_torch.core.precision import FULL_PRECISION as F32
    from ghost_tpu_torch.models import sam as S

    pin = _test_inputs("torch_prep_inputs")
    sd = pin.sam_state_dict(np.random.default_rng(13), 8, 2, 2, (1,), 48,
                            16, 2, 16, 32)
    tree = convert_sam_state_dict(sd, depth=2)
    rng = np.random.default_rng(14)
    img = rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)
    kps = rng.uniform(0, 96, (5, 2)).astype(np.float32)
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        m = S.Sam(S.ImageEncoderViT(48, 16, 8, 2, 2, 2, (1,), 16, F32, dev),
                  S.PromptEncoder(16, 48, 3, F32, dev),
                  S.MaskDecoder(16, 2, 32, policy=F32, device=dev))
        m = load_flax_variables(m.eval(), tree)
        out[name] = S.SamPredictor(m).predict_points(
            img, kps, np.ones(5), multimask_output=True)
    (mc, _, lc), (mk, _, lk) = out["cpu"], out["card"]
    top = float(np.abs(lc).max())
    err = float(np.abs(lk - lc).max()) / top
    diff = mk != mc
    edge = np.abs(lc) <= 2e-4 * top
    ok = err <= 2e-4 and not (diff & ~edge).any() \
        and diff.mean() <= ROUTE_EDGE_SHARE
    log(f"masks (b0) tiny SAM f32 card vs CPU: logits {err:.2e} of the "
        f"largest, masks differ on {diff.mean():.2e}: {ok} ({card})")
    if not ok:
        raise AssertionError("SAM: card against CPU")


def _prep_argv(f, mode, out):
    src = f["tree"] if mode == "vgg" else f["flat"]
    extra = {"celeba": ["--max_darken", "2"],
             "vgg": ["--max_images_per_dir", str(PREP["per_dir"])],
             "gender": []}[mode]
    return ["--mode", mode, "--input_dir", src, "--output_dir", out,
            "--detector_path", f["det"], *extra]


def _prep_full(card, f):
    """(c) `preprocess.main(argv)` on the card in each mode on the seeded
    1080p jpgs with the templated full-width detector: celeba
    --max_darken 2 (4 images: 12 files), vgg (2 folders x 4: 8), gender
    (4, the random head); wall, ms per image, and each `crop_faces`
    call synced. Returns (counts, numbers)."""
    import torch

    from ghost_tpu_torch.cli import preprocess as pp
    from ghost_tpu_torch.pipeline import swap

    d = f["dir"]
    real_crop = swap.SwapPipeline.crop_faces
    counts, out = {}, {}
    n_img = {"celeba": PREP["flat"], "vgg": PREP["dirs"] * PREP["per_dir"],
             "gender": PREP["flat"]}
    want = {"celeba": 3 * PREP["flat"], "vgg": n_img["vgg"],
            "gender": PREP["flat"]}
    for mode in ("celeba", "vgg", "gender"):
        calls = []

        def crop(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = real_crop(self, *a, **kw)
            calls.append((time.perf_counter() - t0) * 1e3)
            return r

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        swap.SwapPipeline.crop_faces = crop
        zero_counts()
        try:
            wall, lines, _ = _cli_call(lambda: pp.main(_prep_argv(
                f, mode, f"{d}/prep_{mode}")))
        finally:
            swap.SwapPipeline.crop_faces = real_crop
        counts[f"prep_{mode}"] = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        files = [p for p in Path(f"{d}/prep_{mode}").rglob("*.jpg")]
        shapes = {_read_image(p).shape for p in files}
        med = sorted(calls[1:])[len(calls[1:]) // 2]
        out[mode] = (wall * 1e3 / n_img[mode], med, peak)
        log(f"prep (c) preprocess --mode {mode} main(argv) on "
            f"{n_img[mode]} 1080p images: wall {wall:.2f} s (pipeline build "
            f"included), {out[mode][0]:.1f} ms an image, crop_faces first "
            f"{calls[0]:.1f} ms then median {med:.2f} ms, peak {peak:.2f} "
            f"GiB, {len(files)} crops {sorted(shapes)} ({card})")
        if lines[-1] != "done" or len(files) != want[mode] \
                or shapes != {(256, 256, 3)}:
            raise AssertionError(f"preprocess {mode}: {lines[-3:]}")
    return counts, out


def _prep_parity(card, f):
    """(c0) `preprocess.main(argv)` --mode celeba --max_darken 2 on the
    1080p jpgs, card against `main(argv, device="cpu")`, both on a narrow
    f32
    pipeline (`build_random_pipeline` wrapped: det_size 320, ArcFace
    (1,1,1,1), AEI-Net width 1/16, the same seed; the templated detector
    msgpack): the same files, each within 3 grey levels on all but
    ROUTE_EDGE_SHARE of its values. Returns the card's counts."""
    from ghost_tpu_torch.cli import preprocess as pp
    from ghost_tpu_torch.core.precision import FULL_PRECISION as F32
    from ghost_tpu_torch.pipeline import swap

    d = f["dir"]
    real = swap.build_random_pipeline

    def narrow(config, device="cuda", **kw):
        import dataclasses

        return real(dataclasses.replace(config, det_size=320), policy=F32,
                    gen_width=1 / 16, device=device)

    counts, runs = {}, {}
    swap.build_random_pipeline = narrow
    try:
        for dev in ("cuda", "cpu"):
            runs[dev] = f"{d}/prep_parity_{dev}"
            zero_counts()
            _cli_call(lambda: pp.main(_prep_argv(f, "celeba", runs[dev]),
                                      device=dev))
            if dev == "cuda":
                counts["prep_parity"] = read_counts()
    finally:
        swap.build_random_pipeline = real
    n, share = _dirs_close(runs["cuda"], runs["cpu"])
    ok = n == 3 * PREP["flat"] and share <= ROUTE_EDGE_SHARE
    log(f"prep (c0) celeba --max_darken 2 on the {PREP['flat']} 1080p "
        f"images, narrow f32 pipeline, card vs CPU: "
        f"{n} files, {share:.2e} of values beyond 3 grey levels: {ok} "
        f"({card})")
    if not ok:
        raise AssertionError("preprocess: card against CPU")
    return counts


def phase_sr_masks(card, device, kept=None):
    """Phase 23: the SR-training library (Pix2PixSR's TTUR steps with
    SpectralConv's power iteration, HiFaceGAN, the encoder pretraining)
    and the mask-target and preprocessing CLIs (`python -m
    ghost_tpu_torch.cli.precompute_masks`, `cli.preprocess`) through
    `main(argv)`: card against CPU at the tests' narrow configs, then the
    reference's sizes. None of the table's kernels runs on these paths
    (cuDNN convs, cuBLAS matmuls, SAM's attention a plain matmul as in
    JAX): every count must read 0. The SAM `.pth` is moved into `kept`
    when it is given. Returns each run's counts and the numbers."""
    import torch

    t0 = time.perf_counter()
    counts, nums, probes = {}, {}, {}
    counts.update(_sr_parity(card, device))
    for policy_name in ("bf16", "f32"):
        zero_counts()
        nums[f"pix2pix_{policy_name}"], probe = _sr_full(card, device,
                                                         policy_name)
        counts[f"pix2pix_{policy_name}"] = read_counts()
        if policy_name == "bf16":
            probes["the bf16 Pix2PixSR G step"] = probe
    zero_counts()
    nums["hifacegan"] = _hifacegan(card, device)
    counts["hifacegan"] = read_counts()
    zero_counts()
    nums["pretrain"] = _pretrain_full(card, device)
    counts["pretrain"] = read_counts()
    with tempfile.TemporaryDirectory() as d:
        f = prep_files(d)
        _sam_parity(card, device)
        for run in (lambda: _masks_hull(card, f),
                    lambda: _masks_sam(card, f, device),
                    lambda: (_prep_parity(card, f), {}),
                    lambda: _prep_full(card, f)):
            c, n, *probe = run()
            counts.update(c)
            nums.update(n)
            if probe:
                probes[f"SAM {MASKS['preset']}'s image encoder"] = probe[0]
        if kept:  # phase 24 converts the SAM checkpoint
            shutil.move(f["sam"], kept)
    # last: a profiler session can slow the host for the rest of the
    # process
    with torch.inference_mode(False):
        for name, fn in probes.items():
            nums[f"busy {name}"] = _profiled(name, fn, card)
    del probes
    torch.cuda.empty_cache()
    launched = {run: c for run, c in counts.items() if any(c.values())}
    log(f"sr/masks: phase 23 in {time.perf_counter() - t0:.1f} s; runs that "
        f"launched a kernel of the table: {launched} ({card})")
    if launched:
        raise AssertionError(f"phase 23 launched kernels: {launched}")
    return counts, nums


# ---------------------------------------------------------------------------
# Phase 24: the weight-conversion and export CLIs, the MXNet 2d106det net,
# the AdaptiveWingLoss FAN and the single-card remainder
# ---------------------------------------------------------------------------

# batches and sizes of phase 24: the converted AEI-Net at the swap's chunk
# (fused AAD, bf16), Landmark106Det's and FANAWL's batches, the export's
# reload batches, ArcMarginHead over MS1MV2's 85,742 identities, the LSTM
# of scripts/profile_rnn.py:15-17 and the transducer lattice of
# scripts/profile_transducer.py:26
WEIGHTS = dict(aei_batch=8, lmk_batch=32, fan_batch=8, export_batches=(1, 8),
               margin=(512, 85742, 64), rnn=(256, 32, 512, 2),
               transducer=(16, 128, 64, 128), iters=10)
K1_PER_PASS = 21  # AAD layers of the full-width unet 2-block generator


def weights_files(d, files, card):
    """Phase 24's checkpoints. Reused: phase 17's G (unet 2 blocks) and
    iresnet100 `backbone.pth`, phase 18's mmdet SCRFD 2.5GF `.pth`, phase
    19's GFPGANv1.4, RealESRGAN_x4plus and realesr-general-x4v3 `.pth`,
    phase 22's D and LIPSPADE `10_net_G.pth` and phase 23's SAM vit_h
    `.pth` (both kept under `files["kept"]`). Written here (seeded): a
    2d106det symbol JSON and its `.params` file (the port's MXNet
    writer), a WFLW_4HG-layout FAN `.pth` (4 modules, 98+1 heatmaps, 256
    features) and a torchvision VGG19 `.pth`. Returns {kind: (src,
    flags)} for the convert CLI, and the symbol's path."""
    import numpy as np

    from ghost_tpu_torch.convert import mxnet_graph, mxnet_nd

    cin = _test_inputs("torch_cli_inputs")
    win = _test_inputs("torch_weight_inputs")
    t0 = time.perf_counter()
    rng = np.random.default_rng(24)
    symbol = win.write_symbol_2d106det(f"{d}/2d106det-symbol.json")
    params = mxnet_graph.MXNetGraphInterpreter(
        symbol, device="cpu").init_params(seed=24)
    mxnet_nd.save_ndarray_dict(f"{d}/2d106det-0000.params",
                               win.prefixed(params))
    cin.save_pth(f"{d}/WFLW_4HG.pth", win.fan_awl_state_dict(rng))
    cin.save_pth(f"{d}/vgg19.pth", win.vgg19_state_dict(rng))
    k, src = files["kept"], files["dir"]
    kinds = {
        "aei": (files["G"], []),
        "arcface": (files["arc"], []),
        "discriminator": (f"{k}/D_unet_2blocks.pth", []),
        "spade": (f"{k}/10_net_G.pth", []),
        "scrfd": (f"{src}/SCRFD_2_5GF.pth", []),
        "landmark_mxnet": (f"{d}/2d106det-0000.params", []),
        "vgg19": (f"{d}/vgg19.pth", []),
        "gfpgan": (f"{src}/GFPGANv1.4.pth", []),
        "rrdb": (f"{src}/RealESRGAN_x4plus.pth", []),
        "srvgg": (f"{src}/realesr-general-x4v3.pth", []),
        "sam": (f"{k}/sam_{MASKS['preset']}.pth",
                ["--sam_preset", MASKS["preset"]]),
        "fan": (f"{d}/WFLW_4HG.pth", []),
    }
    log(f"weights: wrote the 2d106det symbol and .params, WFLW_4HG.pth and "
        f"vgg19.pth in {time.perf_counter() - t0:.1f} s ({card})")
    return kinds, symbol


def _flat_tensors(out):
    """The tensors of a nested output (tuples, lists, dicts), in order."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    if out is None:
        return []
    if isinstance(out, dict):
        out = list(out.values())
    return [t for o in out for t in _flat_tensors(o)]


def _weights_case(kind, device):
    """(module on `device`, its inputs, fn(module, inputs) -> output) of
    the port model a `--kind` tree loads into, at the serving policy
    (bf16 compute; AEI-Net with the fused AAD kernel)."""
    import numpy as np
    import torch

    from ghost_tpu_torch.core.precision import DEFAULT_POLICY as P

    g = np.random.default_rng(240)

    def u(lo, hi, *shape):
        return torch.from_numpy(g.uniform(lo, hi, shape).astype(
            np.float32)).to(device)

    b = WEIGHTS["aei_batch"]
    if kind == "aei":
        from ghost_tpu_torch.models.aei import AEINet

        z = torch.nn.functional.normalize(u(-1, 1, b, 512), dim=-1)
        return (AEINet(policy=P, fused_aad=True, device=device),
                (u(-1, 1, b, 256, 256, 3), z), lambda m, a: m(*a)[0])
    if kind == "arcface":
        from ghost_tpu_torch.models.arcface import iresnet100

        return iresnet100(policy=P, device=device), (u(-1, 1, b, 112, 112,
                                                       3),), None
    if kind == "discriminator":
        from ghost_tpu_torch.models.discriminator import \
            MultiscaleDiscriminator

        return (MultiscaleDiscriminator(n_layers=5, num_D=3, policy=P,
                                        device=device),
                (u(-1, 1, 4, 256, 256, 3),), None)
    if kind == "spade":
        from ghost_tpu_torch.models.sr.generator import LIPSPADEGenerator

        return (LIPSPADEGenerator(policy=P, device=device),
                (u(-1, 1, 4, 256, 256, 3),), None)
    if kind == "scrfd":
        from ghost_tpu_torch.models.scrfd_v1e import SCRFDV1e

        return SCRFDV1e(policy=P, device=device), (u(-1, 1, 2, 640, 640,
                                                     3),), None
    if kind == "landmark_mxnet":
        from ghost_tpu_torch.models.landmark_mxnet import Landmark106Det

        return (Landmark106Det(policy=P, device=device),
                (u(0, 255, WEIGHTS["lmk_batch"], 192, 192, 3),), None)
    if kind == "vgg19":
        from ghost_tpu_torch.models.sr.vgg import VGG19Features

        return VGG19Features(policy=P, device=device), (u(-2, 2, 4, 256, 256,
                                                          3),), None
    if kind == "gfpgan":
        from ghost_tpu_torch.models.sr.gfpgan import GFPGANClean

        return GFPGANClean(policy=P, device=device), (u(-1, 1, 2, 512, 512,
                                                        3),), None
    if kind == "rrdb":
        from ghost_tpu_torch.models.sr.rrdb import RRDBNet

        return RRDBNet(policy=P, device=device), (u(0, 1, 2, 64, 64, 3),), \
            None
    if kind == "srvgg":
        from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact

        return (SRVGGNetCompact(policy=P, device=device),
                (u(0, 1, 2, 64, 64, 3),), None)
    if kind == "sam":
        from ghost_tpu_torch.models.sam import build_sam

        return (build_sam(MASKS["preset"], policy=P, device=device),
                (u(-2, 2, 1, 1024, 1024, 3),),
                lambda m, a: m.image_encoder(*a))
    if kind == "fan":
        from ghost_tpu_torch.models.fan_awl import FANAWL

        return FANAWL(policy=P, device=device), (u(0, 1, WEIGHTS[
            "fan_batch"], 256, 256, 3),), None
    raise ValueError(kind)


def _bridged(module, kind, tree):
    from ghost_tpu_torch.convert.from_jax import load_flax_variables

    if kind == "gfpgan":
        from ghost_tpu_torch.models.sr.gfpgan import drop_unread_leaves

        tree, _ = drop_unread_leaves(tree, module)
    return load_flax_variables(module, tree)


def _weights_convert(card, device, kinds, d):
    """(a) `convert.main(argv)` for every --kind, seconds each; each
    msgpack bridged into its port model on the card gives the output of
    the same model loaded from the tree converted straight from the
    `.pth` (the same code path), max abs diff 0; AEI-Net in bf16 with
    the fused AAD kernel at batch 8, K1 counted, and the SRVGG x4v3
    model on S2. Returns (counts, {kind: seconds}, {kind: msgpack
    path})."""
    import torch

    from ghost_tpu_torch.cli import convert
    from ghost_tpu_torch.core.checkpoint import load_msgpack

    counts, secs, outs = {}, {}, {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kind, (src, flags) in kinds.items():
            argv = ["--kind", kind, "--src", src, "--out",
                    f"{d}/{kind}.msgpack"] + flags
            wall, lines, _ = _cli_call(lambda: convert.main(argv))
            secs[kind], outs[kind] = wall, f"{d}/{kind}.msgpack"
            msg = load_msgpack(outs[kind])
            direct = convert.convert_tree(convert.build_parser().parse_args(
                argv))
            module, args, fn = _weights_case(kind, device)
            module.eval()
            fn = fn or (lambda m, a: m(*a))
            zero_counts()
            got = []
            with torch.inference_mode():
                for tree in (msg, direct):
                    _bridged(module, kind, tree)
                    got.append([t.float() for t in _flat_tensors(
                        fn(module, args))])
            torch.cuda.synchronize()
            counts[f"convert {kind}"] = read_counts()
            diff = max(float((a - b).abs().max())
                       for a, b in zip(*got))
            finite = all(bool(torch.isfinite(t).all()) for t in got[0])
            log(f"weights: convert --kind {kind}: {wall:.2f} s, "
                f"{Path(src).stat().st_size / 2 ** 20:.1f} MiB -> "
                f"{Path(outs[kind]).stat().st_size / 2 ** 20:.1f} MiB "
                f"({lines[-1].split(': ')[-1]}); msgpack vs .pth tree on "
                f"the card: {len(got[0])} outputs, max abs diff {diff} "
                f"(must be 0), finite {finite}; launches "
                f"{_launched(counts[f'convert {kind}'])} ({card})")
            if diff != 0 or not finite:
                raise AssertionError(f"weights: convert {kind}: msgpack "
                                     f"output differs by {diff}")
            del module, msg, direct, got
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    # two passes each: K1 in the generator's AAD layers, S2 in
    # realesr-general-x4v3's 34 convs (SRVGGNetCompact on Conv3x3)
    want = {("convert aei", "aad_modulate"): 2 * K1_PER_PASS,
            ("convert srvgg", "conv3x3"): 2 * sum(S2_SRVGG_TILE.values())}
    wrong = {(run, name): v for run, c in counts.items()
             for name, v in c.items() if v != want.get((run, name), 0)}
    if wrong:
        raise AssertionError(f"weights: launches {wrong}, expected {want}")
    return counts, secs, outs


def _launched(c):
    """The kernels of a count dict that launched, or "none"."""
    return {k: v for k, v in c.items() if v} or "none"


def _rel(got, ref):
    return float((got.float().cpu() - ref.float().cpu()).abs().max()
                 / max(ref.float().abs().max().item(), 1e-12))


def _card_vs_cpu(card, what, cpu_mod, x, tol=1e-4):
    """f32: the module on the card against itself on the CPU, relative
    to the output's scale."""
    import torch

    card_mod = copy.deepcopy(cpu_mod).cuda()
    with torch.inference_mode():
        ref = _flat_tensors(cpu_mod(x))
        got = _flat_tensors(card_mod(x.cuda()))
    err = max(_rel(g, r) for g, r in zip(got, ref))
    log(f"weights: {what} f32 card vs CPU: max err {err:.2e} of scale "
        f"(<= {tol:g}) ({card})")
    if err > tol:
        raise AssertionError(f"weights: {what}: card vs CPU {err:.2e}")
    return card_mod, got


def _weights_landmark_fan(card, device, outs, symbol, kinds):
    """(b) Landmark106Det at batch 32, 192 px: f32 card vs CPU, and
    against the port's MXNetGraphInterpreter on the card over the
    symbol JSON; bf16 ms a batch. (c) FANAWL(4, 98, 256) at 256 px, batch
    8: f32 card vs CPU; bf16 ms a batch."""
    import numpy as np
    import torch

    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.mxnet_graph import MXNetGraphInterpreter
    from ghost_tpu_torch.convert.mxnet_nd import load_ndarray_dict
    from ghost_tpu_torch.core.checkpoint import load_msgpack
    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.models.fan_awl import FANAWL
    from ghost_tpu_torch.models.landmark_mxnet import Landmark106Det

    nums = {}
    g = np.random.default_rng(241)
    tree = load_msgpack(outs["landmark_mxnet"])
    x = torch.from_numpy(g.uniform(0, 255, (WEIGHTS["lmk_batch"], 192, 192,
                                            3)).astype(np.float32))
    cpu = load_flax_variables(Landmark106Det(policy=FULL_PRECISION),
                              tree).eval()
    card_mod, got = _card_vs_cpu(card, "Landmark106Det (32x192)", cpu, x)
    bare = {k.split(":", 1)[1]: v for k, v in load_ndarray_dict(
        kinds["landmark_mxnet"][0]).items()}
    interp = MXNetGraphInterpreter(symbol, device=device)
    ref = interp.run(bare, x.cuda().permute(0, 3, 1, 2))
    err = _rel(got[0].reshape(ref.shape), ref)
    ms_interp = _time_one(lambda: interp.run(bare, x.cuda().permute(
        0, 3, 1, 2)), 3, device)
    bf = load_flax_variables(Landmark106Det(policy=DEFAULT_POLICY,
                                            device=device), tree).eval()
    xc = x.cuda()
    with torch.inference_mode():
        ms = _time_one(lambda: bf(xc), WEIGHTS["iters"], device)
        bf_err = _rel(bf(xc), ref.reshape(-1, 106, 2))
    nums["landmark_bf16_ms"] = ms
    log(f"weights: Landmark106Det f32 on the card vs the MXNet graph "
        f"interpreter on the card: max err {err:.2e} of scale (<= 1e-4); "
        f"bf16 {ms:.3f} ms a batch of {WEIGHTS['lmk_batch']} (its error "
        f"vs the f32 graph {bf_err:.2e} of scale), the interpreter "
        f"{ms_interp:.3f} ms ({card})")
    if err > 1e-4:
        raise AssertionError(f"weights: Landmark106Det vs graph {err:.2e}")
    del card_mod, bf, interp
    tree = load_msgpack(outs["fan"])
    x = torch.from_numpy(g.uniform(0, 1, (WEIGHTS["fan_batch"], 256, 256,
                                          3)).astype(np.float32))
    cpu = load_flax_variables(FANAWL(policy=FULL_PRECISION), tree).eval()
    card_mod, got = _card_vs_cpu(card, "FANAWL(4, 98, 256) (8x256)", cpu, x)
    bf = load_flax_variables(FANAWL(policy=DEFAULT_POLICY, device=device),
                             tree).eval()
    xc = x.cuda()
    with torch.inference_mode():
        ms = _time_one(lambda: bf(xc), WEIGHTS["iters"], device)
        bf_err = max(_rel(a, b) for a, b in zip(bf(xc), got))
    nums["fan_bf16_ms"] = ms
    keep = float((torch.clamp(got[0][..., -1], 0, 1) > 0.05).float().mean())
    log(f"weights: FANAWL bf16 {ms:.3f} ms a batch of {WEIGHTS['fan_batch']}"
        f" (its error vs f32 {bf_err:.2e} of scale); share of stack 1's "
        f"boundary map past the 0.05 gate {keep:.3f} ({card})")
    return nums


def _weights_export(card, device, files, d):
    """(d) `export.main(argv)` for full-width AEI-Net (G) and iresnet100
    (backbone.pth): onnx through the port's OnnxExecutor on the card
    against the eager module in f32; pt2 reloaded with torch.export.load
    and run at batch 1 and 8 against the eager module at the same policy
    (DEFAULT_POLICY), within 1e-3 of scale (eager's own bf16 error
    against its f32 twin beside it). Export seconds, file bytes, ms a
    call of the reloaded program beside eager (batch 8). Returns
    (numbers, the AEI program, its inputs at batch 8)."""
    import numpy as np
    import torch

    from ghost_tpu_torch.cli import export
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.onnx_exec import OnnxExecutor
    from ghost_tpu_torch.convert.onnx_reader import read_onnx_graph
    from ghost_tpu_torch.core.precision import FULL_PRECISION
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.models.arcface import iresnet100

    g = np.random.default_rng(242)
    nums, keep = {}, {}
    for model, flags in (("aei", ["--G_path", files["G"]]),
                         ("arcface", ["--arcface_path", files["arc"]])):
        args = export.build_parser().parse_args(["--model", model, "--out",
                                                 "x"] + flags)
        eager, tree, _ = export.build_module(args, device)
        if model == "aei":
            f32 = AEINet(policy=FULL_PRECISION, device=device)
            y_of, shape, names = export.GeneratorY, (256, 256, 3), ("xt",
                                                                  "z_id")
        else:
            f32 = iresnet100(policy=FULL_PRECISION, device=device)
            y_of, shape, names = (lambda m: m), (112, 112, 3), ("input",)
        f32 = load_flax_variables(f32, tree).eval()
        xs = torch.from_numpy(g.uniform(-1, 1, (8,) + shape).astype(
            np.float32)).to(device)
        zs = torch.nn.functional.normalize(torch.from_numpy(g.normal(
            0, 1, (8, 512)).astype(np.float32)), dim=-1).to(device)
        inputs = (xs, zs) if model == "aei" else (xs,)
        # onnx, f32, batch 2 against the eager f32 module
        p = f"{d}/{model}.onnx"
        wall, _, _ = _cli_call(lambda: export.main(
            ["--model", model, "--format", "onnx", "--out", p] + flags))
        ex = OnnxExecutor(read_onnx_graph(p), device=device)
        with torch.inference_mode():
            ref = y_of(f32)(*[t[:2] for t in inputs])
            feeds = dict(zip(names, [
                t[:2].permute(0, 3, 1, 2) if t.ndim == 4 else t[:2]
                for t in inputs]))
            out = ex(feeds)[0]
            out = out.permute(0, 2, 3, 1) if out.ndim == 4 else out
            err = _rel(out, ref)
        nums[f"{model}_onnx"] = (wall, Path(p).stat().st_size, err)
        log(f"weights: export {model} --format onnx: {wall:.2f} s, "
            f"{Path(p).stat().st_size} bytes; OnnxExecutor on the card vs "
            f"the eager f32 module (batch 2): max err {err:.2e} of scale "
            f"(<= 1e-4) ({card})")
        if err > 1e-4:
            raise AssertionError(f"weights: {model} onnx {err:.2e}")
        del ex
        # pt2 at DEFAULT_POLICY
        p = f"{d}/{model}.pt2"
        wall, _, _ = _cli_call(lambda: export.main(
            ["--model", model, "--out", p] + flags))
        t0 = time.perf_counter()
        prog = torch.export.load(p).module()
        load_s = time.perf_counter() - t0
        errs = []
        with torch.inference_mode():
            for b in WEIGHTS["export_batches"]:
                a = [t[:b] for t in inputs]
                got, want, want32 = prog(*a), y_of(eager)(*a), y_of(f32)(*a)
                own = _rel(want, want32)
                errs.append((b, _rel(got, want), own))
            ms_prog = _time_one(lambda: prog(*inputs), WEIGHTS["iters"],
                                device)
            ms_eager = _time_one(lambda: y_of(eager)(*inputs),
                                 WEIGHTS["iters"], device)
        nums[f"{model}_pt2"] = (wall, Path(p).stat().st_size, load_s,
                                ms_prog, ms_eager, errs)
        log(f"weights: export {model} --format pt2: {wall:.2f} s, "
            f"{Path(p).stat().st_size} bytes, torch.export.load + module() "
            f"{load_s:.2f} s; the reloaded program vs eager (bf16): "
            + ", ".join(f"batch {b} max err {e:.2e} of scale (eager's own "
                        f"bf16 error vs f32 {o:.2e})" for b, e, o in errs)
            + f" (<= 1e-3); batch 8: program {ms_prog:.3f} ms, eager "
            f"{ms_eager:.3f} ms a call ({card})")
        # the same aten ops on the same inputs: equal up to an algorithm
        # choice, far inside eager's own bf16 error
        if any(e > 1e-3 for _, e, _ in errs):
            raise AssertionError(f"weights: {model} pt2 vs eager {errs}")
        if model == "aei":
            keep = {"prog": prog, "inputs": inputs}
        del eager, f32
        torch.cuda.empty_cache()
    return nums, keep


def _weights_rest(card, device, outs, pt2, d):
    """(e) 2:4 masks of full-width AEI-Net (card equal to CPU),
    ArcMarginHead over 85,742 classes, the colour losses, id_similarity,
    psnr and perceptual_distance, the pt2 call inside trace() +
    annotate("phase24"), StageTimer and flop_estimate, the LSTM beside
    cuDNN's, GRU and mLSTM, the transducer loss forward + backward. Peak
    memory each."""
    import numpy as np
    import torch

    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.core.checkpoint import load_msgpack
    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.models.arcface import iresnet100
    from ghost_tpu_torch.models.sr.vgg import VGG19Features
    from ghost_tpu_torch.nn import rnn, transducer
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.train import color, sparsity
    from ghost_tpu_torch.train.arcface_margin import ArcMarginHead
    from ghost_tpu_torch.utils import profiling, quality

    g = np.random.default_rng(243)
    timer = profiling.StageTimer()
    nums = {}

    def peak(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        with timer.stage(name):
            out = fn()
            torch.cuda.synchronize()
        nums[f"{name}_peak_gib"] = (torch.cuda.max_memory_allocated(device)
                                    - base) / 2 ** 30
        return out

    # 2:4 masks
    tree = load_msgpack(outs["aei"])
    gen = load_flax_variables(AEINet(policy=DEFAULT_POLICY, device=device),
                              tree)
    masks = peak("masks", lambda: sparsity.compute_masks(gen))
    cpu_masks = sparsity.compute_masks(copy.deepcopy(gen).cpu())
    same = all(bool(torch.equal(masks[k].cpu(), cpu_masks[k]))
               for k in masks)
    ms = _time_one(lambda: sparsity.compute_masks(gen), 2, device)
    ratio = sparsity.sparsity_ratio(masks)
    log(f"weights: 2:4 masks of full-width AEI-Net ({len(masks)} "
        f"parameters, {sum(m.numel() for m in masks.values())} values): "
        f"card equal to CPU {same}; sparsity_ratio {ratio:.6f}; "
        f"compute_masks {ms:.1f} ms on the card ({card})")
    if not same:
        raise AssertionError("weights: 2:4 masks card vs CPU")
    del gen, masks, cpu_masks
    # ArcMarginHead
    dim, classes, b = WEIGHTS["margin"]
    head = init_weights(ArcMarginHead(dim, classes),
                        torch.Generator().manual_seed(24)).eval()
    emb = torch.from_numpy(g.normal(0, 1, (b, dim)).astype(np.float32))
    lab = torch.from_numpy(g.integers(0, classes, b))
    card_head = copy.deepcopy(head).cuda()
    with torch.inference_mode():
        ref = head(emb, lab)
        got = peak("margin", lambda: card_head(emb.cuda(), lab.cuda()))
        ms = _time_one(lambda: card_head(emb.cuda(), lab.cuda()),
                       WEIGHTS["iters"], device)
    err = _rel(got, ref)
    log(f"weights: ArcMarginHead({dim} -> {classes}) batch {b} f32: card vs "
        f"CPU max err {err:.2e} of scale (<= 1e-5); {ms:.3f} ms ({card})")
    if err > 1e-5:
        raise AssertionError(f"weights: ArcMarginHead {err:.2e}")
    del head, card_head
    # colour
    img = torch.from_numpy(g.uniform(-1, 1, (8, 256, 256, 3)).astype(
        np.float32))
    errs = []
    for fn in (lambda x: color.get_hsv(x),
               lambda x: color.hsv_to_rgb(color.get_hsv(x)),
               lambda x: color.color_consistency_loss(x),
               lambda x: color.stuck_loss(x, (64, 64, 128, 128))):
        errs.append(_rel(peak("colour", lambda: fn(img.cuda())), fn(img)))
    log(f"weights: colour functions (get_hsv, the HSV round trip, "
        f"color_consistency_loss, stuck_loss) at 8x256: card vs CPU max "
        f"err {max(errs):.2e} of scale (<= 1e-5) ({card})")
    if max(errs) > 1e-5:
        raise AssertionError(f"weights: colour {errs}")
    # quality
    arc = load_flax_variables(iresnet100(policy=FULL_PRECISION),
                              load_msgpack(outs["arcface"])).eval()
    vgg = load_flax_variables(VGG19Features(policy=FULL_PRECISION),
                              load_msgpack(outs["vgg19"])).eval()
    a = torch.from_numpy(g.uniform(-1, 1, (4, 256, 256, 3)).astype(
        np.float32))
    bimg = (a + 0.1 * torch.from_numpy(g.normal(0, 1, a.shape).astype(
        np.float32))).clamp(-1, 1)
    u8a = ((a + 1) * 127.5).to(torch.uint8)
    u8b = ((bimg + 1) * 127.5).to(torch.uint8)
    carc, cvgg = copy.deepcopy(arc).cuda(), copy.deepcopy(vgg).cuda()
    with torch.inference_mode():
        q_cpu = (quality.id_similarity(arc, a, bimg), quality.psnr(u8a, u8b),
                 quality.perceptual_distance(vgg, a, bimg))
        q_card = peak("quality", lambda: (
            quality.id_similarity(carc, a.cuda(), bimg.cuda()),
            quality.psnr(u8a.cuda(), u8b.cuda()),
            quality.perceptual_distance(cvgg, a.cuda(), bimg.cuda())))
    errs = [_rel(x, y) for x, y in zip(q_card, q_cpu)]
    log(f"weights: quality at 4x256 f32: id_similarity (iresnet100) "
        f"{q_card[0].cpu().numpy().round(4).tolist()}, psnr "
        f"{q_card[1].cpu().numpy().round(3).tolist()} dB, "
        f"perceptual_distance (VGG19) "
        f"{q_card[2].cpu().numpy().round(5).tolist()}; card vs CPU max err "
        f"{max(errs):.2e} of scale (<= 1e-4) ({card})")
    if max(errs) > 1e-4:
        raise AssertionError(f"weights: quality {errs}")
    # flop_estimate of iresnet100 at batch 1
    cost = profiling.flop_estimate(carc, torch.zeros(1, 112, 112, 3,
                                                     device=device))
    del arc, vgg, carc, cvgg
    torch.cuda.empty_cache()
    # the pt2 call inside trace() + annotate()
    logdir = f"{d}/trace"
    with torch.inference_mode(), profiling.trace(logdir):
        with profiling.annotate("phase24"):
            pt2["prog"](*pt2["inputs"])
        torch.cuda.synchronize()
    path = Path(logdir) / profiling.TRACE_FILE
    text = path.read_text() if path.exists() else ""
    has_cuda = '"cat": "kernel"' in text or "cuda" in text.lower()
    log(f"weights: trace() + annotate('phase24') around the pt2 AEI-Net "
        f"call: {path.name} {path.stat().st_size if path.exists() else 0} "
        f"bytes, holds 'phase24' {'phase24' in text}, device kernels "
        f"{has_cuda}; flop_estimate(iresnet100, batch 1): "
        f"{cost['flops'] / 1e9:.3f} GFLOP, "
        f"{cost['bytes_accessed'] / 2 ** 20:.1f} MiB of aten operands "
        f"(unfused) ({card})")
    if "phase24" not in text:
        raise AssertionError("weights: the trace lacks the annotation")
    nums["iresnet100_gflop"] = cost["flops"] / 1e9
    # the RNNs
    t, b, h, layers = WEIGHTS["rnn"]
    gen_ = torch.Generator().manual_seed(25)
    params = rnn.init_rnn_params(gen_, "lstm", h, h, layers, device=device)
    x = torch.from_numpy(g.normal(0, 1, (t, b, h)).astype(np.float32)).to(
        device)
    ref_mod = torch.nn.LSTM(h, h, layers).to(device)
    with torch.no_grad():
        for li, p in enumerate(params):
            for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                getattr(ref_mod, name.replace("w_", "weight_").replace(
                    "b_", "bias_") + f"_l{li}").copy_(getattr(p, name))
    with torch.inference_mode():
        y, _ = peak("lstm", lambda: rnn.lstm(params, x))
        y_ref, _ = ref_mod(x)
        ms = _time_one(lambda: rnn.lstm(params, x), 3, device)
        ms_ref = _time_one(lambda: ref_mod(x), WEIGHTS["iters"], device)
        err = float((y - y_ref).abs().max())
        others = {}
        for kind in ("gru", "mlstm"):
            pk = rnn.init_rnn_params(gen_, kind, h, h, layers, device=device)
            out, _ = rnn.rnn_forward(kind, pk, x)
            others[kind] = (tuple(out.shape), bool(torch.isfinite(out).all()))
    nums["lstm_ms"], nums["lstm_cudnn_ms"] = ms, ms_ref
    log(f"weights: LSTM T{t} B{b} H{h} {layers} layers f32 forward "
        f"{ms:.2f} ms (torch.nn.LSTM, cuDNN: {ms_ref:.3f} ms; max abs diff "
        f"{err:.2e}, <= 1e-4); GRU and mLSTM once: {others} ({card})")
    if err > 1e-4 or not all(v[1] for v in others.values()):
        raise AssertionError(f"weights: RNN {err} {others}")
    # the transducer loss
    bt, tt, ut, vt = WEIGHTS["transducer"]
    lp = torch.log_softmax(torch.from_numpy(g.normal(0, 1, (
        bt, tt, ut + 1, vt)).astype(np.float32)), -1)
    labels = torch.from_numpy(g.integers(1, vt, (bt, ut)))
    f_len = torch.full((bt,), tt)
    y_len = torch.full((bt,), ut)

    def fwd_bwd(lp_, dev):
        x_ = lp_.detach().to(dev).requires_grad_(True)
        loss = transducer.transducer_loss(x_, labels.to(dev), f_len.to(dev),
                                          y_len.to(dev))
        loss.sum().backward()
        return loss.detach(), x_.grad

    t0 = time.perf_counter()
    l_cpu, g_cpu = fwd_bwd(lp, "cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    l64, g64 = fwd_bwd(lp.double(), "cpu")
    l_card, g_card = peak("transducer", lambda: fwd_bwd(lp, device))
    ms = _time_one(lambda: fwd_bwd(lp, device), 3, device)
    # each f32 run against the f64 one: the card within 2x the CPU's own
    # f32 error (191 sequential logaddexp steps accumulate rounding)
    errs = {"card": (_rel(l_card, l64), _rel(g_card, g64)),
            "cpu": (_rel(l_cpu, l64), _rel(g_cpu, g64))}
    nums["transducer_ms"], nums["transducer_cpu_ms"] = ms, cpu_ms
    log(f"weights: transducer loss B{bt} T{tt} U{ut} V{vt} forward + "
        f"backward: card {ms:.2f} ms, CPU {cpu_ms:.1f} ms; against f64 "
        f"(loss, grad, of scale): card {errs['card'][0]:.2e}, "
        f"{errs['card'][1]:.2e}; CPU {errs['cpu'][0]:.2e}, "
        f"{errs['cpu'][1]:.2e} (card <= 2x CPU + 1e-7) ({card})")
    if any(c > 2 * r + 1e-7 for c, r in zip(errs["card"], errs["cpu"])):
        raise AssertionError(f"weights: transducer {errs}")
    log(f"weights: StageTimer.report() ({card}):\n" + timer.report())
    log("weights: peak memory above the phase's resident tensors: "
        + ", ".join(f"{k[:-9]} {v:.3f} GiB" for k, v in nums.items()
                    if k.endswith("_peak_gib")) + f" ({card})")
    return nums


def phase_weights(card, device, files):
    """Phase 24: the weight-conversion and export CLIs (`python -m
    ghost_tpu_torch.cli.convert`, `cli.export`) on the card and the
    single-card remainder of the port: (a) convert every --kind, each
    msgpack bridged and run on the card against the `.pth` tree (K1 in
    the converted generator); (b) Landmark106Det against the MXNet graph
    interpreter; (c) FANAWL; (d) onnx and pt2 exports; (e) masks, the
    margin head, colour, quality, profiling, RNNs and the transducer.
    Returns the runs' counts (K1 in the converted generator only) and
    the numbers."""
    import torch

    t0 = time.perf_counter()
    d = f"{files['dir']}/weights24"
    Path(d).mkdir()
    kinds, symbol = weights_files(d, files, card)
    counts, secs, outs = _weights_convert(card, device, kinds, d)
    nums = {"convert_s": secs}
    nums.update(_weights_landmark_fan(card, device, outs, symbol, kinds))
    zero_counts()
    export_nums, pt2 = _weights_export(card, device, files, d)
    nums.update(export_nums)
    nums.update(_weights_rest(card, device, outs, pt2, d))
    counts["export and the rest"] = read_counts()
    del pt2
    torch.cuda.empty_cache()
    if any(counts["export and the rest"].values()):
        raise AssertionError(f"weights: launches {counts}")
    log(f"weights: phase 24 in {time.perf_counter() - t0:.1f} s; convert "
        f"seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f"; K1 launches in the converted generator's two passes "
        f"{counts['convert aei']['aad_modulate']}, S2 in SRVGG x4v3's "
        f"{counts['convert srvgg']['conv3x3']} ({card})")
    return counts, nums


# ---------------------------------------------------------------------------
# The parallel layer (phase 25)
# ---------------------------------------------------------------------------


def _timed(fn, iters=None):
    """fn() run `iters` (PARALLEL["iters"]) times, each synced: (median
    ms, peak GiB over the runs, the last result)."""
    import torch

    iters = iters or PARALLEL["iters"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts = []
    for _ in range(iters):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return (sorted(ts)[len(ts) // 2],
            torch.cuda.max_memory_allocated() / 2 ** 30, out)


def _counted(fn, iters=None):
    """`_timed` with every launch count zeroed first: (ms, peak, result,
    the counts of the `iters` calls)."""
    zero_counts()
    ms, peak, out = _timed(fn, iters)
    return ms, peak, out, read_counts()


def _par_attention(card, device, devices):
    """(a1) ring_attention and MultiheadAttention(seq_mesh) at the train
    cell's shape (phase 8: x (8, 4096, 512), 8 heads of 64, causal), four
    logical shards. ring_attention against attention_reference on the
    same inputs: f32 within 1e-5, bf16 within 2^-7 of the output's
    largest value (each side rounds once to bf16). The MHA (norm_add)
    with seq_mesh against the same module's local core (K2 on the card):
    f32 within 1e-4; bf16 held to the f32 local output within 2x the
    local core's own bf16 error + 1e-3. K2 launches: 1 per local call, 0
    with seq_mesh (bypassed, as in JAX)."""
    import torch

    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.nn.modules import MultiheadAttention
    from ghost_tpu_torch.parallel.sp import (attention_reference,
                                             make_seq_mesh, ring_attention)

    c = TRAIN
    b, s, h, dh = c["batch"], c["seq"], c["heads"], c["head_dim"]
    mesh = make_seq_mesh(PARALLEL["shards"], devices)
    gen = torch.Generator(device).manual_seed(25)
    runs, ok = {}, True
    with torch.inference_mode():
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = (torch.randn(b, s, h, dh, generator=gen, device=device)
                       .to(dt) for _ in range(3))
            ms, peak, out, counts = _counted(lambda: ring_attention(
                q, k, v, mesh=mesh, causal=True))
            ref_ms, _, ref = _timed(lambda: attention_reference(
                q, k, v, causal=True), 1)
            err = float((out.float() - ref.float()).abs().max())
            bound = 1e-5 if dt == torch.float32 else \
                2 ** -7 * float(ref.float().abs().max())
            good = err <= bound and out.dtype == dt
            ok &= good
            runs[f"ring_{name}"] = counts
            log(f"parallel (a) ring_attention {name} ({b}, {s}, {h}, {dh}) "
                f"causal over {PARALLEL['shards']} shards: {ms:.2f} ms "
                f"(attention_reference {ref_ms:.2f} ms), peak {peak:.2f} "
                f"GiB, max |ring - reference| {err:.3e} (bound "
                f"{bound:.3e}): {good} ({card})")
            del q, k, v, out, ref
        x = torch.randn(b, s, h * dh, generator=gen, device=device)
        wgen = torch.Generator(device).manual_seed(26)
        local32 = None
        for name, pol in (("f32", FULL_PRECISION), ("bf16", DEFAULT_POLICY)):
            wgen.manual_seed(26)
            mha = init_weights(MultiheadAttention(
                h * dh, h, dh, causal=True, norm_add=True, policy=pol,
                device=device), wgen)
            l_ms, l_peak, local, l_counts = _counted(lambda: mha(x))
            mha.seq_mesh = mesh
            s_ms, s_peak, sharded, s_counts = _counted(lambda: mha(x))
            runs[f"mha_local_{name}"], runs[f"mha_seq_{name}"] = (l_counts,
                                                                  s_counts)
            iters = PARALLEL["iters"]
            if name == "f32":
                local32 = local.float()
                err = float((sharded.float() - local32).abs().max())
                bound, what = 1e-4, "against the local core"
            else:
                err = float((sharded.float() - local32).abs().max())
                own = float((local.float() - local32).abs().max())
                bound, what = 2 * own + 1e-3, (
                    f"against the f32 local core (the bf16 local core's own "
                    f"error {own:.3e})")
            good = (err <= bound and l_counts["flash_attention_fwd"] == iters
                    and s_counts["flash_attention_fwd"] == 0)
            ok &= good
            log(f"parallel (a) MultiheadAttention {name} (8 x 64, causal, "
                f"norm_add) on x {tuple(x.shape)}: local core {l_ms:.2f} ms "
                f"(peak {l_peak:.2f} GiB, K2 fwd launches "
                f"{l_counts['flash_attention_fwd']}), seq_mesh "
                f"{s_ms:.2f} ms (peak {s_peak:.2f} GiB, K2 fwd launches "
                f"{s_counts['flash_attention_fwd']}); max diff {err:.3e} "
                f"{what}, bound {bound:.3e}: {good} ({card})")
            del mha, local, sharded
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("parallel (a): ring attention")
    return runs


def _par_moe(card, device, devices):
    """(a2) moe_apply_expert_parallel over four logical shards (2 experts
    each) against the dense moe_apply, f32: the same per-expert sums
    added in another order, within 1e-5 of the output's largest value."""
    import torch

    from ghost_tpu_torch.nn.moe import init_moe_params, moe_apply
    from ghost_tpu_torch.parallel.ep import (make_expert_mesh,
                                             moe_apply_expert_parallel,
                                             shard_expert_params)

    c = PARALLEL["moe"]
    gen = torch.Generator(device).manual_seed(27)
    p = init_moe_params(gen, c["d_model"], c["hidden"], c["experts"],
                        device=device)
    x = torch.randn(c["tokens"], c["d_model"], generator=gen, device=device)
    mesh = make_expert_mesh(PARALLEL["shards"], devices)
    placed = shard_expert_params(p, mesh)
    with torch.inference_mode():
        d_ms, d_peak, ref = _timed(lambda: moe_apply(p, x, c["top_k"]))
        ms, peak, out, counts = _counted(lambda: moe_apply_expert_parallel(
            placed, x, mesh=mesh, top_k=c["top_k"]))
    err = float((out - ref).abs().max())
    bound = 1e-5 * float(ref.abs().max())
    log(f"parallel (a) moe_apply_expert_parallel f32, d_model "
        f"{c['d_model']}, hidden {c['hidden']}, {c['experts']} experts top "
        f"{c['top_k']}, {c['tokens']} tokens over {PARALLEL['shards']} "
        f"shards: {ms:.2f} ms (peak {peak:.2f} GiB), dense moe_apply "
        f"{d_ms:.2f} ms (peak {d_peak:.2f} GiB); max diff {err:.3e} (bound "
        f"{bound:.3e}) ({card})")
    del p, placed, x, ref, out
    torch.cuda.empty_cache()
    if not err <= bound:
        raise AssertionError("parallel (a): MoE")
    return {"moe": counts}


def _par_rrdb(card, device, devices):
    """(a3) rrdb_forward_pipelined on RealESRGAN x4plus (23 blocks, 64/32:
    6 slots a stage over 4 stages, one identity slot) on one enhancer tile
    batch (8, 290, 260, 3) in 4 microbatches, f32 and bf16, against
    net(x). The trunk runs on microbatches of 2, which cuDNN may round
    apart from the batch of 8: the bound is 2x the distance of net(x)
    from the plain forward run on the same microbatches + 1e-6 of the
    output's largest value (exact when cuDNN does not part them)."""
    import torch

    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.models.sr.rrdb import RRDBNet, rrdb_forward_pipelined
    from ghost_tpu_torch.nn.layers import init_weights
    from ghost_tpu_torch.parallel.pp import make_pipe_mesh

    mesh = make_pipe_mesh(PARALLEL["shards"], devices)
    m = PARALLEL["micro"]
    x = torch.rand(*PARALLEL["rrdb_tile"], 3,
                   generator=torch.Generator(device).manual_seed(28),
                   device=device)
    runs, ok = {}, True
    for name, pol in (("f32", FULL_PRECISION), ("bf16", DEFAULT_POLICY)):
        net = init_weights(RRDBNet(policy=pol, device=device),
                           torch.Generator(device).manual_seed(29))
        with torch.inference_mode():
            f_ms, f_peak, full = _timed(lambda: net(x))
            mb = torch.cat([net(c) for c in torch.chunk(x, m)])
            ms, peak, pipe, counts = _counted(lambda: rrdb_forward_pipelined(
                net, x, mesh=mesh, num_microbatches=m))
        top = float(full.float().abs().max())
        yard = float((mb.float() - full.float()).abs().max())
        err = float((pipe.float() - full.float()).abs().max())
        bound = 2 * yard + 1e-6 * top
        good = err <= bound and bool(torch.isfinite(pipe).all())
        ok &= good
        runs[f"rrdb_{name}"] = counts
        log(f"parallel (a) rrdb_forward_pipelined {name}, x4plus 23 blocks "
            f"over {PARALLEL['shards']} stages, {m} microbatches of "
            f"{tuple(x.shape)}: {ms:.1f} ms (peak {peak:.2f} GiB), net(x) "
            f"{f_ms:.1f} ms (peak {f_peak:.2f} GiB); max |pipelined - "
            f"net(x)| {err:.3e}, the microbatched plain forward's "
            f"{yard:.3e}, bound {bound:.3e}: {good} ({card})")
        del net, full, mb, pipe
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("parallel (a): pipelined RRDB")
    return runs


def _par_enhance(card, f):
    """(a4) FaceEnhancer(bg_mesh=...) in `full` mode, rrdb and srvgg, on
    phase 19's chunk of 8 1080p frames (the CLI's bf16 enhancer and the
    templated pipeline's detector), the 32 background tiles over four
    logical shards, against bg_mesh=None: equal bit for bit; S2 1088 a
    chunk with srvgg either way; ms a chunk (one warm call, then one
    timed call each), peak memory."""
    import numpy as np
    import torch

    from ghost_tpu_torch.cli import inference
    from ghost_tpu_torch.core.mesh import make_mesh
    from ghost_tpu_torch.pipeline.enhance import FaceEnhancer
    from ghost_tpu_torch.pipeline.video import read_video

    ef = f["enhance_files"]
    frames = read_video(f["mp4"])[0][:ENHANCE["chunk"]]
    args = inference.build_parser().parse_args(_enhance_argv(f, ef, "face"))
    with _templated_cli() as load:
        pipe = load(args)
    mesh = make_mesh([torch.device("cuda", 0)] * PARALLEL["shards"])
    runs, ok = {}, True
    for mode in ("rrdb", "srvgg"):
        args = inference.build_parser().parse_args(_enhance_argv(f, ef, mode))
        enh = inference.build_enhancer(args, pipe)
        sharded = FaceEnhancer(
            enh.det_mod, enh.gfp_mod, enh.bg_mod, det_size=enh.det_size,
            det_thresh=enh.det_thresh, max_faces=enh.max_faces,
            crop_size=enh.crop_size, bg_tile=enh.bg_tile,
            bg_tile_pad=enh.bg_tile_pad, bg_mesh=mesh)
        enh.enhance(frames)  # warm: the timed calls are one each
        p_ms, p_peak, plain, p_counts = _counted(
            lambda: enh.enhance(frames), 1)
        ms, peak, out, counts = _counted(lambda: sharded.enhance(frames), 1)
        want_s2 = _s2_per_call(enh, frames.shape[1:3])
        good = (np.array_equal(out, plain) and out.shape == frames.shape
                and counts["conv3x3"] == p_counts["conv3x3"] == want_s2)
        ok &= good
        runs[f"enhance_{mode}"] = counts
        log(f"parallel (a) FaceEnhancer full {mode}, bg_mesh over "
            f"{PARALLEL['shards']} shards: {ms:.1f} ms a chunk of "
            f"{len(frames)} 1080p (peak {peak:.2f} GiB), bg_mesh=None "
            f"{p_ms:.1f} ms (peak {p_peak:.2f} GiB); equal bit for bit "
            f"{np.array_equal(out, plain)}; S2 launches {counts['conv3x3']} "
            f"and {p_counts['conv3x3']} (want {want_s2}): {good} ({card})")
        del enh, sharded
    del pipe
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("parallel (a): sharded enhancer")
    return runs


def _par_dp(card, device, d):
    """(b) The data-parallel GAN step at phase 20's full width: batch 16
    split 8 + 8 over two ranks on cuda:0 (gloo, which takes all-reduce and
    broadcast on CUDA tensors; NCCL refuses two ranks on one card),
    spawned from here: synchronised BatchNorm, global losses and ZeRO
    GhostAdam, round_trip (every loss term), f32 then bf16, the masks
    split unevenly across the ranks. The first f32 step is held to the
    single-process step on the global batch on this card with
    `torch_ddp_ranks.compare`'s bounds (beside the single-process step's
    own spread on the reordered batch: 2.5e-2 of G's whole gradient here,
    with cuDNN's deterministic algorithms or without);
    both ranks must end equal bit for bit; bf16's losses finite. Step ms
    per rank, peak memory per process; every kernel count 0 (the path
    runs none of the table's kernels, as phase 20). With two cards or
    more the same again over NCCL, a rank a card."""
    import gc
    import math

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    tp = _tp()
    import torch_ddp_ranks as R

    c = GAN
    batch = R.uneven_batch(c["batch"], seed=0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    single = [R.single_step(c, tp.POLICIES["f32"], "round_trip", b, device)
              for b in (batch, tp.swapped(batch))]
    single_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    setups = [("gloo", str(device))]
    if torch.cuda.device_count() >= 2:
        setups.append(("nccl", "cuda:{rank}"))
    else:
        log("parallel (b) NCCL, one rank a card: needs two cards; this "
            f"machine has {torch.cuda.device_count()}")
    counts, ok = {}, True
    for backend, dev in setups:
        out = Path(d) / f"ranks_{backend}"
        out.mkdir()
        t0 = time.perf_counter()
        res = R.Ranks(PARALLEL["ranks"], str(out), dev, ["dp"],
                      timeout=PARALLEL["dp_timeout"], backend=backend, gan=c,
                      policies=("f32", "bf16"), global_batch=c["batch"],
                      dp_steps=PARALLEL["dp_steps"]).join()
        wall = time.perf_counter() - t0
        k0 = res[0]["dp"]
        moments = R.assemble_moments([r["dp"]["moments"] for r in res])
        good, report = R.compare((k0["metrics"], moments, k0["tensors"]),
                                 *single)
        same = all(torch.equal(t, res[1]["dp"]["tensors"][n])
                   for n, t in k0["tensors"].items())
        finite = all(math.isfinite(v) for r in res
                     for v in r["dp_bf16"]["metrics"].values())
        counts[f"dp_{backend}"] = {k: sum(r["launches"][k] for r in res)
                                   for k in res[0]["launches"]}
        zero = not any(counts[f"dp_{backend}"].values())
        good &= same and finite and zero
        ok &= good
        for pol in ("dp", "dp_bf16"):
            per = "; ".join(
                f"rank {i}: {', '.join(f'{t:.1f}' for t in r[pol]['ms'])} "
                f"ms, peak {r[pol].get('peak_gib', math.nan):.2f} GiB"
                for i, r in enumerate(res))
            log(f"parallel (b) {backend} {PARALLEL['ranks']} ranks on "
                f"{dev}, {'f32' if pol == 'dp' else 'bf16'} round_trip "
                f"G + D steps, batch {c['batch']} split "
                f"{c['batch'] // PARALLEL['ranks']} a rank: {per} ({card})")
        log(f"parallel (b) {backend}: the first f32 step against the "
            f"single-process step on the global batch ({single_s:.1f} s for "
            f"it and its reordered run): {report}; ranks equal bit for bit "
            f"{same}; bf16 losses finite {finite}; launches "
            f"{counts[f'dp_{backend}']}; ranks' wall {wall:.1f} s: {good} "
            f"({card})")
    if not ok:
        raise AssertionError("parallel (b): data-parallel step")
    return counts


def _par_example(card):
    """(a5) `python -m ghost_tpu_torch.examples.swap_example` as a user
    runs it: the random-weight pipeline on the card, a 16-frame 480x640
    video and one image; outputs of the frames' shape, StageTimer's
    report."""
    import numpy as np

    from ghost_tpu_torch.examples import swap_example

    zero_counts()
    t0 = time.perf_counter()
    out, img, report = swap_example.main([])
    wall = time.perf_counter() - t0
    counts = read_counts()
    good = (out.shape == (16, 480, 640, 3) and out.dtype == np.uint8
            and img.shape == (480, 640, 3))
    log(f"parallel (a) examples/swap_example.py: {wall:.1f} s with the "
        f"build; outputs {out.shape} {img.shape}; StageTimer: "
        f"{' | '.join(report.splitlines())}; launches {counts}: {good} "
        f"({card})")
    if not good:
        raise AssertionError("parallel (a): swap example")
    return {"swap_example": counts}


def phase_parallel(card, device, files):
    """Phase 25: the parallel layer. (a) the single-controller schedules
    on four logical shards of cuda:0 at full width (ring attention and
    MultiheadAttention(seq_mesh), expert-parallel MoE, the pipelined
    RRDB trunk, the sharded enhancer); (b) the data-parallel step on two
    ranks. Returns each run's launch counts."""
    t0 = time.perf_counter()
    devices = [device] * PARALLEL["shards"]
    runs = _par_attention(card, device, devices)
    runs.update(_par_moe(card, device, devices))
    runs.update(_par_rrdb(card, device, devices))
    runs.update(_par_enhance(card, files))
    runs.update(_par_example(card))
    runs.update(_par_dp(card, device, files["dir"]))
    log(f"parallel: phase 25 in {time.perf_counter() - t0:.1f} s ({card})")
    return runs


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
    with tempfile.TemporaryDirectory() as d:
        files = cli_files(d)
        files["kept"] = f"{d}/kept"  # checkpoints phase 24 converts
        Path(files["kept"]).mkdir()
        cli = phase_cli(card, files)
        routes = phase_routes(card, files)
        enhance, enhance_cli = phase_enhance(card, files, cli)
        cli.update(enhance_cli)
        phase_gan(device, card)
        train_cli = phase_train_cli(card, files)
        distill, extras = phase_distill(card, files)
        sr_masks, _ = phase_sr_masks(card, device, files["kept"])
        weights, _ = phase_weights(card, device, files)
        parallel = phase_parallel(card, device, files)
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
                           if k in st},
                        # the launches of each CLI run (phases 17-19) and
                        # of the enhancer's chunk runs (phase 19)
                        **{key: {run: c[name] for run, c in runs.items()}
                           for key, runs in (("cli_launches", cli),
                                             ("route_launches", routes),
                                             ("enhance_launches", enhance))
                           if any(c[name] for c in runs.values())},
                        # each train CLI run of phase 21 (all 0)
                        "train_cli_launches": {run: c[name] for run, c
                                               in train_cli.items()},
                        # each distillation run of phase 22 (S2 only)
                        # and each auxiliary-trainer run (all 0)
                        "distill_launches": {run: c[name] for run, c
                                             in distill.items()},
                        "train_extras_launches": {run: c[name] for run, c
                                                  in extras.items()},
                        # each SR-training, mask-target and
                        # preprocessing run of phase 23 (all 0)
                        "sr_masks_launches": {run: c[name] for run, c
                                              in sr_masks.items()},
                        # each convert run of phase 24 (K1 in the
                        # converted generator) and its exports and rest
                        "weights_launches": {run: c[name] for run, c
                                             in weights.items()},
                        # each schedule of phase 25 (a) (K2 in the local
                        # MHA core, S2 in the srvgg tiles) and the
                        # data-parallel ranks of (b), summed over ranks
                        "parallel_launches": {run: c[name] for run, c
                                              in parallel.items()}})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
