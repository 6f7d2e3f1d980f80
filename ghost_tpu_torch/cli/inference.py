"""Reference-compatible swap CLI on the card, mirroring
`ghost_tpu/cli/inference.py`.

Flag-for-flag parity with the JAX CLI (and through it with reference
inference.py:127-151): the same options, defaults, choices and nargs.
It reads the reference's `.pth` checkpoints through the port's own
converters (`convert/torch_loader.py`) and strict bridge
(`convert/from_jax.py`), msgpack detector / landmark / SR weights, and
images and videos through `pipeline/image.py`, `pipeline/video.py` and
the native frame ring (`data/frames.py`).

Usage (on a machine with a CUDA card):
    python -m ghost_tpu_torch.cli.inference --source_paths a.jpg \
        --target_video in.mp4 --out_video_name out.mp4

The reference's own packs load as in the JAX CLI: an `.onnx`
`--arcface_path` (glintr100.onnx) through `models/arcface_onnx.py`, an
`.onnx` `--detector_path` (scrfd_10g_bnkps.onnx) through
`models/scrfd_onnx.py`, both on the port's ONNX executor
(`convert/onnx_exec.py`), and an mmdet `.pth` `--detector_path`
(model_25GF.pth) as `models/scrfd_v1e.py:SCRFDV1e` through
`convert_scrfd_state_dict`.

`--enhance_output face|full` runs the enhancer post-pass
(`pipeline/enhance.py`: GFPGANv1Clean on every detected face, with
`full` over a tiled x4 background, `--bg_model rrdb` RealESRGAN_x4plus or
`srvgg` realesr-general-x4v3) on the pipeline's detector, as the JAX CLI
does.

`main(argv, device="cpu")` runs on the CPU (tests); the command line
always runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ghost_tpu_torch.cli import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ghost_tpu_torch face swap")
    p.add_argument("--G_path", default="weights/G_unet_2blocks.pth")
    p.add_argument("--backbone", default="unet", const="unet", nargs="?",
                   choices=["unet", "linknet", "resnet"])
    p.add_argument("--num_blocks", default=2, type=int)
    p.add_argument("--batch_size", default=40, type=int)
    p.add_argument("--crop_size", default=224, type=int)
    # --use_sr / --image_to_image keep the reference's `type=bool` wart
    # for flag parity (reference inference.py:102,107: any non-empty
    # string, including "False", parses as True); the extra flags below
    # use str2bool instead. The warning in help= is deliberate.
    p.add_argument("--use_sr", default=False, type=bool,
                   help="reference-parity flag: ANY non-empty value "
                        "(even 'False') enables; omit to disable")
    p.add_argument("--similarity_th", default=0.15, type=float)
    p.add_argument("--source_paths", default=[], nargs="+")
    p.add_argument("--target_faces_paths", default=[], nargs="+")
    p.add_argument("--target_video", default="", type=str)
    p.add_argument("--out_video_name", default="result.mp4", type=str)
    p.add_argument("--image_to_image", default=False, type=bool,
                   help="reference-parity flag: ANY non-empty value "
                        "(even 'False') enables; omit to disable")
    p.add_argument("--target_image", default="", type=str)
    p.add_argument("--out_image_name", default="result.png", type=str)
    # extras of the JAX CLI
    p.add_argument("--streaming", default=True, type=str2bool,
                   help="constant-memory decode->swap->encode streaming")
    p.add_argument("--smooth", default=True, type=str2bool,
                   help="temporal keypoint smoothing (reference parity). "
                        "Off = fused detect->swap per chunk (stills are "
                        "always fused)")
    p.add_argument("--arcface_path", default="weights/backbone.pth")
    p.add_argument("--detector_path", default="", help="SCRFD weights (msgpack)")
    p.add_argument("--landmark_path", default="", help="landmark weights (msgpack)")
    p.add_argument("--sr_path", default="", help="SR generator weights")
    p.add_argument("--sr_model", default="lipspade",
                   choices=["lipspade", "srvgg_student"],
                   help="--use_sr seat: lipspade = the reference's SR "
                        "generator on every swapped crop; srvgg_student = "
                        "a distilled SRVGG student (cli/distill_enhancer "
                        "output). Student hyperparams are inferred from "
                        "the --sr_path checkpoint shapes; without "
                        "--sr_path the bundled round-5 weights are used "
                        "(assets/srvgg_student_x2_r05.msgpack)")
    p.add_argument("--bf16", default=True, type=str2bool)
    p.add_argument("--allow_random_weights", default=False, type=str2bool,
                   help="run without checkpoints (smoke tests / demos)")
    p.add_argument("--width", default=1.0, type=float,
                   help="AEI channel multiplier (1.0 = reference)")
    p.add_argument("--arcface_depth", default="iresnet100",
                   choices=["iresnet34", "iresnet50", "iresnet100", "tiny"])
    p.add_argument("--det_size", default=640, type=int)
    p.add_argument("--enhance_output", default="none",
                   choices=["none", "face", "full"],
                   help="post-enhance outputs: 'face' = GFPGAN restore "
                        "on detected faces, 'full' = + Real-ESRGAN "
                        "background (reference upsample(), "
                        "utils/training/upsampler.py:92-106)")
    p.add_argument("--gfpgan_path", default="",
                   help="GFPGANv1Clean weights (.pth)")
    p.add_argument("--bg_upsampler_path", default="",
                   help="background upsampler weights (.pth)")
    p.add_argument("--bg_model", default="rrdb", choices=["rrdb", "srvgg"],
                   help="background upsampler family: rrdb = "
                        "RealESRGAN_x4plus (the reference's "
                        "get_bg_upsampler), srvgg = realesr-general-x4v3 "
                        "(the fast model its Dockerfile also ships)")
    return p


def bundled_student_ckpt() -> str | None:
    """Path of the shipped round-5 seat-student weights
    (assets/srvgg_student_x2_r05.msgpack), or None when running from an
    installation without the repo assets tree."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "assets", "srvgg_student_x2_r05.msgpack")
    return path if os.path.exists(path) else None


def _seeded(model):
    """`init_weights` on a torch.Generator seeded with 0 (a model with no
    checkpoint; not the JAX CLI's `jax.random.key(0)` values)."""
    from ghost_tpu_torch.nn.layers import init_weights

    return init_weights(model, torch.Generator().manual_seed(0))


def build_enhancer(args, pipe):
    """The optional GFPGAN (+ background) post-pass sharing the
    pipeline's detector, on the pipeline's device; None for
    `--enhance_output none`.

    A converted GFPGANv1.4 tree carries `toRGB_*` and style-MLP leaves
    that the serving module does not read; `drop_unread_leaves` removes
    them (and only them) before the strict bridge."""
    if args.enhance_output == "none":
        return None
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.torch_loader import (
        convert_gfpgan_state_dict, convert_rrdbnet_state_dict,
        convert_srvgg_state_dict, load_torch_checkpoint)
    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.models.sr.gfpgan import (GFPGANClean,
                                                  drop_unread_leaves)
    from ghost_tpu_torch.models.sr.rrdb import RRDBNet
    from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact
    from ghost_tpu_torch.nn.layers import cast_to_compute_dtype
    from ghost_tpu_torch.pipeline.enhance import FaceEnhancer

    policy = DEFAULT_POLICY if args.bf16 else FULL_PRECISION
    gfp = GFPGANClean(policy=policy)
    if os.path.exists(args.gfpgan_path):
        gfp_vars, _ = drop_unread_leaves(convert_gfpgan_state_dict(
            load_torch_checkpoint(args.gfpgan_path)), gfp)
        load_flax_variables(gfp, gfp_vars)
    elif args.allow_random_weights:
        print("WARNING: random GFPGAN weights (--gfpgan_path not given)")
        _seeded(gfp)
    else:
        raise SystemExit(f"missing --gfpgan_path {args.gfpgan_path!r}")
    bg = None
    if args.enhance_output == "full":
        if args.bg_model == "srvgg":
            convert_bg = convert_srvgg_state_dict
            bg = SRVGGNetCompact(policy=policy)
        else:
            convert_bg = convert_rrdbnet_state_dict
            bg = RRDBNet(policy=policy)
        if os.path.exists(args.bg_upsampler_path):
            load_flax_variables(bg, convert_bg(
                load_torch_checkpoint(args.bg_upsampler_path)))
        elif args.allow_random_weights:
            print(f"WARNING: random {args.bg_model} weights "
                  "(--bg_upsampler_path not given)")
            _seeded(bg)
        else:
            raise SystemExit(
                f"missing --bg_upsampler_path {args.bg_upsampler_path!r}")
        bg = cast_to_compute_dtype(bg.to(pipe.device).eval())
    gfp = cast_to_compute_dtype(gfp.to(pipe.device).eval())
    return FaceEnhancer(pipe.det_mod, gfp, bg, det_size=args.det_size)


def load_pipeline(args, device="cuda"):
    """The swap pipeline of `args` on `device` (the card by default;
    raises without one, so a CPU run asks for device="cpu").

    AEI-Net is built with fused_aad=True (inference: every AADLayer runs
    the fused AAD kernel on the card). A model without a checkpoint gets
    random weights (with --allow_random_weights for the generator and
    ArcFace): `init_weights` on a torch.Generator seeded with 0 for each
    model. Those values differ from the JAX CLI's `jax.random.key(0)`
    draws; weights read from files are the same as the JAX CLI's. The
    ONNX adapters compute in f32 whatever `--bf16` says, as in JAX."""
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.torch_loader import (
        convert_aei_state_dict, convert_arcface_state_dict,
        convert_scrfd_state_dict, load_torch_checkpoint)
    from ghost_tpu_torch.core.checkpoint import load_msgpack
    from ghost_tpu_torch.core.precision import (DEFAULT_POLICY,
                                                FULL_PRECISION, disable_tf32)
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.models.arcface import _DEPTHS, IResNet
    from ghost_tpu_torch.models.arcface_onnx import ArcFaceOnnx
    from ghost_tpu_torch.models.landmark import Landmark106
    from ghost_tpu_torch.models.scrfd import SCRFD
    from ghost_tpu_torch.models.scrfd_onnx import SCRFDOnnx
    from ghost_tpu_torch.models.scrfd_v1e import SCRFDV1e
    from ghost_tpu_torch.nn.layers import cast_to_compute_dtype
    from ghost_tpu_torch.pipeline.swap import SwapConfig, SwapPipeline

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("load_pipeline: no CUDA card; pass "
                               "device='cpu' to run on the CPU")
        disable_tf32()

    policy = DEFAULT_POLICY if args.bf16 else FULL_PRECISION
    cfg = SwapConfig(
        crop_size=args.crop_size,
        similarity_th=args.similarity_th,
        chunk_size=args.batch_size,
        use_sr=bool(args.use_sr),
        det_size=args.det_size,
    )

    gen = AEINet(backbone=args.backbone, num_blocks=args.num_blocks,
                 policy=policy, width=args.width, fused_aad=True)
    if os.path.exists(args.G_path):
        load_flax_variables(gen, convert_aei_state_dict(
            load_torch_checkpoint(args.G_path), backbone=args.backbone,
            num_blocks=args.num_blocks))
    elif args.allow_random_weights:
        print("WARNING: random generator weights")
        _seeded(gen)
    else:
        raise SystemExit(f"missing --G_path {args.G_path!r} "
                         "(pass --allow_random_weights 1 for a smoke run)")

    arc_layers = (1, 1, 1, 1) if args.arcface_depth == "tiny" \
        else _DEPTHS[args.arcface_depth]
    if args.arcface_path.endswith(".onnx"):
        # insightface recognition pack (glintr100.onnx) on the ONNX
        # executor, whatever --arcface_depth says
        arc = ArcFaceOnnx(args.arcface_path, device=device)
    else:
        arc = IResNet(layers=arc_layers, policy=policy)
        # as in the JAX CLI, --arcface_depth tiny ignores --arcface_path
        # and takes random weights
        if os.path.exists(args.arcface_path) \
                and args.arcface_depth != "tiny":
            load_flax_variables(arc, convert_arcface_state_dict(
                load_torch_checkpoint(args.arcface_path), layers=arc_layers))
        elif args.allow_random_weights:
            print("WARNING: random ArcFace weights")
            _seeded(arc)
        else:
            raise SystemExit(f"missing --arcface_path {args.arcface_path!r}")

    if args.detector_path.endswith(".onnx"):
        # the reference's own detector pack (scrfd_10g_bnkps.onnx) on the
        # ONNX executor
        det = SCRFDOnnx(args.detector_path, input_size=cfg.det_size,
                        device=device)
        if not det.has_kps:
            print("WARNING: detector has no kps branch; alignment needs "
                  "a *_bnkps model")
    elif args.detector_path.endswith(".pth"):
        # mmdet SCRFD checkpoint (e.g. SCRFD-2.5GF model_25GF.pth);
        # boxes only: no kps branch in that family of checkpoints
        det = load_flax_variables(SCRFDV1e(policy=policy),
                                  convert_scrfd_state_dict(
                                      load_torch_checkpoint(
                                          args.detector_path)))
        print("WARNING: SCRFD-2.5GF has no kps branch; alignment keypoints "
              "will be degenerate (detection/boxes only)")
    else:
        det = SCRFD(policy=policy)
        if args.detector_path:
            load_flax_variables(det, load_msgpack(args.detector_path))
        else:
            _seeded(det)
            print("WARNING: random detector weights "
                  "(--detector_path not given)")
    lmk = Landmark106(policy=policy)
    if args.landmark_path:
        load_flax_variables(lmk, load_msgpack(args.landmark_path))
    else:
        _seeded(lmk)
        print("WARNING: random landmark weights (--landmark_path not given)")

    sr = None
    if cfg.use_sr:
        if args.sr_model == "srvgg_student":
            from ghost_tpu_torch.models.sr.srvgg import (SRVGGNetCompact,
                                                         SRVGGStudentSeat,
                                                         srvgg_from_variables)

            sr_path = args.sr_path or bundled_student_ckpt()
            if sr_path:
                if not args.sr_path:
                    print(f"using bundled seat student: {sr_path}")
                sr_vars = load_msgpack(sr_path)
                student = load_flax_variables(
                    srvgg_from_variables(sr_vars, policy=policy), sr_vars)
            else:
                student = _seeded(SRVGGNetCompact(num_feat=32, num_conv=16,
                                                  upscale=2, policy=policy))
                print("WARNING: random SR-student weights "
                      "(--sr_path not given, no bundled checkpoint)")
            sr = SRVGGStudentSeat(student)
        else:
            from ghost_tpu_torch.models.sr.generator import LIPSPADEGenerator

            sr = LIPSPADEGenerator(policy=policy)
            if args.sr_path:
                load_flax_variables(sr, load_msgpack(args.sr_path))
            else:
                _seeded(sr)
                print("WARNING: random SR weights (--sr_path not given)")
        sr = cast_to_compute_dtype(sr.to(device).eval())

    # the ONNX adapters were built on `device` and keep the file's dtypes
    det, arc, gen, lmk = (cast_to_compute_dtype(m.to(device).eval())
                          if isinstance(m, torch.nn.Module) else m
                          for m in (det, arc, gen, lmk))
    return SwapPipeline(det, arc, gen, lmk, config=cfg, sr=sr)


def crop_or_center(pipe, path: str) -> np.ndarray:
    """The best-scored face crop of an image, or its centre crop."""
    from ghost_tpu_torch.pipeline.image import read_image_rgb

    img = read_image_rgb(path)
    crops, _scores = pipe.crop_faces(img)
    if crops.shape[0]:
        return crops[0]
    # reference exits on "Bad source images!" (inference.py:66-68);
    # with random detector weights fall back to a center crop so
    # smoke runs stay usable
    print(f"WARNING: no face found in {path}; using center crop")
    h, w = img.shape[:2]
    side = min(h, w)
    y0, x0 = (h - side) // 2, (w - side) // 2
    import cv2

    sq = img[y0:y0 + side, x0:x0 + side]
    return cv2.resize(sq, (pipe.cfg.crop_size, pipe.cfg.crop_size))


def run(args, pipe) -> None:
    """The CLI's work on a loaded pipeline: the enhancer of
    `--enhance_output` (`build_enhancer`), source (and target) crops,
    then the image or video swap and the enhancer's post-pass, written
    to the output file."""
    from ghost_tpu_torch.pipeline.image import read_image_rgb, write_image_rgb
    from ghost_tpu_torch.pipeline.video import (VideoChunkWriter,
                                                add_audio_from_video,
                                                read_video, video_fps,
                                                write_video)

    enh = build_enhancer(args, pipe)
    post = enh.enhance if enh is not None else (lambda fr: fr)
    print("List of source paths:", args.source_paths)
    sources = np.stack([crop_or_center(pipe, p) for p in args.source_paths])
    targets = None
    if args.target_faces_paths:
        targets = np.stack([crop_or_center(pipe, p)
                            for p in args.target_faces_paths])

    start = time.time()
    if args.image_to_image:
        frame = read_image_rgb(args.target_image)
        result = pipe.swap_image_fused(frame, sources, targets)
        result = post(result[None])[0]
        write_image_rgb(args.out_image_name, result)
        print(f"Swapped Image saved with path {args.out_image_name}")
    elif args.streaming:
        # constant-memory path: decode-thread ring -> stage A/B ->
        # incremental encode (replaces the reference's whole-video-in-RAM
        # read_video, video_processing.py:37-66)
        from ghost_tpu_torch.data.frames import stream_video_chunks

        writer = VideoChunkWriter(args.out_video_name,
                                  video_fps(args.target_video))
        n_out = 0
        for out in pipe.swap_video_stream(
                stream_video_chunks(args.target_video, pipe.cfg.chunk_size),
                sources, targets, smooth=args.smooth):
            writer.write(post(out))
            n_out += out.shape[0]
        writer.close()
        if n_out == 0:
            raise SystemExit(f"no frames decoded from {args.target_video}")
        if add_audio_from_video(args.target_video, args.out_video_name):
            print("audio remuxed")
        print(f"Video saved with path {args.out_video_name} ({n_out} frames)")
    else:
        frames, fps = read_video(args.target_video)
        out = pipe.swap_video_frames(frames, sources, targets,
                                     smooth=args.smooth)
        out = np.concatenate(
            [post(out[i:i + pipe.cfg.chunk_size])
             for i in range(0, out.shape[0], pipe.cfg.chunk_size)]) \
            if enh is not None else out
        write_video(args.out_video_name, out, fps)
        if add_audio_from_video(args.target_video, args.out_video_name):
            print("audio remuxed")
        print(f"Video saved with path {args.out_video_name}")
    print("Total time: ", time.time() - start)


def main(argv=None, device="cuda") -> None:
    """Parse argv, load the pipeline on `device` (the card unless the
    caller asks for the CPU) and run the swap."""
    args = build_parser().parse_args(argv)
    run(args, load_pipeline(args, device))


if __name__ == "__main__":
    main()
