"""Training CLI on the card: the reference's training regimes behind one
entry point, mirroring `ghost_tpu/cli/train.py`.

Flag parity with the JAX CLI (and through it with reference
train.py:554-616 and the train-self / train-roundtrip variants), selected
by --mode:

  canonical    GHOST GAN losses (utils/training/losses.py:14-67)
  distill      inswapper teacher distillation (train.py): --teacher_onnx
               on the port's ONNX executor; --teacher_upsample puts its
               output through LIPSPADE (--sr_path)
  self         self-distillation from a frozen AEI teacher (train-self.py)
  roundtrip    adds the round-trip loss (train-roundtrip.py)

It reads the reference's `.pth` G, D and ArcFace through the port's
converters, FAN from the JAX package's msgpack (--fan_path), and a
directory of face crops through `data/datasets.py` and the threaded
`data/loader.py`; the step, loop, checkpoints and preemption guard are
`train/`'s. A `--run_name` directory of the JAX CLI's orbax steps is
not read: the port's checkpoints are its own (`core/checkpoint.py`),
and a run there starts fresh with a warning.

Where the port departs from the JAX CLI:
  * roundtrip takes the frozen AEI teacher of self (--teacher_path, else
    G's starting weights): the JAX CLI gives that mode no teacher, and
    its step then stops at the first batch on the missing `teacher_y`;
  * --max_steps_per_process (the JAX CLI's chain of child processes, a
    workaround for a remote TPU client's host-memory growth) parses, and
    a nonzero value stops before any weight is read;
  * random weights are drawn from torch.Generators seeded as JAX's keys
    (0 for G, D and ArcFace, 1 for FAN, 2 for the SR model), not JAX's
    values.

Usage (on a machine with a CUDA card):
    python -m ghost_tpu_torch.cli.train --dataset_path /data/celeba \
        --mode canonical --batch_size 8

`main(argv, device="cpu")` runs on the CPU (tests); the command line
always runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import os

import torch

from ghost_tpu_torch.cli import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ghost_tpu_torch training")
    # reference flags (train.py:554-616)
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--G_path", default="", help="pretrained G (torch .pth or ckpt dir)")
    p.add_argument("--D_path", default="")
    p.add_argument("--teacher_path", default="", help="frozen AEI teacher for --mode self")
    p.add_argument("--teacher_onnx", default="", help="inswapper_128.onnx for --mode distill")
    p.add_argument("--arcface_path", default="weights/backbone.pth")
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--lr_G", default=4e-4, type=float)
    p.add_argument("--lr_D", default=4e-4, type=float)
    p.add_argument("--b1", default=0.0, type=float)
    p.add_argument("--b2", default=0.999, type=float)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--max_epochs", default=2000, type=int)
    p.add_argument("--show_step", default=250, type=int)
    p.add_argument("--save_interval", default=2500, type=int)
    p.add_argument("--run_name", default="ghost", type=str)
    p.add_argument("--output_dir", default="./output", type=str)
    p.add_argument("--backbone", default="unet",
                   choices=["unet", "linknet", "resnet"])
    p.add_argument("--num_blocks", default=2, type=int)
    p.add_argument("--same_person", default=0.2, type=float,
                   help="probability of same-person pairs (1 - same_prob)")
    # the four flags below keep the reference's `type=bool` wart for
    # flag parity (reference train.py:554-603); see cli/inference.py
    p.add_argument("--same_identity", default=False, type=bool,
                   help="reference-parity flag: ANY non-empty value (even 'False') enables; omit to disable")
    p.add_argument("--vgg_dataset", default=False, type=bool,
                   help="per-identity folder layout (VGGFace2); reference-parity flag: ANY non-empty value (even 'False') enables; omit to disable")
    p.add_argument("--celeba", default=False, type=bool,
                   help="reference-parity flag: ANY non-empty value (even 'False') enables; omit to disable")
    p.add_argument("--eye_detector_loss", default=False, type=bool,
                   help="reference-parity flag: ANY non-empty value (even 'False') enables; omit to disable")
    p.add_argument("--pretrained", default=True, type=bool,
                   help="load --G_path/--D_path weights (reference "
                        "train.py:512-521); type=bool parity wart: "
                        "pass '' (empty) to disable")
    p.add_argument("--verbose_output", default=False, type=bool,
                   help="print the loss dashboard every iteration "
                        "(reference train.py:602 'More print() when "
                        "training'); parity wart: ANY non-empty value enables")
    p.add_argument("--diff_eq_same", default=False, type=bool,
                   help="accepted for flag parity; dead in the reference "
                        "fork too (train.py:574 parses it, :218/:391 "
                        "hardcode diff_person=ones)")
    p.add_argument("--save_epoch", default=1, type=int,
                   help="accepted for flag parity; dead in the reference "
                        "fork too (train.py:588 parses it, never read — "
                        "use --save_interval)")
    p.add_argument("--scheduler", default=False, type=str2bool,
                   help="StepLR on both optimizers (reference "
                        "train.py:473-508)")
    p.add_argument("--scheduler_step", default=5000, type=int)
    p.add_argument("--scheduler_gamma", default=0.2, type=float)
    # distill-regime switches (reference train.py:276-377,593-601)
    p.add_argument("--teacher_fine_tune", default=False, type=str2bool,
                   help="distill: optimize the teacher residual only, "
                        "x1000 (reference train.py:375-377)")
    p.add_argument("--teacher_inner_crop", default=False, type=str2bool,
                   help="distill: teacher residual on the central face "
                        "crop (reference train.py:277-291)")
    p.add_argument("--teacher_lower_signal", default=False, type=str2bool,
                   help="distill: fixed low teacher/id_hq/multi-round "
                        "multipliers (reference train.py:346-349)")
    p.add_argument("--without_teacher_loss", default=False, type=str2bool,
                   help="distill: drop teacher/id_hq/eyes terms "
                        "(reference train.py:340-344)")
    p.add_argument("--teacher_upsample", default=False, type=str2bool,
                   help="distill: enhance teacher outputs with the SR "
                        "upscaler before the residual (reference "
                        "train.py:228-229 via GFPGAN/RealESRGAN; "
                        "natively LIPSPADE --sr_path)")
    p.add_argument("--sr_path", default="",
                   help="LIPSPADE weights for --teacher_upsample "
                        "(converted 10_net_G.pth or msgpack; empty = "
                        "random, smoke only)")
    p.add_argument("--sr_ngf", default=48, type=int)
    # CelebA-mode filters (reference train.py:597-600, Dataset.py:169-283)
    p.add_argument("--fine_tune_filter", default=None, type=str)
    p.add_argument("--into_data_path", default=None, type=str)
    p.add_argument("--only_attractive", default=False, type=str2bool)
    p.add_argument("--normalize_training_images", default=False,
                   type=str2bool)
    p.add_argument("--fan_path", default="", help="FAN weights (msgpack)")
    p.add_argument("--fan_stacks", default=4, type=int,
                   help="FAN hourglass stacks (4 = reference WFLW_4HG)")
    p.add_argument("--weight_adv", default=1.0, type=float)
    p.add_argument("--weight_attr", default=10.0, type=float)
    p.add_argument("--weight_id", default=15.0, type=float)
    p.add_argument("--weight_rec", default=10.0, type=float)
    p.add_argument("--weight_eyes", default=0.0, type=float)
    p.add_argument("--mode", default="canonical",
                   choices=["canonical", "distill", "self", "roundtrip"])
    p.add_argument("--d_interval", default=10, type=int)
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--max_steps", default=None, type=int)
    p.add_argument("--max_steps_per_process", default=0, type=int,
                   help="the JAX CLI's chain of child processes of at most "
                        "N steps each; not ported: a nonzero value stops "
                        "before training (0 = off)")
    p.add_argument("--bf16", default=True, type=str2bool)
    p.add_argument("--resume", default=True, type=str2bool,
                   help="auto-resume from the run_name checkpoint dir "
                        "when it holds a step (exact: full train state "
                        "incl. optimizer moments). --resume 0 starts "
                        "fresh; use a new --run_name to keep the old "
                        "snapshots (saves at or below the dir's latest "
                        "step are skipped)")
    p.add_argument("--width", default=1.0, type=float)
    p.add_argument("--arcface_depth", default="iresnet100",
                   choices=["iresnet34", "iresnet50", "iresnet100", "tiny"],
                   help="'tiny' is for smoke tests only")
    return p


def _seeded(model, seed: int):
    """`init_weights` on a torch.Generator seeded with `seed` (a model
    with no checkpoint)."""
    from ghost_tpu_torch.nn.layers import init_weights

    return init_weights(model, torch.Generator().manual_seed(seed))


def _present_leaves(module, tree):
    """The leaves of a flax variables tree whose layer `module` has: flax's
    apply reads those and ignores the rest, so a full-depth ArcFace tree
    drives a shallower IResNet through the first blocks of its stages
    (the JAX CLI under --arcface_depth tiny with an existing .pth)."""
    from ghost_tpu_torch.convert.from_jax import _WRAPPERS

    def keep(path):
        names = [p for p in path if p not in _WRAPPERS][:-1]
        try:
            module.get_submodule(".".join(names))
        except AttributeError:
            return False
        return True

    def prune(t, path):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                sub = prune(v, path + (k,))
                if sub:
                    out[k] = sub
            elif keep(path + (k,)):
                out[k] = v
        return out

    return {c: prune(t, ()) for c, t in tree.items()}


def _frozen(model, device):
    """An inference-only model: eval mode, no gradient to its weights,
    cast once to its compute dtype, on `device`."""
    from ghost_tpu_torch.nn.layers import cast_to_compute_dtype

    return cast_to_compute_dtype(model.eval().requires_grad_(False)).to(device)


def main(argv=None, device="cuda") -> None:
    """Parse argv and train on `device` (the card unless the caller asks
    for the CPU; raises without one)."""
    args = build_parser().parse_args(argv)
    if args.max_steps_per_process:
        raise SystemExit(
            "--max_steps_per_process is not ported: the JAX CLI splits a "
            "run into child processes to bound a remote TPU client's "
            "host-memory growth; ghost_tpu_torch trains in one process "
            "(pass 0)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA card; pass device='cpu' to "
                           "train on the CPU")

    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.convert.torch_loader import (
        convert_aei_state_dict, convert_arcface_state_dict,
        convert_discriminator_state_dict, load_torch_checkpoint)
    from ghost_tpu_torch.core.checkpoint import CheckpointManager
    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.data.datasets import (CelebAStyleDataset,
                                               FaceEmbedDataset,
                                               FaceEmbedVGG2Dataset)
    from ghost_tpu_torch.data.loader import PrefetchLoader
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.models.arcface import _DEPTHS, IResNet
    from ghost_tpu_torch.models.discriminator import MultiscaleDiscriminator
    from ghost_tpu_torch.nn.layers import resize
    from ghost_tpu_torch.train.loop import LoopConfig, train_loop
    from ghost_tpu_torch.train.losses import GeneratorLossWeights
    from ghost_tpu_torch.train.preempt import PreemptionGuard
    from ghost_tpu_torch.train.train_step import (TrainStepConfig,
                                                  init_train_state,
                                                  make_train_steps)

    policy = DEFAULT_POLICY if args.bf16 else FULL_PRECISION

    gen = AEINet(backbone=args.backbone, num_blocks=args.num_blocks,
                 policy=policy, train=True, width=args.width)
    if args.pretrained and args.G_path.endswith(".pth"):
        load_flax_variables(gen, convert_aei_state_dict(
            load_torch_checkpoint(args.G_path), args.backbone,
            args.num_blocks))
    else:
        _seeded(gen, 0)

    mode = {"canonical": "canonical", "distill": "distill",
            "self": "self_distill", "roundtrip": "round_trip"}[args.mode]
    teacher_apply = None
    if mode in ("self_distill", "round_trip"):
        t_gen = AEINet(backbone=args.backbone, num_blocks=args.num_blocks,
                       policy=policy, train=False, width=args.width)
        if args.teacher_path:
            load_flax_variables(t_gen, convert_aei_state_dict(
                load_torch_checkpoint(args.teacher_path), args.backbone,
                args.num_blocks))
        else:
            t_gen.load_state_dict(gen.state_dict())  # G's starting weights
        t_gen = _frozen(t_gen, device)
        teacher_apply = lambda xt, z: t_gen(xt, z)[0]  # noqa: E731

    disc = MultiscaleDiscriminator(n_layers=5, num_D=3, norm="instance",
                                   policy=policy)
    if args.pretrained and args.D_path.endswith(".pth"):
        load_flax_variables(disc, convert_discriminator_state_dict(
            load_torch_checkpoint(args.D_path), num_D=3, n_layers=5))
    else:
        _seeded(disc, 0)

    arc_layers = (1, 1, 1, 1) if args.arcface_depth == "tiny" \
        else _DEPTHS[args.arcface_depth]
    arc = IResNet(layers=arc_layers, policy=policy)
    if args.arcface_path and args.arcface_path.endswith(".pth") and \
            os.path.exists(args.arcface_path):
        # as the JAX CLI: read whatever --arcface_depth says, through the
        # converter's default (iresnet100) depth
        tree = convert_arcface_state_dict(
            load_torch_checkpoint(args.arcface_path))
        load_flax_variables(arc, _present_leaves(arc, tree))
    else:
        print("WARNING: random ArcFace weights")
        _seeded(arc, 0)
    arc = _frozen(arc, device)

    step_cfg = TrainStepConfig(
        lr_g=args.lr_G, lr_d=args.lr_D, b1=args.b1, b2=args.b2,
        weight_decay=args.weight_decay, d_interval=args.d_interval,
        mode=mode, eye_loss=args.eye_detector_loss,
        scheduler=args.scheduler, scheduler_step=args.scheduler_step,
        scheduler_gamma=args.scheduler_gamma,
        teacher_inner_crop=args.teacher_inner_crop,
        teacher_fine_tune=args.teacher_fine_tune,
        teacher_lower_signal=args.teacher_lower_signal,
        without_teacher_loss=args.without_teacher_loss,
    )
    weights = GeneratorLossWeights(
        adv=args.weight_adv, attr=args.weight_attr, id=args.weight_id,
        rec=args.weight_rec, eyes=args.weight_eyes,
    )

    fan_apply = None
    if args.eye_detector_loss:
        # reference train.py:483-501: FAN(4, 98) eye detector (WFLW_4HG
        # weights via --fan_path msgpack; random = smoke mode); frozen,
        # eval BatchNorm: the eye loss's gradient reaches its input only
        from ghost_tpu_torch.models.fan import FAN

        fan = FAN(num_stacks=args.fan_stacks, policy=policy)
        if args.fan_path:
            from ghost_tpu_torch.core.checkpoint import load_msgpack

            load_flax_variables(fan, load_msgpack(args.fan_path))
        else:
            print("WARNING: random FAN weights (--fan_path not given)")
            _seeded(fan, 1)
        fan = _frozen(fan, device)
        fan_apply = lambda x01: fan(x01)[-1]  # noqa: E731

    g_step, d_step = make_train_steps(arc, step_cfg, weights,
                                      teacher_apply=teacher_apply,
                                      fan_apply=fan_apply)
    state = init_train_state(gen, disc, step_cfg, device=device)

    if args.celeba:
        ds = CelebAStyleDataset(
            args.dataset_path, fine_tune_filter=args.fine_tune_filter,
            into_data_path=args.into_data_path,
            only_attractive=args.only_attractive,
            normalize_pm1=args.normalize_training_images)
    elif args.vgg_dataset:
        ds = FaceEmbedVGG2Dataset(args.dataset_path,
                                  same_prob=1 - args.same_person,
                                  same_identity=args.same_identity)
    else:
        ds = FaceEmbedDataset([args.dataset_path],
                              same_prob=1 - args.same_person)
    loader = PrefetchLoader(ds, args.batch_size, num_workers=args.num_workers)

    def with_embeds(batches):
        # the source embedding at area 112, left on the device: the host
        # does not wait on it
        for b in batches:
            with torch.no_grad():
                x = torch.as_tensor(b["xs_arcface"], device=device)
                b["xs_arcface"] = x
                b["embed"] = arc(resize(x, (112, 112), method="area"))
            yield b

    teacher = None
    if mode == "distill":
        from ghost_tpu_torch.train.distill import build_inswapper_teacher

        teacher = build_inswapper_teacher(args.teacher_onnx, device=device)
        if args.teacher_upsample:
            from ghost_tpu_torch.models.sr.generator import LIPSPADEGenerator
            from ghost_tpu_torch.train.distill import UpsampledTeacher
            from ghost_tpu_torch.train.extra_trainers import (
                load_lipspade_vars, sr_upscale_apply)

            sr = load_lipspade_vars(
                LIPSPADEGenerator(ngf=args.sr_ngf, policy=policy),
                args.sr_path, args.sr_ngf, warn_context="--teacher_upsample")
            teacher = UpsampledTeacher(teacher,
                                       sr_upscale_apply(sr.to(device)))

    def batch_iter():
        # fresh iterator per epoch: a one-shot generator here would
        # silently end training after a single dataset pass
        it = with_embeds(iter(loader))
        if teacher is not None:
            from ghost_tpu_torch.train.distill import TeacherPrefetcher

            it = iter(TeacherPrefetcher(teacher, it))
        return it

    ckpt_dir = (f"{args.run_name}_ckpt" if not args.run_name.startswith("/")
                else args.run_name)
    ckpt = CheckpointManager(ckpt_dir)
    start_iteration = 0
    if ckpt.latest_step() is not None:
        if args.resume:
            # the whole train state (parameters, BN statistics, optimizer
            # moments, the ratchets) and the iteration count: an exact
            # resume, which the reference cannot do (it drops optimizer
            # state, reference train.py:449-456)
            start_iteration = ckpt.latest_step() + 1
            state = ckpt.restore(like=state)
            print(f"resuming from checkpoint step {start_iteration - 1}")
        else:
            print(f"WARNING: --resume 0 with existing checkpoints at "
                  f"step {ckpt.latest_step()}; starting fresh — saves "
                  f"at already-written steps will be skipped")
    elif any(n.isdigit() for n in os.listdir(ckpt.directory)):
        print(f"WARNING: {ckpt.directory} holds the JAX CLI's orbax steps, "
              f"which ghost_tpu_torch does not read; starting fresh")
    loop_cfg = LoopConfig(
        max_epochs=args.max_epochs, d_interval=args.d_interval,
        show_step=args.show_step, save_interval=args.save_interval,
        run_name=args.run_name, distill=(mode != "canonical"),
        output_dir=args.output_dir,
        print_interval=1 if args.verbose_output else 10,
    )
    with PreemptionGuard() as guard:
        state, metrics = train_loop(
            state, g_step, d_step, batch_iter, loop_cfg,
            checkpoint_manager=ckpt, max_steps=args.max_steps,
            preemption=guard, start_iteration=start_iteration)
    print("final:", metrics)


if __name__ == "__main__":
    main()
