"""Auxiliary trainer CLI on the card: D pretrain, upsampler-in-the-loop
and mask, mirroring `ghost_tpu/cli/train_extras.py` flag for flag.

One entry point for the reference's three standalone trainer scripts,
selected by --mode (the steps are `train/extra_trainers.py`'s):

  discriminator  reference train-discriminator.py:60-199: D alone learns
                 real(Xs) vs fake(G's output), hinge, x1000 (:185); the
                 fakes come from a frozen G (--G_path)
  upsampler      reference train-upsampler.py:45-225: G fine-tuned to
                 match an upscaled copy of its own output (MSE x30000,
                 :110-135) plus the multiscale perceptual colour loss
                 (:91); the upscaler is the LIPSPADE SR generator
                 (--sr_path, the converted 10_net_G.pth)
  mask           reference train-mask.py:236-324: AEI-Net repurposed to
                 predict soft face masks, MSE x10000 against precomputed
                 targets (--mask_source, paired by basename)

Each mode writes `{run_name}_{mode}.msgpack` in the flax layout
(`convert.from_jax.flax_variables`): D's `params`, or G's `params` and
`batch_stats`, which the JAX package's `load_msgpack` and both packages'
`--G_path *.msgpack` routes read.

Where the port departs from the JAX CLI: random weights come from
torch.Generators seeded as JAX's keys (0 for G and ArcFace, 1 for D, 2
for the SR model), not JAX's values; the JAX CLI's persistent XLA
compile cache has no counterpart.

    python -m ghost_tpu_torch.cli.train_extras --mode discriminator \\
        --dataset_path /data/crops --run_name d_pretrain

`main(argv, device="cpu")` runs on the CPU (tests); the command line
always runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import os

import torch

from ghost_tpu_torch.cli import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ghost-tpu auxiliary trainers")
    p.add_argument("--mode", required=True,
                   choices=["discriminator", "upsampler", "mask"])
    # reference-shared flags (train-discriminator.py:283-311,
    # train-upsampler.py:337-358, train-mask.py:455-483)
    p.add_argument("--dataset_path", required=True,
                   help="aligned 256 crops (flat dir)")
    p.add_argument("--G_path", default="", help="pretrained G (torch .pth)")
    p.add_argument("--D_path", default="", help="pretrained D (torch .pth)")
    p.add_argument("--backbone", default="unet",
                   choices=["unet", "linknet", "resnet"])
    p.add_argument("--num_blocks", default=2, type=int)
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--lr", default=4e-4, type=float,
                   help="lr_D (discriminator) / lr_G (upsampler, mask)")
    p.add_argument("--max_epochs", default=2000, type=int)
    p.add_argument("--max_steps", default=None, type=int)
    p.add_argument("--show_step", default=100, type=int)
    p.add_argument("--save_interval", default=2500, type=int)
    p.add_argument("--run_name", default="ghost_extra", type=str)
    p.add_argument("--arcface_path", default="weights/backbone.pth")
    p.add_argument("--arcface_depth", default="iresnet100",
                   choices=["iresnet34", "iresnet50", "iresnet100", "tiny"],
                   help="'tiny' is for smoke tests only")
    p.add_argument("--bf16", default=True, type=str2bool)
    p.add_argument("--width", default=1.0, type=float)
    p.add_argument("--num_workers", default=4, type=int)
    # mode-specific knobs (reference loss multipliers)
    p.add_argument("--loss_mult", default=1000.0, type=float,
                   help="discriminator: hinge multiplier "
                        "(train-discriminator.py:185)")
    p.add_argument("--upsample_mult", default=30000.0, type=float,
                   help="upsampler: MSE multiplier "
                        "(train-upsampler.py:110-135)")
    p.add_argument("--mask_mult", default=10000.0, type=float,
                   help="mask: MSE multiplier (train-mask.py:300-308)")
    p.add_argument("--sr_path", default="",
                   help="upsampler: LIPSPADE weights (converted "
                        "10_net_G.pth .pth or msgpack); empty = random "
                        "(smoke only)")
    p.add_argument("--sr_ngf", default=48, type=int)
    p.add_argument("--mask_source", default="",
                   help="mask: dir of precomputed targets "
                        "(cli/precompute_masks.py output; basename-"
                        "paired .png/.npy)")
    p.add_argument("--allow_random_weights", default=False, type=str2bool,
                   help="permit random G/ArcFace init when a weight "
                        "path is ABSENT (smoke tests only); an "
                        "explicitly given path that does not exist "
                        "always errors")
    return p


_DEFAULT_ARC = "weights/backbone.pth"


def _require_random_ok(args, what: str):
    if not args.allow_random_weights:
        raise SystemExit(
            f"no {what} weights given — a full run on random {what} "
            f"produces a useless checkpoint; pass the weight path, or "
            f"--allow_random_weights 1 for smoke tests")
    print(f"WARNING: random {what} weights (smoke mode)")


def _load_gen(args, policy, train: bool):
    """AEI-Net from --G_path (a torch .pth, or a flax msgpack holding
    `params`, such as this CLI's own output), or random under
    --allow_random_weights; a typo'd path exits."""
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.nn.layers import init_weights

    gen = AEINet(backbone=args.backbone, num_blocks=args.num_blocks,
                 policy=policy, train=train, width=args.width)
    if args.G_path:
        if not os.path.exists(args.G_path):
            raise SystemExit(f"--G_path {args.G_path!r} does not exist")
        if args.G_path.endswith(".pth"):
            from ghost_tpu_torch.convert.torch_loader import (
                convert_aei_state_dict, load_torch_checkpoint)

            tree = convert_aei_state_dict(load_torch_checkpoint(args.G_path),
                                          args.backbone, args.num_blocks)
        else:
            from ghost_tpu_torch.core.checkpoint import load_msgpack

            tree = load_msgpack(args.G_path)
            if "params" not in tree:
                raise SystemExit(
                    f"--G_path {args.G_path!r} has no 'params' tree")
        return load_flax_variables(gen, tree)
    _require_random_ok(args, "G")
    return init_weights(gen, torch.Generator().manual_seed(0))


def _load_arc(args, policy, device):
    """The frozen ArcFace as `x_pm1 -> embedding`, read at an area
    resize to 112. A missing --arcface_path is random weights (with the
    opt-in) only at its default `weights/backbone.pth`; any other
    missing path exits."""
    from ghost_tpu_torch.cli.train import _frozen, _present_leaves, _seeded
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.models.arcface import _DEPTHS, IResNet
    from ghost_tpu_torch.nn.layers import resize

    arc_layers = (1, 1, 1, 1) if args.arcface_depth == "tiny" \
        else _DEPTHS[args.arcface_depth]
    arc = IResNet(layers=arc_layers, policy=policy)
    if os.path.exists(args.arcface_path):
        if args.arcface_path.endswith(".pth"):
            from ghost_tpu_torch.convert.torch_loader import (
                convert_arcface_state_dict, load_torch_checkpoint)

            tree = convert_arcface_state_dict(
                load_torch_checkpoint(args.arcface_path))
        else:
            from ghost_tpu_torch.core.checkpoint import load_msgpack

            tree = load_msgpack(args.arcface_path)
        # flax reads the leaves its depth has and ignores the rest
        load_flax_variables(arc, _present_leaves(arc, tree))
    else:
        if args.arcface_path != _DEFAULT_ARC:
            raise SystemExit(
                f"--arcface_path {args.arcface_path!r} does not exist")
        _require_random_ok(args, "ArcFace")
        _seeded(arc, 0)
    arc = _frozen(arc, device)

    def embed(x):
        with torch.no_grad():
            return arc(resize(x, (112, 112), method="area"))

    return embed


def _epoch_batches(loader, embed_fn, max_epochs: int, device):
    """Each epoch's batches as tensors on `device`, with the source
    embedding; stops at an epoch with no batch."""
    for _ in range(max_epochs):
        empty = True
        for b in loader:
            b = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
            if embed_fn is not None:
                b["embed"] = embed_fn(b["xs_arcface"])
            empty = False
            yield b
        if empty:
            return


def _run_loop(args, out_path, batches, step_once, save_tree):
    """The three modes' loop: show_step prints, save_interval snapshots,
    a SIGTERM latch (`train/preempt.py`) that saves and stops, and a
    final save. step_once(batch) -> printable."""
    from ghost_tpu_torch.core.checkpoint import save_msgpack
    from ghost_tpu_torch.train.preempt import PreemptionGuard

    it = 0
    with PreemptionGuard() as guard:
        for b in batches:
            msg = step_once(b)
            if it % args.show_step == 0:
                print(f"step {it} {msg}")
            it += 1
            if it % args.save_interval == 0:
                save_msgpack(out_path, save_tree())
            if guard.triggered:
                print("train_extras: preemption signal latched — "
                      "saving final state and stopping")
                break
            if args.max_steps is not None and it >= args.max_steps:
                break
    save_msgpack(out_path, save_tree())


def main(argv=None, device="cuda"):
    """Parse argv and train on `device` (the card unless the caller asks
    for the CPU; raises without one)."""
    args = build_parser().parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("train_extras: no CUDA card; pass "
                               "device='cpu' to train on the CPU")
        from ghost_tpu_torch.core.precision import disable_tf32

        disable_tf32()

    from ghost_tpu_torch.cli.train import _frozen, _seeded
    from ghost_tpu_torch.convert.from_jax import (flax_variables,
                                                  load_flax_variables)
    from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from ghost_tpu_torch.data.datasets import (FaceEmbedDataset,
                                               MaskTargetDataset)
    from ghost_tpu_torch.data.loader import PrefetchLoader
    from ghost_tpu_torch.train import extra_trainers as xt

    policy = DEFAULT_POLICY if args.bf16 else FULL_PRECISION
    out_path = f"{args.run_name}_{args.mode}.msgpack"

    if args.mode == "mask" and not args.mask_source:
        raise SystemExit(
            "--mode mask needs --mask_source (precompute targets "
            "with: python -m ghost_tpu.cli.precompute_masks "
            "--input_dir crops/ --output_dir masks/ [--sam_path])")

    gen = _load_gen(args, policy, train=args.mode != "discriminator")
    if args.mode == "discriminator":
        from ghost_tpu_torch.models.discriminator import (
            MultiscaleDiscriminator)

        gen = _frozen(gen, device)
        disc = MultiscaleDiscriminator(n_layers=5, num_D=3, norm="instance",
                                       policy=policy)
        if args.D_path.endswith(".pth"):
            from ghost_tpu_torch.convert.torch_loader import (
                convert_discriminator_state_dict, load_torch_checkpoint)

            load_flax_variables(disc, convert_discriminator_state_dict(
                load_torch_checkpoint(args.D_path), num_D=3, n_layers=5))
        else:
            _seeded(disc, 1)
        disc = disc.to(device)
        arc_apply = _load_arc(args, policy, device)
        step, _ = xt.make_discriminator_pretrain_step(
            disc, lr=args.lr, loss_mult=args.loss_mult)

        def step_once(b):
            with torch.no_grad():
                fake = gen(b["xt"], b["embed"])[0]
            return f"lossD {float(step(fake, b['xs'])):.4f}"

        def save_tree():
            return {"params": flax_variables(disc)["params"]}

        ds = FaceEmbedDataset([args.dataset_path])
    else:
        gen = gen.to(device)
        if args.mode == "upsampler":
            from ghost_tpu_torch.models.sr.generator import LIPSPADEGenerator

            sr = xt.load_lipspade_vars(
                LIPSPADEGenerator(ngf=args.sr_ngf, policy=policy),
                args.sr_path, args.sr_ngf, warn_context="--mode upsampler")
            arc_apply = _load_arc(args, policy, device)
            step, _ = xt.make_upsampler_finetune_step(
                gen, xt.sr_upscale_apply(sr.to(device)), lr=args.lr,
                upsample_mult=args.upsample_mult)

            def step_once(b):
                m = step(b["xt"], b["embed"])
                return (f"loss {float(m['loss']):.4f} "
                        f"upsample {float(m['upsample']):.4f}")

            ds = FaceEmbedDataset([args.dataset_path])
        else:  # mask
            arc_apply = _load_arc(args, policy, device)
            step, _ = xt.make_mask_train_step(gen, lr=args.lr,
                                              mask_mult=args.mask_mult)

            def step_once(b):
                loss = step(b["xt"], b["embed"], b["mask"])
                return f"mask loss {float(loss):.4f}"

            ds = MaskTargetDataset(args.dataset_path, args.mask_source)

        def save_tree():
            return flax_variables(gen)

    loader = PrefetchLoader(ds, args.batch_size, num_workers=args.num_workers)
    _run_loop(args, out_path,
              _epoch_batches(loader, arc_apply, args.max_epochs, device),
              step_once, save_tree)
    print(f"saved {out_path}")


if __name__ == "__main__":
    main()
