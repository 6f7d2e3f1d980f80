"""Model export CLI, mirroring `ghost_tpu/cli/export.py`'s flags.

The reference exports AEI_Net and ArcFace to ONNX with dynamic batch
(reference export-onnx.py:44-77). Two formats:

  * --format pt2 (default): `torch.export`'s program, written with
    `torch.export.save` and reloaded with `torch.export.load` (then
    `.module()(...)`); it takes the place of the JAX package's
    StableHLO artifact. AEINet's Y (bf16 compute, f32 out:
    `DEFAULT_POLICY`, the plain AAD path `fused_aad=False`, as JAX
    exports it; no fused kernel in the program) from (xt (B,256,256,3),
    z_id (B,512)) f32 NHWC, or IResNet's embedding from (B,112,112,3).
    `--batch -1` exports a dynamic batch dim (`torch.export.Dim`, any
    batch >= 1); the trace runs at batch 2, since export specialises a
    dim traced at size 1. `--format stablehlo` is not offered
    (argparse's choices refuse it): StableHLO is XLA's format.
  * --format onnx: a real .onnx file (`convert/onnx_emit.py`, no onnx
    package needed), node for node the JAX CLI's graph for the same
    tree, with a dynamic batch for `--batch -1`; it runs through the
    port's `convert/onnx_exec.py:OnnxExecutor`.

Weights: `--G_path` / `--arcface_path` torch checkpoints through the
converters, else the module's seeded random init (a torch.Generator
seeded with 0: not JAX's values); `--weights_out` writes the module's
flax-layout tree (`convert/from_jax.py:flax_variables`) as msgpack.

A stated departure from the JAX CLI: its StableHLO route rebuilds the
generator without `--width` (`ghost_tpu/cli/export.py:56`) and the
recognizer as iresnet100 whatever `--arcface_depth` says (`:71`), and
its `--arcface_path` conversion ignores the depth too (`:120-121`), so
a width other than 1 or a shallower ArcFace cannot be exported there.
Here both formats export the module `main` built, at the parsed width
and depth, and `--arcface_path` converts at that depth.

    python -m ghost_tpu_torch.cli.export --model aei --out aei.pt2 \\
        [--G_path weights/G_unet_2blocks.pth] [--batch -1]
    python -m ghost_tpu_torch.cli.export --model arcface --out arc.onnx \\
        --format onnx --arcface_path weights/backbone.pth

`main(argv, device="cpu")` runs without a card (tests); the command
line builds and exports on the card and raises without one.
"""

from __future__ import annotations

import argparse
import os

import torch
from torch import nn


def build_parser():
    p = argparse.ArgumentParser(description="ghost-tpu model export")
    p.add_argument("--model", default="aei", choices=["aei", "arcface"])
    p.add_argument("--out", required=True, help="output .pt2 / .onnx path")
    p.add_argument("--format", default="pt2", choices=["pt2", "onnx"])
    p.add_argument("--weights_out", default="",
                   help="optional msgpack weights path")
    p.add_argument("--G_path", default="")
    p.add_argument("--arcface_path", default="")
    p.add_argument("--backbone", default="unet")
    p.add_argument("--num_blocks", default=2, type=int)
    p.add_argument("--width", default=1.0, type=float,
                   help="AEI channel-width multiplier (1.0 = reference)")
    p.add_argument("--arcface_depth", default="iresnet100")
    p.add_argument("--batch", default=-1, type=int,
                   help="-1 for a symbolic (dynamic) batch")
    return p


class GeneratorY(nn.Module):
    """AEINet's first output, Y (what the JAX export's fn returns)."""

    def __init__(self, aei: nn.Module):
        super().__init__()
        self.aei = aei

    def forward(self, xt, z_id):
        return self.aei(xt, z_id)[0]


def export_program(model_name: str, module: nn.Module, batch: int = -1):
    """torch.export's program of the eval-mode `module` (AEINet: its Y)
    on f32 inputs on the module's device; batch -1: a dynamic batch,
    traced at 2."""
    device = next(module.parameters()).device
    b = 2 if batch == -1 else batch
    if model_name == "aei":
        fn = GeneratorY(module)
        args = (torch.zeros(b, 256, 256, 3, device=device),
                torch.zeros(b, 512, device=device))
    else:
        fn, args = module, (torch.zeros(b, 112, 112, 3, device=device),)
    dynamic = None
    if batch == -1:
        dim = torch.export.Dim("b", min=1)
        dynamic = tuple({0: dim} for _ in args)
    with torch.no_grad():
        return torch.export.export(fn.eval(), args, dynamic_shapes=dynamic,
                                   strict=False)


def build_module(args, device):
    """The eval-mode module `main` exports, with its weights: the
    converted checkpoint when a path is given, else a seeded init."""
    from ghost_tpu_torch.convert import torch_loader as tl
    from ghost_tpu_torch.convert.from_jax import load_flax_variables
    from ghost_tpu_torch.core.precision import DEFAULT_POLICY
    from ghost_tpu_torch.models.aei import AEINet
    from ghost_tpu_torch.models.arcface import _DEPTHS, IResNet
    from ghost_tpu_torch.nn.layers import init_weights

    arc_layers = _DEPTHS.get(args.arcface_depth, _DEPTHS["iresnet100"])
    if args.model == "aei":
        mod = AEINet(backbone=args.backbone, num_blocks=args.num_blocks,
                     width=args.width, policy=DEFAULT_POLICY, device=device)
        path, convert = args.G_path, lambda sd: tl.convert_aei_state_dict(
            sd, args.backbone, args.num_blocks)
    else:
        mod = IResNet(layers=arc_layers, policy=DEFAULT_POLICY, device=device)
        path, convert = args.arcface_path, lambda sd: \
            tl.convert_arcface_state_dict(sd, layers=arc_layers)
    if path:
        tree = convert(tl.load_torch_checkpoint(path))
        load_flax_variables(mod, tree)
    else:
        init_weights(mod, torch.Generator().manual_seed(0))
        tree = None
    return mod.eval(), tree, arc_layers


def main(argv=None, device="cuda"):
    """Parse argv, build the module on `device` (the card unless the
    caller asks for the CPU; raises without one) and write `--out`."""
    from ghost_tpu_torch.convert.from_jax import flax_variables

    args = build_parser().parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("export: no CUDA card; pass device='cpu' to "
                               "run on the CPU")
        from ghost_tpu_torch.core.precision import disable_tf32

        disable_tf32()
    mod, tree, arc_layers = build_module(args, device)
    if args.format == "onnx":
        from ghost_tpu_torch.convert.onnx_emit import emit_aei, emit_arcface

        np_vars = tree if tree is not None else flax_variables(mod)
        batch = "b" if args.batch == -1 else args.batch
        if args.model == "aei":
            blob = emit_aei(np_vars, backbone=args.backbone,
                            num_blocks=args.num_blocks, batch=batch)
        else:
            blob = emit_arcface(np_vars, layers=arc_layers, batch=batch)
        with open(args.out, "wb") as f:
            f.write(blob)
        size = len(blob)
    else:
        torch.export.save(export_program(args.model, mod, args.batch),
                          args.out)
        size = os.path.getsize(args.out)
    print(f"exported {args.model} -> {args.out} ({size} bytes)")
    if args.weights_out:
        from ghost_tpu_torch.core.checkpoint import save_msgpack

        save_msgpack(args.weights_out, flax_variables(mod))
        print(f"weights -> {args.weights_out}")


if __name__ == "__main__":
    main()
