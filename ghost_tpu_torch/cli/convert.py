"""Weight conversion CLI: reference checkpoints -> msgpack trees,
mirroring `ghost_tpu/cli/convert.py` flag for flag.

The reference fetches weights with download_models.sh and loads them
per framework (torch / onnxruntime / MXNet). This tool converts any of
them once into the flax-layout msgpack trees that both packages read
(`core/checkpoint.py:load_msgpack`; the port's modules through
`convert/from_jax.py:load_flax_variables`):

    python -m ghost_tpu_torch.cli.convert --kind aei \\
        --src weights/G_unet_2blocks.pth --out g.msgpack
    python -m ghost_tpu_torch.cli.convert --kind arcface \\
        --src weights/backbone.pth --out arcface.msgpack
    python -m ghost_tpu_torch.cli.convert --kind landmark_mxnet \\
        --src 2d106det-0000.params --out lmk.msgpack
    python -m ghost_tpu_torch.cli.convert --kind fan \\
        --src WFLW_4HG.pth --out fan.msgpack

kinds: aei | arcface | discriminator | spade | scrfd | landmark_mxnet |
vgg19 | gfpgan | rrdb | srvgg | sam | fan. `landmark_mxnet` reads a raw
MXNet `.params` file (`convert/mxnet_nd.py`, no mxnet needed) or an
`.npz`; the others a torch state dict. The conversion is numpy on the
host; the file written (`core/checkpoint.py:save_msgpack`, each dict's
keys sorted as the JAX CLI writes them) is byte for byte the JAX CLI's
for the same checkpoint. ONNX models need no conversion: they run through
`convert/onnx_exec.py`.

Faults of the JAX CLI, kept (a fix belongs in both packages): `--kind
fan` writes `models/fan_awl.FANAWL`'s tree, which the train CLI's
`--fan_path` (it builds `models/fan.FAN`) cannot load; `--kind scrfd`
writes an `SCRFDV1e` tree where the swap CLI's msgpack
`--detector_path` builds `SCRFD`; `--kind landmark_mxnet` writes
`Landmark106Det`'s tree where `--landmark_path` builds `Landmark106`.

`main(argv, device="cpu")` runs without a card (tests); the command
line takes the card and raises without one, as every entry point of
the port does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="ghost-tpu weight conversion")
    p.add_argument("--kind", required=True,
                   choices=["aei", "arcface", "discriminator", "spade",
                            "scrfd", "landmark_mxnet", "vgg19",
                            "gfpgan", "rrdb", "srvgg", "sam", "fan"])
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--backbone", default="unet",
                   choices=["unet", "linknet", "resnet"])
    p.add_argument("--num_blocks", default=2, type=int)
    p.add_argument("--arcface_depth", default="iresnet100",
                   choices=["iresnet34", "iresnet50", "iresnet100"])
    p.add_argument("--num_D", default=3, type=int)
    p.add_argument("--n_layers", default=5, type=int)
    p.add_argument("--ngf", default=48, type=int)
    p.add_argument("--num_conv", default=32, type=int,
                   help="srvgg trunk convs (realesr-general-x4v3: 32)")
    p.add_argument("--rrdb_blocks", default=23, type=int)
    p.add_argument("--sam_preset", default="vit_h",
                   choices=["vit_b", "vit_l", "vit_h"])
    return p


def convert_tree(args):
    """The flax-layout variables tree of `args.src` for `args.kind`."""
    if args.kind == "landmark_mxnet":
        from ghost_tpu_torch.models.landmark_mxnet import \
            convert_2d106det_params

        if args.src.endswith(".npz"):
            blob = dict(np.load(args.src))
        else:
            # the raw MXNet NDArray file of the reference's
            # coordinate_reg/model/2d106det pack, parsed natively
            from ghost_tpu_torch.convert.mxnet_nd import load_ndarray_dict

            blob = load_ndarray_dict(args.src)
        return convert_2d106det_params(blob)

    from ghost_tpu_torch.convert import torch_loader as tl

    sd = tl.load_torch_checkpoint(args.src)
    if args.kind == "aei":
        return tl.convert_aei_state_dict(sd, args.backbone, args.num_blocks)
    if args.kind == "arcface":
        from ghost_tpu_torch.models.arcface import _DEPTHS

        return tl.convert_arcface_state_dict(
            sd, layers=_DEPTHS[args.arcface_depth])
    if args.kind == "discriminator":
        return tl.convert_discriminator_state_dict(
            sd, num_D=args.num_D, n_layers=args.n_layers)
    if args.kind == "spade":
        return tl.convert_spade_generator_state_dict(sd, ngf=args.ngf)
    if args.kind == "scrfd":
        return tl.convert_scrfd_state_dict(sd)
    if args.kind == "vgg19":
        from ghost_tpu_torch.models.sr.vgg import convert_vgg19_features

        return convert_vgg19_features(sd)
    if args.kind == "gfpgan":
        return tl.convert_gfpgan_state_dict(sd)
    if args.kind == "rrdb":
        return tl.convert_rrdbnet_state_dict(sd, num_block=args.rrdb_blocks)
    if args.kind == "srvgg":
        return tl.convert_srvgg_state_dict(sd, num_conv=args.num_conv)
    if args.kind == "sam":
        depth = {"vit_b": 12, "vit_l": 24, "vit_h": 32}[args.sam_preset]
        return tl.convert_sam_state_dict(sd, depth=depth)
    if args.kind == "fan":
        return tl.convert_fan_awl_state_dict(sd)
    raise SystemExit(args.kind)  # pragma: no cover


def main(argv=None, device="cuda"):
    """Parse argv, convert `--src` and write `--out`. `device` is where
    the caller runs (the card unless it asks for the CPU; raises without
    one); the conversion itself is host numpy."""
    from ghost_tpu_torch.core.checkpoint import save_msgpack

    args = build_parser().parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("convert: no CUDA card; pass device='cpu' to "
                           "run on the CPU")
    tree = convert_tree(args)
    save_msgpack(args.out, _key_sorted(tree))
    n = sum(np.asarray(x).size for x in _leaves(tree))
    print(f"wrote {args.out}: {n / 1e6:.1f}M params")


def _key_sorted(tree):
    """The tree with each dict's keys in sorted order: the order the JAX
    CLI writes (its save_msgpack passes the tree through jax.device_get,
    which rebuilds every dict sorted), so the two files are equal."""
    if isinstance(tree, dict):
        return {k: _key_sorted(tree[k]) for k in sorted(tree)}
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
