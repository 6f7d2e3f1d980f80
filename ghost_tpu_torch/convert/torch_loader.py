"""PyTorch checkpoints of the reference -> flax-style variables trees,
the port's copy of the parts of `ghost_tpu/convert/torch_loader.py`
that the swap CLI reads.

The reference distributes weights as torch state_dicts
(G_unet_{N}blocks.pth, backbone.pth; reference download_models.sh:1-24,
inference.py:28,34). These converters map the reference's parameter
names onto the JAX package's flax module tree and transpose layouts:

  conv        torch (cout, cin, kh, kw)  -> (kh, kw, cin, cout)
  conv-transpose torch (cin, cout, kh, kw) -> (kh, kw, cin, cout)
  linear      torch (out, in)            -> (in, out)
  batchnorm   weight/bias/running_mean/running_var -> scale/bias/mean/var

Fused layers (see models/aei.py): each AADLayer's two 1x1 gamma/beta
convs pack into one `attr_gb` kernel and the two id FCs into one
`id_gb` matrix, concatenated along the output-channel axis in
(gamma, beta) order.

The port loads the tree with its strict bridge,
`convert/from_jax.py:load_flax_variables`, which the parity tests hold
against the JAX models; the converters themselves are pure numpy and do
not depend on the model's width. `convert_discriminator_state_dict`
reads the trainer's multiscale discriminator (D_*.pth);
`convert_scrfd_state_dict` the mmdet SCRFD checkpoints
(`--detector_path *.pth`). The enhancer's
checkpoints (`--enhance_output face|full`) read through
`convert_gfpgan_state_dict` (GFPGANv1.4.pth), `convert_rrdbnet_state_dict`
(RealESRGAN_x4plus.pth) and `convert_srvgg_state_dict`
(realesr-general-x4v3.pth). `convert_spade_generator_state_dict` reads
the LIPSPADE SR generator (10_net_G.pth) behind the train CLI's
`--teacher_upsample --sr_path *.pth`. `convert_sam_state_dict` reads
Segment Anything (sam_vit_{b,l,h}_*.pth) behind `cli/precompute_masks.py
--sam_path *.pth`. `convert_fan_awl_state_dict` reads the
AdaptiveWingLoss FAN (WFLW_4HG.pth) into `models/fan_awl.py`'s tree
(`python -m ghost_tpu_torch.cli.convert --kind fan`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Unpickle a torch .pth state_dict into numpy arrays."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # mmdet-style checkpoints carry non-tensor metadata
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    # basicsr-family checkpoints (RealESRGAN/GFPGAN) nest under
    # params_ema/params; mmdet under state_dict; misc under model
    for wrapper in ("state_dict", "model", "params_ema", "params"):
        if isinstance(sd, dict) and wrapper in sd \
                and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
            break
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def _conv(sd, name):
    return np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0))


def _deconv(sd, name):
    return np.transpose(sd[f"{name}.weight"], (2, 3, 0, 1))


def _bn(sd, name):
    return {
        "scale": sd[f"{name}.weight"],
        "bias": sd[f"{name}.bias"],
    }, {
        "mean": sd[f"{name}.running_mean"],
        "var": sd[f"{name}.running_var"],
    }


def _linear_kernel(sd, name):
    return np.transpose(sd[f"{name}.weight"], (1, 0))


def _aad_layer(sd, prefix: str):
    """Pack one reference AADLayer (conv1/conv2 1x1 convs = attr
    gamma/beta, fc1/fc2 = id gamma/beta, conv_h = mask) into the fused
    AADLayer params."""
    g_attr = np.transpose(sd[f"{prefix}.conv1.weight"], (2, 3, 1, 0))
    b_attr = np.transpose(sd[f"{prefix}.conv2.weight"], (2, 3, 1, 0))
    attr_kernel = np.concatenate([g_attr, b_attr], axis=-1)
    attr_bias = np.concatenate(
        [sd[f"{prefix}.conv1.bias"], sd[f"{prefix}.conv2.bias"]], axis=0
    )
    id_kernel = np.concatenate(
        [_linear_kernel(sd, f"{prefix}.fc1"), _linear_kernel(sd, f"{prefix}.fc2")],
        axis=-1,
    )
    id_bias = np.concatenate(
        [sd[f"{prefix}.fc1.bias"], sd[f"{prefix}.fc2.bias"]], axis=0
    )
    return {
        "attr_gb": {"Conv_0": {"kernel": attr_kernel, "bias": attr_bias}},
        "id_gb": {"Dense_0": {"kernel": id_kernel, "bias": id_bias}},
        "mask": {
            "Conv_0": {
                "kernel": np.transpose(sd[f"{prefix}.conv_h.weight"], (2, 3, 1, 0)),
                "bias": sd[f"{prefix}.conv_h.bias"],
            }
        },
    }


def _aad_resblock(sd, prefix: str, num_blocks: int, cin: int, cout: int):
    """Reference AAD_ResBlk: add_blocks is a flat Sequential of
    [AADLayer, ReLU, Conv] repeated (reference network/AADLayer.py:59-66),
    so AADLayer k lives at index 3k and its conv at 3k+2."""
    out = {}
    for k in range(num_blocks):
        out[f"aad{k}"] = _aad_layer(sd, f"{prefix}.add_blocks.{3 * k}")
        out[f"conv{k}"] = {
            "Conv_0": {"kernel": _conv(sd, f"{prefix}.add_blocks.{3 * k + 2}")}
        }
    if cin != cout:
        out["aad_short"] = _aad_layer(sd, f"{prefix}.last_add_block.0")
        out["conv_short"] = {
            "Conv_0": {"kernel": _conv(sd, f"{prefix}.last_add_block.2")}
        }
    return out


def _convert_resnet_encoder(sd, prefix: str = "encoder."):
    """MLAttrEncoderResnet (reference network/resnet.py:81-149): 7x7
    stem pair + six 2-block Bottleneck stages, each stage stride 2 with
    a 1x1 downsample on its first block."""
    p: Dict = {}
    s: Dict = {}

    def put_bn(dst_p, dst_s, torch_name, flax_name):
        bp, bs = _bn(sd, torch_name)
        dst_p[flax_name] = {"BatchNorm_0": bp}
        dst_s[flax_name] = {"BatchNorm_0": bs}

    p["conv0"] = {"Conv_0": {"kernel": _conv(sd, f"{prefix}conv0")}}
    put_bn(p, s, f"{prefix}bn0", "bn0")
    p["conv1"] = {"Conv_0": {"kernel": _conv(sd, f"{prefix}conv1")}}
    put_bn(p, s, f"{prefix}bn1", "bn1")

    for stage in range(1, 7):
        for b in range(2):
            t = f"{prefix}layer{stage}.{b}"
            f = f"layer{stage}_block{b}"
            bp: Dict = {}
            bs: Dict = {}
            for c in ("conv1", "conv2", "conv3"):
                bp[c] = {"Conv_0": {"kernel": _conv(sd, f"{t}.{c}")}}
            for n in ("bn1", "bn2", "bn3"):
                put_bn(bp, bs, f"{t}.{n}", n)
            if b == 0:
                bp["ds_conv"] = {
                    "Conv_0": {"kernel": _conv(sd, f"{t}.downsample.0")}
                }
                put_bn(bp, bs, f"{t}.downsample.1", "ds_bn")
            p[f] = bp
            s[f] = bs
    return p, s


_AAD_CIN = (1024, 1024, 1024, 1024, 512, 256, 128, 64)
_AAD_COUT = (1024, 1024, 1024, 512, 256, 128, 64, 3)


def convert_aei_state_dict(
    sd: Mapping[str, np.ndarray], backbone: str = "unet", num_blocks: int = 2
):
    """G_*.pth -> {'params': ..., 'batch_stats': ...} for models.aei.AEINet."""
    params: Dict = {"encoder": {}, "generator": {}}
    stats: Dict = {"encoder": {}}  # generator has no batch-norm state

    if backbone in ("unet", "linknet"):
        for i in range(1, 8):
            # reference conv4x4 Sequential: 0=conv, 1=norm
            bn_p, bn_s = _bn(sd, f"encoder.conv{i}.1")
            params["encoder"][f"down{i}"] = {
                "conv": {"Conv_0": {"kernel": _conv(sd, f"encoder.conv{i}.0")}},
                "bn": {"BatchNorm_0": bn_p},
            }
            stats["encoder"][f"down{i}"] = {"bn": {"BatchNorm_0": bn_s}}
        for i in range(1, 7):
            bn_p, bn_s = _bn(sd, f"encoder.deconv{i}.bn")
            params["encoder"][f"up{i}"] = {
                "deconv": {"kernel": _deconv(sd, f"encoder.deconv{i}.deconv")},
                "bn": {"BatchNorm_0": bn_p},
            }
            stats["encoder"][f"up{i}"] = {"bn": {"BatchNorm_0": bn_s}}
    elif backbone == "resnet":
        enc_p, enc_s = _convert_resnet_encoder(sd, prefix="encoder.")
        params["encoder"] = enc_p
        stats["encoder"] = enc_s
    else:
        raise ValueError(f"unknown backbone {backbone!r}")

    params["generator"]["up1"] = {
        "kernel": _deconv(sd, "generator.up1"),
        "bias": sd["generator.up1.bias"],
    }
    for k in range(8):
        params["generator"][f"blk{k + 1}"] = _aad_resblock(
            sd, f"generator.AADBlk{k + 1}", num_blocks, _AAD_CIN[k], _AAD_COUT[k]
        )
    return {"params": params, "batch_stats": stats}


def convert_arcface_state_dict(sd: Mapping[str, np.ndarray], layers=(3, 13, 30, 3)):
    """backbone.pth (insightface iresnet) -> models.arcface.IResNet tree."""
    params: Dict = {}
    stats: Dict = {}

    def put_bn(dst_p, dst_s, torch_name, flax_name):
        p, s = _bn(sd, torch_name)
        dst_p[flax_name] = {"BatchNorm_0": p}
        dst_s[flax_name] = {"BatchNorm_0": s}

    params["stem_conv"] = {"Conv_0": {"kernel": _conv(sd, "conv1")}}
    put_bn(params, stats, "bn1", "stem_bn")
    params["stem_prelu"] = {"alpha": sd["prelu.weight"]}

    for stage, n in enumerate(layers):
        for b in range(n):
            t = f"layer{stage + 1}.{b}"
            f = f"layer{stage + 1}_block{b}"
            blk_p: Dict = {}
            blk_s: Dict = {}
            put_bn(blk_p, blk_s, f"{t}.bn1", "bn1")
            blk_p["conv1"] = {"Conv_0": {"kernel": _conv(sd, f"{t}.conv1")}}
            put_bn(blk_p, blk_s, f"{t}.bn2", "bn2")
            blk_p["prelu"] = {"alpha": sd[f"{t}.prelu.weight"]}
            blk_p["conv2"] = {"Conv_0": {"kernel": _conv(sd, f"{t}.conv2")}}
            put_bn(blk_p, blk_s, f"{t}.bn3", "bn3")
            if b == 0:
                blk_p["ds_conv"] = {
                    "Conv_0": {"kernel": _conv(sd, f"{t}.downsample.0")}
                }
                put_bn(blk_p, blk_s, f"{t}.downsample.1", "ds_bn")
            params[f] = blk_p
            stats[f] = blk_s

    put_bn(params, stats, "bn2", "head_bn")
    params["fc"] = {
        "Dense_0": {"kernel": _linear_kernel(sd, "fc"), "bias": sd["fc.bias"]}
    }
    # features BatchNorm1d
    params["features"] = {"scale": sd["features.weight"], "bias": sd["features.bias"]}
    stats["features"] = {
        "mean": sd["features.running_mean"],
        "var": sd["features.running_var"],
    }
    return {"params": params, "batch_stats": stats}


def convert_scrfd_state_dict(sd: Mapping[str, np.ndarray], arch=None):
    """mmdet SCRFD checkpoint (e.g. the reference's
    coordinate_reg/model/SCRFD/model_25GF.pth, 226 keys) ->
    flax-style variables of `models.scrfd_v1e.SCRFDV1e` (the JAX tree's
    names, which the bridge loads). Topology is recorded in the
    checkpoint's own meta config (ResNetV1e + PAFPN + shared GN head)."""
    from ghost_tpu_torch.models.scrfd_v1e import SCRFD_2_5GF

    arch = arch or SCRFD_2_5GF
    params: Dict = {"backbone": {}, "neck": {}, "head": {}}
    stats: Dict = {"backbone": {}}

    def put_cbn(dst_p, dst_s, flax_name, conv_t, bn_t):
        bn_p, bn_s = _bn(sd, bn_t)
        dst_p[flax_name] = {"conv": {"Conv_0": {"kernel": _conv(sd, conv_t)}},
                            "bn": {"BatchNorm_0": bn_p}}
        dst_s[flax_name] = {"bn": {"BatchNorm_0": bn_s}}

    bp, bs = params["backbone"], stats["backbone"]
    for i, (c, b) in enumerate(((0, 1), (3, 4), (6, 7))):
        put_cbn(bp, bs, f"stem{i}", f"backbone.stem.{c}", f"backbone.stem.{b}")
    for s, depth in enumerate(arch.stage_blocks):
        for blk in range(depth):
            t = f"backbone.layer{s + 1}.{blk}"
            f = f"layer{s + 1}_block{blk}"
            blk_p: Dict = {}
            blk_s: Dict = {}
            for c in ("conv1", "conv2"):
                blk_p[c] = {"Conv_0": {"kernel": _conv(sd, f"{t}.{c}")}}
            for n in ("bn1", "bn2"):
                p, st = _bn(sd, f"{t}.{n}")
                blk_p[n] = {"BatchNorm_0": p}
                blk_s[n] = {"BatchNorm_0": st}
            if f"{t}.downsample.1.weight" in sd:
                blk_p["ds_conv"] = {
                    "Conv_0": {"kernel": _conv(sd, f"{t}.downsample.1")}
                }
                p, st = _bn(sd, f"{t}.downsample.2")
                blk_p["ds_bn"] = {"BatchNorm_0": p}
                blk_s["ds_bn"] = {"BatchNorm_0": st}
            bp[f] = blk_p
            bs[f] = blk_s

    def biased(name):
        return {"Conv_0": {"kernel": _conv(sd, name),
                           "bias": sd[f"{name}.bias"]}}

    npz = params["neck"]
    n_levels = len(arch.stage_planes) - arch.start_level
    for i in range(n_levels):
        npz[f"lateral{i}"] = biased(f"neck.lateral_convs.{i}.conv")
        npz[f"fpn{i}"] = biased(f"neck.fpn_convs.{i}.conv")
    for i in range(n_levels - 1):
        npz[f"down{i}"] = biased(f"neck.downsample_convs.{i}.conv")
        npz[f"pafpn{i}"] = biased(f"neck.pafpn_convs.{i}.conv")

    hp = params["head"]
    for i in range(arch.stacked_convs):
        t = f"bbox_head.cls_stride_convs.0.{i}"
        hp[f"tower{i}_conv"] = {
            "Conv_0": {"kernel": _conv(sd, f"{t}.conv")}}
        hp[f"tower{i}_gn"] = {"scale": sd[f"{t}.gn.weight"],
                              "bias": sd[f"{t}.gn.bias"]}
    hp["cls"] = biased("bbox_head.stride_cls.0")
    hp["reg"] = biased("bbox_head.stride_reg.0")
    if arch.use_kps:
        hp["kps"] = biased("bbox_head.stride_kps.0")
    for lvl in range(n_levels):
        hp[f"scale{lvl}"] = sd[f"bbox_head.scales.{lvl}.scale"]
    return {"params": params, "batch_stats": stats}


def _spectral_conv(sd, name):
    """torch spectral_norm conv -> {params, spectral} fragments."""
    p = {"kernel": np.transpose(sd[f"{name}.weight_orig"], (2, 3, 1, 0))}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    s = {"u": sd[f"{name}.weight_u"], "v": sd[f"{name}.weight_v"]}
    return p, s


def _spade_norm(sd, name):
    """SPADE module (reference models/networks/normalization.py:63-107):
    affine-free synced BN stats + segmap-conditioned gamma/beta convs."""
    p = {
        "mlp_shared": {
            "kernel": np.transpose(sd[f"{name}.mlp_shared.0.weight"],
                                   (2, 3, 1, 0)),
            "bias": sd[f"{name}.mlp_shared.0.bias"],
        },
        "mlp_gamma": {
            "kernel": np.transpose(sd[f"{name}.mlp_gamma.weight"], (2, 3, 1, 0))
        },
        "mlp_beta": {
            "kernel": np.transpose(sd[f"{name}.mlp_beta.weight"], (2, 3, 1, 0))
        },
    }
    stats = {
        "pfn": {
            "mean": sd[f"{name}.param_free_norm.running_mean"],
            "var": sd[f"{name}.param_free_norm.running_var"],
        }
    }
    return p, stats


def _spade_resblock(sd, name, learned_shortcut: bool):
    """SPADEResnetBlock (reference models/networks/architecture.py:21-70)."""
    p: Dict = {}
    stats: Dict = {}
    spec: Dict = {}
    convs = ["conv_0", "conv_1"] + (["conv_s"] if learned_shortcut else [])
    for c in convs:
        p[c], spec[c] = _spectral_conv(sd, f"{name}.{c}")
    norms = ["norm_0", "norm_1"] + (["norm_s"] if learned_shortcut else [])
    for n in norms:
        p[n], stats[n] = _spade_norm(sd, f"{name}.{n}")
    return p, stats, spec


def convert_spade_generator_state_dict(
    sd: Mapping[str, np.ndarray], ngf: int = 48, lip: bool = True,
    n_2xdown: int = 5,
):
    """SR generator .pth (10_net_G.pth layout) -> variables for
    models.sr.generator.{LIPSPADEGenerator,SPADEGenerator}.

    Reference structure: SPADEGenerator head/middle/ups blocks +
    to_rgbs list (models/networks/generator.py:17-137; the test config
    is_test=True uses to_rgbs[-1]) and, for netG='lipspade'
    (models/config_sr.py:21), a LIPEncoder whose Sequential packs
    [conv, IN, ReLU] + n x [SimplifiedLIP, conv, IN, (ReLU)]
    (generator.py:353-388).
    """
    params: Dict = {}
    stats: Dict = {}
    spec: Dict = {}

    blocks = [("head_0", False), ("G_middle_0", False), ("G_middle_1", False),
              ("ups_0", True), ("ups_1", True), ("ups_2", True),
              ("ups_3", True)]
    for ours, shortcut in blocks:
        theirs = ours if not ours.startswith("ups_") else \
            f"ups.{ours.split('_')[1]}"
        params[ours], stats[ours], spec[ours] = _spade_resblock(
            sd, theirs, shortcut)

    # is_test runs every phase and emits via the LAST to_rgb
    # (generator.py:109-118)
    n_rgb = max(int(k.split(".")[1]) for k in sd if k.startswith("to_rgbs."))
    params["to_rgb"] = {
        "Conv_0": {
            "kernel": np.transpose(sd[f"to_rgbs.{n_rgb}.weight"], (2, 3, 1, 0)),
            "bias": sd[f"to_rgbs.{n_rgb}.bias"],
        }
    }

    if lip:
        enc: Dict = {
            "stem": {"Conv_0": {"kernel": _conv(sd, "lip_encoder.model.0")}}
        }
        for i in range(n_2xdown):
            lip_idx = 3 + 4 * i
            enc[f"lip{i}"] = {
                "logit_conv": {
                    "Conv_0": {
                        "kernel": _conv(sd, f"lip_encoder.model.{lip_idx}.logit.0")
                    }
                },
                "in_scale": sd[f"lip_encoder.model.{lip_idx}.logit.1.weight"],
                "in_bias": sd[f"lip_encoder.model.{lip_idx}.logit.1.bias"],
            }
            enc[f"conv{i}"] = {
                "Conv_0": {
                    "kernel": _conv(sd, f"lip_encoder.model.{lip_idx + 1}"),
                    "bias": sd[f"lip_encoder.model.{lip_idx + 1}.bias"],
                }
            }
        params["lip_encoder"] = enc
    else:
        params["fc"] = {
            "Conv_0": {"kernel": _conv(sd, "fc"), "bias": sd["fc.bias"]}
        }
    return {"params": params, "batch_stats": stats, "spectral": spec}


def convert_discriminator_state_dict(
    sd: Mapping[str, np.ndarray], num_D: int = 3, n_layers: int = 5
):
    """MultiscaleDiscriminator .pth (D_*.pth, getIntermFeat=False layout:
    `layer{i}` Sequentials) -> the flax tree of
    `ghost_tpu/convert/torch_loader.py:439`. torch flattens the groups
    [conv, lrelu] + n_layers x [conv, norm, lrelu] + [conv]; a paramless
    InstanceNorm still advances the module index, so the convs sit at 0,
    2, 5, 8, ... and the head at 2 + 3 * n_layers."""
    params: Dict = {}
    for i in range(num_D):
        scale: Dict = {}
        for n in range(n_layers + 1):
            scale[f"stage{n}"] = _conv_wb(
                sd, f"layer{i}.{0 if n == 0 else 2 + 3 * (n - 1)}")
        scale["head"] = _conv_wb(sd, f"layer{i}.{2 + 3 * n_layers}")
        params[f"scale{i}"] = scale
    return {"params": params}


def _conv_wb(sd, name):
    return {"Conv_0": {"kernel": _conv(sd, name),
                       "bias": sd[f"{name}.bias"]}}


def convert_rrdbnet_state_dict(
    sd: Mapping[str, np.ndarray], num_block: int = 23
):
    """Real-ESRGAN RRDBNet checkpoints (RealESRGAN_x4plus.pth — the
    reference's bg upsampler, utils/training/upsampler.py:32,61).
    Official key layout: conv_first / body.N.rdbM.convK / conv_body /
    conv_up1 / conv_up2 / conv_hr / conv_last; checkpoints wrap the
    state dict under 'params_ema' or 'params'."""
    for wrapper in ("params_ema", "params"):
        if wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
            break
    params: Dict = {}
    for top in ("conv_first", "conv_body", "conv_up1", "conv_up2",
                "conv_hr", "conv_last"):
        params[top] = _conv_wb(sd, top)
    for i in range(num_block):
        blk: Dict = {}
        for m in range(1, 4):
            rdb = {f"conv{k}": _conv_wb(sd, f"body.{i}.rdb{m}.conv{k}")
                   for k in range(1, 6)}
            blk[f"rdb{m}"] = rdb
        params[f"body_{i}"] = blk
    return {"params": params}


def convert_fan_awl_state_dict(sd: Mapping[str, np.ndarray],
                               num_modules: int = 4, depth: int = 4):
    """AdaptiveWingLoss FAN checkpoints (WFLW_4HG.pth, the reference's
    eye-landmark net, download_models.sh:20) -> the flax tree of
    `models/fan_awl.FANAWL`. Official layout per the public
    AdaptiveWingLoss core/models.py: CoordConv stems store their conv
    under `.conv`; ConvBlocks as bn1/conv1..bn3/conv3 + downsample.{0,2};
    hourglass pyramids as b1_L/b2_L/b2_plus_1/b3_L; per-stack heads
    conv_last/bn_end/l/bl/al. A `module.` prefix (DataParallel) is
    dropped."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    params: Dict = {}
    stats: Dict = {}

    def bn(name):
        p, s = _bn(sd, name)
        return {"BatchNorm_0": p}, {"BatchNorm_0": s}

    def convblock(name):
        p: Dict = {}
        s: Dict = {}
        for i in (1, 2, 3):
            p[f"bn_{i}"], s[f"bn_{i}"] = bn(f"{name}.bn{i}")
            p[f"conv_{i}"] = {"Conv_0": {"kernel": _conv(sd,
                                                         f"{name}.conv{i}")}}
        if f"{name}.downsample.0.weight" in sd:
            p["bn_ds"], s["bn_ds"] = bn(f"{name}.downsample.0")
            p["conv_ds"] = {"Conv_0": {"kernel": _conv(
                sd, f"{name}.downsample.2")}}
        return p, s

    params["conv1"] = {"conv": _conv_wb(sd, "conv1.conv")}
    params["bn1"], stats["bn1"] = bn("bn1")
    for blk in ("conv2", "conv3", "conv4"):
        params[blk], stats[blk] = convblock(blk)

    for m in range(num_modules):
        mp: Dict = {"coordconv": {"conv": _conv_wb(sd,
                                                   f"m{m}.coordconv.conv")}}
        ms: Dict = {}
        names = [f"b1_{d}" for d in range(depth, 0, -1)]
        names += [f"b2_{d}" for d in range(depth, 0, -1)]
        names += ["b2_plus_1"]
        names += [f"b3_{d}" for d in range(depth, 0, -1)]
        for n in names:
            mp[n], ms[n] = convblock(f"m{m}.{n}")
        params[f"m{m}"], stats[f"m{m}"] = mp, ms
        params[f"top_m_{m}"], stats[f"top_m_{m}"] = convblock(f"top_m_{m}")
        params[f"conv_last{m}"] = _conv_wb(sd, f"conv_last{m}")
        params[f"bn_end{m}"], stats[f"bn_end{m}"] = bn(f"bn_end{m}")
        params[f"l{m}"] = _conv_wb(sd, f"l{m}")
        if m < num_modules - 1:
            params[f"bl{m}"] = _conv_wb(sd, f"bl{m}")
            params[f"al{m}"] = _conv_wb(sd, f"al{m}")
    return {"params": params, "batch_stats": stats}


def convert_srvgg_state_dict(sd: Mapping[str, np.ndarray],
                             num_conv: int = 32):
    """SRVGGNetCompact checkpoints (realesr-general-x4v3.pth — the
    reference's fast general upsampler, Dockerfile:65-68,
    utils/training/upsampler.py:6). Official layout: a flat
    `body.{idx}` ModuleList alternating conv (even idx) and PReLU
    (odd idx), final conv at index 2*(num_conv+1); wrapped under
    'params' or 'params_ema'."""
    for wrapper in ("params_ema", "params"):
        if wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
            break
    params: Dict = {}
    for i in range(num_conv + 1):
        params[f"conv_{i}"] = _conv_wb(sd, f"body.{2 * i}")
        params[f"prelu_{i}"] = sd[f"body.{2 * i + 1}.weight"]
    params["conv_last"] = _conv_wb(sd, f"body.{2 * (num_conv + 1)}")
    return {"params": params}


def convert_gfpgan_state_dict(
    sd: Mapping[str, np.ndarray],
    out_size: int = 512,
    num_style_feat: int = 512,
):
    """GFPGANv1Clean checkpoints (GFPGANv1.4.pth / v1.3 — the
    reference's face enhancer, utils/training/upsampler.py:39-46).
    Official key layout per the public gfpganv1_clean_arch module;
    noise buffers (stylegan_decoder.noises.*) are dropped — serving
    uses deterministic zero noise (models/sr/gfpgan.py)."""
    import math

    log_size = int(math.log2(out_size))
    n_stages = log_size - 2

    def resblock(prefix):
        return {
            "conv1": _conv_wb(sd, f"{prefix}.conv1"),
            "conv2": _conv_wb(sd, f"{prefix}.conv2"),
            "skip": {"Conv_0": {"kernel": _conv(sd, f"{prefix}.skip")}},
        }

    def modconv(prefix):
        # torch weight (1, cout, cin, k, k) -> (k, k, cin, cout)
        w = np.transpose(sd[f"{prefix}.weight"][0], (2, 3, 1, 0))
        return {
            "weight": w,
            "modulation": {"Dense_0": {
                "kernel": _linear_kernel(sd, f"{prefix}.modulation"),
                "bias": sd[f"{prefix}.modulation.bias"],
            }},
        }

    def styleconv(prefix):
        return {
            "modulated_conv": modconv(f"{prefix}.modulated_conv"),
            "noise_weight": sd[f"{prefix}.weight"].reshape(1),
            "bias": sd[f"{prefix}.bias"].reshape(-1),
        }

    def torgb(prefix):
        return {
            "modulated_conv": modconv(f"{prefix}.modulated_conv"),
            "bias": sd[f"{prefix}.bias"].reshape(-1),
        }

    params: Dict = {"conv_body_first": _conv_wb(sd, "conv_body_first"),
                    "final_conv": _conv_wb(sd, "final_conv")}
    for i in range(n_stages):
        params[f"conv_body_down_{i}"] = resblock(f"conv_body_down.{i}")
        params[f"conv_body_up_{i}"] = resblock(f"conv_body_up.{i}")
        for kind in ("scale", "shift"):
            params[f"condition_{kind}_{i}_0"] = _conv_wb(
                sd, f"condition_{kind}.{i}.0")
            params[f"condition_{kind}_{i}_1"] = _conv_wb(
                sd, f"condition_{kind}.{i}.2")
        if f"toRGB.{i}.weight" in sd:
            params[f"toRGB_{i}"] = _conv_wb(sd, f"toRGB.{i}")

    # final_linear: torch flattens NCHW (c*16 + y*4 + x); our NHWC
    # flatten is ((y*4 + x)*C + c) — permute the input axis to match
    w = sd["final_linear.weight"]  # (out, C*16)
    c4 = w.shape[1] // 16
    w = (w.reshape(-1, c4, 4, 4).transpose(0, 2, 3, 1)
         .reshape(-1, 16 * c4))
    params["final_linear"] = {"Dense_0": {
        "kernel": np.transpose(w, (1, 0)),
        "bias": sd["final_linear.bias"],
    }}

    dec: Dict = {
        "constant_input": np.transpose(
            sd["stylegan_decoder.constant_input.weight"], (0, 2, 3, 1)),
        "style_conv1": styleconv("stylegan_decoder.style_conv1"),
        "to_rgb1": torgb("stylegan_decoder.to_rgb1"),
    }
    for j in range(2 * n_stages):
        dec[f"style_convs_{j}"] = styleconv(
            f"stylegan_decoder.style_convs.{j}")
    for s in range(n_stages):
        dec[f"to_rgbs_{s}"] = torgb(f"stylegan_decoder.to_rgbs.{s}")
    for j in range(8):
        k = f"stylegan_decoder.style_mlp.{2 * j}.weight"
        if k in sd:
            dec[f"mlp_{j}"] = {"Dense_0": {
                "kernel": _linear_kernel(
                    sd, f"stylegan_decoder.style_mlp.{2 * j}"),
                "bias": sd[f"stylegan_decoder.style_mlp.{2 * j}.bias"],
            }}
    params["stylegan_decoder"] = dec
    return {"params": params}


def _dense(sd, name):
    return {"Dense_0": {"kernel": _linear_kernel(sd, name),
                        "bias": sd[f"{name}.bias"]}}


def _ln(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def convert_sam_state_dict(sd: Mapping[str, np.ndarray], depth: int = 32):
    """Segment Anything checkpoints (the sam_vit_h_4b8939.pth family;
    reference train-mask.py:236, segment_anything_celeba.py:24) -> the
    variables of `models/sam.py:build_sam`, the JAX package's tree
    (`ghost_tpu/convert/torch_loader.py:684`). depth: 12 (vit_b), 24
    (vit_l) or 32 (vit_h). The key layout is the public
    segment_anything/modeling sources'."""
    enc: Dict = {
        "patch_embed": {"Conv_0": {
            "kernel": _conv(sd, "image_encoder.patch_embed.proj"),
            "bias": sd["image_encoder.patch_embed.proj.bias"]}},
        "pos_embed": sd["image_encoder.pos_embed"],  # already (1,H,W,C)
        "neck_conv1": {"Conv_0": {"kernel": _conv(sd,
                                                  "image_encoder.neck.0")}},
        "neck_ln1": _ln(sd, "image_encoder.neck.1"),
        "neck_conv2": {"Conv_0": {"kernel": _conv(sd,
                                                  "image_encoder.neck.2")}},
        "neck_ln2": _ln(sd, "image_encoder.neck.3"),
    }
    for i in range(depth):
        t = f"image_encoder.blocks.{i}"
        enc[f"block_{i}"] = {
            "norm1": _ln(sd, f"{t}.norm1"),
            "norm2": _ln(sd, f"{t}.norm2"),
            "attn": {
                "qkv": _dense(sd, f"{t}.attn.qkv"),
                "proj": _dense(sd, f"{t}.attn.proj"),
                "rel_pos_h": sd[f"{t}.attn.rel_pos_h"],
                "rel_pos_w": sd[f"{t}.attn.rel_pos_w"],
            },
            "mlp_lin1": _dense(sd, f"{t}.mlp.lin1"),
            "mlp_lin2": _dense(sd, f"{t}.mlp.lin2"),
        }

    prm: Dict = {
        "pe_gauss":
            sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"],
        "not_a_point": sd["prompt_encoder.not_a_point_embed.weight"][0],
        "no_mask_embed": sd["prompt_encoder.no_mask_embed.weight"][0],
    }
    for i in range(4):
        prm[f"point_embed_{i}"] = \
            sd[f"prompt_encoder.point_embeddings.{i}.weight"][0]

    def attn(prefix):
        return {n: _dense(sd, f"{prefix}.{n}")
                for n in ("q_proj", "k_proj", "v_proj", "out_proj")}

    dec: Dict = {
        "iou_token": sd["mask_decoder.iou_token.weight"],
        "mask_tokens": sd["mask_decoder.mask_tokens.weight"],
        "final_attn": attn("mask_decoder.transformer.final_attn_token_to_image"),
        "norm_final": _ln(sd, "mask_decoder.transformer.norm_final_attn"),
        "upscale_conv1": {
            "kernel": _deconv(sd, "mask_decoder.output_upscaling.0"),
            "bias": sd["mask_decoder.output_upscaling.0.bias"]},
        "upscale_ln": _ln(sd, "mask_decoder.output_upscaling.1"),
        "upscale_conv2": {
            "kernel": _deconv(sd, "mask_decoder.output_upscaling.3"),
            "bias": sd["mask_decoder.output_upscaling.3.bias"]},
    }
    for i in range(2):
        t = f"mask_decoder.transformer.layers.{i}"
        dec[f"layer_{i}"] = {
            "self_attn": attn(f"{t}.self_attn"),
            "cross_attn_token_to_image": attn(f"{t}.cross_attn_token_to_image"),
            "cross_attn_image_to_token": attn(f"{t}.cross_attn_image_to_token"),
            "norm1": _ln(sd, f"{t}.norm1"), "norm2": _ln(sd, f"{t}.norm2"),
            "norm3": _ln(sd, f"{t}.norm3"), "norm4": _ln(sd, f"{t}.norm4"),
            "mlp_lin1": _dense(sd, f"{t}.mlp.lin1"),
            "mlp_lin2": _dense(sd, f"{t}.mlp.lin2"),
        }
    for i in range(4):
        for j in range(3):
            dec[f"hyper_{i}_lin{j}"] = _dense(
                sd, f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}")
    for j in range(3):
        dec[f"iou_lin{j}"] = _dense(
            sd, f"mask_decoder.iou_prediction_head.layers.{j}")

    return {"params": {"image_encoder": enc, "prompt_encoder": prm,
                       "mask_decoder": dec}}
