"""ONNX graph emitters for the exportable models (AEI-Net, ArcFace), a
copy of `ghost_tpu/convert/onnx_emit.py` (numpy only).

The reference's export-onnx.py:44-77 emits AEI_Net and ArcFace with
dynamic batch for the inswapper-style ONNX deployment ecosystem. These
emitters rebuild the SAME computation as the models
(`models/aei.py`, `models/arcface.py`) as an ONNX node list over the
flax-layout parameter tree that the port's converters
(`convert/torch_loader.py`) return — NCHW, opset-13 ops, restricted to
exactly the op set `convert/onnx_exec.py` interprets, so export ->
re-import round-trips through the port's own executor. The bytes equal
the JAX package's emitters' for the same tree.

Layout conversions (inverse of convert/torch_loader.py):
  Conv kernel   (kh,kw,cin,cout) -> OIHW  via transpose(3,2,0,1)
  Deconv kernel (kh,kw,cin,cout) -> IOHW  via transpose(2,3,0,1)
  Dense kernel  (in,out)          -> Gemm B operand as-is (transB=0)
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from ghost_tpu_torch.convert.onnx_writer import OnnxBuilder

_EPS_BN = 1e-5
_EPS_IN = 1e-5


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _bn(b: OnnxBuilder, x: str, p: Dict[str, Any], s: Dict[str, Any]) -> str:
    return b.node("BatchNormalization", [
        x,
        b.initializer(_f32(p["scale"])),
        b.initializer(_f32(p["bias"])),
        b.initializer(_f32(s["mean"])),
        b.initializer(_f32(s["var"])),
    ], epsilon=_EPS_BN)


def _conv(b: OnnxBuilder, x: str, kernel, bias=None, stride=1, pad=0) -> str:
    kernel = _f32(kernel)
    kh, kw = kernel.shape[0], kernel.shape[1]
    ins = [x, b.initializer(np.transpose(kernel, (3, 2, 0, 1)))]
    if bias is not None:
        ins.append(b.initializer(_f32(bias)))
    return b.node("Conv", ins, kernel_shape=[kh, kw],
                  strides=[stride, stride], pads=[pad, pad, pad, pad])


def _deconv(b: OnnxBuilder, x: str, kernel, bias=None, stride=2,
            pad=1) -> str:
    kernel = _f32(kernel)
    kh, kw = kernel.shape[0], kernel.shape[1]
    ins = [x, b.initializer(np.transpose(kernel, (2, 3, 0, 1)))]
    if bias is not None:
        ins.append(b.initializer(_f32(bias)))
    return b.node("ConvTranspose", ins, kernel_shape=[kh, kw],
                  strides=[stride, stride], pads=[pad, pad, pad, pad])


def _resize2x(b: OnnxBuilder, x: str) -> str:
    """2x bilinear align_corners — resize_like_torch(x, 2.0) parity."""
    scales = b.initializer(np.array([1, 1, 2, 2], np.float32))
    return b.node("Resize", [x, "", scales], mode="linear",
                  coordinate_transformation_mode="align_corners")


# --------------------------------------------------------------------- AEI


def _aad_layer(b: OnnxBuilder, h: str, za: str, zid: str,
               p: Dict[str, Any], ups: int) -> str:
    """AADLayer (`ghost_tpu/models/aei.py:160-218`): IN(h), attr/id
    gamma-beta, learned blend mask."""
    cin = int(np.shape(p["mask"]["Conv_0"]["kernel"])[2])

    ab = _conv(b, za, p["attr_gb"]["Conv_0"]["kernel"],
               p["attr_gb"]["Conv_0"]["bias"])
    if ups > 1:
        ab = _resize2x(b, ab)
    # no 'split' attribute: opset 13 moved it to an optional input, and
    # onnxruntime rejects it as an unrecognized attribute at load; with
    # it absent Split divides equally across the 2 outputs (both halves
    # are cin channels), which our executor mirrors
    g_attr, b_attr = b.node("Split", [ab], n_out=2, axis=1)

    ab_id = b.node("Gemm", [
        zid,
        b.initializer(_f32(p["id_gb"]["Dense_0"]["kernel"])),
        b.initializer(_f32(p["id_gb"]["Dense_0"]["bias"])),
    ])
    g_id, b_id = b.node("Split", [ab_id], n_out=2, axis=1)
    bc = b.initializer(np.array([0, cin, 1, 1], np.int64))
    g_id = b.node("Reshape", [g_id, bc])
    b_id = b.node("Reshape", [b_id, bc])

    hn = b.node("InstanceNormalization", [
        h,
        b.initializer(np.ones(cin, np.float32)),
        b.initializer(np.zeros(cin, np.float32)),
    ], epsilon=_EPS_IN)

    m = b.node("Sigmoid", [_conv(b, hn, p["mask"]["Conv_0"]["kernel"],
                                 p["mask"]["Conv_0"]["bias"])])
    a = b.node("Add", [b.node("Mul", [g_attr, hn]), b_attr])
    i = b.node("Add", [b.node("Mul", [g_id, hn]), b_id])
    one = b.initializer(np.float32(1.0).reshape(()))
    return b.node("Add", [
        b.node("Mul", [b.node("Sub", [one, m]), a]),
        b.node("Mul", [m, i]),
    ])


def _aad_res_block(b: OnnxBuilder, h: str, za: str, zid: str,
                   p: Dict[str, Any], num_blocks: int, ups: int) -> str:
    """AADResBlock (models/aei.py:221-250)."""
    x = h
    for i in range(num_blocks):
        x = _aad_layer(b, x, za, zid, p[f"aad{i}"], ups)
        x = b.node("Relu", [x])
        x = _conv(b, x, p[f"conv{i}"]["Conv_0"]["kernel"], pad=1)
    if "aad_short" in p:
        s = _aad_layer(b, h, za, zid, p["aad_short"], ups)
        s = b.node("Relu", [s])
        s = _conv(b, s, p["conv_short"]["Conv_0"]["kernel"], pad=1)
        return b.node("Add", [x, s])
    return b.node("Add", [x, h])


def emit_aei(variables, backbone: str = "unet", num_blocks: int = 2,
             batch="b") -> bytes:
    """AEINet.__call__[0] (models/aei.py:300-328) as an ONNX graph:
    (xt[B,3,256,256], z_id[B,512]) -> y[B,3,256,256]."""
    if backbone not in ("unet", "linknet"):
        raise NotImplementedError(
            f"ONNX export for backbone {backbone!r} (unet/linknet only)")
    params = variables["params"]
    stats = variables["batch_stats"]
    b = OnnxBuilder("aei_net")
    xt = b.graph_input("xt", [batch, 3, 256, 256])
    zid = b.graph_input("z_id", [batch, 512])

    # MLAttrEncoder (models/aei.py:105-131)
    enc_p, enc_s = params["encoder"], stats["encoder"]
    feats = []
    h = xt
    for i in range(7):
        p, s = enc_p[f"down{i + 1}"], enc_s[f"down{i + 1}"]
        h = _conv(b, h, p["conv"]["Conv_0"]["kernel"], stride=2, pad=1)
        h = _bn(b, h, p["bn"]["BatchNorm_0"], s["bn"]["BatchNorm_0"])
        h = b.node("LeakyRelu", [h], alpha=0.1)
        feats.append(h)
    attrs = [feats[-1]]
    h = feats[-1]
    for i in range(6):
        p, s = enc_p[f"up{i + 1}"], enc_s[f"up{i + 1}"]
        h = _deconv(b, h, p["deconv"]["kernel"], stride=2, pad=1)
        h = _bn(b, h, p["bn"]["BatchNorm_0"], s["bn"]["BatchNorm_0"])
        h = b.node("LeakyRelu", [h], alpha=0.1)
        skip = feats[-2 - i]
        if backbone == "linknet":
            h = b.node("Add", [h, skip])
        else:
            h = b.node("Concat", [h, skip], axis=1)
        attrs.append(h)
    # NB the flax encoder's 8th map (2x bilinear of attrs[6]) is never
    # emitted: the blk8 commute below consumes attrs[6] directly, and a
    # dead Resize node would still execute in sequential consumers

    # AADGenerator (models/aei.py:253-297)
    gen_p = params["generator"]
    zr = b.node("Reshape", [zid, b.initializer(
        np.array([0, 512, 1, 1], np.int64))])
    m = _deconv(b, zr, gen_p["up1"]["kernel"], gen_p["up1"]["bias"],
                stride=1, pad=0)
    for k in range(8):
        if k == 7:  # blk8 commute: conv at 128-res, upsample conv output
            za, ups = attrs[6], 2
        else:
            za, ups = attrs[k], 1
        y = _aad_res_block(b, m, za, zid, gen_p[f"blk{k + 1}"],
                           num_blocks, ups)
        if k < 7:
            m = _resize2x(b, y)
    b.node("Tanh", [y], outputs=["y"])
    b.graph_output("y", [batch, 3, 256, 256])
    return b.serialize()


# ----------------------------------------------------------------- ArcFace


def _prelu(b: OnnxBuilder, x: str, alpha) -> str:
    return b.node("PRelu", [x, b.initializer(_f32(alpha))])


def emit_arcface(variables, layers: Sequence[int] = (3, 13, 30, 3),
                 num_features: int = 512, batch="b") -> bytes:
    """IResNet (models/arcface.py:68-116) as an ONNX graph:
    x[B,3,112,112] -> embedding[B,num_features]."""
    params = variables["params"]
    stats = variables["batch_stats"]
    b = OnnxBuilder("arcface_iresnet")
    x = b.graph_input("input", [batch, 3, 112, 112])

    x = _conv(b, x, params["stem_conv"]["Conv_0"]["kernel"], pad=1)
    x = _bn(b, x, params["stem_bn"]["BatchNorm_0"],
            stats["stem_bn"]["BatchNorm_0"])
    x = _prelu(b, x, params["stem_prelu"]["alpha"])

    for stage, n in enumerate(layers):
        for blk in range(n):
            name = f"layer{stage + 1}_block{blk}"
            p, s = params[name], stats[name]
            first = blk == 0
            stride = 2 if first else 1
            out = _bn(b, x, p["bn1"]["BatchNorm_0"], s["bn1"]["BatchNorm_0"])
            out = _conv(b, out, p["conv1"]["Conv_0"]["kernel"], pad=1)
            out = _bn(b, out, p["bn2"]["BatchNorm_0"],
                      s["bn2"]["BatchNorm_0"])
            out = _prelu(b, out, p["prelu"]["alpha"])
            out = _conv(b, out, p["conv2"]["Conv_0"]["kernel"],
                        stride=stride, pad=1)
            out = _bn(b, out, p["bn3"]["BatchNorm_0"],
                      s["bn3"]["BatchNorm_0"])
            if first:
                idn = _conv(b, x, p["ds_conv"]["Conv_0"]["kernel"],
                            stride=stride)
                idn = _bn(b, idn, p["ds_bn"]["BatchNorm_0"],
                          s["ds_bn"]["BatchNorm_0"])
            else:
                idn = x
            x = b.node("Add", [out, idn])

    x = _bn(b, x, params["head_bn"]["BatchNorm_0"],
            stats["head_bn"]["BatchNorm_0"])
    # torch flattens NCHW (C,H,W)-order — in an NCHW graph that is just
    # Flatten; the flax module transposes NHWC->NCHW first to match
    # (models/arcface.py:104-106)
    x = b.node("Flatten", [x], axis=1)
    x = b.node("Gemm", [
        x,
        b.initializer(_f32(params["fc"]["Dense_0"]["kernel"])),
        b.initializer(_f32(params["fc"]["Dense_0"]["bias"])),
    ])
    x = b.node("BatchNormalization", [
        x,
        b.initializer(_f32(params["features"]["scale"])),
        b.initializer(_f32(params["features"]["bias"])),
        b.initializer(_f32(stats["features"]["mean"])),
        b.initializer(_f32(stats["features"]["var"])),
    ], epsilon=_EPS_BN, outputs=["embedding"])
    b.graph_output("embedding", [batch, num_features])
    return b.serialize()
