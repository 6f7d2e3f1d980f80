"""Seeded inputs of the CLI's reference-pack routes, made with numpy and
the port's own ONNX writer (no jax here: `chip_smoke.py` loads this file
by path, and the card tests use it too):

  (a) `scrfd_mmdet_state_dict`: an mmdet SCRFD state dict with the names
      `convert_scrfd_state_dict` reads (what model_25GF.pth holds), for
      any `SCRFDArch`;
  (b) `planted_scrfd_graph`: the JAX test's planted-head SCRFD graph
      (`tests/test_scrfd_onnx.py:_head`: per-stride AveragePool, zero
      1x1 convs with planted biases) in the insightface layout;
  (c) `emit_scrfd`: a full-width SCRFD graph emitted node for node from
      the port's own `models/scrfd.py:SCRFD` module with the port's
      `OnnxBuilder`, in the insightface layout: sigmoid scores (B,n,1),
      bboxes (B,n,4) and kps (B,n,10) per stride, 9 outputs. Emitted
      after `inject_detection_template`, it finds faces on random
      weights. This emitter is test support: the JAX package has no
      SCRFD emitter;
  (d) `recognition_graph`: a small recognition-shaped graph (Conv,
      PRelu, Flatten, Gemm to 512 on 112 px crops, as
      `tests/test_arcface_onnx.py` builds one).
"""

from __future__ import annotations

import numpy as np

from torch_cli_inputs import _bn, _kernel, _vec

STRIDES = (8, 16, 32)


def scrfd_mmdet_state_dict(rng, arch):
    """An mmdet SCRFD checkpoint's state dict for `arch` (a
    `models.scrfd_v1e.SCRFDArch`: ResNetV1e, PAFPN, shared GN head)."""
    sd = {}
    half, base = arch.base_channels // 2, arch.base_channels
    for (c, b), (cin, cout) in zip(((0, 1), (3, 4), (6, 7)),
                                   ((3, half), (half, half), (half, base))):
        sd[f"backbone.stem.{c}.weight"] = _kernel(rng, cout, cin, 3, 3)
        _bn(rng, sd, f"backbone.stem.{b}", cout)
    cin = base
    for s, (planes, depth) in enumerate(zip(arch.stage_planes,
                                            arch.stage_blocks)):
        stride = 1 if s == 0 else 2
        for blk in range(depth):
            t = f"backbone.layer{s + 1}.{blk}"
            sd[f"{t}.conv1.weight"] = _kernel(rng, planes, cin, 3, 3)
            _bn(rng, sd, f"{t}.bn1", planes)
            sd[f"{t}.conv2.weight"] = _kernel(rng, planes, planes, 3, 3)
            _bn(rng, sd, f"{t}.bn2", planes)
            if blk == 0 and (stride != 1 or cin != planes):
                # downsample.0 is the V1e AvgPool (no weights)
                sd[f"{t}.downsample.1.weight"] = _kernel(rng, planes, cin,
                                                         1, 1)
                _bn(rng, sd, f"{t}.downsample.2", planes)
            cin = planes
    c = arch.neck_out
    ins = arch.stage_planes[arch.start_level:]

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = _kernel(rng, cout, cin, k, k)
        sd[f"{name}.bias"] = _vec(rng, cout)

    for i, ch in enumerate(ins):
        conv(f"neck.lateral_convs.{i}.conv", c, ch, 1)
        conv(f"neck.fpn_convs.{i}.conv", c, c, 3)
    for i in range(len(ins) - 1):
        conv(f"neck.downsample_convs.{i}.conv", c, c, 3)
        conv(f"neck.pafpn_convs.{i}.conv", c, c, 3)
    feat, na = arch.feat_channels, arch.num_anchors
    for i in range(arch.stacked_convs):
        t = f"bbox_head.cls_stride_convs.0.{i}"
        sd[f"{t}.conv.weight"] = _kernel(rng, feat, c if i == 0 else feat,
                                         3, 3)
        sd[f"{t}.gn.weight"] = 1.0 + _vec(rng, feat)
        sd[f"{t}.gn.bias"] = _vec(rng, feat)
    conv("bbox_head.stride_cls.0", na, feat, 3)
    conv("bbox_head.stride_reg.0", 4 * na, feat, 3)
    if arch.use_kps:
        conv("bbox_head.stride_kps.0", 10 * na, feat, 3)
    for lvl in range(len(ins)):
        sd[f"bbox_head.scales.{lvl}.scale"] = np.asarray(
            1.0 + 0.1 * rng.standard_normal(), np.float32)
    return sd


def _logit(p):
    return float(np.log(p / (1 - p)))


def planted_scrfd_graph(size=640):
    """(b): ONNX bytes of the planted-head graph of
    `tests/test_scrfd_onnx.py` (uniform maps per stride: anchor scores
    (0.9, 0.2), (0.3, 0.1), (0.2, 0.1), box distances (2, 1, 2, 1) in
    stride units, kps at the anchor centres); input "x" (1,3,size,size),
    outputs score_{s}, bbox_{s}, kps_{s} of shape (1, n, C)."""
    from ghost_tpu_torch.convert.onnx_writer import OnnxBuilder

    b = OnnxBuilder("scrfd_planted")
    b.graph_input("x", [1, 3, size, size])
    w = {k: b.initializer(np.zeros((ch, 3, 1, 1), np.float32), f"w_zero_{k}")
         for k, ch in (("s", 2), ("b", 8), ("k", 20))}
    shapes = {k: b.initializer(np.asarray([1, -1, ch], np.int64),
                               f"{k}_shape")
              for k, ch in (("score", 1), ("box", 4), ("kps", 10))}
    b_kps = b.initializer(np.zeros((20,), np.float32), "b_kps")
    box_d = np.tile(np.asarray((2.0, 1.0, 2.0, 1.0), np.float32), 2)
    for i, (s, sc) in enumerate(zip(STRIDES, ((0.9, 0.2), (0.3, 0.1),
                                              (0.2, 0.1)))):
        b_s = b.initializer(np.asarray([_logit(sc[0]), _logit(sc[1])],
                                       np.float32), f"b_score{i}")
        b_b = b.initializer(box_d, f"b_box{i}")
        p = b.node("AveragePool", ["x"], kernel_shape=[s, s],
                   strides=[s, s])
        one = dict(kernel_shape=[1, 1], strides=[1, 1], pads=[0, 0, 0, 0])
        cs = b.node("Sigmoid", [b.node("Conv", [p, w["s"], b_s], **one)])
        b.node("Reshape", [b.node("Transpose", [cs], perm=[0, 2, 3, 1]),
                           shapes["score"]], outputs=[f"score_{s}"])
        cb = b.node("Conv", [p, w["b"], b_b], **one)
        b.node("Reshape", [b.node("Transpose", [cb], perm=[0, 2, 3, 1]),
                           shapes["box"]], outputs=[f"bbox_{s}"])
        ck = b.node("Conv", [p, w["k"], b_kps], **one)
        b.node("Reshape", [b.node("Transpose", [ck], perm=[0, 2, 3, 1]),
                           shapes["kps"]], outputs=[f"kps_{s}"])
    for kind, ch in (("score", 1), ("bbox", 4), ("kps", 10)):
        for s in STRIDES:
            b.graph_output(f"{kind}_{s}", [1, (size // s) ** 2 * 2, ch])
    return b.serialize()


# ------------------------------------------------------------------ (c)
def _f32(t):
    return t.detach().float().cpu().numpy()


def _emit_conv(b, x, conv):
    """A port `nn.layers.Conv` (OIHW weight, torch padding) as Conv."""
    ins = [x, b.initializer(_f32(conv.weight))]
    if conv.bias is not None:
        ins.append(b.initializer(_f32(conv.bias)))
    kh, kw = conv.weight.shape[2:]
    (sh, sw), (ph, pw) = conv.stride, conv.padding
    return b.node("Conv", ins, kernel_shape=[kh, kw], strides=[sh, sw],
                  pads=[ph, pw, ph, pw])


def _emit_bn(b, x, bn):
    return b.node("BatchNormalization", [
        x, b.initializer(_f32(bn.weight)), b.initializer(_f32(bn.bias)),
        b.initializer(_f32(bn.running_mean)),
        b.initializer(_f32(bn.running_var))], epsilon=float(bn.eps))


def _emit_block(b, x, blk):
    """models/scrfd.py ConvBlock: conv, BN, ReLU."""
    return b.node("Relu", [_emit_bn(b, _emit_conv(b, x, blk.conv), blk.bn)])


def emit_scrfd(det, batch="b") -> bytes:
    """(c): `models/scrfd.py:SCRFD` `det` (backbone, PAFPN, head) as
    ONNX bytes: input "input.1" (B,3,S,S) normalized NCHW, 9 outputs
    [score_8/16/32 (B,n,1) sigmoid, bbox_* (B,n,4), kps_* (B,n,10)]."""
    from ghost_tpu_torch.convert.onnx_writer import OnnxBuilder

    b = OnnxBuilder("scrfd")
    x = b.graph_input("input.1", [batch, 3, "h", "w"])
    bb = det.backbone
    x = _emit_block(b, _emit_block(b, x, bb.stem0), bb.stem1)
    feats = []
    for s, names in enumerate(bb.plan):
        for name in names:
            blk = getattr(bb, name)
            h = _emit_bn(b, _emit_conv(b, _emit_block(b, x, blk.c1), blk.c2),
                         blk.bn2)
            if blk.has_ds:
                x = _emit_bn(b, _emit_conv(b, x, blk.ds), blk.ds_bn)
            x = b.node("Relu", [b.node("Add", [h, x])])
        if s >= 1:
            feats.append(x)
    neck = det.neck
    lat = [_emit_conv(b, f, getattr(neck, f"lat{i}"))
           for i, f in enumerate(feats)]
    td = [None] * neck.n
    td[-1] = lat[-1]
    up2 = b.initializer(np.asarray([1, 1, 2, 2], np.float32), "up2")
    for i in range(neck.n - 2, -1, -1):
        # the strides' maps are exact halves: nearest 2x is the resize
        td[i] = b.node("Add", [lat[i], b.node("Resize", [td[i + 1], "", up2],
                                              mode="nearest")])
    td = [_emit_block(b, t, getattr(neck, f"td{i}")) for i, t in enumerate(td)]
    pyr = [td[0]]
    for i in range(1, neck.n):
        pyr.append(b.node("Add", [td[i], _emit_block(
            b, pyr[-1], getattr(neck, f"bu{i}"))]))
    head = det.head
    shapes = {ch: b.initializer(np.asarray([0, -1, ch], np.int64),
                                f"rows_{ch}") for ch in (1, 4, 10)}
    outs = {"score": [], "bbox": [], "kps": []}
    for stride, h in zip(STRIDES, pyr):
        for i in range(head.stacked):
            h = _emit_block(b, h, getattr(head, f"tower{i}"))
        for kind, conv, ch in (("score", head.score, 1),
                               ("bbox", head.bbox, 4),
                               ("kps", head.kps, 10)):
            t = b.node("Transpose", [_emit_conv(b, h, conv)],
                       perm=[0, 2, 3, 1])
            name = f"{kind}_{stride}"
            if kind == "score":
                t = b.node("Reshape", [t, shapes[ch]])
                b.node("Sigmoid", [t], outputs=[name])
            else:
                b.node("Reshape", [t, shapes[ch]], outputs=[name])
            outs[kind].append((name, ch))
    for kind in ("score", "bbox", "kps"):
        for name, ch in outs[kind]:
            b.graph_output(name, [batch, "n", ch])
    return b.serialize()


# ------------------------------------------------------------------ (d)
def recognition_graph(rng) -> bytes:
    """(d): input "data" (B,3,112,112) -> "fc1" (B,512): a stride-4 3x3
    conv to 4 channels, PRelu, Flatten, Gemm."""
    from ghost_tpu_torch.convert.onnx_writer import OnnxBuilder

    def f32(a):
        return np.asarray(a, np.float32)

    b = OnnxBuilder("rec")
    x = b.graph_input("data", ["b", 3, 112, 112])
    c = b.node("Conv", [x, b.initializer(f32(rng.normal(0, 0.2,
                                                        (4, 3, 3, 3)))),
                        b.initializer(f32(rng.normal(0, 0.2, 4)))],
               kernel_shape=[3, 3], strides=[4, 4], pads=[1, 1, 1, 1])
    p = b.node("PRelu", [c, b.initializer(f32(rng.uniform(0.05, 0.5,
                                                          (4, 1, 1))))])
    b.node("Gemm", [b.node("Flatten", [p], axis=1),
                    b.initializer(f32(rng.normal(0, 0.02,
                                                 (512, 4 * 28 * 28)))),
                    b.initializer(f32(rng.normal(0, 0.05, 512)))],
           transB=1, outputs=["fc1"])
    b.graph_output("fc1", ["b", 512])
    return b.serialize()
