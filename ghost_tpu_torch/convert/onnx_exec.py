"""ONNX graph executor in torch (no onnxruntime), mirroring
`ghost_tpu/convert/onnx_exec.py` op for op.

Runs the reference's ONNX models (the detector and recognizer packs,
reference download_models.sh:6-8; the inswapper_128 teacher,
train.py:44) on the card: `read_onnx_graph` (onnx_reader) supplies the
topology and the weights, and this module interprets the node list into
torch operations on every call, eagerly (one launch or a few per node).

Semantics:
  * executes in ONNX's native NCHW layout;
  * float initializers, and the outputs of float Constant nodes, become
    tensors on the executor's device once, at construction; feeds
    shadow same-named initializers;
  * shape-carrying values stay concrete numpy or Python values on the
    host, as the JAX executor keeps them at trace time: Shape outputs,
    integer initializers and Constants, and the operands of Reshape,
    Slice, Resize/Upsample, the axes and repeats operands
    (`_HOST_OPERANDS`). A node whose inputs are all such values
    computes on the host in numpy (the JAX executor's `_lib`); every
    other node computes on the device, and float outputs are returned
    as tensors on the device;
  * eval-mode semantics (BatchNormalization uses stored moments,
    Dropout = identity).

Reproduced as the JAX executor has them, not repaired:
  * ConvTranspose is a correlation with the flipped kernel over the
    stride-dilated input, padded (k-1-pad_begin, k-1-pad_end +
    output_padding); its `dilations` are ignored;
  * pooling grows the end padding under `ceil_mode` and divides an
    average by the real element count unless `count_include_pad`;
  * BatchNormalization takes 1/sqrt(var + eps) in numpy float32 when the
    moments are unfed initializers (computed once, at construction);
  * Resize and Upsample send every `nearest*` mode to the port's
    `nn.layers.resize(method="nearest")` (torch's legacy floor
    convention) whatever the `coordinate_transformation_mode`; `linear`
    is `align_corners` only when asked;
  * Cast goes through the reader's `_DTYPE` table.

Unsupported ops raise at construction with the op name, and so do
`auto_pad` on Conv and the pools (the JAX executor raises at the call)
and a grouped ConvTranspose.
"""

from __future__ import annotations

import operator
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ghost_tpu_torch.convert.onnx_reader import _DTYPE, OnnxGraph
from ghost_tpu_torch.nn.layers import resize as nhwc_resize

# input positions whose values the ops read on the host (shape-carrying)
_HOST_OPERANDS = {
    "Reshape": (1,), "Slice": (1, 2, 3, 4), "Resize": (1, 2, 3),
    "Upsample": (1,), "Unsqueeze": (1,), "Squeeze": (1,), "Expand": (1,),
    "Tile": (1,), "Pad": (1, 2), "ConstantOfShape": (0,), "Split": (1,),
    "ReduceMean": (1,), "ReduceSum": (1,), "ReduceMax": (1,),
    "Clip": (1, 2),
}
# the ops that read `pads` through `_pads4` (and so refuse auto_pad)
_PADS4_OPS = ("Conv", "MaxPool", "AveragePool")


def _np(v):
    return isinstance(v, (np.ndarray, np.generic, int, float, list, tuple))


def _host(*args):
    """True when every argument is a host value (or absent)."""
    return all(_np(a) or a is None for a in args)


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


class OnnxExecutor:
    """Runs an `OnnxGraph` on `device` (the card by default; a CPU run
    asks for device="cpu"). `ex(feeds)` -> the graph outputs in order."""

    def __init__(self, graph: OnnxGraph, device="cuda"):
        self.graph = graph
        missing = sorted({n.op_type for n in graph.nodes
                          if not hasattr(self, f"op_{n.op_type}")})
        if missing:
            raise NotImplementedError(f"unsupported ONNX ops: {missing}")
        for n in graph.nodes:
            auto = n.attrs.get("auto_pad", "NOTSET")
            if n.op_type in _PADS4_OPS and auto not in ("NOTSET", "", None):
                raise NotImplementedError(f"auto_pad={auto}")
            if n.op_type == "ConvTranspose" and int(n.attrs.get("group",
                                                                1)) != 1:
                raise NotImplementedError("grouped ConvTranspose")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OnnxExecutor: no CUDA card; pass "
                               "device='cpu' to run on the CPU")
        # host copies of everything known before a call: initializers and
        # the outputs of Constant nodes
        self._host_vals: Dict[str, Any] = dict(graph.initializers)
        for n in graph.nodes:
            if n.op_type == "Constant":
                self._host_vals[n.outputs[0]] = self.op_Constant(n, [])
        self._dev = {k: self._t(v) for k, v in self._host_vals.items()
                     if np.asarray(v).dtype.kind == "f"}
        # BatchNormalization's scale * 1/sqrt(var + eps) from unfed moments
        self._bn_mul = {}
        for n in graph.nodes:
            if n.op_type == "BatchNormalization" and all(
                    i in self._host_vals for i in n.inputs[1:5]):
                scale, var = (np.asarray(self._host_vals[i])
                              for i in (n.inputs[1], n.inputs[4]))
                eps = n.attrs.get("epsilon", 1e-5)
                self._bn_mul[id(n)] = self._t(
                    scale * (1.0 / np.sqrt(var + eps)))

    # ------------------------------------------------------------- driver
    def __call__(self, feeds: Dict[str, Any]) -> List[Any]:
        vals: Dict[str, Any] = dict(self._host_vals)
        vals.update(self._dev)
        for k, v in feeds.items():
            vals[k] = v if isinstance(v, torch.Tensor) or \
                np.asarray(v).dtype.kind != "f" else self._t(v)
        for node in self.graph.nodes:
            if node.op_type == "Constant":
                continue  # evaluated at construction
            host = _HOST_OPERANDS.get(node.op_type, ())
            args = []
            for pos, name in enumerate(node.inputs):
                if not name:
                    args.append(None)
                elif pos in host:
                    args.append(self._host_vals[name]
                                if name in self._host_vals
                                and name not in feeds
                                else self._to_host(vals[name]))
                else:
                    args.append(vals[name])
            outs = getattr(self, f"op_{node.op_type}")(node, args)
            if not isinstance(outs, (list, tuple)):
                outs = (outs,)
            for name, val in zip(node.outputs, outs):
                if name:
                    vals[name] = val
        return [self._t(v) if _np(v) and np.asarray(v).dtype.kind == "f"
                else v for v in (vals[o] for o in self.graph.outputs)]

    # ------------------------------------------------------------ helpers
    def _t(self, v):
        """A value as a tensor on the executor's device (float64 host
        values become float32, as JAX keeps them without x64)."""
        if isinstance(v, torch.Tensor):
            return v
        arr = np.asarray(v)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        # a copy: the reader's arrays are read-only views of the file
        return torch.tensor(arr, device=self.device)

    @staticmethod
    def _to_host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return v

    @staticmethod
    def _ints(v) -> List[int]:
        if v is None:
            return []
        return [int(x) for x in np.asarray(v).reshape(-1)]

    def _binary(self, fn, a):
        if _host(a[0], a[1]):
            return fn(np.asarray(a[0]), np.asarray(a[1]))
        return fn(self._t(a[0]), self._t(a[1]))

    @staticmethod
    def _unary(np_fn, torch_fn, x):
        return np_fn(x) if _np(x) else torch_fn(x)

    # -------------------------------------------------------- elementwise
    def op_Add(self, n, a):
        return self._binary(operator.add, a)

    def op_Sub(self, n, a):
        return self._binary(operator.sub, a)

    def op_Mul(self, n, a):
        return self._binary(operator.mul, a)

    def op_Div(self, n, a):
        x, y = a
        if _host(x, y) and np.issubdtype(np.asarray(x).dtype, np.integer):
            return np.asarray(x) // np.asarray(y)
        return self._binary(operator.truediv, a)

    def op_Pow(self, n, a):
        return self._binary(operator.pow, a)

    def op_Sqrt(self, n, a):
        return self._unary(np.sqrt, torch.sqrt, a[0])

    def op_Exp(self, n, a):
        return self._unary(np.exp, torch.exp, a[0])

    def op_Neg(self, n, a):
        return -a[0]

    def op_Abs(self, n, a):
        return self._unary(np.abs, torch.abs, a[0])

    def op_Erf(self, n, a):
        return torch.special.erf(self._t(a[0]))

    def op_Relu(self, n, a):
        return self._unary(lambda x: np.maximum(x, 0), torch.relu, a[0])

    def op_LeakyRelu(self, n, a):
        alpha = n.attrs.get("alpha", 0.01)
        x = a[0]
        lib = np if _np(x) else torch
        return lib.where(x >= 0, x, alpha * x)

    def op_PRelu(self, n, a):
        x, slope = self._t(a[0]), self._t(a[1])
        if slope.ndim == 1 and x.ndim == 4:  # per-channel on NCHW
            slope = slope.reshape(1, -1, 1, 1)
        return torch.where(x >= 0, x, slope * x)

    def op_Sigmoid(self, n, a):
        return torch.sigmoid(self._t(a[0]))

    def op_Tanh(self, n, a):
        return self._unary(np.tanh, torch.tanh, a[0])

    def op_Softmax(self, n, a):
        return torch.softmax(self._t(a[0]), dim=n.attrs.get("axis", -1))

    def op_Clip(self, n, a):
        lo = a[1] if len(a) > 1 and a[1] is not None else n.attrs.get("min")
        hi = a[2] if len(a) > 2 and a[2] is not None else n.attrs.get("max")
        x = self._t(a[0])
        if lo is not None:
            x = torch.clamp(x, min=np.asarray(lo).item())
        if hi is not None:
            x = torch.clamp(x, max=np.asarray(hi).item())
        return x

    def op_Where(self, n, a):
        if _host(*a):
            return np.where(a[0], a[1], a[2])
        return torch.where(self._t(a[0]), self._t(a[1]), self._t(a[2]))

    def op_Equal(self, n, a):
        return self._binary(operator.eq, a)

    def op_Greater(self, n, a):
        return self._binary(operator.gt, a)

    def op_Less(self, n, a):
        return self._binary(operator.lt, a)

    # ---------------------------------------------------------- structure
    def op_Identity(self, n, a):
        return a[0]

    def op_Dropout(self, n, a):
        return a[0]

    def op_Cast(self, n, a):
        dt = _DTYPE[int(n.attrs["to"])]
        if _np(a[0]):
            return np.asarray(a[0]).astype(dt)
        return a[0].to(_torch_dtype(dt))

    def op_Constant(self, n, a):
        for key in ("value", "value_float", "value_int", "value_ints",
                    "value_floats"):
            if key in n.attrs:
                return np.asarray(n.attrs[key])
        raise ValueError("Constant node without value")

    def op_ConstantOfShape(self, n, a):
        shape = self._ints(a[0])
        fill = n.attrs.get("value")
        fill = np.asarray(fill).reshape(-1) if fill is not None else \
            np.zeros(1, np.float32)
        return np.full(shape, fill[0], dtype=np.asarray(fill).dtype)

    def op_Shape(self, n, a):
        return np.asarray(tuple(np.shape(a[0]) if _np(a[0])
                                else a[0].shape), np.int64)

    def op_Reshape(self, n, a):
        shape = self._ints(a[1])
        x = np.asarray(a[0]) if _np(a[0]) else a[0]
        cur = list(x.shape)
        shape = [cur[i] if s == 0 else s for i, s in enumerate(shape)]
        return x.reshape(shape)

    def op_Flatten(self, n, a):
        ax = n.attrs.get("axis", 1)
        sh = tuple(a[0].shape)
        lead = int(np.prod(sh[:ax])) if ax else 1
        return a[0].reshape(lead, -1)

    def op_Transpose(self, n, a):
        perm = n.attrs.get("perm")
        if _np(a[0]):
            return np.transpose(a[0], perm)
        x = a[0]
        return x.permute(*(perm if perm is not None
                           else range(x.ndim - 1, -1, -1)))

    def op_Concat(self, n, a):
        axis = n.attrs.get("axis", 0)
        if _host(*a):
            return np.concatenate([np.asarray(x) for x in a], axis=axis)
        return torch.cat([self._t(x) for x in a], dim=axis)

    def op_Split(self, n, a):
        x = self._t(a[0])
        axis = n.attrs.get("axis", 0)
        sizes = n.attrs.get("split") or (self._ints(a[1]) if len(a) > 1
                                         else None)
        if sizes is None:
            k = len(n.outputs)
            if x.shape[axis] % k:
                raise ValueError("array split does not result in an equal "
                                 "division")
            return tuple(torch.split(x, x.shape[axis] // k, dim=axis))
        idx = np.cumsum(sizes)[:-1]
        return tuple(torch.tensor_split(x, [int(i) for i in idx], dim=axis))

    def op_Gather(self, n, a):
        axis = n.attrs.get("axis", 0)
        if _host(*a):
            return np.take(a[0], np.asarray(a[1]).astype(np.int64),
                           axis=axis)
        x, idx = self._t(a[0]), self._t(a[1]).long()
        axis %= x.ndim
        idx = torch.where(idx < 0, idx + x.shape[axis], idx)
        out = torch.index_select(x, axis, idx.reshape(-1))
        return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])

    def op_Unsqueeze(self, n, a):
        axes = n.attrs.get("axes") or self._ints(a[1])
        out = a[0]
        for ax in sorted(self._ints(axes)):
            out = np.expand_dims(out, ax) if _np(out) else out.unsqueeze(ax)
        return out

    def op_Squeeze(self, n, a):
        axes = n.attrs.get("axes")
        if axes is None and len(a) > 1 and a[1] is not None:
            axes = self._ints(a[1])
        x = a[0]
        if axes is None:
            return np.squeeze(x) if _np(x) else x.squeeze()
        for ax in sorted(self._ints(axes), reverse=True):
            x = np.squeeze(x, axis=ax) if _np(x) else x.squeeze(ax)
        return x

    def op_Expand(self, n, a):
        shape = self._ints(a[1])
        x = np.asarray(a[0]) if _np(a[0]) else a[0]
        cur = tuple(x.shape)
        # onnx Expand broadcasts both ways; broadcast_to needs the target
        tgt = list(shape)
        if len(cur) > len(tgt):
            tgt = [1] * (len(cur) - len(tgt)) + tgt
        cur = (1,) * (len(tgt) - len(cur)) + tuple(cur)
        tgt = [max(c, t) for c, t in zip(cur, tgt)]
        if _np(x):
            return np.broadcast_to(x.reshape(cur), tgt)
        return x.reshape(cur).expand(tgt)

    def op_Tile(self, n, a):
        reps = self._ints(a[1])
        return np.tile(a[0], reps) if _np(a[0]) else torch.tile(a[0], reps)

    def op_Slice(self, n, a):
        x = a[0]
        if "starts" in n.attrs:  # opset < 10
            starts = n.attrs["starts"]
            ends = n.attrs["ends"]
            axes = n.attrs.get("axes", list(range(len(starts))))
            steps = [1] * len(starts)
        else:
            starts = self._ints(a[1])
            ends = self._ints(a[2])
            axes = self._ints(a[3]) if len(a) > 3 and a[3] is not None \
                else list(range(len(starts)))
            steps = self._ints(a[4]) if len(a) > 4 and a[4] is not None \
                else [1] * len(starts)
        if _np(x):
            idx = [slice(None)] * np.ndim(x)
            for s, e, ax, st in zip(starts, ends, axes, steps):
                idx[ax] = slice(int(s), int(e), int(st))
            return np.asarray(x)[tuple(idx)]
        # torch slicing takes no negative step: those axes gather
        for s, e, ax, st in zip(starts, ends, axes, steps):
            ax %= x.ndim
            s, e, st = slice(int(s), int(e), int(st)).indices(x.shape[ax])
            if st > 0:
                x = x[(slice(None),) * ax + (slice(s, e, st),)]
            else:
                idx = torch.arange(s, e, st, device=x.device)
                x = torch.index_select(x, ax, idx)
        return x

    def op_Pad(self, n, a):
        x = self._t(a[0])
        mode = n.attrs.get("mode", "constant")
        pads = n.attrs.get("pads") or self._ints(a[1])
        nd = x.ndim
        pairs = [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
        np_mode = {"constant": "constant", "reflect": "reflect",
                   "edge": "edge"}[mode]
        if np_mode == "constant":
            cval = 0.0
            if len(a) > 2 and a[2] is not None:
                cval = float(np.asarray(a[2]).reshape(-1)[0])
            flat = [p for pair in reversed(pairs) for p in pair]
            return F.pad(x, flat, value=cval)
        # reflect / edge: numpy's padding of each axis's index range
        for ax, (lo, hi) in enumerate(pairs):
            if lo or hi:
                idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=np_mode)
                x = torch.index_select(x, ax, torch.as_tensor(
                    idx, device=x.device))
        return x

    # ------------------------------------------------------------- linear
    def op_MatMul(self, n, a):
        return self._binary(operator.matmul, a)

    def op_Gemm(self, n, a):
        if not _host(*a):
            a = [None if v is None else self._t(v) for v in a]
        alpha = n.attrs.get("alpha", 1.0)
        beta = n.attrs.get("beta", 1.0)
        x = a[0].T if n.attrs.get("transA", 0) else a[0]
        w = a[1].T if n.attrs.get("transB", 0) else a[1]
        out = alpha * (x @ w)
        if len(a) > 2 and a[2] is not None:
            out = out + beta * a[2]
        return out

    # --------------------------------------------------------------- conv
    @staticmethod
    def _pads4(n):
        p = n.attrs.get("pads", [0, 0, 0, 0])
        return ((int(p[0]), int(p[2])), (int(p[1]), int(p[3])))

    def op_Conv(self, n, a):
        x, w = self._t(a[0]), self._t(a[1])
        b = self._t(a[2]) if len(a) > 2 and a[2] is not None else None
        strides = tuple(n.attrs.get("strides", [1, 1]))
        dil = tuple(n.attrs.get("dilations", [1, 1]))
        groups = int(n.attrs.get("group", 1))
        (pt, pb), (pl, pr) = self._pads4(n)
        if pt == pb and pl == pr:
            return F.conv2d(x, w, b, strides, (pt, pl), dil, groups)
        return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, b, strides, 0, dil,
                        groups)

    def op_ConvTranspose(self, n, a):
        x, w = self._t(a[0]), self._t(a[1])
        kh, kw = w.shape[2:4]
        sh, sw = (int(s) for s in n.attrs.get("strides", [1, 1]))
        pads = n.attrs.get("pads", [0, 0, 0, 0])
        opad = n.attrs.get("output_padding", [0, 0])
        # (I, O, kh, kw) -> flipped (O, I, kh, kw) correlation over the
        # stride-dilated input: the algebraic equivalent of the torch /
        # onnx deconvolution, as the JAX executor computes it
        wt = torch.flip(w.transpose(0, 1), dims=(2, 3))
        b, c, h, wd = x.shape
        xd = x.new_zeros((b, c, (h - 1) * sh + 1, (wd - 1) * sw + 1))
        xd[:, :, ::sh, ::sw] = x
        xd = F.pad(xd, (kw - 1 - int(pads[1]),
                        kw - 1 - int(pads[3]) + int(opad[1]),
                        kh - 1 - int(pads[0]),
                        kh - 1 - int(pads[2]) + int(opad[0])))
        y = F.conv2d(xd, wt)
        if len(a) > 2 and a[2] is not None:
            y = y + self._t(a[2]).reshape(1, -1, 1, 1)
        return y

    # ------------------------------------------------------------ pooling
    def _pool(self, n, x, avg: bool):
        x = self._t(x)
        kh, kw = n.attrs["kernel_shape"]
        strides = tuple(n.attrs.get("strides", [1, 1]))
        (pt, pb), (pl, pr) = self._pads4(n)
        if n.attrs.get("ceil_mode", 0):
            h, w = x.shape[2:4]
            pb += (-(h + pt + pb - kh) % strides[0])
            pr += (-(w + pl + pr - kw) % strides[1])
        flat = (pl, pr, pt, pb)
        if not avg:
            return F.max_pool2d(F.pad(x, flat, value=-np.inf), (kh, kw),
                                strides)
        out = F.avg_pool2d(F.pad(x, flat), (kh, kw), strides,
                           divisor_override=1)  # the window sums
        if n.attrs.get("count_include_pad", 0):
            return out / (kh * kw)
        ones = x.new_ones((1, 1) + tuple(x.shape[2:4]))
        cnt = F.avg_pool2d(F.pad(ones, flat), (kh, kw), strides,
                           divisor_override=1)
        return out / cnt

    def op_MaxPool(self, n, a):
        return self._pool(n, a[0], avg=False)

    def op_AveragePool(self, n, a):
        return self._pool(n, a[0], avg=True)

    def op_GlobalAveragePool(self, n, a):
        return self._t(a[0]).mean(dim=(2, 3), keepdim=True)

    # ------------------------------------------------------------- norms
    def op_BatchNormalization(self, n, a):
        x = self._t(a[0])
        scale, bias, mean, var = (self._t(v) for v in a[1:5])
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = self._bn_mul.get(id(n))
        if mul is None or not all(
                a[i] is self._dev.get(n.inputs[i]) for i in (1, 4)):
            mul = scale * (var + n.attrs.get("epsilon", 1e-5)) ** -0.5
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + bias.reshape(shape)

    def op_InstanceNormalization(self, n, a):
        x, scale, bias = (self._t(v) for v in a)
        eps = n.attrs.get("epsilon", 1e-5)
        axes = tuple(range(2, x.ndim))
        mu = x.mean(dim=axes, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=axes, keepdim=True)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - mu) / torch.sqrt(var + eps) * scale.reshape(shape) \
            + bias.reshape(shape)

    # ------------------------------------------------------------ reduce
    def _reduce(self, n, a, np_fn, torch_fn):
        axes = n.attrs.get("axes")
        if axes is None and len(a) > 1 and a[1] is not None:
            axes = self._ints(a[1])
        keep = bool(n.attrs.get("keepdims", 1))
        ax = tuple(self._ints(axes)) if axes is not None else None
        if _np(a[0]):
            return np_fn(a[0], axis=ax, keepdims=keep)
        x = a[0]
        return torch_fn(x, dim=ax if ax is not None else tuple(
            range(x.ndim)), keepdim=keep)

    def op_ReduceMean(self, n, a):
        return self._reduce(n, a, np.mean, torch.mean)

    def op_ReduceSum(self, n, a):
        return self._reduce(n, a, np.sum, torch.sum)

    def op_ReduceMax(self, n, a):
        return self._reduce(n, a, np.max, torch.amax)

    # ------------------------------------------------------------ resize
    def op_Upsample(self, n, a):
        scales = n.attrs.get("scales") or self._ints(a[1]) or \
            np.asarray(a[1]).tolist()
        return self._resize(a[0], scales=np.asarray(scales, np.float64),
                            mode=n.attrs.get("mode", "nearest"))

    def op_Resize(self, n, a):
        mode = n.attrs.get("mode", "nearest")
        scales = None
        sizes = None
        if len(a) > 2 and a[2] is not None and np.size(a[2]):
            scales = np.asarray(a[2], np.float64)
        if len(a) > 3 and a[3] is not None and np.size(a[3]):
            sizes = self._ints(a[3])
        return self._resize(a[0], scales=scales, sizes=sizes, mode=mode,
                            coord=n.attrs.get(
                                "coordinate_transformation_mode",
                                "half_pixel"))

    def _resize(self, x, scales=None, sizes=None, mode="nearest",
                coord="asymmetric"):
        x = self._t(x)
        b, c, h, w = x.shape
        if sizes is not None:
            oh, ow = int(sizes[2]), int(sizes[3])
        else:
            oh, ow = int(h * scales[2]), int(w * scales[3])
        xn = x.permute(0, 2, 3, 1)
        if mode.startswith("nearest"):
            out = nhwc_resize(xn, (oh, ow), method="nearest")
        elif mode in ("linear", "bilinear"):
            out = nhwc_resize(xn, (oh, ow), method="bilinear",
                              align_corners=(coord == "align_corners"))
        else:
            raise NotImplementedError(f"resize mode {mode}")
        return out.permute(0, 3, 1, 2)
