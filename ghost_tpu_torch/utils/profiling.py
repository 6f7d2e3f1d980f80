"""Profiling and observability (the apex.pyprof equivalent), mirroring
`ghost_tpu/utils/profiling.py`.

The reference ships a 3-stage GPU profiler: NVTX monkey-patching of
every torch op with call stack + shapes, nvprof SQLite parsing, and
per-op FLOP/bandwidth analysis (reference apex/apex/pyprof/README.md:1-40,
nvtx/nvmarker.py:67-105, prof/blas.py). Here:

  * `trace(logdir)`: a torch.profiler session over everything inside
    the context (CPU ops, and CUDA kernels when a card is present),
    written as a Chrome trace (`trace.json`) into `logdir`;
  * `annotate(name)`: a `record_function` range (it shows in the trace)
    plus an NVTX range on CUDA, for external timelines;
  * `StageTimer`: per-stage wall-clock aggregation with items/sec
    reporting; a stage given `block_on` tensors syncs their device
    before it stops the clock;
  * `flop_estimate(fn, *args)`: the flops of one eager call counted by
    `torch.utils.flop_counter` (matmuls, convs and attention; a conv's
    taps on padding are not counted, as XLA's cost analysis does not
    count them: the same count as XLA's for a dense layer and a conv),
    and
    `bytes_accessed`, the bytes of every aten op's tensor operands and
    results (views excluded). That is an UNFUSED count: each op reads
    and writes its operands on its own, so it lies above XLA's, which
    counts a fused program's traffic once.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile everything inside the context; on exit the Chrome trace
    is written to `logdir/trace.json` (default: a directory under the
    temporary directory). Yields logdir."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "ghost_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named span: a profiler range, and an NVTX range on CUDA."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _sync(tree):
    """Wait for the devices of the CUDA tensors in `tree`."""
    devices = set()
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulates wall time + item counts per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.items: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0, block_on: Any = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _sync(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.items[name] += items

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            t = self.totals[name]
            line = f"{name:24s} {t:8.3f}s  x{self.counts[name]}"
            if self.items[name]:
                line += f"  {self.items[name] / t:9.1f} items/s"
            lines.append(line)
        return "\n".join(lines)


class _OperandBytes(TorchDispatchMode):
    """Sums the bytes of every non-view aten op's tensor operands and
    results."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for x in tree_leaves((args, kwargs, out)):
                if isinstance(x, torch.Tensor):
                    self.total += x.numel() * x.element_size()
        return out


def _valid_taps(n_in, n_out, k, stride, pad, dil) -> int:
    """(output position, kernel tap) pairs of one spatial axis whose tap
    lands inside the input (not on padding)."""
    return sum(1 for o in range(n_out) for j in range(k)
               if 0 <= o * stride - pad + j * dil < n_in)


def _conv_flop(x_shape, w_shape, _bias, stride, padding, dilation,
               transposed, *args, out_shape=None, **kwargs) -> int:
    """A forward convolution's flops as XLA's cost analysis counts them:
    2 per multiply-add of a tap inside the input, none for the taps on
    padding (torch's formula counts every tap). A transposed conv keeps
    torch's formula."""
    from torch.utils.flop_counter import conv_flop

    if transposed:
        return conv_flop(x_shape, w_shape, _bias, stride, padding, dilation,
                         transposed, *args, out_shape=out_shape, **kwargs)
    taps = 1
    for i in range(2, len(x_shape)):
        taps *= _valid_taps(x_shape[i], out_shape[i], w_shape[i],
                            stride[i - 2], padding[i - 2], dilation[i - 2])
    # w (cout, cin/groups, *k): every output channel reads cin/groups
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


def flop_estimate(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Flops and bytes of one call of fn(*args, **kwargs) (it runs)."""
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution: _conv_flop,
        torch.ops.aten._convolution: _conv_flop})
    nbytes = _OperandBytes()
    with torch.no_grad(), counter, nbytes:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float(nbytes.total)}
