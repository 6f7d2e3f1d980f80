"""Build the CUDA sources of `ghost_tpu_torch/csrc` into shared libraries.

nvcc compiles each `csrc/<name>.cu` for sm_90a into a library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds). The build runs at first use, into `build/ghost_tpu_torch/`
at the root of the checkout, under a name that carries a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edit
rebuilds. `build(names)` starts one nvcc per source at once and waits
for all of them. The compiler's `-Xptxas -v` report (registers, shared
memory, spills per kernel) is printed once, to stderr, when a library is
built. `launch` calls a library entry point on the current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "ghost_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("aad_modulate", "flash_attention", "layer_norm", "conv3x3")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_REPORTS: dict[str, dict] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is not None and Path(CUDA_HOME, "bin", "nvcc").exists():
            nvcc = str(Path(CUDA_HOME, "bin", "nvcc"))
    if nvcc is None:
        raise RuntimeError("nvcc not found: a CUDA toolkit is needed to build "
                           "the port's kernels")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> None:
    """Build every named source that has no library yet: one nvcc each,
    all started together."""
    todo = [n for n in names if n not in _LIBS and not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    jobs = {}
    for name in todo:
        lib_path = _lib_path(name)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, cmd, tmp, lib_path)
    failed = []
    for name, (proc, cmd, tmp, lib_path) in jobs.items():
        _, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (rc {proc.returncode}):"
                          f"\n{err}")
            continue
        os.replace(tmp, lib_path)
        BUILD_REPORTS[name] = {"seconds": seconds, "cmd": cmd,
                               "ptxas": err.strip()}
        print(f"[ghost_tpu_torch] built {lib_path.name} in {seconds:.2f} s\n"
              f"{err.strip()}", file=sys.stderr, flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))


def launch(index: int, name: str, fn, *args) -> None:
    """fn(*args, stream) on device `index` and its current stream, for a
    library entry point that returns a cudaError_t; the device context is
    entered only when `index` is not current. Raises on a launch error."""
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return launch(index, name, fn, *args)
    # the stream's raw handle, as Triton's launcher reads it: no Stream
    # object is built on every call
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError {rc}")


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]
