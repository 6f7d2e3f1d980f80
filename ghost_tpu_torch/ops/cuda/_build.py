"""Build a CUDA source of `ghost_tpu_torch/csrc` into a shared library.

nvcc compiles each `csrc/<name>.cu` for sm_90a into a library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds). The build runs at first use, into `build/ghost_tpu_torch/`
at the root of the checkout, under a name that carries a hash of the
source and flags, so an edited source rebuilds. The compiler's
`-Xptxas -v` report (registers, shared memory, spills per kernel) is
printed once, to stderr, when a library is built.
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

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "ghost_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(rc {res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib_path)
        BUILD_REPORTS[name] = {"seconds": seconds, "cmd": cmd,
                               "ptxas": res.stderr.strip()}
        print(f"[ghost_tpu_torch] built {lib_path.name} in {seconds:.2f} s\n"
              f"{res.stderr.strip()}", file=sys.stderr, flush=True)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    return lib
