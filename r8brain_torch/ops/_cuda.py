"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface, ``_build/<name>-<hash>.so`` inside the package, keyed on
a hash of the source, the shared headers ``csrc/*.cuh`` and the flags, and
loaded with ``ctypes``.  Nothing is
built when a module is imported: the first launch builds, or a caller
builds every kernel at once with ``build`` (one ``nvcc`` per source, all
started together).  A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch
from torch.autograd import forward_ad

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: No --use_fast_math: the kernels' compensated sums must not be
#: reassociated, and no TF32 is ever used.
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ptxas's register / spill report of each build, by kernel source name.
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def lib_path(name: str) -> Path:
    # the kernels' shared headers (csrc/*.cuh) count as part of each source
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all running at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        build_logs[name] = log
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def no_gradient(name: str, *tensors) -> None:
    """Raise when a kernel that has no gradient is handed a tensor that
    autograd or torch.func differentiates: its output would silently drop
    that path's share of the gradient.  Chains on such kernels
    differentiate through ``functional.resample_fn``'s twin."""
    for t in tensors:
        if t is not None and ((torch.is_grad_enabled() and t.requires_grad)
                              or forward_ad.unpack_dual(t).tangent
                              is not None):
            raise RuntimeError(
                f"{name} has no gradient: differentiate the chain through "
                f"r8brain_torch.resample_fn, whose backward runs a twin "
                f"on the default engines")
