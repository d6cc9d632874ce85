"""Build and load the package's CUDA kernels (``octvr_tpu_torch/csrc``).

The sources fall in two groups, each built into a shared library of its
own with a plain C interface and loaded with ``ctypes`` by name
(``load_library(group)``):

- ``product``: ``remap.cu``, the remap kernels of every stitch path;
- ``tools``: ``mxu_taps.cu``, the MXU-taps probe's kernels (an
  instrument, off every product path).

So a fault in a tool's source never breaks the product, and the
product's first build compiles only its own source.  nvcc takes a few
seconds per library, against minutes for ``torch.utils.cpp_extension.load``
(whose sources include PyTorch's headers).  A library is built at first
use into ``build/octvr_tpu_torch/`` at the root of the checkout, and
cached by a hash of its own group's sources and the flags.  Nothing here
runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["GROUPS", "NVCC_FLAGS", "build_dir", "library_path", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"

GROUPS = {"product": ("remap.cu",), "tools": ("mxu_taps.cu",)}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS = {}


def build_dir() -> Path:
    return _PKG.parent / "build" / "octvr_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (not on PATH, no CUDA_HOME/bin/nvcc)")


def _sources(group: str):
    if group not in GROUPS:
        raise ValueError(f"unknown kernel group {group!r}, not in {sorted(GROUPS)}")
    srcs = [_CSRC / name for name in GROUPS[group]]
    missing = [str(s) for s in srcs if not s.exists()]
    if missing:
        raise RuntimeError(f"missing CUDA sources of group {group!r}: {missing}")
    return srcs


def library_path(group: str) -> Path:
    """Path of ``group``'s shared library for its current sources and
    the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources(group):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return build_dir() / f"liboctvr_{group}_{h.hexdigest()[:16]}.so"


def load_library(group: str) -> ctypes.CDLL:
    """Build (if the cached library is missing) and load ``group``'s
    kernels.  Raises if nvcc is missing or the build fails; the
    compiler's output, register and spill counts included, is kept
    beside the library as ``<name>.log``."""
    if group in _LIBS:
        return _LIBS[group]
    lib = library_path(group)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources(group))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lib.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on group {group!r} ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    _LIBS[group] = ctypes.CDLL(str(lib))
    return _LIBS[group]
