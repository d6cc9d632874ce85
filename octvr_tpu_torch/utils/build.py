"""Build and load the package's CUDA kernels (``octvr_tpu_torch/csrc``).

nvcc compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, loaded with ``ctypes``: a few seconds per build, against
minutes for ``torch.utils.cpp_extension.load`` (whose sources include
PyTorch's headers).  The build happens at first use, into
``build/octvr_tpu_torch/`` at the root of the checkout, and is cached by
a hash of the sources and flags.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "library_path", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIB = None


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


def _sources():
    srcs = sorted(_CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    return srcs


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return build_dir() / f"liboctvr_kernels_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Build (if the cached library is missing) and load the kernels.
    Raises if nvcc is missing or the build fails; the compiler's output,
    register and spill counts included, is kept beside the library as
    ``<name>.log``."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = library_path()
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lib.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    _LIB = ctypes.CDLL(str(lib))
    return _LIB
