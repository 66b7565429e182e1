"""Build and load the CUDA kernels (csrc/*.cu) as one shared library.

nvcc compiles every csrc/*.cu for Hopper (sm_90a) into
jpeg_encoder_torch/_build/libjpeg_torch_kernels.so, which ctypes loads;
the kernels have a plain C interface, so no PyTorch header is compiled
(seconds of nvcc instead of minutes). The build runs at first use and
again whenever a source is newer than the library. It is never run at
import time: the CPU-only test machine imports every module and has no
nvcc.

-fmad=false and no --use_fast_math: the kernels' results must equal the
plain PyTorch versions bit for bit, which rules out fused multiply-adds
and approximate division. A failed build raises with nvcc's stderr; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libjpeg_torch_kernels.so")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError(
        f"nvcc not found (neither on PATH nor at {default}): the CUDA "
        "kernels of jpeg_encoder_torch cannot be built on this machine"
    )


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def build() -> None:
    """Compile csrc/*.cu into LIB_PATH."""
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Per-process temporary name: concurrent builds must not interleave
    # writes into one file; os.replace installs the finished library.
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            _lib = ctypes.CDLL(LIB_PATH)
        return _lib
