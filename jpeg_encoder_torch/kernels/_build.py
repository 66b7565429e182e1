"""Build and load the CUDA kernels, one shared library per csrc/*.cu.

nvcc compiles each csrc/<name>.cu for Hopper (sm_90a) into
jpeg_encoder_torch/_build/lib<name>.so, which ctypes loads; the kernels have
a plain C interface, so no PyTorch header is compiled (seconds of nvcc
instead of minutes). build() starts one nvcc per source, all at once. A
library is built at its first use and again whenever its source (or a
shared .cuh) is newer. Nothing is built at import time: the CPU-only test
machine imports every module and has no nvcc.

-fmad=false and no --use_fast_math for every source: the exact kernels'
results must equal the plain PyTorch versions bit for bit, which rules out
contracted multiply-adds and approximate division (a kernel that is not
exact by contract spells its fused multiply-adds out). A failed build
raises with nvcc's stderr; there is no fallback. ptxas reports each
kernel's registers, spills and shared memory (-Xptxas=-v); build() keeps
the reports of the sources it compiled (ptxas_usage reads them).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_reports: dict[str, str] = {}  # source name -> nvcc's stderr (ptxas -v)


def names() -> list[str]:
    """The kernel sources, csrc/<name>.cu, by name."""
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC, "*.cu"))
    )


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


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


def _stale(name: str) -> bool:
    path = lib_path(name)
    if not os.path.exists(path):
        return True
    built = os.path.getmtime(path)
    deps = [os.path.join(CSRC, f"{name}.cu")]
    deps += glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def build(which: list[str] | None = None, csrc: str | None = None,
          build_dir: str | None = None) -> None:
    """Compile csrc/<name>.cu into build_dir/lib<name>.so for each name
    (all by default), one nvcc process per source, all running at once.
    Another csrc and build_dir build another checkout's sources (chip_smoke
    --parent)."""
    own = build_dir is None
    csrc, build_dir = csrc or CSRC, build_dir or BUILD_DIR
    nvcc = nvcc_path()
    os.makedirs(build_dir, exist_ok=True)
    jobs = []
    for name in which or names():
        # Per-process temporary name: concurrent builds must not interleave
        # writes into one file; os.replace installs the finished library.
        tmp = os.path.join(build_dir, f"lib{name}.so.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(csrc, f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        jobs.append((name, tmp, cmd, proc))
    errors = []
    for name, tmp, cmd, proc in jobs:
        _, stderr = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, os.path.join(build_dir, f"lib{name}.so"))
            if own:
                _reports[name] = stderr
            continue
        if os.path.exists(tmp):
            os.unlink(tmp)
        errors.append(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{stderr}"
        )
    if errors:
        raise RuntimeError("\n".join(errors))


def ptxas_usage(name: str) -> list[str]:
    """One line per kernel of csrc/<name>.cu from the last build()'s ptxas
    report: "<kernel>: <registers>, <spill stores>, <spill loads>, <smem>"
    (empty if build() did not compile it in this process)."""
    lines, kernel, spills = [], None, ""
    for line in _reports.get(name, "").splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            found = re.findall(r"[A-Za-z_]+_kernel", entry.group(1))
            kernel = found[-1] if found else entry.group(1)
        elif "spill stores" in line:
            spills = ", ".join(part.strip() for part in line.split(",")[1:])
        elif kernel and "Used" in line and "registers" in line:
            used = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{kernel}: {used} registers, {spills}, "
                         f"{smem.group(1) if smem else 0} bytes smem")
            kernel = None
    return lines


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built first if missing or
    stale."""
    with _lock:
        if name not in _libs:
            if _stale(name):
                build([name])
            _libs[name] = ctypes.CDLL(lib_path(name))
        return _libs[name]


@dataclasses.dataclass(eq=False)
class Kernel:
    """One kernel: its source csrc/<lib>.cu (lib defaults to the name; one
    source may export several entries), the C entry point it exports, the
    TPU kernel it replaces, and its launch count."""

    name: str
    symbol: str
    argtypes: tuple
    replaces: str  # file:line of the Pallas kernel in jpeg_encoder_tpu
    lib: str = ""
    launches: int = 0  # since the last reset; the CPU path does not count

    def __post_init__(self) -> None:
        self.lib = self.lib or self.name

    @property
    def source(self) -> str:
        return f"jpeg_encoder_torch/csrc/{self.lib}.cu"

    @functools.cached_property
    def _fn(self):
        fn = getattr(load(self.lib), self.symbol)
        fn.argtypes = list(self.argtypes)
        fn.restype = ctypes.c_int
        return fn

    def loaded_from(self, path: str) -> "Kernel":
        """This kernel, counting from 0, with its entry point taken from
        the library at path: another build of its source, whose C entry
        must take the same arguments (chip_smoke --parent times a parent
        commit's kernel with it)."""
        other = dataclasses.replace(self, launches=0)
        fn = getattr(ctypes.CDLL(path), self.symbol)
        fn.argtypes = list(self.argtypes)
        fn.restype = ctypes.c_int
        other.__dict__["_fn"] = fn
        return other

    def launch(self, *args) -> None:
        """Call the entry point (which returns the launch's cudaError_t)
        and count the launch; raise if it failed."""
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: cudaError_t {err}"
            )
        with _count_lock:  # the stream engine launches from two threads
            self.launches += 1
