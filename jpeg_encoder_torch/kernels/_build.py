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
sass_counts counts chosen opcodes in each kernel of a built library
(cuobjdump -sass), e.g. the conversions F1 is written to avoid.
"""

from __future__ import annotations

import contextlib
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
_recording = threading.local()  # .counts: this thread's capture's launches


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


def cuobjdump_path() -> str | None:
    """The toolkit's cuobjdump beside nvcc, or on PATH; None if neither."""
    with contextlib.suppress(RuntimeError):
        beside = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
        if os.path.exists(beside):
            return beside
    return shutil.which("cuobjdump")


def kernel_label(symbol: str) -> str:
    """A mangled kernel name as its name and template arguments, e.g.
    front_kernel<2, 2, 1> (integers and bools in order)."""
    found = re.findall(r"[A-Za-z_]+_kernel", symbol)
    name = found[-1] if found else symbol
    tail = symbol.split(name, 1)[-1]
    args = re.findall(r"L[ib](\d+)E", tail.split("EEv", 1)[0])
    return f"{name}<{', '.join(args)}>" if args else name


def sass_counts(path: str, prefixes: tuple[str, ...]) -> dict | None:
    """{kernel label: {opcode: count}} of the library at path: the SASS
    instructions (cuobjdump -sass) of each kernel whose opcode begins with
    one of prefixes, by full opcode (e.g. I2F.U32); None where the toolkit
    has no cuobjdump."""
    tool = cuobjdump_path()
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, kernel = {}, None
    for line in out.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            kernel = counts.setdefault(kernel_label(func.group(1)), {})
            continue
        op = _SASS_OPCODE.search(line)
        if kernel is not None and op and op.group(1).startswith(prefixes):
            kernel[op.group(1)] = kernel.get(op.group(1), 0) + 1
    return counts


# An instruction of cuobjdump -sass: its address, a predicate, the opcode.
_SASS_OPCODE = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


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
        and count the launch; raise if it failed. Inside recording() the
        launch is counted there instead: it was captured into a CUDA graph,
        and runs on the card only when the graph is replayed."""
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: cudaError_t {err}"
            )
        captured = getattr(_recording, "counts", None)
        if captured is not None:
            captured[self] = captured.get(self, 0) + 1
            return
        add_launches({self: 1})


@contextlib.contextmanager
def recording():
    """Count this thread's kernel launches into the dict it yields (Kernel
    -> launches) instead of Kernel.launches: graphs.py wraps a capture in
    it and adds the dict to the counts at every replay (add_launches)."""
    _recording.counts = {}
    try:
        yield _recording.counts
    finally:
        _recording.counts = None


def add_launches(counts: dict) -> None:
    """Add launches (Kernel -> count) to each kernel's count."""
    with _count_lock:  # the stream engine launches from two threads
        for kernel, n in counts.items():
            kernel.launches += n
