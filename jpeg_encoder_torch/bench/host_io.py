"""The stream engine's host I/O, leg by leg: what sets a folder's pace.

The instrument of the open question of which host resource the loader's
reads and the emitter's writes share (ROADMAP §2 item 10, PERF.md §7):
its emit times beside reading threads show the contention; its probe and
read times are the evidence for reading the headers in path order and
the rows natively.

    python -m jpeg_encoder_torch.bench.host_io [--images 64] [--width 1920]
        [--height 1080] [--threads N] [--reps 5] [--dir DIR]
        [--device cuda|cpu]

Writes N BMP files of corpus content (bench/dataset.write_bmps) and their
JFIF files (one parallel/stream.encode_paths pass on `device`), then
times, by the host clock, median of --reps:

- probe: the headers of every file read in path order on one thread
  (parallel/stream._probe, what encode_paths does before its legs) and
  the same reads spread over a pool of --threads threads;
- read: every file's stored rows read into one buffer a file (pinned on
  a card, as the loader's ring is), by io/bmp.read (one native call
  where the native runtime loads) and by its path without the native
  runtime, on one thread and on a pool of --threads;
- emit: the N JFIF files written one after another from one thread, as
  the stream's emitter writes them: alone, then while 1 and --threads
  threads read BMP files without pause (the loader's native read).

The JSON line gives ms a file for each. The threads default to the
decoder pool's size (one a core).

    python -m jpeg_encoder_torch.bench.host_io --upload [--images 8]
        [--width 1920] [--height 1080] [--reps 5] [--device cuda|cpu]

times instead the upload of one (images, H, W, 3) uint8 array of corpus
frames in ordinary pageable memory (what encode_batch and encode_array
take), in GB/s of the array by the host clock up to a device
synchronisation, median of --reps: (a) one pageable copy_ ("pageable");
a pinned copy of the whole array for reference ("pinned_dma"); the
host's copy alone into one pinned piece of pipeline.PIECE_BYTES, piece
after piece, (b) by torch's CPU copy_ ("fill_torch", on its intra-op
threads) and (c) by the native runtime's jt_copy_threads at 1, 2, 4 and 8
threads ("fill_native_T"); and (d) each of these overlapped with the
pieces' copies to the card through a pipeline.UploadRing ("ring_torch",
"ring_native_T"; "ring_torch_<MiB>" at other piece sizes).

    python -m jpeg_encoder_torch.bench.host_io --split [--reps 21]
        [--geometries 1920x1080,3840x2160] [--device cuda|cpu]

times instead one page-cached corpus BMP's stored rows read into the
pinned buffer of its geometry (pipeline.STAGING.take, as encode_file
reads them), at each geometry, by the host clock, the median of --reps
rounds (each candidate once a round, in a new order), in ms a file and
GB/s of the rows, by each candidate (split_candidates): (a) one pread ("one_pread": bmp.read(path, out=));
(b) N contiguous range preads on the native read pool, whose threads
start once a process ("pool_N": bmp.read(path, out=, ranges=N)); (c) the
same N ranges on threads started for each call ("threads_N":
jt_read_ranges_threads); (d) mmap of the file with MAP_POPULATE, torch's
CPU copy_ of the rows on its intra-op threads, and the munmap
("mmap_copy"); and encode_file's read ("chosen": bmp.file_ranges of the
geometry), for N in 2, 4, 8 and the CPUs the process may use. Every
candidate's rows must equal one pread's ("exact").
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import mmap
import os
import random
import shutil
import statistics
import sys
import tempfile
import threading
import time

import torch

from jpeg_encoder_torch import native, pipeline
from jpeg_encoder_torch.bench import timing
from jpeg_encoder_torch.bench.dataset import write_bmps
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.parallel import stream
from jpeg_encoder_torch.parallel.devices import resolve_device


def median_ms(fn, reps: int, count: int) -> float:
    """fn() once to warm, then the median of `reps` calls, in ms a file
    of `count` files."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3 / count


def python_read(path, buffer: torch.Tensor):
    """io/bmp.read's path without the native runtime (open, header,
    readinto) into buffer."""
    return bmp._read_python(path, buffer)


def native_read(path, buffer: torch.Tensor):
    return bmp.read(path, out=buffer)


class Readers:
    """`count` threads reading the files into their own buffers without
    pause, while the block runs."""

    def __init__(self, count: int, paths: list[str], buffers):
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self.run,
                                         args=(j, paths, buffers[j]))
                        for j in range(count)]

    def run(self, j: int, paths: list[str], buffer: torch.Tensor) -> None:
        k = j
        while not self.stop.is_set():
            native_read(paths[k % len(paths)], buffer)
            k += 1

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self.threads:
            t.join()


def main(argv: list[str] | None = None) -> int:
    ap = timing.parser(__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--threads", type=int,
                    default=len(os.sched_getaffinity(0)))
    ap.add_argument("--reps", type=int, default=None,
                    help="repetitions (default 5; 21 with --split)")
    ap.add_argument("--dir", default="")
    ap.add_argument("--upload", action="store_true",
                    help="time the upload of a pageable array instead")
    ap.add_argument("--split", action="store_true",
                    help="time one file's read as split ranges instead")
    ap.add_argument("--geometries", default="1920x1080,3840x2160",
                    help="WxH,... of the --split files")
    args = ap.parse_args(argv)
    if args.reps is None:
        args.reps = 21 if args.split else 5
    device = resolve_device(args.device)
    card = timing.card_line(device)
    if args.upload:
        return upload(args, device, card)
    if args.split:
        root = tempfile.mkdtemp(prefix="jpeg_torch_split_")
        try:
            return split(args, device, card, root)
        finally:
            shutil.rmtree(root)
    root = args.dir or tempfile.mkdtemp(prefix="jpeg_torch_io_")
    try:
        return run(args, device, card, root)
    finally:
        if not args.dir:
            shutil.rmtree(root)


def run(args, device: torch.device, card: str, root: str) -> int:
    src, out = os.path.join(root, "bmp"), os.path.join(root, "out")
    os.makedirs(src, exist_ok=True)
    os.makedirs(out, exist_ok=True)
    paths = write_bmps(src, args.images, args.height, args.width)
    files = {}
    stream.encode_paths(paths, EncoderConfig(), files.__setitem__,
                        device=device)
    n, reps, threads = len(paths), args.reps, args.threads
    nbytes = args.height * bmp.row_stride(args.width)
    buffers = torch.empty((max(n, threads), nbytes), dtype=torch.uint8,
                          pin_memory=device.type == "cuda")

    def reads(read, pool=None):
        if pool is None:
            return lambda: [read(p, b) for p, b in zip(paths, buffers)]
        return lambda: list(pool.map(read, paths, buffers))

    def emits():
        for i, path in enumerate(paths):
            with open(os.path.join(out, f"{i:05d}.jpg"), "wb") as f:
                f.write(files[path])

    line = {"metric": "host_io_ms_per_file", "images": n,
            "geometry": f"{args.width}x{args.height}", "threads": threads,
            "jfif_kb_per_file": sum(map(len, files.values())) / n / 1e3,
            "pinned": bool(buffers.is_pinned())}
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        line["probe_serial"] = median_ms(
            lambda: [stream._probe(p) for p in paths], reps, n)
        line["probe_pool"] = median_ms(
            lambda: list(pool.map(stream._probe, paths)), reps, n)
        for name, read in (("native", native_read), ("python", python_read)):
            line[f"read_{name}_1"] = median_ms(reads(read), reps, n)
            line[f"read_{name}_pool"] = median_ms(reads(read, pool), reps, n)
    line["emit_alone"] = median_ms(emits, reps, n)
    for count in (1, threads):
        with Readers(count, paths, buffers):
            line[f"emit_under_{count}_readers"] = median_ms(emits, reps, n)
    timing.log(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in line.items()))
    line.update(clock="host", card=card)
    timing.emit(line)
    return 0


class NativeRing(pipeline.UploadRing):
    """An UploadRing whose host copy is jt_copy_threads on `threads`
    threads."""

    def __init__(self, device, threads: int, **kwargs):
        super().__init__(device, **kwargs)
        self.threads = threads

    def fill(self, piece: torch.Tensor, src: torch.Tensor) -> None:
        native_copy(piece, src, self.threads)


def native_copy(dst: torch.Tensor, src: torch.Tensor, threads: int) -> None:
    """src's bytes into dst (flat contiguous uint8 host tensors of one
    size) by jt_copy_threads."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    native.load().jt_copy_threads(
        ctypes.cast(dst.data_ptr(), u8p), ctypes.cast(src.data_ptr(), u8p),
        src.numel(), threads)


def gb_per_s(fn, nbytes: int, reps: int, device: torch.device) -> float:
    """nbytes over the median seconds of fn() followed by a device
    synchronisation (fn() once to warm first)."""

    def call():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    return nbytes / (median_ms(call, reps, 1) * 1e-3) / 1e9


def upload(args, device: torch.device, card: str) -> int:
    """The --upload mode (module docstring): one JSON line of GB/s."""
    if native.load() is None:
        raise RuntimeError("the native runtime does not load: --upload "
                           "times its jt_copy_threads")
    array = timing.corpus_batch(args.height, args.width, args.images)
    src = torch.from_numpy(array).view(-1)
    nbytes, reps = src.numel(), args.reps
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    pin = device.type == "cuda"
    whole = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    whole.copy_(src)
    piece = torch.empty(pipeline.PIECE_BYTES, dtype=torch.uint8,
                        pin_memory=pin)
    step = piece.numel()

    def fill(copy):
        def run():
            for start in range(0, nbytes, step):
                part = src[start : start + step]
                copy(piece[: part.numel()], part)
        return run

    line = {"metric": "upload_gb_per_s", "images": args.images,
            "geometry": f"{args.width}x{args.height}", "array_mb":
            nbytes / 1e6, "piece_mb": step / 2**20,
            "ring_depth": pipeline.RING_DEPTH,
            "torch_threads": torch.get_num_threads(), "pinned": pin}
    line["pageable"] = gb_per_s(lambda: dst.copy_(src), nbytes, reps, device)
    line["pinned_dma"] = gb_per_s(
        lambda: dst.copy_(whole, non_blocking=True), nbytes, reps, device)
    line["fill_torch"] = gb_per_s(fill(torch.Tensor.copy_), nbytes, reps,
                                  device)
    rings = {"ring_torch": pipeline.UploadRing(device)}
    for threads in (1, 2, 4, 8):
        line[f"fill_native_{threads}"] = gb_per_s(
            fill(lambda d, s, t=threads: native_copy(d, s, t)), nbytes,
            reps, device)
        rings[f"ring_native_{threads}"] = NativeRing(device, threads)
    for mib in (1, 16):
        rings[f"ring_torch_{mib}"] = pipeline.UploadRing(
            device, piece_bytes=mib << 20)
    for name, ring in rings.items():
        line[name] = gb_per_s(lambda r=ring: r.upload(src, dst), nbytes,
                              reps, device)
    check = dst.cpu() if device.type == "cuda" else dst
    line["exact"] = bool(torch.equal(check, src))
    timing.log(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in line.items()))
    line.update(clock="host", card=card)
    timing.emit(line)
    return 0 if line["exact"] else 1


def split_counts() -> list[int]:
    """The range counts of the --split candidates: 2, 4, 8 and the CPUs
    this process may use."""
    return sorted({2, 4, 8, len(os.sched_getaffinity(0))})


def split_candidates() -> list[str]:
    """The names of the --split candidates (module docstring)."""
    counts = split_counts()
    return ["one_pread", *(f"pool_{n}" for n in counts),
            *(f"threads_{n}" for n in counts), "mmap_copy", "chosen"]


def threads_read(lib, path, buffer: torch.Tensor, ranges: int) -> None:
    """A file's rows into buffer as `ranges` range preads on threads
    started for this call (jt_read_ranges_threads), opened as bmp.read
    opens it."""
    fd, width, height = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    offset, error, used = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.jt_bmp_open_rows(
        os.fsencode(path), ctypes.byref(fd), ctypes.byref(width),
        ctypes.byref(height), ctypes.byref(offset), ctypes.byref(error))
    if rc != 0:
        raise bmp._native_error(rc, error.value, path)
    try:
        rc = lib.jt_read_ranges_threads(
            fd.value, ctypes.cast(buffer.data_ptr(),
                                  ctypes.POINTER(ctypes.c_uint8)),
            height.value * bmp.row_stride(width.value), offset.value, ranges,
            ctypes.byref(used), ctypes.byref(error))
    finally:
        os.close(fd.value)
    if rc != 0:
        raise bmp._native_error(rc, error.value, path)


_LIBC = ctypes.CDLL(None, use_errno=True)
_LIBC.mmap.restype = ctypes.c_void_p
_LIBC.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_long]
_LIBC.munmap.restype = ctypes.c_int
_LIBC.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]


def mmap_read(path, buffer: torch.Tensor) -> None:
    """A file's rows into buffer by mmap (MAP_POPULATE: the pages mapped
    in the call), torch's CPU copy_ of them, munmap."""
    fd = os.open(path, os.O_RDONLY | os.O_CLOEXEC)
    try:
        size = os.fstat(fd).st_size
        width, height, offset = bmp._header(os.pread(fd, 54, 0), size)
        address = _LIBC.mmap(None, size, mmap.PROT_READ,
                             mmap.MAP_SHARED | mmap.MAP_POPULATE, fd, 0)
    finally:
        os.close(fd)
    if address in (None, ctypes.c_void_p(-1).value):
        raise OSError(ctypes.get_errno(), "mmap failed", path)
    try:
        nbytes = height * bmp.row_stride(width)
        mapped = torch.frombuffer(
            (ctypes.c_uint8 * size).from_address(address), dtype=torch.uint8)
        buffer[:nbytes].copy_(mapped[offset: offset + nbytes])
        del mapped
    finally:
        _LIBC.munmap(address, size)


def split(args, device: torch.device, card: str, root: str) -> int:
    """The --split mode (module docstring): one JSON line of ms a file and
    GB/s a candidate and geometry."""
    lib = native.load()
    if lib is None:
        raise RuntimeError("the native runtime does not load: --split "
                           "times its reads")
    line = {"metric": "split_read_ms_per_file",
            "cpus": len(os.sched_getaffinity(0)),
            "pool_threads": lib.jt_read_pool_threads(), "reps": args.reps,
            "torch_threads": torch.get_num_threads(), "geometries": {}}
    exact = True
    for geometry in args.geometries.split(","):
        width, height = map(int, geometry.split("x"))
        src = os.path.join(root, geometry)
        os.makedirs(src)
        path = write_bmps(src, 1, height, width)[0]
        buffer = pipeline.STAGING.take(device, width, height).buffer
        ways = {"one_pread": lambda: bmp.read(path, out=buffer)}
        for n in split_counts():
            ways[f"pool_{n}"] = lambda n=n: bmp.read(path, out=buffer,
                                                     ranges=n)
            ways[f"threads_{n}"] = lambda n=n: threads_read(lib, path,
                                                            buffer, n)
        ways["mmap_copy"] = lambda: mmap_read(path, buffer)
        ways["chosen"] = lambda: bmp.read(path, out=buffer,
                                          ranges=bmp.file_ranges)
        want = bmp.read(path, out=buffer).rows.clone().view(-1)
        same = {}
        for name, way in ways.items():  # warm the page cache and the pool
            buffer.zero_()
            way()
            same[name] = torch.equal(buffer[: want.numel()], want)
        times = {name: [] for name in ways}
        names = list(ways)
        order = random.Random(0)
        for _ in range(args.reps):
            # A new order each round: no candidate always follows another
            # (torch's intra-op threads spin on after mmap_copy's copy_).
            order.shuffle(names)
            for name in names:
                t = time.perf_counter()
                ways[name]()
                times[name].append(time.perf_counter() - t)
        ms = {name: statistics.median(t) * 1e3 for name, t in times.items()}
        line["geometries"][geometry] = {
            "mb": want.numel() / 1e6, "pinned": bool(buffer.is_pinned()),
            "chosen_ranges": bmp.file_ranges(width, height),
            "ms": ms, "gb_per_s": {name: want.numel() / (t * 1e6)
                                   for name, t in ms.items()},
            "exact": same}
        exact = exact and all(same.values())
        timing.log(f"{geometry}: " + " ".join(
            f"{name}={t:.4f}ms" for name, t in ms.items()))
    line.update(exact=exact, clock="host", card=card)
    timing.emit(line)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
