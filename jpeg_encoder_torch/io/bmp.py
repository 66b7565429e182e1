"""BMP (Windows bitmap) reading and writing, host-side.

Same wire assumptions as the reference reader (bmp_image.rs): pixel-data
offset at byte 10, signed width/height at 18/22, 24-bit BGR pixels stored
bottom-to-top with rows padded to 4-byte multiples. Unlike the reference
(which issues one 3-byte read() syscall per pixel), ingest here is a single
buffer read + one vectorized numpy reshape — this is host code feeding the
device, so it must not be the bottleneck.

read(path, out=...) is the staged read of the single-file entry
(pipeline.encode_file) and of the stream's loader: it validates the
header, reads the file's pixel rows as stored (bottom row first, BGR, each
row padded to 4 bytes) straight into a caller's buffer, with no bytes
object and no host decode, and returns them as Rows, which the front kernel
(kernels/front.py) reads as stored; rows_to_rgb, its plain version's first
step, does the strip, flip and swap as torch ops. With
ranges > 1 the native runtime reads the rows as that many contiguous
ranges at once, on its read pool (file_ranges is encode_file's count).

The writer exists for fixtures, benchmarks, and round-trip tests (the
reference ships no sample images).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import struct

import numpy as np
import torch

from jpeg_encoder_torch import native, trace

_DATA_OFFSET_POS = 10
_WIDTH_POS = 18
_HEIGHT_POS = 22
_BPP_POS = 28
_HEADER_BYTES = 54


_NATIVE_ERRORS = {
    -1: "not a BMP file (missing 'BM' magic)",
    -2: "only 24-bit BMP is supported",
    -3: "unsupported BMP dimensions",
    -4: "BMP file truncated",
}
_NATIVE_IO = -6        # a system call failed (its errno is returned)
_NATIVE_POOL = -7      # jt_read_ranges: the read pool could not start

# encode_file's read of one file's rows (file_ranges), from
# bench/host_io.py --split on the card machine (PERF.md §6): READ_RANGES
# ranges where the rows hold SPLIT_MIN_BYTES or more; below that, one
# pread (a 640x480 file, 0.92 MB, read slower split, a 1366x768 one,
# 3.1 MB, faster).
READ_RANGES = 8
SPLIT_MIN_BYTES = 2 << 20


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _decode_native(lib, raw: np.ndarray) -> np.ndarray:
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    off = ctypes.c_int64()
    bpp = ctypes.c_int32()
    rc = lib.jt_bmp_probe(
        _u8ptr(raw), raw.size,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(off), ctypes.byref(bpp),
    )
    if rc != 0:
        raise ValueError(_NATIVE_ERRORS.get(rc, f"BMP decode error {rc}"))
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.jt_bmp_decode_rgb(_u8ptr(raw), raw.size, _u8ptr(out))
    if rc != 0:
        raise ValueError(_NATIVE_ERRORS.get(rc, f"BMP decode error {rc}"))
    return out


def decode(buf: bytes | np.ndarray) -> np.ndarray:
    """BMP file bytes -> (H, W, 3) uint8 RGB, top-to-bottom rows."""
    raw = np.ascontiguousarray(np.frombuffer(memoryview(buf), dtype=np.uint8))
    lib = native.load()
    if lib is not None:
        return _decode_native(lib, raw)
    width, height, data_offset = _header(bytes(raw[:_HEADER_BYTES]), raw.size)
    stride = row_stride(width)
    rows = raw[data_offset:data_offset + stride * height].reshape(
        height, stride)[:, : width * 3]
    bgr = rows.reshape(height, width, 3)
    rgb = bgr[::-1, :, ::-1]  # bottom-up storage, BGR channel order
    return np.ascontiguousarray(rgb)


def row_stride(width: int) -> int:
    """The bytes of one stored pixel row: 3 a pixel, padded to 4."""
    return (width * 3 + 3) // 4 * 4


def _header(head: bytes, size: int) -> tuple[int, int, int]:
    """(width, height, pixel-data offset) of a BMP file of `size` bytes
    from its first 54 bytes, validated as decode validates the whole file,
    with the same ValueError texts (the native probe's where the native
    runtime loads)."""
    lib = native.load()
    if lib is not None:
        raw = np.zeros(_HEADER_BYTES, np.uint8)
        raw[: len(head)] = np.frombuffer(head[:_HEADER_BYTES], np.uint8)
        w, h = ctypes.c_int32(), ctypes.c_int32()
        off, bpp = ctypes.c_int64(), ctypes.c_int32()
        rc = lib.jt_bmp_probe(
            _u8ptr(raw), size,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(off),
            ctypes.byref(bpp),
        )
        if rc != 0:
            raise ValueError(_NATIVE_ERRORS.get(rc, f"BMP decode error {rc}"))
        return w.value, h.value, off.value
    if size < _HEADER_BYTES or head[:2] != b"BM":
        raise ValueError("not a BMP file (missing 'BM' magic)")
    data_offset = int.from_bytes(head[_DATA_OFFSET_POS:_DATA_OFFSET_POS + 4], "little")
    width = int.from_bytes(head[_WIDTH_POS:_WIDTH_POS + 4], "little", signed=True)
    height = int.from_bytes(head[_HEIGHT_POS:_HEIGHT_POS + 4], "little", signed=True)
    bpp = int.from_bytes(head[_BPP_POS:_BPP_POS + 2], "little")
    if bpp != 24:
        raise ValueError(f"only 24-bit BMP is supported, got {bpp}-bit")
    if width <= 0 or height <= 0:
        raise ValueError(f"unsupported BMP dimensions {width}x{height}")
    if size < data_offset + row_stride(width) * height:
        raise ValueError("BMP file truncated")
    return width, height, data_offset


def probe_dimensions(head: bytes) -> tuple[int, int]:
    """(width, height) from the first bytes of a BMP file (>= 30 needed)."""
    if len(head) < 30 or head[:2] != b"BM":
        raise ValueError("not a BMP file (missing 'BM' magic)")
    width = int.from_bytes(head[_WIDTH_POS:_WIDTH_POS + 4], "little", signed=True)
    height = int.from_bytes(
        head[_HEIGHT_POS:_HEIGHT_POS + 4], "little", signed=True
    )
    bpp = int.from_bytes(head[_BPP_POS:_BPP_POS + 2], "little")
    if bpp != 24:
        raise ValueError(f"only 24-bit BMP is supported, got {bpp}-bit")
    if width <= 0 or height <= 0:
        raise ValueError(f"unsupported BMP dimensions {width}x{height}")
    return width, height


@dataclasses.dataclass(frozen=True)
class Rows:
    """A BMP file's pixel rows as the file stores them: `rows` is
    (height, row_stride(width)) uint8, bottom row first, BGR, each row
    padded to 4 bytes (rows_to_rgb makes the image of them); or, for a
    chunk of B files of one geometry, (B, height, row_stride(width))."""

    rows: torch.Tensor
    width: int
    height: int


def rows_to_rgb(rows: torch.Tensor, width: int) -> torch.Tensor:
    """Stored rows (Rows.rows, (..., height, stride)) -> (..., height,
    width, 3) uint8 RGB, top row first, as decode gives it: the padding
    strip, the row flip and the B/R swap, as torch ops on the rows' device
    (one contiguous copy); leading dimensions are a batch."""
    bgr = rows[..., : 3 * width].unflatten(-1, (width, 3))
    return bgr.flip((-3, -1))


def file_ranges(width: int, height: int) -> int:
    """The ranges of encode_file's read of a width x height file:
    READ_RANGES, at most one a CPU this process may use, where its rows
    hold SPLIT_MIN_BYTES or more; else 1."""
    if height * row_stride(width) < SPLIT_MIN_BYTES:
        return 1
    return max(1, min(READ_RANGES, len(os.sched_getaffinity(0))))


def read(path: str | os.PathLike, out=None, *, ranges=1):
    """BMP file -> (H, W, 3) uint8 RGB (decode), or with `out` its stored
    pixel rows (Rows) read straight into `out`.

    out is a 1-D uint8 CPU tensor of at least height * row_stride(width)
    bytes, or a function (width, height) -> such a tensor, called once the
    header is read (a buffer for the file's geometry). The header is
    validated as decode validates it, with the same ValueError texts; the
    pixel rows are read into out's first bytes, and Rows holds a view of
    them. With the native runtime the read is native calls (open and the
    header, the rows, then close) that hold the interpreter lock for none
    of their I/O: the stream engine's decoder threads read this way beside
    its emitting thread. ranges is an int or, as out may be, a function
    (width, height) -> one (file_ranges). The rows are one pread, or with
    `ranges` > 1 as many contiguous preads as the rows span 4 KiB pages, up
    to `ranges`, the first on the calling thread and the others on the
    native read pool (threads started once a process, one a usable CPU; a
    pool that cannot start raises RuntimeError). Without the native
    runtime, Python reads the header and readintos the rows, one range
    whatever `ranges` is. Under trace.recording() each read counts its
    ranges ("read.ranges").
    """
    if out is None:
        with open(path, "rb") as f:
            return decode(f.read())
    lib = native.load()
    if lib is not None:
        return _read_native(lib, path, out, ranges)
    trace.count("read.ranges")
    return _read_python(path, out)


def _read_python(path, out) -> Rows:
    """read(path, out=out) without the native runtime: the header read
    and checked in Python, the rows readinto out."""
    with open(path, "rb", buffering=0) as f:
        head = f.read(_HEADER_BYTES)
        width, height, data_offset = _header(head, os.fstat(f.fileno()).st_size)
        rows = _buffer(path, out, width, height)
        view = memoryview(rows.numpy())
        f.seek(data_offset)
        got = 0
        while got < rows.numel():
            n = f.readinto(view[got:])
            if not n:
                raise ValueError("BMP file truncated")
            got += n
    return Rows(rows.view(height, row_stride(width)), width, height)


def _buffer(path, out, width: int, height: int) -> torch.Tensor:
    """The first height * row_stride(width) bytes of read's out (called
    with the geometry where it is a function), or read's ValueError."""
    buffer = out(width, height) if callable(out) else out
    nbytes = height * row_stride(width)
    if not (isinstance(buffer, torch.Tensor) and buffer.dtype == torch.uint8
            and buffer.device.type == "cpu" and buffer.dim() == 1
            and buffer.is_contiguous() and buffer.numel() >= nbytes):
        raise ValueError(
            f"{path}: out must be a contiguous 1-D uint8 CPU tensor of at "
            f"least {nbytes} bytes, got {buffer.dtype} "
            f"{tuple(buffer.shape)} on {buffer.device}")
    return buffer[:nbytes]


def _native_error(rc: int, errno: int, path) -> Exception:
    """The exception of a failed native read: the header's ValueError
    texts, an OSError of the failed call's errno, the pool's
    RuntimeError."""
    if rc == _NATIVE_IO:
        return OSError(errno, os.strerror(errno), os.fspath(path))
    if rc == _NATIVE_POOL:
        return RuntimeError(f"the native read pool could not start: "
                            f"{os.strerror(errno)}")
    return ValueError(_NATIVE_ERRORS.get(rc, f"BMP decode error {rc}"))


def _read_native(lib, path, out, ranges) -> Rows:
    """read(path, out=out, ranges=ranges) through the native runtime, with
    read's errors: one open (jt_bmp_open_rows: the header checked as
    jt_bmp_probe checks a file of its size), out sized from its geometry,
    the rows (jt_read_ranges), close."""
    fd, width, height = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    offset, errno = ctypes.c_int64(), ctypes.c_int32()
    rc = lib.jt_bmp_open_rows(
        os.fsencode(path), ctypes.byref(fd), ctypes.byref(width),
        ctypes.byref(height), ctypes.byref(offset), ctypes.byref(errno))
    if rc != 0:
        raise _native_error(rc, errno.value, path)
    used = ctypes.c_int32()
    try:
        rows = _buffer(path, out, width.value, height.value)
        if callable(ranges):
            ranges = ranges(width.value, height.value)
        if ranges < 1:
            raise ValueError(f"ranges must be at least 1, got {ranges}")
        rc = lib.jt_read_ranges(
            fd.value, ctypes.cast(rows.data_ptr(), ctypes.POINTER(
                ctypes.c_uint8)),
            rows.numel(), offset.value, ranges, ctypes.byref(used),
            ctypes.byref(errno))
    finally:
        os.close(fd.value)
    if rc != 0:
        raise _native_error(rc, errno.value, path)
    trace.count("read.ranges", used.value)
    stride = row_stride(width.value)
    return Rows(rows.view(height.value, stride), width.value, height.value)


def read_batch(
    paths: list, num_threads: int = 0
) -> np.ndarray:
    """Decode same-sized BMP files into one (N, H, W, 3) array.

    Uses the native threaded loader when available (one worker per core by
    default); otherwise decodes sequentially. All images must share the
    first file's dimensions — the batch paths feed fixed-shape device
    programs (parallel/batch.py).
    """
    if not paths:
        raise ValueError("read_batch needs at least one path")
    buffers = []
    for p in paths:
        with open(p, "rb") as f:
            buffers.append(
                np.ascontiguousarray(np.frombuffer(f.read(), np.uint8))
            )
    lib = native.load()
    if lib is None:
        images = [decode(b) for b in buffers]
        first = images[0].shape
        for p, img in zip(paths, images):
            if img.shape != first:
                raise ValueError(
                    f"batch images must share dimensions; {p} is "
                    f"{img.shape[1]}x{img.shape[0]}, expected "
                    f"{first[1]}x{first[0]}"
                )
        return np.stack(images)

    w = ctypes.c_int32()
    h = ctypes.c_int32()
    off = ctypes.c_int64()
    bpp = ctypes.c_int32()
    rc = lib.jt_bmp_probe(
        _u8ptr(buffers[0]), buffers[0].size,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(off), ctypes.byref(bpp),
    )
    if rc != 0:
        raise ValueError(_NATIVE_ERRORS.get(rc, f"BMP decode error {rc}"))
    n = len(buffers)
    out = np.empty((n, h.value, w.value, 3), np.uint8)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(*[_u8ptr(b) for b in buffers])
    lens = (ctypes.c_int64 * n)(*[b.size for b in buffers])
    rc = lib.jt_bmp_decode_batch(
        ptrs, lens, n, w.value, h.value, _u8ptr(out), num_threads
    )
    if rc != 0:
        raise ValueError(
            _NATIVE_ERRORS.get(rc, f"BMP decode error {rc}")
            + " (within batch; all images must share dimensions)"
        )
    return out


def read_into(path: str | os.PathLike, out: np.ndarray) -> np.ndarray:
    """Read and decode one BMP file into out, a C-contiguous (H, W, 3)
    uint8 array of the file's dimensions (the stream engine's pinned
    staging buffers), on the calling thread; the native decode releases the
    interpreter lock, so several threads decode at once."""
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    lib = native.load()
    if lib is None:
        rgb = decode(raw)
        w, h = rgb.shape[1], rgb.shape[0]
    else:
        w, h = ctypes.c_int32(), ctypes.c_int32()
        off, bpp = ctypes.c_int64(), ctypes.c_int32()
        rc = lib.jt_bmp_probe(
            _u8ptr(raw), raw.size,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(off),
            ctypes.byref(bpp),
        )
        if rc != 0:
            raise ValueError(f"{path}: {_NATIVE_ERRORS.get(rc, rc)}")
        w, h = w.value, h.value
    if (out.dtype != np.uint8 or out.shape != (h, w, 3)
            or not out.flags.c_contiguous):
        raise ValueError(
            f"{path}: out must be a C-contiguous ({h}, {w}, 3) uint8 array, "
            f"got {out.dtype} {out.shape}"
        )
    if lib is None:
        out[...] = rgb
        return out
    rc = lib.jt_bmp_decode_rgb(_u8ptr(raw), raw.size, _u8ptr(out))
    if rc != 0:
        raise ValueError(f"{path}: {_NATIVE_ERRORS.get(rc, rc)}")
    return out


def encode(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> 24-bit BMP file bytes."""
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError("expected (H, W, 3) uint8 RGB")
    height, width = rgb.shape[:2]
    lib = native.load()
    if lib is not None:
        size = lib.jt_bmp_encoded_size(width, height)
        out = np.empty(size, np.uint8)
        rc = lib.jt_bmp_encode_rgb(
            _u8ptr(np.ascontiguousarray(rgb)), width, height, _u8ptr(out), size
        )
        if rc != 0:
            raise ValueError(f"BMP encode error {rc}")
        return out.tobytes()
    stride = row_stride(width)
    data_size = stride * height
    file_size = 54 + data_size

    header = struct.pack(
        "<2sIHHI"  # BITMAPFILEHEADER
        "IiiHHIIiiII",  # BITMAPINFOHEADER
        b"BM", file_size, 0, 0, 54,
        40, width, height, 1, 24, 0, data_size, 2835, 2835, 0, 0,
    )
    rows = np.zeros((height, stride), dtype=np.uint8)
    rows[:, : width * 3] = rgb[::-1, :, ::-1].reshape(height, width * 3)
    return header + rows.tobytes()


def write(path: str | os.PathLike, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(rgb))
