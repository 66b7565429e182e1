"""BMP (Windows bitmap) reading and writing, host-side.

Same wire assumptions as the reference reader (bmp_image.rs): pixel-data
offset at byte 10, signed width/height at 18/22, 24-bit BGR pixels stored
bottom-to-top with rows padded to 4-byte multiples. Unlike the reference
(which issues one 3-byte read() syscall per pixel), ingest here is a single
buffer read + one vectorized numpy reshape — this is host code feeding the
device, so it must not be the bottleneck.

The writer exists for fixtures, benchmarks, and round-trip tests (the
reference ships no sample images).
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from jpeg_encoder_torch import native

_DATA_OFFSET_POS = 10
_WIDTH_POS = 18
_HEIGHT_POS = 22
_BPP_POS = 28


_NATIVE_ERRORS = {
    -1: "not a BMP file (missing 'BM' magic)",
    -2: "only 24-bit BMP is supported",
    -3: "unsupported BMP dimensions",
    -4: "BMP file truncated",
}


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
    if raw.size < 54 or bytes(raw[:2]) != b"BM":
        raise ValueError("not a BMP file (missing 'BM' magic)")
    data_offset = int.from_bytes(raw[_DATA_OFFSET_POS:_DATA_OFFSET_POS + 4], "little")
    width = int.from_bytes(raw[_WIDTH_POS:_WIDTH_POS + 4], "little", signed=True)
    height = int.from_bytes(raw[_HEIGHT_POS:_HEIGHT_POS + 4], "little", signed=True)
    bpp = int.from_bytes(raw[_BPP_POS:_BPP_POS + 2], "little")
    if bpp != 24:
        raise ValueError(f"only 24-bit BMP is supported, got {bpp}-bit")
    if width <= 0 or height <= 0:
        raise ValueError(f"unsupported BMP dimensions {width}x{height}")

    row_stride = (width * 3 + 3) // 4 * 4
    need = data_offset + row_stride * height
    if raw.size < need:
        raise ValueError("BMP file truncated")
    rows = raw[data_offset:need].reshape(height, row_stride)[:, : width * 3]
    bgr = rows.reshape(height, width, 3)
    rgb = bgr[::-1, :, ::-1]  # bottom-up storage, BGR channel order
    return np.ascontiguousarray(rgb)


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


def read(path: str | os.PathLike) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


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
    row_stride = (width * 3 + 3) // 4 * 4
    data_size = row_stride * height
    file_size = 54 + data_size

    header = struct.pack(
        "<2sIHHI"  # BITMAPFILEHEADER
        "IiiHHIIiiII",  # BITMAPINFOHEADER
        b"BM", file_size, 0, 0, 54,
        40, width, height, 1, 24, 0, data_size, 2835, 2835, 0, 0,
    )
    rows = np.zeros((height, row_stride), dtype=np.uint8)
    rows[:, : width * 3] = rgb[::-1, :, ::-1].reshape(height, width * 3)
    return header + rows.tobytes()


def write(path: str | os.PathLike, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(rgb))
