"""ctypes loader for the native host runtime (host_runtime.cpp).

The shared library is built on demand with g++ into jpeg_encoder_torch/_build/
(the first use pays ~1s, cached afterwards by an mtime check). Every caller
must handle `load()` returning None — the NumPy implementations in io/ and
utils/ remain the behavioral spec and the fallback, and
JPEG_TPU_NATIVE=0 forces them (used to A/B the two paths in tests).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host_runtime.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB = os.path.join(_BUILD_DIR, "libjpegtorch_host.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    # Per-process temp name: concurrent builders (multi-host encode_dataset,
    # parallel pytest) must not interleave writes into one .tmp file — a
    # corrupt .so with a fresh mtime would pass the staleness check and
    # silently pin every later run to the NumPy fallback.
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        "-o", tmp, _SRC,
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120
        )
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        print(
            f"jpeg_encoder_torch: native build failed, using NumPy fallback:\n"
            f"{proc.stderr}",
            file=sys.stderr,
        )
        return False
    try:
        ctypes.CDLL(tmp)  # verify loadability before installing
    except OSError:
        os.unlink(tmp)
        return False
    os.replace(tmp, _LIB)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8pp = ctypes.POINTER(u8p)

    lib.jt_bmp_probe.restype = ctypes.c_int
    lib.jt_bmp_probe.argtypes = [u8p, ctypes.c_int64, i32p, i32p, i64p, i32p]
    lib.jt_bmp_decode_rgb.restype = ctypes.c_int
    lib.jt_bmp_decode_rgb.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.jt_bmp_encoded_size.restype = ctypes.c_int64
    lib.jt_bmp_encoded_size.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.jt_bmp_encode_rgb.restype = ctypes.c_int
    lib.jt_bmp_encode_rgb.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_int64
    ]
    lib.jt_bmp_open_rows.restype = ctypes.c_int
    lib.jt_bmp_open_rows.argtypes = [ctypes.c_char_p, i32p, i32p, i32p, i64p,
                                     i32p]
    for read in (lib.jt_read_ranges, lib.jt_read_ranges_threads):
        read.restype = ctypes.c_int
        read.argtypes = [ctypes.c_int32, u8p, ctypes.c_int64, ctypes.c_int64,
                         ctypes.c_int32, i32p, i32p]
    lib.jt_read_pool_threads.restype = ctypes.c_int32
    lib.jt_read_pool_threads.argtypes = []
    lib.jt_read_pool_hold.restype = None
    lib.jt_read_pool_hold.argtypes = [ctypes.c_int32, i32p]
    lib.jt_bmp_decode_batch.restype = ctypes.c_int
    lib.jt_bmp_decode_batch.argtypes = [
        u8pp, i64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
        ctypes.c_int32,
    ]
    lib.jt_copy_threads.restype = None
    lib.jt_copy_threads.argtypes = [u8p, u8p, ctypes.c_int64, ctypes.c_int32]
    lib.jt_stuff_bytes.restype = ctypes.c_int64
    lib.jt_stuff_bytes.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.jt_optimal_huffman.restype = ctypes.c_int
    lib.jt_optimal_huffman.argtypes = [i64p, u8p, u8p, i32p]
    lib.jt_splice_bits.restype = ctypes.c_int64
    lib.jt_splice_bits.argtypes = [u8pp, i64p, ctypes.c_int32, u8p]
    return lib


def load() -> ctypes.CDLL | None:
    """The native library, building it if needed; None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if os.environ.get("JPEG_TPU_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        stale = (
            not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        )
        if stale and not _build():
            _tried = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(_LIB))
        except OSError:
            # A stale-but-corrupt library (e.g. from a killed build of an
            # older version of this loader): rebuild once instead of caching
            # the failure for the life of the process.
            try:
                os.unlink(_LIB)
            except OSError:
                pass
            if _build():
                try:
                    _lib = _bind(ctypes.CDLL(_LIB))
                except OSError:
                    _lib = None
        _tried = True
        return _lib
