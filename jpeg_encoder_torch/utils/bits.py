"""Host-side bit-level splicing of per-shard entropy streams.

When one image's MCU bands are encoded on separate devices, each shard
produces an independently packed, byte-aligned bitstream plus its exact bit
length. The global scan is their bit-level concatenation (shard payloads
start at arbitrary bit offsets). Splicing is vectorized per shard: an
8-way shift/OR over the shard's byte array, so the host cost is O(total
payload bytes), not O(total bits).
"""

from __future__ import annotations

import ctypes

import numpy as np

from jpeg_encoder_torch import native


def splice_bitstreams(chunks: list[tuple[np.ndarray, int]]) -> tuple[bytes, int]:
    """Concatenate MSB-first bitstreams.

    Args:
      chunks: list of (byte_array, bit_length) in stream order. Each array
        must hold at least ceil(bit_length / 8) bytes, with any bits past
        bit_length in the final byte being zero (the device packer
        guarantees this).

    Returns:
      (spliced bytes, total bit length); the final partial byte zero-filled.
    """
    for arr, nbits in chunks:
        if int(nbits) < 0:
            raise ValueError(f"negative bit length {int(nbits)}")
        if arr.size < (int(nbits) + 7) // 8:
            raise ValueError(
                f"chunk declares {int(nbits)} bits but holds only "
                f"{arr.size} bytes"
            )
    total_bits = sum(int(n) for _, n in chunks)
    lib = native.load()
    if lib is not None and chunks:
        arrays = [
            np.ascontiguousarray(arr[: (int(n) + 7) // 8], dtype=np.uint8)
            for arr, n in chunks
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ptrs = (u8p * len(arrays))(*[a.ctypes.data_as(u8p) for a in arrays])
        lens = (ctypes.c_int64 * len(arrays))(*[int(n) for _, n in chunks])
        out = np.zeros((total_bits + 7) // 8, dtype=np.uint8)
        got = lib.jt_splice_bits(ptrs, lens, len(arrays), out.ctypes.data_as(u8p))
        if got != total_bits:
            raise RuntimeError(
                f"native splice returned {got} bits, expected {total_bits}"
            )
        return out.tobytes(), total_bits
    out = np.zeros((total_bits + 7) // 8, dtype=np.uint8)
    offset = 0
    for arr, nbits in chunks:
        nbits = int(nbits)
        if nbits == 0:
            continue
        nbytes = (nbits + 7) // 8
        arr = np.ascontiguousarray(arr[:nbytes], dtype=np.uint8)
        pos, k = divmod(offset, 8)
        if k == 0:
            out[pos : pos + nbytes] |= arr
        else:
            ext = np.concatenate([np.zeros(1, np.uint8), arr])
            merged = ((ext[:-1].astype(np.uint16) << (8 - k))
                      | (ext[1:].astype(np.uint16) >> k)).astype(np.uint8)
            tail = np.uint8((int(arr[-1]) << (8 - k)) & 0xFF)
            span = (k + nbits + 7) // 8  # bytes touched in out
            contribution = np.concatenate([merged, tail[None]])[:span]
            out[pos : pos + span] |= contribution
        offset += nbits
    return out.tobytes(), total_bits
