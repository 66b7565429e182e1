"""Baseline JFIF container emission (host-side).

Byte-for-byte equivalent of the reference's segment writers (file.rs:10-103):
SOI, APP0 (JFIF 1.1, 72x72 dpi, no thumbnail), two DQTs written in zigzag
order, SOF0 (8-bit precision, 3 components, Y sampling factors (h<<4)|v and
0x11 for chroma, quant table 0/1/1), four DHTs, SOS (DC/AC table 0 for Y,
0x11 for chroma, spectral selection 0..63), the 0xFF-stuffed scan payload,
EOI. The final partial scan byte is zero-filled (reference behavior; the
spec's suggested 1-padding is a tolerated deviation the reference makes).
"""

from __future__ import annotations

import struct

import numpy as np

from jpeg_encoder_torch import native, tables
from jpeg_encoder_torch.config import FrameGeometry

SOI = b"\xff\xd8"
EOI = b"\xff\xd9"


def app0_segment() -> bytes:
    return b"\xff\xe0" + struct.pack(
        ">H5s2sBHHBB", 16, b"JFIF\0", b"\x01\x01", 1, 72, 72, 0, 0
    )


def dqt_segment(destination: int, table: np.ndarray) -> bytes:
    zigzagged = table.reshape(64)[tables.ZIGZAG_ORDER].astype(np.uint8)
    return b"\xff\xdb" + struct.pack(">HB", 67, destination) + zigzagged.tobytes()


def sof0_segment(geom: FrameGeometry) -> bytes:
    body = struct.pack(">HBHHB", 17, 8, geom.height, geom.width, 3)
    y_sampling = (geom.h_factor << 4) | geom.v_factor
    for comp_id, sampling, quant_id in (
        (1, y_sampling, 0), (2, 0x11, 1), (3, 0x11, 1)
    ):
        body += struct.pack(">BBB", comp_id, sampling, quant_id)
    return b"\xff\xc0" + body


def dht_segment(coeff_type: int, table_id: int, spec: tables.HuffmanSpec) -> bytes:
    num_codes = sum(spec.bits)
    body = struct.pack(">HB", 19 + num_codes, (coeff_type << 4) | table_id)
    body += bytes(spec.bits)
    body += bytes(spec.symbols)
    return b"\xff\xc4" + body


def dri_segment(restart_interval_mcus: int) -> bytes:
    """Define Restart Interval: RSTn markers every N MCUs (ITU-T T.81
    B.2.4.4). Absent from the reference (file.rs has no DRI writer) —
    emitted only in the opt-in restart-marker extension mode."""
    return b"\xff\xdd" + struct.pack(">HH", 4, restart_interval_mcus)


def sos_segment() -> bytes:
    body = struct.pack(">HB", 12, 3)
    for comp_id, dc_ac in ((1, 0x00), (2, 0x11), (3, 0x11)):
        body += struct.pack(">BB", comp_id, dc_ac)
    body += struct.pack(">BBB", 0, 63, 0)
    return b"\xff\xda" + body


def stuff_bytes(payload: np.ndarray) -> bytes:
    """Escape in-payload 0xFF bytes as 0xFF 0x00 (file.rs:92-103).

    Native single-pass when the host runtime is built; otherwise vectorized
    NumPy (each source byte expands to 1 or 2 output bytes via repeat).
    """
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    lib = native.load()
    if lib is not None and payload.size:
        import ctypes

        out = np.empty(2 * payload.size, np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = lib.jt_stuff_bytes(
            payload.ctypes.data_as(u8p), payload.size, out.ctypes.data_as(u8p)
        )
        return out[:n].tobytes()
    is_ff = payload == 0xFF
    if not is_ff.any():
        return payload.tobytes()
    counts = np.where(is_ff, 2, 1).astype(np.int64)
    out = np.repeat(payload, counts)
    # The repeat duplicates 0xFF; rewrite each duplicate to 0x00.
    ends = np.cumsum(counts)
    out[ends[is_ff] - 1] = 0
    return out.tobytes()


def header_bytes(
    geom: FrameGeometry,
    quality: int | None = None,
    restart_interval: int | None = None,
    dht_specs: tuple | None = None,
) -> bytes:
    """Everything before the entropy-coded scan payload.

    `quality` selects the DQT contents (tables.scaled_quant_tables); it must
    match the tables the coefficients were quantized with. None = the
    reference's fixed Annex-K tables. `restart_interval` (MCUs) inserts a
    DRI segment before SOS; None = reference parity (no DRI). `dht_specs`
    = (y_dc, c_dc, y_ac, c_ac) HuffmanSpecs overrides the Annex-K code
    tables (the optimized-Huffman mode); they must match the tables the
    scan was coded with.
    """
    q_luma, q_chroma = tables.scaled_quant_tables(quality)
    y_dc, c_dc, y_ac, c_ac = dht_specs or (
        tables.Y_DC_HUFFMAN, tables.C_DC_HUFFMAN,
        tables.Y_AC_HUFFMAN, tables.C_AC_HUFFMAN,
    )
    segments = [
        SOI,
        app0_segment(),
        dqt_segment(0, q_luma),
        dqt_segment(1, q_chroma),
        sof0_segment(geom),
        dht_segment(0, 0, y_dc),
        dht_segment(0, 1, c_dc),
        dht_segment(1, 0, y_ac),
        dht_segment(1, 1, c_ac),
    ]
    if restart_interval is not None:
        segments.append(dri_segment(restart_interval))
    segments.append(sos_segment())
    return b"".join(segments)


def assemble(
    geom: FrameGeometry,
    entropy_payload: np.ndarray | bytes,
    quality: int | None = None,
    dht_specs: tuple | None = None,
) -> bytes:
    """Full JFIF file bytes from the (unstuffed) entropy payload."""
    if isinstance(entropy_payload, (bytes, bytearray)):
        entropy_payload = np.frombuffer(bytes(entropy_payload), dtype=np.uint8)
    return (header_bytes(geom, quality, dht_specs=dht_specs)
            + stuff_bytes(entropy_payload) + EOI)


def pad_final_byte(payload: np.ndarray, bit_length: int) -> np.ndarray:
    """Fill the final partial byte with 1-bits (ITU-T T.81 B.1.1.5).

    The unbroken-scan writer keeps the reference's zero-fill deviation for
    byte-exactness; restart segments instead follow the spec — padding
    before a marker is defined to be 1-bits, and strict decoders check.
    """
    rem = bit_length & 7
    if rem:
        payload = payload.copy()
        payload[-1] |= 0xFF >> rem
    return payload


def assemble_restart(
    geom: FrameGeometry,
    interval_payloads: list[np.ndarray],
    interval_bits: list[int],
    restart_interval: int,
    quality: int | None = None,
    dht_specs: tuple | None = None,
) -> bytes:
    """JFIF file with DRI/RSTn: one independently coded scan segment per
    restart interval, each byte-aligned (1-padded) and 0xFF-stuffed, joined
    by RST(n mod 8) markers (no marker after the last segment).

    Zero-bit segments are dropped here: a live MCU always emits at least
    its DC and EOB codes, so 0 bits means a fully dead (padding) interval,
    and dead intervals are always a suffix of the scan — dropping them
    never shifts the RSTn numbering of live segments. (The band-tiled
    assembler also pre-filters; this keeps the invariant for any caller.)
    """
    parts = [header_bytes(geom, quality, restart_interval=restart_interval,
                          dht_specs=dht_specs)]
    live = [
        (p, b) for p, b in zip(interval_payloads, interval_bits) if int(b) > 0
    ]
    last = len(live) - 1
    for n, (payload, bits) in enumerate(live):
        num_bytes = (int(bits) + 7) // 8
        seg = np.ascontiguousarray(payload[:num_bytes], dtype=np.uint8)
        parts.append(stuff_bytes(pad_final_byte(seg, int(bits))))
        if n != last:
            parts.append(bytes([0xFF, 0xD0 + (n & 7)]))
    parts.append(EOI)
    return b"".join(parts)
