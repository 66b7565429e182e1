"""Constant tables for baseline JFIF encoding.

All tables here are the public ITU-T T.81 (JPEG) Annex K constants:
the example luminance/chrominance quantization tables (K.1/K.2) and the
"typical" Huffman tables (K.3.3). The reference encoder uses the same
constants (see /root/reference/src/jpeg/quant_tables.rs:2-23 and
/root/reference/src/jpeg/huffman_tables.rs:45-101); we take them from the
standard directly.

The canonical-code generator follows the JPEG canonical Huffman rule
(codes assigned in symbol order within each length, incrementing, shifted
left at each length step) — same algorithm as huffman_tables.rs:18-29.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# --------------------------------------------------------------------------
# Annex K quantization tables, row-major natural (not zigzag) order.
# --------------------------------------------------------------------------

Y_QUANT_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.uint8,
)

C_QUANT_TABLE = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.uint8,
)

@functools.cache
def scaled_quant_tables(
    quality: int | None,
) -> tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) quantization tables for a quality setting.

    quality=None (the default everywhere) returns the Annex-K constants
    unchanged — the reference has no quality flag (its tables are fixed;
    jpeg_theory.md:162 notes scaling as an unimplemented consideration), so
    None is the reference-parity mode. An integer 1..100 applies the
    standard libjpeg scaling: scale% = 5000/q below 50 else 200 - 2q, each
    entry rounded as (base * scale + 50) / 100 and clamped to 1..255 (the
    baseline 8-bit DQT range). quality=50 reproduces the base tables
    exactly, so `-q 50` is byte-identical to the default.
    """
    if quality is None:
        return Y_QUANT_TABLE, C_QUANT_TABLE
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be in 1..100, got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality

    def scaled(base: np.ndarray) -> np.ndarray:
        q = (base.astype(np.int64) * scale + 50) // 100
        out = np.clip(q, 1, 255).astype(np.uint8)
        out.setflags(write=False)  # cached — guard against aliasing mutation
        return out

    return scaled(Y_QUANT_TABLE), scaled(C_QUANT_TABLE)


# --------------------------------------------------------------------------
# Zigzag scan order. ZIGZAG_ORDER[k] = natural (row-major) index of the k-th
# zigzag element. Matches huffman_tables.rs:97-101 (standard scan).
# --------------------------------------------------------------------------


def _make_zigzag() -> np.ndarray:
    order = np.empty(64, dtype=np.int32)
    r = c = 0
    for k in range(64):
        order[k] = r * 8 + c
        if (r + c) % 2 == 0:  # moving up-right
            if c == 7:
                r += 1
            elif r == 0:
                c += 1
            else:
                r -= 1
                c += 1
        else:  # moving down-left
            if r == 7:
                c += 1
            elif c == 0:
                r += 1
            else:
                r += 1
                c -= 1
    return order


ZIGZAG_ORDER = _make_zigzag()

# Inverse permutation: natural index -> zigzag position.
ZIGZAG_INverse = np.empty(64, dtype=np.int32)
ZIGZAG_INverse[ZIGZAG_ORDER] = np.arange(64, dtype=np.int32)
ZIGZAG_INVERSE = ZIGZAG_INverse
del ZIGZAG_INverse

# --------------------------------------------------------------------------
# Annex K "typical" Huffman tables, expressed as (BITS, HUFFVAL):
# BITS[i] = number of codes of length i+1 (i in 0..15), HUFFVAL = symbols in
# code order. This is the exact on-the-wire DHT representation.
# --------------------------------------------------------------------------

Y_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
Y_DC_SYMBOLS = tuple(range(12))

C_DC_BITS = (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)
C_DC_SYMBOLS = tuple(range(12))

Y_AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125)
Y_AC_SYMBOLS = (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
)

C_AC_BITS = (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119)
C_AC_SYMBOLS = (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
)


@dataclasses.dataclass(frozen=True)
class HuffmanSpec:
    """A canonical Huffman table: DHT wire form plus derived lookup arrays."""

    bits: tuple[int, ...]  # codes per length 1..16
    symbols: tuple[int, ...]  # symbols in code order

    @functools.cached_property
    def codes_by_order(self) -> np.ndarray:
        """Canonical code for each symbol position (uint32), in symbol order."""
        codes = np.zeros(len(self.symbols), dtype=np.uint32)
        code = 0
        k = 0
        for length_minus_1 in range(16):
            for _ in range(self.bits[length_minus_1]):
                codes[k] = code
                code += 1
                k += 1
            code <<= 1
        return codes

    @functools.cached_property
    def lengths_by_order(self) -> np.ndarray:
        """Code length (bits) for each symbol position, in symbol order."""
        lengths = np.zeros(len(self.symbols), dtype=np.uint8)
        k = 0
        for length_minus_1 in range(16):
            for _ in range(self.bits[length_minus_1]):
                lengths[k] = length_minus_1 + 1
                k += 1
        return lengths

    @functools.cached_property
    def code_lut(self) -> np.ndarray:
        """256-entry symbol -> code lookup (uint32). Unused entries are 0."""
        lut = np.zeros(256, dtype=np.uint32)
        lut[np.asarray(self.symbols)] = self.codes_by_order
        return lut

    @functools.cached_property
    def length_lut(self) -> np.ndarray:
        """256-entry symbol -> code length lookup (int32). 0 = no code."""
        lut = np.zeros(256, dtype=np.int32)
        lut[np.asarray(self.symbols)] = self.lengths_by_order
        return lut

    def encode_symbol(self, symbol: int) -> tuple[int, int]:
        """(code, code_length) for a symbol. Raises if symbol has no code."""
        length = int(self.length_lut[symbol])
        if length == 0:
            raise KeyError(f"symbol 0x{symbol:02x} has no Huffman code")
        return int(self.code_lut[symbol]), length


def optimal_spec(freq: np.ndarray) -> HuffmanSpec:
    """Per-image optimal canonical table from symbol counts (T.81 K.2).

    The exact flowchart algorithm (figures K.1-K.3, the one libjpeg's
    -optimize implements): merge the two least-frequent active symbols
    (ties broken toward the LARGER symbol value), chaining code-size
    increments through OTHERS; reserve pseudo-symbol 256 with count 1 so
    no real symbol is assigned the all-ones code (F.1.4.5's forbidden
    pattern); then fold code sizes longer than 16 down with the BITS
    adjustment and drop the reserved symbol from the longest length.
    Symbols list in (code length, symbol value) order — the canonical
    DHT ordering the rest of the codec already consumes via HuffmanSpec.

    An extension beyond the reference (huffman_tables.rs ships only the
    Annex-K defaults); produced tables go on the wire in DHT segments, so
    any decoder reads them like libjpeg-optimized files.

    The native host runtime carries an exact port (~30 us/table vs ~2 ms
    here — the batched optimize mode builds 4 tables per image between
    its device passes); this Python body remains the behavioral spec and
    the fallback, and tests assert the two agree over fuzzed histograms.
    """
    assert freq.shape == (256,)
    from jpeg_encoder_torch import native

    lib = native.load()
    if lib is not None:
        import ctypes

        freq64 = np.ascontiguousarray(freq, dtype=np.int64)
        bits_out = np.zeros(16, np.uint8)
        syms_out = np.zeros(256, np.uint8)
        nsym = ctypes.c_int32()
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = lib.jt_optimal_huffman(
            freq64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            bits_out.ctypes.data_as(u8p), syms_out.ctypes.data_as(u8p),
            ctypes.byref(nsym),
        )
        if rc == 0:
            spec = HuffmanSpec(
                tuple(int(b) for b in bits_out),
                tuple(int(s) for s in syms_out[: nsym.value]),
            )
            assert sum(spec.bits) == len(spec.symbols)
            return spec
    return _optimal_spec_py(freq)


def _optimal_spec_py(freq: np.ndarray) -> HuffmanSpec:
    """The pure-NumPy K.2 construction (spec + fallback; see optimal_spec)."""
    counts = np.zeros(257, dtype=np.int64)
    counts[:256] = freq
    counts[256] = 1  # reserved: claims the all-ones code
    codesize = np.zeros(257, dtype=np.int32)
    others = np.full(257, -1, dtype=np.int32)

    while True:
        active = np.nonzero(counts > 0)[0]
        if active.size < 2:
            break
        # Least count, ties toward the largest value (K.2: "If more than
        # one such value, choose the one with the largest value").
        c = counts[active]
        v1 = int(active[np.lexsort((-active, c))[0]])
        rest = active[active != v1]
        c2 = counts[rest]
        v2 = int(rest[np.lexsort((-rest, c2))[0]])

        counts[v1] += counts[v2]
        counts[v2] = 0
        codesize[v1] += 1
        while others[v1] != -1:
            v1 = others[v1]
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] != -1:
            v2 = others[v2]
            codesize[v2] += 1

    bits = np.zeros(60, dtype=np.int32)  # generous: sizes can exceed 16
    # Depth bound: a Huffman code of length L requires total count >=
    # Fib(L+1) (the minimal-count tree is the Fibonacci chain), so
    # L <= ~1.44 * log2(total). 60 covers total counts up to ~Fib(61)
    # ~ 2.5e12 symbols — far beyond any 65535x65535 image's scan — but
    # the bound is implicit, so fail loudly rather than IndexError.
    assert codesize.max() <= len(bits), (
        f"Huffman code size {int(codesize.max())} exceeds the {len(bits)}-"
        "entry working array (pathological symbol distribution)"
    )
    for size in codesize[codesize > 0]:
        bits[size - 1] += 1
    # Fold sizes > 16 down (figure K.3 verbatim): remove a PAIR from the
    # over-long length (one moves to length i-1), and split a shorter
    # code (the longest with length <= i-2) into two at j+1.
    i = len(bits) - 1
    while i >= 16:
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
        i -= 1
    # Remove the reserved symbol's code from the longest used length.
    i = 15
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1

    lengths = codesize[:256]
    order = np.lexsort((np.arange(256), lengths))
    symbols = tuple(
        int(s) for s in order[lengths[order] > 0]
    )
    spec = HuffmanSpec(tuple(int(b) for b in bits[:16]), symbols)
    assert sum(spec.bits) == len(symbols)
    return spec


Y_DC_HUFFMAN = HuffmanSpec(Y_DC_BITS, Y_DC_SYMBOLS)
C_DC_HUFFMAN = HuffmanSpec(C_DC_BITS, C_DC_SYMBOLS)
Y_AC_HUFFMAN = HuffmanSpec(Y_AC_BITS, Y_AC_SYMBOLS)
C_AC_HUFFMAN = HuffmanSpec(C_AC_BITS, C_AC_SYMBOLS)

# Stacked LUTs for device-side gathers: index 0 = luma, 1 = chroma.
DC_CODE_LUT = np.stack([Y_DC_HUFFMAN.code_lut, C_DC_HUFFMAN.code_lut])
DC_LEN_LUT = np.stack([Y_DC_HUFFMAN.length_lut, C_DC_HUFFMAN.length_lut])
AC_CODE_LUT = np.stack([Y_AC_HUFFMAN.code_lut, C_AC_HUFFMAN.code_lut])
AC_LEN_LUT = np.stack([Y_AC_HUFFMAN.length_lut, C_AC_HUFFMAN.length_lut])
