"""Constant operands of the DCT and entropy kernels, built with NumPy.

These are exactly the arrays the JAX package's kernels take as operands
(kernels/dct_pallas._realdct_constants, _bindct_constants and
_fast_kron_zigzag, ops/dct.bindct_descale_2d and
ops/entropy.default_packed_luts in jpeg_encoder_tpu), rebuilt here from the
JAX-free tables.py and oracle.dct_basis_f32 so that this package never
imports JAX. The tests assert bit-for-bit equality with the JAX package's
arrays. The binDCT lifting network lives here too: the descale gains are
fitted to it, and the plain transform (ops/dct.py) runs it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from jpeg_encoder_torch import oracle, tables

_F32 = np.float32


def _alpha() -> np.ndarray:
    """(8,) f32 DCT normalization: 1/sqrt(2) for frequency 0, else 1."""
    inv_sqrt2 = _F32(1.0) / _F32(np.sqrt(2.0))
    return np.where(np.arange(8) == 0, inv_sqrt2, _F32(1.0)).astype(_F32)


class RealDctConstants(NamedTuple):
    """Per-step factors and quantization rows, columns in zigzag order.

    a_steps[k, j] = basis[u_j, x_k] and b_steps[k, j] = basis[v_j, y_k]
    for step k = x_k * 8 + y_k and zigzag output position j (natural index
    u_j * 8 + v_j), so coefficient j accumulates
    acc += (px[k] * a_steps[k, j]) * b_steps[k, j] over k = 0..63, in the
    reference's order, and comes out in zigzag order.
    """

    a_steps: np.ndarray   # (64, 64) f32, (step, zigzag column)
    b_steps: np.ndarray   # (64, 64) f32
    scale: np.ndarray     # (1, 64) f32: (0.25 * alpha_u) * alpha_v
    q_luma: np.ndarray    # (1, 64) f32 luma quantization row, zigzag order
    q_chroma: np.ndarray  # (1, 64) f32 chroma quantization row


@functools.cache
def realdct_constants(quality: int | None = None) -> RealDctConstants:
    """The RealDCT kernel's constant operands for one quality setting."""
    q_luma, q_chroma = tables.scaled_quant_tables(quality)
    basis = oracle.dct_basis_f32()
    zz = tables.ZIGZAG_ORDER
    u_of = (np.arange(64) // 8)[zz]  # output column -> u
    v_of = (np.arange(64) % 8)[zz]
    x_of = np.arange(64) // 8        # step -> x
    y_of = np.arange(64) % 8
    a_steps = basis[u_of[None, :], x_of[:, None]].astype(_F32)
    b_steps = basis[v_of[None, :], y_of[:, None]].astype(_F32)
    alpha = _alpha()
    scale = ((_F32(0.25) * alpha[u_of]) * alpha[v_of]).astype(_F32)
    consts = RealDctConstants(
        a_steps=a_steps,
        b_steps=b_steps,
        scale=scale[None, :],
        q_luma=q_luma.reshape(64)[zz].astype(_F32)[None, :],
        q_chroma=q_chroma.reshape(64)[zz].astype(_F32)[None, :],
    )
    for arr in consts:
        arr.setflags(write=False)  # cached: shared by every caller
    return consts


class RealDctKernelOperands(NamedTuple):
    """The RealDCT kernel's compact form of realdct_constants: the basis
    once, and the rows in natural order (index u * 8 + v) with the zigzag
    position of each. a_steps[k, j] = basis[u_j, x_k] and b_steps[k, j] =
    basis[v_j, y_k], so the kernel forms px[k] * basis[u, x_k] once per u
    and multiplies it by basis[v, y_k] for each v, the same two products in
    the same order."""

    basis: np.ndarray     # (8, 8) f32, basis[u, x] = oracle.dct_basis_f32()
    scale: np.ndarray     # (64,) f32, natural order
    q_luma: np.ndarray    # (64,) f32, natural order
    q_chroma: np.ndarray  # (64,) f32, natural order
    zigzag: np.ndarray    # (64,) int32: zigzag position of natural index


@functools.cache
def realdct_kernel_operands(quality: int | None = None) -> RealDctKernelOperands:
    """realdct_constants(quality) in the kernel's compact form, rows taken
    from it bit for bit."""
    consts = realdct_constants(quality)
    zigzag = tables.ZIGZAG_INVERSE.copy()
    ops = RealDctKernelOperands(
        basis=np.ascontiguousarray(oracle.dct_basis_f32(), dtype=_F32),
        scale=np.ascontiguousarray(consts.scale[0][zigzag]),
        q_luma=np.ascontiguousarray(consts.q_luma[0][zigzag]),
        q_chroma=np.ascontiguousarray(consts.q_chroma[0][zigzag]),
        zigzag=zigzag,
    )
    for arr in ops:
        arr.setflags(write=False)
    return ops


@functools.cache
def fast_kron_zigzag() -> np.ndarray:
    """(64, 64) f32 M[j, xy] = scale[u, v] * B[u, x] * B[v, y], where
    (u, v) is zigzag position j: the Kronecker DCT basis with the scale
    folded in and rows in zigzag order, so M @ block yields zigzag
    coefficients (the --fast-dct operand; ops/dct.dct_kron_matrix and
    dct_pallas._fast_kron_zigzag in the JAX package)."""
    basis = oracle.dct_basis_f32()
    alpha = _alpha()
    scale = (_F32(0.25) * alpha[:, None]) * alpha[None, :]  # (u, v)
    kron = np.einsum(
        "uv,ux,vy->xyuv", scale, basis, basis, dtype=np.float64
    ).astype(_F32).reshape(64, 64)  # (x*8+y, u*8+v)
    out = np.ascontiguousarray(kron[:, tables.ZIGZAG_ORDER].T)
    out.setflags(write=False)
    return out


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """The bfloat16 nearest to each finite float32 (ties to even), as its
    uint16 bit pattern: NumPy has no bfloat16 type."""
    u = np.ascontiguousarray(x, dtype=_F32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> their (exact) float32 values."""
    return (bits.astype(np.uint32) << 16).view(_F32)


@functools.cache
def fast_kron_split() -> np.ndarray:
    """(3, 64, 64) uint16: the bfloat16 bit patterns of the 3-term split of
    fast_kron_zigzag() M that the --fast-dct TPU kernel forms
    (dct_pallas._realdct_t_planes_fast_chain): m1 = bf16(M), m2 = bf16(M -
    m1), m3 = bf16(M - m1 - m2), the differences taken in float32; rows
    [m1, m2, m3]. M = m1 + m2 + m3 to ~2^-24 relative, and every product
    of a level-shifted pixel (exact in bfloat16) with a term is exact in
    float32, which is why K2 can run the product on bf16 tensor cores."""
    m = fast_kron_zigzag()
    m1 = bf16_bits(m)
    r1 = m - bf16_to_f32(m1)
    m2 = bf16_bits(r1)
    m3 = bf16_bits(r1 - bf16_to_f32(m2))
    out = np.stack([m1, m2, m3])
    out.setflags(write=False)
    return out


def bindct_lift8(x: list, shr) -> list:
    """One 8-point all-lifting binDCT-C pass (dct_quant.rs:84-129 in the
    reference), outputs in natural frequency order. shr(v, k) is the
    network's right shift: an arithmetic `>>` for the integer transform
    (ops/dct.py), an exact division by 2**k for the linearized network
    that the descale gains are fitted to."""
    x0, x1, x2, x3, x4, x5, x6, x7 = x
    s7 = x0 - x7
    s0 = x0 - shr(s7, 1)
    s6 = x1 - x6
    s1 = x1 - shr(s6, 1)
    s5 = x2 - x5
    s2 = x2 - shr(s5, 1)
    s4 = x3 - x4
    s3 = x3 - shr(s4, 1)
    s6 = shr(s5 * 3, 3) + s6
    s5 = shr(s6 * 5, 3) - s5
    t0 = s0 + s3
    t3 = s0 - s3
    t1 = s1 + s2
    t2 = s1 - s2
    t4 = s4 + s5
    t5 = s4 - s5
    t6 = s7 - s6
    t7 = s7 + s6
    t4 = t4 - shr(t7, 3)
    t0 = t0 + t1
    t1 = -t1 + shr(t0, 1)
    t2 = t2 - shr(t3 * 3, 3)
    t3 = t3 + shr(t2 * 3, 3)
    t5 = t5 + shr(t6 * 7, 3)
    t6 = t6 - shr(t5, 1)
    return [t0, t7, t3, t6, t1, t5, t2, t4]


@functools.cache
def bindct_descale_2d() -> np.ndarray:
    """(64,) f32 gains, natural order, mapping raw binDCT outputs to
    normalized DCT coefficients (ops/dct.bindct_descale_2d in the JAX
    package): each output row of the linearized lifting network is fitted
    to its cosine row by least squares, giving the per-frequency gain g_u,
    and the 2-D factor is 0.25 * alpha_u * alpha_v / (g_u * g_v)."""
    t = np.zeros((8, 8))
    for i in range(8):
        e = [0.0] * 8
        e[i] = 1.0
        t[:, i] = bindct_lift8(e, lambda v, k: v / (1 << k))
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    braw = np.cos((2 * x + 1) * u * np.pi / 16)
    gains = np.array(
        [(t[r] @ braw[r]) / (braw[r] @ braw[r]) for r in range(8)]
    )
    alpha = np.where(np.arange(8) == 0, 1.0 / np.sqrt(2.0), 1.0)
    per_axis = 0.5 * alpha / gains
    out = (per_axis[:, None] * per_axis[None, :]).reshape(64).astype(_F32)
    out.setflags(write=False)
    return out


class BinDctConstants(NamedTuple):
    """Quantization rows and descale gains of the binDCT kernel, zigzag
    order (position j holds natural index tables.ZIGZAG_ORDER[j])."""

    q_luma: np.ndarray    # (1, 64) int32
    q_chroma: np.ndarray  # (1, 64) int32
    gains: np.ndarray     # (64,) f32, bindct_descale_2d in zigzag order


@functools.cache
def bindct_constants(quality: int | None = None) -> BinDctConstants:
    """The binDCT kernel's constant operands for one quality setting."""
    q_luma, q_chroma = tables.scaled_quant_tables(quality)
    zz = tables.ZIGZAG_ORDER
    consts = BinDctConstants(
        q_luma=q_luma.reshape(64)[zz].astype(np.int32)[None, :],
        q_chroma=q_chroma.reshape(64)[zz].astype(np.int32)[None, :],
        gains=np.ascontiguousarray(bindct_descale_2d()[zz]),
    )
    for arr in consts:
        arr.setflags(write=False)
    return consts


def division_magic(d: int) -> tuple[int, int]:
    """(m, s) such that C's truncating n / d, for every int32 n (|n| well
    below 2^31) and divisor 1 <= d < 2^31, is

        ((n + mulhi(m, n)) >> s) - (n >> 31)

    with mulhi the high 32 bits of the signed 64-bit product and >> the
    arithmetic shift (Granlund and Montgomery, "Division by Invariant
    Integers using Multiplication", PLDI 1994, signed division by a
    constant; Hacker's Delight, section 10). m is an int32."""
    if not 1 <= d < 2**31:
        raise ValueError(f"divisor {d} out of range")
    ell = max((d - 1).bit_length(), 1)  # ceil(log2 d), at least 1
    return 1 + (1 << (31 + ell)) // d - (1 << 32), ell - 1


@functools.cache
def bindct_divisors(quality: int | None = None) -> np.ndarray:
    """(2, 64, 2) int32: the division_magic (m, s) of every zigzag position
    of the luma (row 0) and chroma (row 1) rows of
    bindct_constants(quality), so the binDCT kernel's bug-parity x / q is a
    multiply-high and shifts."""
    consts = bindct_constants(quality)
    out = np.array(
        [[division_magic(int(q)) for q in row[0]]
         for row in (consts.q_luma, consts.q_chroma)],
        dtype=np.int32,
    )
    out.setflags(write=False)
    return out


@functools.cache
def default_packed_luts() -> tuple[np.ndarray, np.ndarray]:
    """(dc, ac) (2, 256) int32 `length << 20 | code` Annex-K tables.

    Row 0 is the luma table, row 1 the chroma table. One lookup yields both
    fields (codes and lengths are at most 16 bits). Per-image optimized
    tables take the same packed form, which is why the entropy kernel takes
    them as operands.
    """
    dc = (tables.DC_LEN_LUT.astype(np.int32) << 20) | (
        tables.DC_CODE_LUT.astype(np.int32)
    )
    ac = (tables.AC_LEN_LUT.astype(np.int32) << 20) | (
        tables.AC_CODE_LUT.astype(np.int32)
    )
    dc.setflags(write=False)
    ac.setflags(write=False)
    return dc, ac
