"""Constant operands of the RealDCT and entropy kernels, built with NumPy.

These are exactly the arrays the JAX package's kernels take as operands
(kernels/dct_pallas._realdct_constants and ops/entropy.default_packed_luts
in jpeg_encoder_tpu), rebuilt here from the JAX-free tables.py and
oracle.dct_basis_f32 so that this package never imports JAX. The tests
assert bit-for-bit equality with the JAX package's arrays.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from jpeg_encoder_tpu import oracle, tables

_F32 = np.float32


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
    inv_sqrt2 = _F32(1.0) / _F32(np.sqrt(2.0))
    alpha = np.where(np.arange(8) == 0, inv_sqrt2, _F32(1.0)).astype(_F32)
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
