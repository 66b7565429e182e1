"""DCT + quantization of three padded planes, or of (N, 64) blocks (the
plain paths).

The CPU path and the specs of the CUDA kernels in kernels/dct.py: the
exact RealDCT (K1), the --fast-dct matmul RealDCT (K2) and the binDCT-C
lifting transform (K3), each with the three-plane luma/chroma quant select
of jpeg_encoder_tpu/ops/dct.py::dct_quantize_planes (:120-177). All return
(N_i, 64) int16 zigzag coefficients [Y, Cb, Cr]. The per-block tier (K6a/b
and K6c: (N, 64) uint8 blocks and one luma/chroma choice -> (N, 64) int32
zigzag coefficients) runs the same per-block cores, real_dct_quant_blocks
and bin_dct_quant_blocks, that the plane functions run.

Exact RealDCT: port of ops/dct.py:180-224 (real_dct_quant_ordered). Per
8x8 block, after the level shift, 64 float32 steps in (x, y) scan order

    acc = acc + (px[k] * a_steps[k]) * b_steps[k]

each as its own tensor op, so every multiply and add rounds once, as the
reference's scalar loop does (dct_quant.rs:217-225); then
trunc((scale * acc) / q) with a true float32 divide. The per-step factors
carry the zigzag permutation in their columns, so coefficients come out in
zigzag order. K1 must equal it bit for bit.

--fast-dct: port of ops/dct.py:85-108 (real_dct_quant) with the select of
:156-160, trunc((block @ K_zz^T) / q) as one float32 matrix product; held
by a tolerance, not by bytes (EncoderConfig.fast_dct).

binDCT-C: port of ops/dct.py:227-265 (the lifting network,
constants.bindct_lift8, on int32 with arithmetic >>), :327-333 (rows first,
then columns) and :164-176 (the
quantization): sign(x) * (|x| // q) in bug-parity mode, or
trunc((x * g) / q) in float32 with the descale gains g. K3 must equal it
bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jpeg_encoder_torch import constants, graphs, tables
from jpeg_encoder_torch.ops.sample import blockify


@graphs.operand_cache(maxsize=32)
def device_constants(
    quality: int | None, device: torch.device
) -> tuple[torch.Tensor, ...]:
    """(a_steps, b_steps, scale, q_luma, q_chroma) as f32 tensors on device.

    a_steps and b_steps are (64, 64); the three rows are (64,).
    """
    return tuple(
        torch.from_numpy(arr.copy()).to(device).squeeze(0)  # (1, 64) -> (64,)
        for arr in constants.realdct_constants(quality)
    )


@functools.lru_cache(maxsize=8)
def fast_device_constant(device: torch.device) -> torch.Tensor:
    """The (64, 64) f32 zigzag-row Kronecker matrix K_zz on device."""
    return torch.from_numpy(constants.fast_kron_zigzag().copy()).to(device)


@graphs.operand_cache(maxsize=8)
def fast_split_device_constant(device: torch.device) -> torch.Tensor:
    """K2's operand: the (3, 64, 64) bfloat16 split [m1, m2, m3] of K_zz
    (constants.fast_kron_split) on device."""
    bits = constants.fast_kron_split().view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)


@graphs.operand_cache(maxsize=32)
def bindct_device_constants(
    quality: int | None, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q_luma, q_chroma, gains): (64,) int32, int32 and f32 zigzag rows."""
    return tuple(
        torch.from_numpy(arr.copy()).to(device).reshape(64)
        for arr in constants.bindct_constants(quality)
    )


@graphs.operand_cache(maxsize=32)
def bindct_divisors_device_constant(
    quality: int | None, device: torch.device
) -> torch.Tensor:
    """The binDCT kernels' (2, 64, 2) int32 division magic numbers
    (constants.bindct_divisors) on device."""
    return torch.from_numpy(constants.bindct_divisors(quality).copy()).to(device)


def _planes_to_blocks(y_plane, cb_plane, cr_plane):
    """[Y | Cb | Cr] (N, 64) uint8 blocks, and a (N, 1) luma mask."""
    blocks = torch.cat(
        [blockify(y_plane), blockify(cb_plane), blockify(cr_plane)]
    )
    rows = torch.arange(blocks.shape[0], device=blocks.device)
    return blocks, (rows < y_plane.numel() // 64)[:, None]


def _split(out: torch.Tensor, y_plane, cb_plane):
    ny, nc = y_plane.numel() // 64, cb_plane.numel() // 64
    return out[:ny], out[ny : ny + nc], out[ny + nc :]


def real_dct_quant_blocks(
    blocks: torch.Tensor, q: torch.Tensor, quality: int | None = None
) -> torch.Tensor:
    """The ordered chain on (N, 64) uint8 blocks with f32 quantization
    rows q ((64,) or (N, 64), zigzag order) -> (N, 64) int32 zigzag
    coefficients."""
    a_steps, b_steps, scale, _, _ = device_constants(quality, blocks.device)
    shifted = (blocks.to(torch.int16) - 128).to(torch.float32)
    acc = torch.zeros_like(shifted)
    for k in range(64):
        acc = acc + (shifted[:, k : k + 1] * a_steps[k]) * b_steps[k]
    return torch.trunc((scale * acc) / q).to(torch.int32)


def real_dct_quant_planes_zigzag(
    y_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    quality: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three padded (H, W) uint8 planes -> three (N_i, 64) int16 zigzag
    quantized coefficient arrays [Y, Cb, Cr]; luma blocks take the luma
    table, the rest the chroma table."""
    *_, q_luma, q_chroma = device_constants(quality, y_plane.device)
    blocks, is_luma = _planes_to_blocks(y_plane, cb_plane, cr_plane)
    q = torch.where(is_luma, q_luma, q_chroma)
    out = real_dct_quant_blocks(blocks, q, quality).to(torch.int16)
    return _split(out, y_plane, cb_plane)


def real_dct_quant_zigzag(
    blocks: torch.Tensor, is_luma: bool, quality: int | None = None
) -> torch.Tensor:
    """K6a/b: (N, 64) uint8 blocks, all luma or all chroma -> (N, 64)
    int32 zigzag RealDCT coefficients (jpeg_encoder_tpu/kernels/
    dct_pallas.py::real_dct_quant_zigzag_pallas and its transposed forms,
    real_dct_quant_zigzag_pallas_t)."""
    *_, q_luma, q_chroma = device_constants(quality, blocks.device)
    return real_dct_quant_blocks(
        blocks, q_luma if is_luma else q_chroma, quality
    )


def real_dct_fast_planes_zigzag(
    y_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    quality: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """--fast-dct: trunc((shifted @ K_zz^T) / q) as one f32 matmul.

    The product must be a full float32 one, as the JAX package's
    Precision.HIGHEST dot is: with TF32 (float32 matmul precision "high"
    or "medium") the card keeps ~10 mantissa bits and the result leaves
    the --fast-dct tolerance, so this refuses to run under it.
    """
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the --fast-dct plain version needs full float32 matmuls: "
            "torch.set_float32_matmul_precision('highest')"
        )
    *_, q_luma, q_chroma = device_constants(quality, y_plane.device)
    kzz = fast_device_constant(y_plane.device)
    blocks, is_luma = _planes_to_blocks(y_plane, cb_plane, cr_plane)
    shifted = (blocks.to(torch.int16) - 128).to(torch.float32)
    coeffs = torch.matmul(shifted, kzz.T)
    q = torch.where(is_luma, q_luma, q_chroma)
    out = torch.trunc(coeffs / q).to(torch.int16)
    return _split(out, y_plane, cb_plane)


def _shr(v: torch.Tensor, k: int) -> torch.Tensor:
    return v >> k  # arithmetic on int32, as Rust's is


def bin_dct_transform(blocks_u8: torch.Tensor) -> torch.Tensor:
    """(N, 64) uint8 blocks -> (N, 64) int32 raw binDCT-C coefficients,
    natural order: lifts along each block row, then along each column."""
    work = blocks_u8.to(torch.int32).reshape(-1, 8, 8) - 128
    rows = constants.bindct_lift8([work[:, :, i] for i in range(8)], _shr)
    work = torch.stack(rows, dim=2)
    cols = constants.bindct_lift8([work[:, i, :] for i in range(8)], _shr)
    work = torch.stack(cols, dim=1)
    return work.reshape(-1, 64)


@functools.lru_cache(maxsize=8)
def _zigzag(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tables.ZIGZAG_ORDER.astype(np.int64)).to(device)


def bin_dct_quant_blocks(
    blocks: torch.Tensor, q: torch.Tensor, gains: torch.Tensor | None = None
) -> torch.Tensor:
    """binDCT-C + quantization of (N, 64) uint8 blocks with int32
    quantization rows q ((64,) or (N, 64), zigzag order) -> (N, 64) int32
    zigzag coefficients. Without gains, the reference's bug-parity path
    (raw lifting outputs divided by the table, integer division
    truncating toward zero); with the (64,) f32 descale gains,
    trunc((x * g) / q), in that float32 association."""
    work = bin_dct_transform(blocks)[:, _zigzag(blocks.device)]
    if gains is not None:
        out = torch.trunc(work.to(torch.float32) * gains / q.to(torch.float32))
    else:
        out = torch.sign(work) * torch.div(work.abs(), q, rounding_mode="floor")
    return out.to(torch.int32)


def bin_dct_quant_planes_zigzag(
    y_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    quality: int | None = None,
    descale: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """binDCT-C + quantization of three padded planes, bug-parity or
    descaled (bin_dct_quant_blocks)."""
    q_luma, q_chroma, gains = bindct_device_constants(
        quality, y_plane.device
    )
    blocks, is_luma = _planes_to_blocks(y_plane, cb_plane, cr_plane)
    q = torch.where(is_luma, q_luma, q_chroma)
    out = bin_dct_quant_blocks(blocks, q, gains if descale else None)
    return _split(out.to(torch.int16), y_plane, cb_plane)


def bin_dct_quant_zigzag(
    blocks: torch.Tensor, is_luma: bool, quality: int | None = None
) -> torch.Tensor:
    """K6c: (N, 64) uint8 blocks, all luma or all chroma -> (N, 64) int32
    zigzag bug-parity binDCT coefficients (jpeg_encoder_tpu/kernels/
    dct_pallas.py::bin_dct_quant_zigzag_pallas)."""
    q_luma, q_chroma, _ = bindct_device_constants(quality, blocks.device)
    return bin_dct_quant_blocks(blocks, q_luma if is_luma else q_chroma)
