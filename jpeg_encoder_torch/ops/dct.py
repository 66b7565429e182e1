"""RealDCT + quantization in the reference's exact order (the plain path).

Port of jpeg_encoder_tpu/ops/dct.py:180-224 (real_dct_quant_ordered) with
the three-plane luma/chroma select of dct_quantize_planes (:120-177). Per
8x8 block, after the level shift, 64 float32 steps in (x, y) scan order

    acc = acc + (px[k] * a_steps[k]) * b_steps[k]

each as its own tensor op, so every multiply and add rounds once, as the
reference's scalar loop does (dct_quant.rs:217-225); then
trunc((scale * acc) / q) with a true float32 divide. The per-step factors
carry the zigzag permutation in their columns, so coefficients come out in
zigzag order. This is the CPU path and the spec for the CUDA kernel
(kernels/dct.py), which must equal it bit for bit.
"""

from __future__ import annotations

import functools

import torch

from jpeg_encoder_torch import constants
from jpeg_encoder_torch.ops.sample import blockify


@functools.lru_cache(maxsize=32)
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


def real_dct_quant_planes_zigzag(
    y_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    quality: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three padded (H, W) uint8 planes -> three (N_i, 64) int16 zigzag
    quantized coefficient arrays [Y, Cb, Cr]; luma blocks take the luma
    table, the rest the chroma table."""
    a_steps, b_steps, scale, q_luma, q_chroma = device_constants(
        quality, y_plane.device
    )
    blocks = torch.cat(
        [blockify(y_plane), blockify(cb_plane), blockify(cr_plane)]
    )
    ny, nc = y_plane.numel() // 64, cb_plane.numel() // 64
    shifted = (blocks.to(torch.int16) - 128).to(torch.float32)
    acc = torch.zeros_like(shifted)
    for k in range(64):
        acc = acc + (shifted[:, k : k + 1] * a_steps[k]) * b_steps[k]
    rows = torch.arange(blocks.shape[0], device=blocks.device)
    is_luma = (rows < ny)[:, None]
    q = torch.where(is_luma, q_luma, q_chroma)
    out = torch.trunc((scale * acc) / q).to(torch.int16)
    return out[:ny], out[ny : ny + nc], out[ny + nc :]
