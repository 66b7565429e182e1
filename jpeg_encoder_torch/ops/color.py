"""RGB -> YCbCr colour conversion (BT.601 / JFIF constants).

The reference evaluates each channel as a float32 multiply/add chain with
one rounding per operation and truncates toward zero with saturation
(colorspace.rs:10-12). Contracting `a * b + c` into a fused multiply-add
merges two roundings and flips pixels whose value lands on a rounding tie
(about 2e-4 of all RGB triples; jpeg_encoder_tpu/ops/color.py:11-29 has
the measurement). So this port uses the contraction-proof form on every
device: each per-channel PRODUCT comes from a 256-entry float32 table that
NumPy computes with per-operation rounding, and the tensor program only
gathers and adds. An add chain has nothing for a compiler to fuse, so the
result is exact on the CPU and on the card alike.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jpeg_encoder_torch import graphs

_F32 = np.float32


# The chains' nine f32 coefficients, in the tables' row order (the front
# kernel, kernels/front.py, forms the same products from them).
COEFFICIENTS = np.array([0.299, 0.587, 0.114, 0.168736, 0.331264, 0.5, 0.5,
                         0.418688, 0.081312], dtype=_F32)


@functools.cache
def _channel_luts_np() -> np.ndarray:
    """(9, 256) f32 per-channel contributions, exactly per-op rounded.

    Rows: y_r, y_g, y_b, cb_r, cb_g, cb_b, cr_r, cr_g, cr_b. The cb_r and
    cr_r rows already hold the first two operations of their chains.
    """
    c = np.arange(256, dtype=_F32)
    k = COEFFICIENTS
    return np.stack([
        k[0] * c,
        k[1] * c,
        k[2] * c,
        _F32(128.0) - k[3] * c,
        k[4] * c,
        k[5] * c,
        _F32(128.0) + k[6] * c,
        k[7] * c,
        k[8] * c,
    ]).astype(_F32)


@graphs.operand_cache(maxsize=8)
def _channel_luts(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_channel_luts_np()).to(device)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.trunc(x), 0.0, 255.0).to(torch.uint8)


def rgb_to_ycbcr(
    rgb: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., 3) uint8 RGB -> three uint8 planes (y, cb, cr), on rgb's device."""
    y_r, y_g, y_b, cb_r, cb_g, cb_b, cr_r, cr_g, cr_b = _channel_luts(
        rgb.device
    )
    r = rgb[..., 0].long()
    g = rgb[..., 1].long()
    b = rgb[..., 2].long()
    y = (y_r[r] + y_g[g]) + y_b[b]
    cb = (cb_r[r] - cb_g[g]) + cb_b[b]
    cr = (cr_r[r] - cr_g[g]) - cr_b[b]
    return _to_u8(y), _to_u8(cb), _to_u8(cr)
