"""Plane padding, chroma subsampling and 8x8 block tiling.

Port of jpeg_encoder_tpu/ops/sample.py. A plane padded to MCU multiples is
exactly a (by, 8, bx, 8) tensor, so blocks are a reshape and a permute.
Subsampling is an integer window mean over the zero-padded plane,
assembled in the reference's block-scan push order: flatten, truncate to
the chroma plane's size, reshape (oracle.subsample_plane tells the whole
story, including the dim % (8 * factor) == 1 quirk).
"""

from __future__ import annotations

import torch

from jpeg_encoder_tpu.config import FrameGeometry


def pad_plane(plane: torch.Tensor, geom: FrameGeometry) -> torch.Tensor:
    """Zero-pad (H, W) up to (padded_height, padded_width).

    Zero padding, not edge replication: the reference allocates its planes
    zero-filled and writes only the image region (jpeg_image.rs:59-84).
    """
    out = plane.new_zeros((geom.padded_height, geom.padded_width))
    out[: geom.height, : geom.width] = plane
    return out


def subsample_plane(plane: torch.Tensor, geom: FrameGeometry) -> torch.Tensor:
    """Box-filter downsample a padded chroma plane -> (chroma_h, chroma_w).

    Integer floor mean over each h x v window of the padded plane (edge
    windows average in the zero padding), then the push-order flatten:
    bit-identical to the reference for every width, including the
    width % (8h) == 1 misalignment.
    """
    h, v = geom.h_factor, geom.v_factor
    if h == 1 and v == 1:
        return plane
    if h not in (1, 2) or v not in (1, 2):
        raise NotImplementedError(f"unsupported subsampling factors ({h}, {v})")
    x = plane.to(torch.int32)
    if v == 2:
        x = x[0::2, :] + x[1::2, :]
    if h == 2:
        x = x[:, 0::2] + x[:, 1::2]
    averages = torch.div(x, h * v, rounding_mode="floor")
    n = geom.chroma_height * geom.chroma_width
    flat = averages.reshape(-1)[:n]
    return flat.to(torch.uint8).reshape(geom.chroma_height, geom.chroma_width)


def blockify(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H//8 * W//8, 64): row-major blocks, row-major within."""
    hgt, wdt = plane.shape
    return (
        plane.reshape(hgt // 8, 8, wdt // 8, 8)
        .permute(0, 2, 1, 3)
        .reshape(-1, 64)
    )
