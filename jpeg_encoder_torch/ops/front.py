"""The program's front as plain PyTorch ops: an image in, the three padded
planes out.

The plain version of the front kernel (kernels/front.py, csrc/front.cu)
and the path the CPU runs. It composes the stages the JAX package runs as
XLA ops (jpeg_encoder_tpu/pipeline.py:251-254): the stored rows' strip,
flip and swap (bmp.rows_to_rgb), colour (ops/color.py), the live-rows
mask, zero padding and chroma subsampling (ops/sample.py).
"""

from __future__ import annotations

import torch

from jpeg_encoder_torch.config import FrameGeometry
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.ops import color, sample


def planes(
    image: torch.Tensor | bmp.Rows,
    geom: FrameGeometry,
    live_rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., H, W, 3) uint8 RGB, or a BMP file's stored rows (bmp.Rows of
    (..., H, stride)) -> the padded planes (Y (B * padded_height,
    padded_width), Cb and Cr (B * chroma_height, chroma_width)) uint8, the
    B images of the leading dimensions stacked, on the image's device.

    live_rows zeroes the Y, Cb and Cr rows at or past it, counted over the
    B * H image rows of the stack, after colour conversion: the band path's
    padding rows (parallel/tiled.py), which the reference's zero-filled
    planes hold as 0 in every plane (zero RGB would give Cb = Cr = 128).
    """
    rgb = (bmp.rows_to_rgb(image.rows, image.width)
           if isinstance(image, bmp.Rows) else image)
    y, cb, cr = color.rgb_to_ycbcr(rgb)
    if live_rows is not None:
        rows = rgb.shape[:-2]
        live = (torch.arange(rows.numel(), device=rgb.device)
                < live_rows).reshape(*rows, 1)
        y, cb, cr = (p * live for p in (y, cb, cr))
    y = sample.pad_plane(y, geom)
    cb = sample.subsample_plane(sample.pad_plane(cb, geom), geom)
    cr = sample.subsample_plane(sample.pad_plane(cr, geom), geom)
    return tuple(p.flatten(0, -2) for p in (y, cb, cr))
