"""The front kernel's wrapper with its plain version.

F1 FRONT (csrc/front.cu) replaces no TPU kernel: the JAX package's front
is plain XLA ops (jpeg_encoder_tpu/pipeline.py:251-254), which XLA fuses;
as separate torch ops it is the device program's largest part. It takes an
image in either of encode_array's forms, an (..., H, W, 3) RGB tensor or a
BMP file's stored rows (bmp.Rows of (..., H, stride)), and returns the
three padded planes [Y, Cb, Cr] that the DCT kernels take, the leading
dimensions' images stacked.

On CUDA tensors planes() launches the kernel or raises; on CPU tensors it
runs the plain version, ops/front.planes, which is the kernel's spec.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from jpeg_encoder_torch.config import FrameGeometry
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.kernels._build import Kernel
from jpeg_encoder_torch.ops import color
from jpeg_encoder_torch.ops import front as front_ops

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

FRONT = Kernel(
    "front", "jt_front_planes",
    (_P, _L, _L, _I, _I, _I, _I, _I, _I, _I, _I, _L, _L, _P, _P, _P, _P, _I,
     _P),
    replaces="jpeg_encoder_tpu/pipeline.py:251",
)

# The colour coefficients, in host memory for the launch's by-value copy.
_COEFFICIENTS = np.ascontiguousarray(color.COEFFICIENTS, dtype=np.float32)


@functools.cache
def sm_count(index: int) -> int:
    """Card `index`'s streaming multiprocessors, read once: the kernel's
    grid is a fixed number of CTAs on each, so a captured launch keeps it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(image: torch.Tensor | bmp.Rows, geom: FrameGeometry,
           live_rows: int | None) -> torch.Tensor:
    """The image's tensor, checked against geom; raise on what the kernel
    does not take."""
    if isinstance(image, bmp.Rows):
        data, tail = image.rows, (geom.height, bmp.row_stride(geom.width))
        if (image.width, image.height) != (geom.width, geom.height):
            raise ValueError(
                f"rows of a {image.width}x{image.height} file, geometry "
                f"{geom.width}x{geom.height}")
    else:
        data, tail = image, (geom.height, geom.width, 3)
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8:
        raise ValueError(f"the image must be a uint8 tensor, got {data!r:.80}")
    if data.dim() < len(tail) or tuple(data.shape[-len(tail):]) != tail:
        raise ValueError(
            f"image shape {tuple(data.shape)} does not end in {tail}")
    if not data.is_contiguous():
        raise ValueError("the image must be contiguous")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    if live_rows is not None and live_rows < 0:
        raise ValueError(f"live_rows must be >= 0, got {live_rows}")
    return data


def planes(
    image: torch.Tensor | bmp.Rows,
    geom: FrameGeometry,
    live_rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F1: the image -> (Y (B * padded_height, padded_width), Cb, Cr (B *
    chroma_height, chroma_width)) uint8 padded planes, bit-identical to
    ops/front.planes; on CUDA three contiguous views of one new tensor,
    each 64-byte aligned (the kernel stores Y 16 bytes at a time)."""
    data = _check(image, geom, live_rows)
    if data.device.type == "cpu":
        return front_ops.planes(image, geom, live_rows)
    is_rows = isinstance(image, bmp.Rows)
    batch = data.numel() // (data.shape[-1] * data.shape[-2]
                             * (1 if is_rows else data.shape[-3]))
    row_pitch = data.shape[-1] if is_rows else 3 * geom.width
    ny = geom.padded_height * geom.padded_width
    nc = geom.chroma_height * geom.chroma_width
    out = torch.empty(batch * (ny + 2 * nc), dtype=torch.uint8,
                      device=data.device)
    y = out[: batch * ny].view(batch * geom.padded_height, geom.padded_width)
    cb, cr = (out[batch * (ny + i * nc): batch * (ny + (i + 1) * nc)]
              .view(batch * geom.chroma_height, geom.chroma_width)
              for i in range(2))
    live = batch * geom.height if live_rows is None else live_rows
    with torch.cuda.device(data.device):
        FRONT.launch(
            data.data_ptr(), row_pitch, row_pitch * geom.height, int(is_rows),
            batch, geom.width, geom.height, geom.h_factor, geom.v_factor,
            geom.padded_width, geom.padded_height, nc, live,
            _COEFFICIENTS.ctypes.data, y.data_ptr(), cb.data_ptr(),
            cr.data_ptr(), sm_count(data.device.index),
            torch.cuda.current_stream(data.device).cuda_stream,
        )
    return y, cb, cr
