"""RealDCT kernel wrapper (K1): csrc/realdct.cu, with its plain version.

Replaces jpeg_encoder_tpu/kernels/dct_pallas.py::
real_dct_quant_planes_zigzag_pallas_t (fast=False). On CUDA tensors the
wrapper launches the hand-written kernel or raises; on CPU tensors it runs
the plain chain of ops/dct.py, which is the kernel's spec.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from jpeg_encoder_torch.kernels import _build
from jpeg_encoder_torch.ops import dct as dct_ops

SOURCE = "jpeg_encoder_torch/csrc/realdct.cu"
REPLACES = "jpeg_encoder_tpu/kernels/dct_pallas.py:362"

# Kernel launches since the last reset (the CPU path does not count).
launches = 0


@functools.cache
def _kernel():
    fn = _build.load().jt_realdct_planes
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, p, p, i, i, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check_planes(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> None:
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.device != y.device:
            raise ValueError(f"{name} plane is on {t.device}, y on {y.device}")
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(
                f"{name} plane must be 2-D uint8, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.shape[0] % 8 or t.shape[1] % 8:
            raise ValueError(
                f"{name} plane shape {tuple(t.shape)} is not padded to 8"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} plane must be contiguous")
    if cb.shape != cr.shape:
        raise ValueError(
            f"cb {tuple(cb.shape)} and cr {tuple(cr.shape)} differ"
        )


def real_dct_quant_planes_zigzag(
    y_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    quality: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded u8 planes -> (N_i, 64) int16 zigzag coefficients [Y, Cb, Cr].

    On CUDA the three outputs are row views of one (N, 64) tensor.
    """
    global launches
    _check_planes(y_plane, cb_plane, cr_plane)
    device = y_plane.device
    if device.type == "cpu":
        return dct_ops.real_dct_quant_planes_zigzag(
            y_plane, cb_plane, cr_plane, quality
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    a_steps, b_steps, scale, q_luma, q_chroma = dct_ops.device_constants(
        quality, device
    )
    ny, nc = y_plane.numel() // 64, cb_plane.numel() // 64
    out = torch.empty((ny + 2 * nc, 64), dtype=torch.int16, device=device)
    with torch.cuda.device(device):
        err = _kernel()(
            y_plane.data_ptr(), y_plane.shape[1], ny,
            cb_plane.data_ptr(), cr_plane.data_ptr(), cb_plane.shape[1], nc,
            a_steps.data_ptr(), b_steps.data_ptr(), scale.data_ptr(),
            q_luma.data_ptr(), q_chroma.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"realdct kernel launch failed: cudaError_t {err}")
    launches += 1
    return out[:ny], out[ny : ny + nc], out[ny + nc :]
