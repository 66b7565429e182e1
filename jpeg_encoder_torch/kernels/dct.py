"""DCT kernel wrappers with their plain versions.

- K1 REALDCT (csrc/realdct.cu) replaces jpeg_encoder_tpu/kernels/
  dct_pallas.py::real_dct_quant_planes_zigzag_pallas_t (fast=False);
- K2 FASTDCT (csrc/fastdct.cu) replaces the same entry with fast=True
  (the --fast-dct matmul body);
- K3 BINDCT (csrc/bindct.cu) replaces
  dct_pallas.py::bin_dct_quant_planes_zigzag_pallas_t.

On CUDA tensors each wrapper launches its hand-written kernel or raises; on
CPU tensors it runs the plain PyTorch version in ops/dct.py, which is the
kernel's spec. All three take three padded uint8 planes [Y, Cb, Cr] and
return (N_i, 64) int16 zigzag coefficients, on CUDA as row views of one
(N, 64) tensor.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_encoder_torch.kernels._build import Kernel
from jpeg_encoder_torch.ops import dct as dct_ops

_P, _I = ctypes.c_void_p, ctypes.c_int

REALDCT = Kernel(
    "realdct", "jt_realdct_planes", (_P, _I, _I, _P, _P, _I, _I) + (_P,) * 7,
    replaces="jpeg_encoder_tpu/kernels/dct_pallas.py:362",
)
FASTDCT = Kernel(
    "fastdct", "jt_fastdct_planes", (_P, _I, _I, _P, _P, _I, _I) + (_P,) * 5,
    replaces="jpeg_encoder_tpu/kernels/dct_pallas.py:362",
)
BINDCT = Kernel(
    "bindct", "jt_bindct_planes",
    (_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P),
    replaces="jpeg_encoder_tpu/kernels/dct_pallas.py:568",
)


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
        if t.device.type == "cuda" and t.data_ptr() % 8:
            raise ValueError(f"{name} plane must be 8-byte aligned")
    if cb.shape != cr.shape:
        raise ValueError(
            f"cb {tuple(cb.shape)} and cr {tuple(cr.shape)} differ"
        )
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y.device}")


def _launch(kernel: Kernel, y_plane, cb_plane, cr_plane, *operands):
    """Launch a 3-plane DCT kernel into a fresh (N, 64) int16 tensor and
    return its [Y, Cb, Cr] row views."""
    device = y_plane.device
    ny, nc = y_plane.numel() // 64, cb_plane.numel() // 64
    out = torch.empty((ny + 2 * nc, 64), dtype=torch.int16, device=device)
    with torch.cuda.device(device):
        kernel.launch(
            y_plane.data_ptr(), y_plane.shape[1], ny,
            cb_plane.data_ptr(), cr_plane.data_ptr(), cb_plane.shape[1], nc,
            *operands, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    return out[:ny], out[ny : ny + nc], out[ny + nc :]


def real_dct_quant_planes_zigzag(
    y_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    quality: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: exact RealDCT (the reference's f32 order), bit-identical to
    ops/dct.real_dct_quant_planes_zigzag."""
    _check_planes(y_plane, cb_plane, cr_plane)
    if y_plane.device.type == "cpu":
        return dct_ops.real_dct_quant_planes_zigzag(
            y_plane, cb_plane, cr_plane, quality
        )
    a_steps, b_steps, scale, q_luma, q_chroma = dct_ops.device_constants(
        quality, y_plane.device
    )
    return _launch(
        REALDCT, y_plane, cb_plane, cr_plane,
        a_steps.data_ptr(), b_steps.data_ptr(), scale.data_ptr(),
        q_luma.data_ptr(), q_chroma.data_ptr(),
    )


def real_dct_fast_planes_zigzag(
    y_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    quality: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: --fast-dct RealDCT, trunc((block @ K_zz^T) / q) in f32 with the
    kernel's own summation order: within max |diff| 1 of
    ops/dct.real_dct_fast_planes_zigzag, not bit-identical."""
    _check_planes(y_plane, cb_plane, cr_plane)
    if y_plane.device.type == "cpu":
        return dct_ops.real_dct_fast_planes_zigzag(
            y_plane, cb_plane, cr_plane, quality
        )
    kzz = dct_ops.fast_device_constant(y_plane.device)
    *_, q_luma, q_chroma = dct_ops.device_constants(quality, y_plane.device)
    return _launch(
        FASTDCT, y_plane, cb_plane, cr_plane,
        kzz.data_ptr(), q_luma.data_ptr(), q_chroma.data_ptr(),
    )


def bin_dct_quant_planes_zigzag(
    y_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    quality: int | None = None,
    descale: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: binDCT-C lifting and quantization (bug-parity, or descaled),
    bit-identical to ops/dct.bin_dct_quant_planes_zigzag."""
    _check_planes(y_plane, cb_plane, cr_plane)
    if y_plane.device.type == "cpu":
        return dct_ops.bin_dct_quant_planes_zigzag(
            y_plane, cb_plane, cr_plane, quality, descale
        )
    q_luma, q_chroma, gains = dct_ops.bindct_device_constants(
        quality, y_plane.device
    )
    return _launch(
        BINDCT, y_plane, cb_plane, cr_plane,
        q_luma.data_ptr(), q_chroma.data_ptr(), gains.data_ptr(),
        int(descale),
    )
