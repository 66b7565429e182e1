"""DCT kernel wrappers with their plain versions.

- K1 REALDCT (csrc/realdct.cu) replaces jpeg_encoder_tpu/kernels/
  dct_pallas.py::real_dct_quant_planes_zigzag_pallas_t (fast=False);
- K2 FASTDCT (csrc/fastdct.cu) replaces the same entry with fast=True
  (the --fast-dct matmul body);
- K3 BINDCT (csrc/bindct.cu) replaces
  dct_pallas.py::bin_dct_quant_planes_zigzag_pallas_t;
- the per-block tier: REALDCT_BLOCKS (csrc/realdct.cu, jt_realdct_blocks)
  replaces dct_pallas.py::real_dct_quant_zigzag_pallas (K6a) and its
  transposed forms real_dct_quant_zigzag_pallas_t (K6b, the same function
  in two TPU layouts), and BINDCT_BLOCKS (csrc/bindct.cu,
  jt_bindct_blocks) replaces dct_pallas.py::bin_dct_quant_zigzag_pallas
  (K6c). They share K1's and K3's device code.

On CUDA tensors each wrapper launches its hand-written kernel or raises; on
CPU tensors it runs the plain PyTorch version in ops/dct.py, which is the
kernel's spec. The plane kernels take three padded uint8 planes [Y, Cb,
Cr] and return (N_i, 64) int16 zigzag coefficients, on CUDA as row views of
one (N, 64) tensor; the per-block ones take (N, 64) uint8 blocks and
is_luma and return (N, 64) int32.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_encoder_torch import constants
from jpeg_encoder_torch.kernels._build import Kernel
from jpeg_encoder_torch.ops import dct as dct_ops

_P, _I = ctypes.c_void_p, ctypes.c_int

# K1's operands are host pointers (constants.realdct_kernel_operands),
# copied into the kernel's by-value parameters at launch.
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
    (_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P),
    replaces="jpeg_encoder_tpu/kernels/dct_pallas.py:568",
)
# K6a (:80); K6b (dct_pallas.py:156) computes the same function.
REALDCT_BLOCKS = Kernel(
    "realdct_blocks", "jt_realdct_blocks", (_P, _I, _I) + (_P,) * 7,
    replaces="jpeg_encoder_tpu/kernels/dct_pallas.py:80", lib="realdct",
)
BINDCT_BLOCKS = Kernel(
    "bindct_blocks", "jt_bindct_blocks", (_P, _I, _P, _P, _P, _P),
    replaces="jpeg_encoder_tpu/kernels/dct_pallas.py:714", lib="bindct",
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


def _realdct_operands(quality: int | None) -> tuple[int, ...]:
    """Host addresses of K1's compact operands (basis, scale, q_luma,
    q_chroma, zigzag), which the cache keeps alive."""
    return tuple(
        arr.ctypes.data for arr in constants.realdct_kernel_operands(quality)
    )


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
    return _launch(
        REALDCT, y_plane, cb_plane, cr_plane, *_realdct_operands(quality)
    )


def real_dct_fast_planes_zigzag(
    y_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    quality: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: --fast-dct RealDCT, trunc((block @ K_zz^T) / q), on the card as
    the TPU kernel's 3-term bf16 split of K_zz on the tensor cores with f32
    accumulation: within max |diff| 1 of ops/dct.real_dct_fast_planes_zigzag,
    not bit-identical."""
    _check_planes(y_plane, cb_plane, cr_plane)
    if y_plane.device.type == "cpu":
        return dct_ops.real_dct_fast_planes_zigzag(
            y_plane, cb_plane, cr_plane, quality
        )
    split = dct_ops.fast_split_device_constant(y_plane.device)
    *_, q_luma, q_chroma = dct_ops.device_constants(quality, y_plane.device)
    return _launch(
        FASTDCT, y_plane, cb_plane, cr_plane,
        split.data_ptr(), q_luma.data_ptr(), q_chroma.data_ptr(),
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
    divisors = dct_ops.bindct_divisors_device_constant(quality, y_plane.device)
    return _launch(
        BINDCT, y_plane, cb_plane, cr_plane,
        q_luma.data_ptr(), q_chroma.data_ptr(), gains.data_ptr(),
        divisors.data_ptr(), int(descale),
    )


def _check_blocks(blocks: torch.Tensor) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 or (
        blocks.shape[1] != 64
    ):
        raise ValueError(
            f"blocks must be (N, 64) uint8, got {blocks.dtype} "
            f"{tuple(blocks.shape)}"
        )
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    if blocks.device.type == "cuda" and blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {blocks.device}")


def _launch_blocks(kernel: Kernel, blocks: torch.Tensor, *operands):
    out = torch.empty(blocks.shape, dtype=torch.int32, device=blocks.device)
    with torch.cuda.device(blocks.device):
        kernel.launch(
            blocks.data_ptr(), blocks.shape[0], *operands, out.data_ptr(),
            torch.cuda.current_stream(blocks.device).cuda_stream,
        )
    return out


def real_dct_quant_zigzag(
    blocks: torch.Tensor, is_luma: bool, quality: int | None = None
) -> torch.Tensor:
    """K6a/b: (N, 64) uint8 blocks, all luma or all chroma -> (N, 64) int32
    zigzag RealDCT coefficients, bit-identical to
    ops/dct.real_dct_quant_zigzag (and to K1 on the same blocks)."""
    _check_blocks(blocks)
    if blocks.device.type == "cpu":
        return dct_ops.real_dct_quant_zigzag(blocks, is_luma, quality)
    return _launch_blocks(
        REALDCT_BLOCKS, blocks, int(not is_luma), *_realdct_operands(quality)
    )


def bin_dct_quant_zigzag(
    blocks: torch.Tensor, is_luma: bool, quality: int | None = None
) -> torch.Tensor:
    """K6c: (N, 64) uint8 blocks, all luma or all chroma -> (N, 64) int32
    zigzag bug-parity binDCT coefficients, bit-identical to
    ops/dct.bin_dct_quant_zigzag (and to K3 on the same blocks)."""
    _check_blocks(blocks)
    if blocks.device.type == "cpu":
        return dct_ops.bin_dct_quant_zigzag(blocks, is_luma, quality)
    q_luma, q_chroma, _ = dct_ops.bindct_device_constants(
        quality, blocks.device
    )
    divisors = dct_ops.bindct_divisors_device_constant(quality, blocks.device)
    table = 0 if is_luma else 1
    return _launch_blocks(
        BINDCT_BLOCKS, blocks, (q_luma if is_luma else q_chroma).data_ptr(),
        divisors[table].data_ptr(),
    )
