"""Bitstream assembly kernel wrapper (K5): csrc/pack.cu, with its plain
version.

Replaces jpeg_encoder_tpu/kernels/pack_pallas.py::assemble_bitstream_pallas,
vmapped over restart intervals as the JAX package's packer="pallas" tier
runs it. On CUDA tensors the wrapper launches the hand-written kernel (a
warp per 32 output words, each written once: one kernel, no memset) or
raises; on CPU tensors it runs ops/entropy.assemble_bitstream, which is the
kernel's spec.

The kernel needs what the plain version does not: within a row the offsets
are non-decreasing and entry e's bits lie in [offsets[e], offsets[e + 1]),
its words zero past its bit count. scan.assemble_operands gives exactly
that (pack_level1's words, offsets an exclusive cumsum of the bit counts,
0-bit entries sharing the next entry's offset). The wrapper does not check
it on the device: that would cost a pass over the offsets and a sync.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_encoder_torch.kernels._build import Kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops

_P, _I = ctypes.c_void_p, ctypes.c_int
PACK = Kernel(
    "pack", "jt_assemble_bitstream", (_P, _P, _I, _I, _I, _P, _I, _P),
    replaces="jpeg_encoder_tpu/kernels/pack_pallas.py:90",
)


def assemble_bitstream(
    entry_words: torch.Tensor, offsets: torch.Tensor, capacity_bytes: int
) -> torch.Tensor:
    """(B, E, EW) int32 per-entry words (u32 bits, pack_level1's) + (B, E)
    int64 bit offsets within each row, non-decreasing as the module's
    docstring says -> (B, capacity_bytes // 4) int32 words, as
    ops/entropy.assemble_bitstream.

    Words at or past a row's capacity are dropped. The TPU kernel clamps
    such entries onto the buffer's tail instead (pack_pallas.py:118-120):
    the two differ only on an overflow, whose payload the caller discards.
    """
    if capacity_bytes <= 0 or capacity_bytes % 4:
        raise ValueError(
            "capacity_bytes must be a positive multiple of 4, got "
            f"{capacity_bytes}"
        )
    if (entry_words.dtype != torch.int32 or entry_words.dim() != 3
            or not 0 < entry_words.shape[2] < 64):
        raise ValueError(
            "entry_words must be (B, E, EW) int32 with EW < 64, got "
            f"{entry_words.dtype} {tuple(entry_words.shape)}"
        )
    if (offsets.dtype != torch.int64
            or offsets.shape != entry_words.shape[:2]
            or offsets.device != entry_words.device):
        raise ValueError(
            "offsets must be (B, E) int64 on entry_words' device, got "
            f"{offsets.dtype} {tuple(offsets.shape)} on {offsets.device}"
        )
    device = entry_words.device
    if device.type == "cpu":
        return entropy_ops.assemble_bitstream(
            entry_words, offsets, capacity_bytes
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if capacity_bytes // 4 >= 2**31:
        raise ValueError(
            f"capacity_bytes {capacity_bytes}: the kernel assembles rows of "
            "fewer than 2^31 4-byte words"
        )
    rows, entries, ew = entry_words.shape
    entry_words = entry_words.contiguous()
    offsets = offsets.contiguous()
    num_words = capacity_bytes // 4
    out = torch.empty((rows, num_words), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        PACK.launch(
            entry_words.data_ptr(), offsets.data_ptr(), rows, entries, ew,
            out.data_ptr(), num_words,
            torch.cuda.current_stream(device).cuda_stream,
        )
    return out
