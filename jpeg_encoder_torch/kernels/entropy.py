"""Entropy kernel wrapper (K4): csrc/entropy.cu, with its plain version.

Replaces jpeg_encoder_tpu/kernels/entropy_pallas.py::encode_entropy_fused.
On CUDA tensors the wrapper launches the hand-written three-pass kernel
(count, scan, write) or raises; on CPU tensors it runs the plain
symbolizer and packer of ops/entropy.py, which is the kernel's spec. The
Huffman tables are operands, so per-image optimized tables need no new
kernel. One launch codes the unbroken scan or every restart interval of a
restart-framed one (the TPU kernel under vmap), each into its own row.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_encoder_tpu.config import FrameGeometry
from jpeg_encoder_torch.kernels._build import Kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops

_P, _I = ctypes.c_void_p, ctypes.c_int
ENTROPY = Kernel(
    "entropy", "jt_entropy_encode",
    (_P, _I, _I, _I, _I) + (_P,) * 8 + (_I, _P),
    replaces="jpeg_encoder_tpu/kernels/entropy_pallas.py:570",
)
_SCAN_TILE = 4096  # entries per scan tile (kScanTile in entropy.cu)


def _check_operands(z, geom, capacity_bytes, init_dc, luts, epi) -> None:
    if entropy_ops.worst_case_capacity_bytes(geom) * 8 >= 2**31:
        raise ValueError(
            f"{geom.width}x{geom.height}: the worst-case bit count does not "
            "fit the kernel's int32 offsets"
        )
    if capacity_bytes <= 0 or capacity_bytes % 4:
        raise ValueError(
            "capacity_bytes must be a positive multiple of 4, got "
            f"{capacity_bytes}"
        )
    if z.dtype != torch.int16 or z.dim() != 2 or z.shape[1] != 64:
        raise ValueError(
            f"z must be (E, 64) int16, got {z.dtype} {tuple(z.shape)}"
        )
    if z.shape[0] == 0:
        raise ValueError("z has no entries")
    if z.shape[0] != geom.num_scan_entries:
        raise ValueError(
            f"z has {z.shape[0]} entries, the geometry {geom.num_scan_entries}"
        )
    if not z.is_contiguous() or z.data_ptr() % 4:
        raise ValueError("z must be contiguous and 4-byte aligned")
    if epi is not None:
        if epi <= 0 or epi % geom.blocks_per_mcu:
            raise ValueError(
                "entries_per_interval must be a positive multiple of the "
                f"{geom.blocks_per_mcu} blocks of an MCU, got {epi}"
            )
        if init_dc is not None and epi < z.shape[0]:
            raise ValueError(
                "init_dc seeds one unbroken scan; the DC predictors of "
                "restart intervals start from 0"
            )
    if init_dc is not None and (
        init_dc.shape != (3,) or init_dc.device != z.device
    ):
        raise ValueError("init_dc must be a (3,) tensor on z's device")
    if luts is not None:
        for t in luts:
            if t.shape != (2, 256) or t.device != z.device:
                raise ValueError(
                    "luts must be two (2, 256) tensors on z's device"
                )


def encode_entries(
    z: torch.Tensor,
    geom: FrameGeometry,
    capacity_bytes: int,
    init_dc: torch.Tensor | None = None,
    luts: tuple[torch.Tensor, torch.Tensor] | None = None,
    *,
    live_entries: int | None = None,
    entries_per_interval: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, 64) int16 scan entries -> (bytes (capacity_bytes,) uint8,
    total_bits int32 scalar), as ops/entropy.encode_entries.

    init_dc: (3,) initial DC predictors (Y, Cb, Cr), zeros by default; the
    unbroken scan only. luts: (dc, ac) (2, 256) packed `length << 20 |
    code` tables, Annex K by default. live_entries: entries at index >= it
    emit nothing. entries_per_interval (a multiple of the MCU's blocks):
    code each run of that many entries as its own restart interval and
    return (bytes (n_int, capacity_bytes), bits (n_int,)), capacity_bytes
    per interval.
    """
    epi = entries_per_interval
    _check_operands(z, geom, capacity_bytes, init_dc, luts, epi)
    device = z.device
    if device.type == "cpu":
        return entropy_ops.encode_entries(
            z, geom, capacity_bytes, init_dc, luts,
            live_entries=live_entries, entries_per_interval=epi,
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if init_dc is None:
        init_dc = torch.zeros(3, dtype=torch.int32, device=device)
    if luts is None:
        luts = entropy_ops.device_luts(device)
    dc_lut, ac_lut = luts
    init_dc = init_dc.to(torch.int32).contiguous()
    dc_lut = dc_lut.to(torch.int32).contiguous()
    ac_lut = ac_lut.to(torch.int32).contiguous()
    num_entries = z.shape[0]
    live = num_entries if live_entries is None else live_entries
    live = min(max(int(live), 0), num_entries)
    n_int = 1 if epi is None else -(-num_entries // epi)
    num_words = capacity_bytes // 4
    entry_bits = torch.empty(num_entries, dtype=torch.int32, device=device)
    tile_sums = torch.empty(
        -(-num_entries // _SCAN_TILE), dtype=torch.int32, device=device
    )
    total_bits = torch.empty(1, dtype=torch.int32, device=device)
    bits = torch.empty(n_int, dtype=torch.int32, device=device)
    words = torch.empty((n_int, num_words), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        ENTROPY.launch(
            z.data_ptr(), num_entries, epi or num_entries, live,
            geom.h_factor * geom.v_factor, init_dc.data_ptr(),
            dc_lut.data_ptr(), ac_lut.data_ptr(), entry_bits.data_ptr(),
            tile_sums.data_ptr(), total_bits.data_ptr(), bits.data_ptr(),
            words.data_ptr(), num_words,
            torch.cuda.current_stream(device).cuda_stream,
        )
    # The kernel stores byte-swapped words: their bytes are the stream.
    data = words.view(torch.uint8)
    if epi is None:
        return data[0], bits[0]
    return data, bits
