"""Entropy kernel wrapper (K4): csrc/entropy.cu, with its plain version.

Replaces jpeg_encoder_tpu/kernels/entropy_pallas.py::encode_entropy_fused.
On CUDA tensors the wrapper launches the hand-written one-pass kernel (a
scan with decoupled look-back, after one memset) or raises; on CPU tensors
it runs the plain symbolizer and packer of ops/entropy.py, which is the
kernel's spec. The Huffman tables are operands, so per-image optimized
tables need no new kernel. One launch codes the unbroken scan or every
restart interval of a restart-framed one (the TPU kernel under vmap), each
into its own row, and the same for every image of a batch, with one table
pair for all images or one an image; the rows' DC predictors start from
one init_dc vector a row when the caller gives them (one image's bands,
parallel/tiled.py), else from 0.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_encoder_torch import graphs
from jpeg_encoder_torch.config import FrameGeometry
from jpeg_encoder_torch.kernels._build import Kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops

_P, _I = ctypes.c_void_p, ctypes.c_int
ENTROPY = Kernel(
    "entropy", "jt_entropy_encode",
    (_P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _P, _P, _I, _P),
    replaces="jpeg_encoder_tpu/kernels/entropy_pallas.py:570",
)
_TILE = 64  # entries a tile (kTile in entropy.cu)
# The kernel's bit offsets and counts are 64-bit; a row's length in words is
# a C int, the one bound on its operands.
MAX_NUM_WORDS = 2**31 - 1


@graphs.operand_cache(maxsize=8)
def _zero_dc(device: torch.device) -> torch.Tensor:
    """The default init_dc on device, made once: a call then runs no
    device operation but the kernel's memset and the kernel. Made by a
    blocking copy, complete when it returns, as every cached operand is:
    the launches of other streams (parallel/devices.py's shares) read it
    with no event to wait on."""
    return torch.zeros(3, dtype=torch.int32).to(device)


def worst_case_bits(geom: FrameGeometry) -> int:
    """One image's worst-case scan length in bits."""
    return geom.num_scan_entries * entropy_ops.WORST_CASE_BITS_PER_ENTRY


def _check_kernel_operands(capacity_bytes: int) -> None:
    """Raise on what only the kernel does not take: rows of more words
    than a C int counts."""
    if capacity_bytes // 4 > MAX_NUM_WORDS:
        raise ValueError(
            f"capacity_bytes {capacity_bytes}: the kernel codes rows of at "
            f"most {MAX_NUM_WORDS} 4-byte words"
        )


def _check_operands(z, geom, capacity_bytes, init_dc, luts, epi) -> int:
    """Raise on what neither path takes; -> the number of images."""
    if z.dtype != torch.int16 or z.dim() != 2 or z.shape[1] != 64:
        raise ValueError(
            f"z must be (E, 64) int16, got {z.dtype} {tuple(z.shape)}"
        )
    if z.shape[0] == 0:
        raise ValueError("z has no entries")
    per_image = geom.num_scan_entries
    if z.shape[0] % per_image:
        raise ValueError(
            f"z has {z.shape[0]} entries, not a whole number of the "
            f"geometry's {per_image}"
        )
    images = z.shape[0] // per_image
    if capacity_bytes <= 0 or capacity_bytes % 4:
        raise ValueError(
            "capacity_bytes must be a positive multiple of 4, got "
            f"{capacity_bytes}"
        )
    if not z.is_contiguous() or z.data_ptr() % 4:
        raise ValueError("z must be contiguous and 4-byte aligned")
    if images > 1 and epi is None:
        raise ValueError(
            "a batch needs entries_per_interval (the geometry's "
            "num_scan_entries for one unbroken scan an image)"
        )
    if epi is not None and (epi <= 0 or epi % geom.blocks_per_mcu):
        raise ValueError(
            "entries_per_interval must be a positive multiple of the "
            f"{geom.blocks_per_mcu} blocks of an MCU, got {epi}"
        )
    n_rows = images * -(-per_image // (epi or per_image))
    if init_dc is not None:
        if init_dc.shape == (3,) and n_rows > 1:
            raise ValueError(
                "a (3,) init_dc seeds one unbroken scan; the DC predictors "
                "of restart intervals and of a batch's images start from "
                f"0, or from an ({n_rows}, 3) init_dc, one vector a row"
            )
        if init_dc.shape not in ((3,), (n_rows, 3)) or (
            init_dc.device != z.device
        ):
            raise ValueError(
                f"init_dc must be a (3,) or ({n_rows}, 3) tensor on z's "
                "device"
            )
    if luts is not None:
        for t in luts:
            if t.shape not in ((2, 256), (images, 2, 256)) or (
                t.shape != luts[0].shape or t.device != z.device
            ):
                raise ValueError(
                    "luts must be two (2, 256) tensors, or two "
                    f"({images}, 2, 256) tensors of per-image tables, on "
                    "z's device"
                )
    return images


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
    total_bits int64 scalar), as ops/entropy.encode_entries.

    init_dc: (3,) initial DC predictors (Y, Cb, Cr) of the unbroken scan,
    zeros by default; or (n_rows, 3), row r's chains starting from
    init_dc[r] (a stack of one image's bands, each band a row,
    parallel/tiled.py). luts: (dc, ac) (2, 256) packed `length << 20 |
    code` tables, Annex K by default. live_entries: entries at index >= it
    emit nothing. entries_per_interval (a multiple of the MCU's blocks):
    code each run of that many entries as its own restart interval and
    return (bytes (n_int, capacity_bytes), bits (n_int,)), capacity_bytes
    per interval.

    A batch: z holds B images' entries, B * geom.num_scan_entries rows
    (parallel/batch.py), and needs entries_per_interval; the intervals
    restart at every image, so the result has n_int rows an image, image
    by image, and live_entries counts within each image. luts may then be
    (B, 2, 256) each, one table pair an image.
    """
    epi = entries_per_interval
    images = _check_operands(z, geom, capacity_bytes, init_dc, luts, epi)
    device = z.device
    if device.type == "cpu":
        return entropy_ops.encode_entries(
            z, geom, capacity_bytes, init_dc, luts,
            live_entries=live_entries, entries_per_interval=epi,
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _check_kernel_operands(capacity_bytes)
    if init_dc is None:
        init_dc = _zero_dc(device)
    if luts is None:
        luts = entropy_ops.device_luts(device)
    dc_lut, ac_lut = luts
    lut_stride = 512 if dc_lut.dim() == 3 else 0
    init_stride = 3 if init_dc.dim() == 2 else 0
    init_dc = init_dc.to(torch.int32).contiguous()
    dc_lut = dc_lut.to(torch.int32).contiguous()
    ac_lut = ac_lut.to(torch.int32).contiguous()
    num_entries = z.shape[0]
    per_image = geom.num_scan_entries
    live = per_image if live_entries is None else live_entries
    live = min(max(int(live), 0), per_image)
    epi = epi or per_image
    n_rows = images * -(-per_image // epi)
    num_words = capacity_bytes // 4
    bits = torch.empty(n_rows, dtype=torch.int64, device=device)
    # One buffer, zeroed by the kernel's one memset: the output rows, then
    # (8-byte aligned) a status word per tile and the tile counter.
    out_ints = n_rows * num_words
    tiles = images * -(-per_image // _TILE)
    buffer = torch.empty(out_ints + out_ints % 2 + 2 * tiles + 2,
                         dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        ENTROPY.launch(
            z.data_ptr(), num_entries, per_image, epi, live,
            geom.h_factor * geom.v_factor, init_dc.data_ptr(), init_stride,
            dc_lut.data_ptr(), ac_lut.data_ptr(), lut_stride,
            bits.data_ptr(), buffer.data_ptr(), num_words,
            torch.cuda.current_stream(device).cuda_stream,
        )
    # The kernel stores byte-swapped words: their bytes are the stream.
    data = buffer[:out_ints].view(n_rows, num_words).view(torch.uint8)
    if entries_per_interval is None:
        return data[0], bits[0]
    return data, bits
