"""Run-length + Huffman entropy coding and bit packing (the plain path).

Port of the JAX package's XLA symbolizer and packer
(jpeg_encoder_tpu/ops/entropy.py:53-112, :316-433, :882-919). The
reference walks blocks through three running DC predictors and one
append-only bit vector (entropy_coding.rs:16-124); here every slot of every
block knows on its own what it emits:

1. scan entries: the coefficient blocks gathered into interleaved MCU order
   (scan_layout / marshal_scan_inputs), raw DC in slot 0;
2. DC differences: a shifted subtraction along each component's chain;
3. run lengths: a cummax over the zigzag axis, with a ZRL on the 16th,
   32nd and 48th zero of a run that ends in a nonzero;
4. Huffman codes: a lookup in packed `length << 20 | code` tables;
5. packing: an exclusive cumsum of slot lengths gives each slot's absolute
   bit offset, and a scatter-add writes the MSB-first codes into 32-bit
   words (the bit ranges are disjoint, so add equals or).

Slot layout per entry, as in the fused TPU kernel: slot 0 is the DC, slot
i in 1..63 is zigzag position i's emission (its nonzero coefficient, a ZRL,
or nothing), and the EOB takes slot 63 when that coefficient is zero. A
zero at position 63 emits nothing else (it ends no run), so the EOB there
keeps the reference's emission order.

Bit arithmetic is int64 throughout: torch's uint32 shifts are thin. This
is the CPU path and the spec for the CUDA kernel (kernels/entropy.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from jpeg_encoder_tpu import oracle
from jpeg_encoder_tpu.config import FrameGeometry
from jpeg_encoder_torch import constants

# Upper bound on packed bits per scan entry (one 8x8 block): the DC slot
# <= 11 + 11, 63 AC slots <= 16 + 10, the EOB <= 16; the JAX package's
# round 65 * 27, kept so that both packages size the same buffers.
WORST_CASE_BITS_PER_ENTRY = 65 * 27


def worst_case_capacity_bytes(geom: FrameGeometry) -> int:
    bits = geom.num_scan_entries * WORST_CASE_BITS_PER_ENTRY
    return (bits // 8 + 4) // 4 * 4


# --------------------------------------------------------------------------
# Static scan layout (host-side, cached per geometry)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScanLayout:
    """Static index arrays describing the interleaved scan."""

    luma_order: np.ndarray  # (num_mcus * h*v,) rows into y coeffs
    entry_row: np.ndarray   # (E,) rows into concat(y, cb, cr) coeffs
    num_entries: int


@functools.lru_cache(maxsize=256)
def scan_layout(geom: FrameGeometry) -> ScanLayout:
    """MCU k's entries are [its h*v luma blocks row-major | Cb k | Cr k].

    The luma order is oracle.luma_scan_order's: superblock k of the
    row-major superblock grid; superblocks past the chroma-driven MCU count
    are never emitted (the quirk geometries).
    """
    hv = geom.h_factor * geom.v_factor
    m = geom.num_mcus
    bpm = geom.blocks_per_mcu
    e = np.arange(m * bpm)
    mcu = e // bpm
    slot = e % bpm
    luma_order = oracle.luma_scan_order(geom).reshape(-1).astype(np.int32)
    ny = geom.num_luma_blocks
    entry_row = np.where(
        slot < hv,
        luma_order[np.minimum(mcu * hv + slot, luma_order.size - 1)],
        np.where(slot == hv, ny + mcu, ny + m + mcu),
    ).astype(np.int32)
    return ScanLayout(
        luma_order=luma_order, entry_row=entry_row, num_entries=m * bpm
    )


@functools.lru_cache(maxsize=64)
def _entry_rows(geom: FrameGeometry, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(scan_layout(geom).entry_row.astype(np.int64)).to(
        device
    )


def marshal_scan_inputs(
    y_coeffs: torch.Tensor,
    cb_coeffs: torch.Tensor,
    cr_coeffs: torch.Tensor,
    geom: FrameGeometry,
) -> torch.Tensor:
    """Coefficient arrays [Y, Cb, Cr] (N_i, 64) -> (E, 64) scan entries.

    One row gather in scan order; the dtype and the coefficient order
    (zigzag when the DCT emitted zigzag) are kept, and slot 0 holds each
    block's raw DC.
    """
    allc = torch.cat([y_coeffs, cb_coeffs, cr_coeffs])
    return allc.index_select(0, _entry_rows(geom, allc.device))


# --------------------------------------------------------------------------
# Symbolization
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def device_luts(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The Annex-K (dc, ac) (2, 256) int32 packed tables on device."""
    dc, ac = constants.default_packed_luts()
    return (
        torch.from_numpy(dc.copy()).to(device),
        torch.from_numpy(ac.copy()).to(device),
    )


def bit_length(values: torch.Tensor) -> torch.Tensor:
    """Magnitude category of non-negative integers below 2^24.

    frexp writes v = m * 2^e with m in [0.5, 1), so e is the bit length
    (and 0 for 0); the float32 conversion is exact below 2^24.
    """
    return torch.frexp(values.to(torch.float32))[1].to(values.dtype)


def _seq_diff(seq: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """diff[k] = seq[k] - seq[k-1], with `init` as the predictor of k=0."""
    return seq - torch.cat([init.reshape(1), seq[:-1]])


def dc_differences(
    dc: torch.Tensor, hv: int, init_dc: torch.Tensor | None = None
) -> torch.Tensor:
    """(E,) raw DCs in scan order -> (E,) differences along each
    component's predictor chain (luma, Cb, Cr), seeded from init_dc."""
    d = dc.reshape(-1, hv + 2)
    init = (
        torch.zeros(3, dtype=dc.dtype, device=dc.device) if init_dc is None
        else init_dc.to(device=dc.device, dtype=dc.dtype)
    )
    dy = _seq_diff(d[:, :hv].reshape(-1), init[0])
    dcb = _seq_diff(d[:, hv], init[1])
    dcr = _seq_diff(d[:, hv + 1], init[2])
    return torch.cat(
        [dy.reshape(-1, hv), dcb[:, None], dcr[:, None]], dim=1
    ).reshape(-1)


def symbolize(
    z: torch.Tensor,
    hv: int,
    init_dc: torch.Tensor | None = None,
    luts: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, 64) zigzag scan entries, raw DC in slot 0 -> (slot_bits,
    slot_lens), both (E, 64) int64, in stream order."""
    device = z.device
    z = z.to(torch.int64)
    num_entries = z.shape[0]
    dc_lut, ac_lut = luts if luts is not None else device_luts(device)
    # Rows 0/1: DC luma/chroma; rows 2/3: AC luma/chroma.
    lut4 = torch.cat([dc_lut, ac_lut]).to(torch.int64)
    chroma = (
        torch.arange(num_entries, device=device) % (hv + 2) >= hv
    ).to(torch.int64)[:, None]

    pos = torch.arange(64, device=device)
    nonzero = (z != 0) & (pos > 0)
    marker = torch.where(nonzero, pos, 0)
    cm = torch.cummax(marker, dim=1).values
    run_base = torch.cat([torch.zeros_like(cm[:, :1]), cm[:, :-1]], dim=1)
    last_nz = cm[:, -1:]
    run_dist = pos - run_base  # distance to the previous nonzero (>= 1)

    # Slot 0 codes the DC difference with the same amplitude formulas.
    diff = dc_differences(z[:, 0], hv, init_dc)
    v = torch.cat([diff[:, None], z[:, 1:]], dim=1)
    bl = bit_length(v.abs())
    ampl = torch.where(v < 0, v + (1 << bl) - 1, v) & ((1 << bl) - 1)
    sym = torch.where(pos == 0, bl, (((run_dist - 1) & 15) << 4) | bl)
    row = chroma + torch.where(pos == 0, 0, 2)
    cl = lut4[row, sym.clamp(max=255)]
    coded_bits = ((cl & 0xFFFFF) << bl) | ampl
    coded_len = (cl >> 20) + bl

    zrl = (z == 0) & (pos > 0) & (pos <= last_nz) & (run_dist % 16 == 0)
    eob = (pos == 63) & (z[:, 63:] == 0)
    zrl_cl = lut4[2 + chroma, 0xF0]
    eob_cl = lut4[2 + chroma, 0x00]
    emit = (pos == 0) | nonzero
    zero = torch.zeros_like(cl)
    spec_cl = torch.where(zrl, zrl_cl, torch.where(eob, eob_cl, zero))
    slot_bits = torch.where(emit, coded_bits, spec_cl & 0xFFFFF)
    slot_lens = torch.where(emit, coded_len, spec_cl >> 20)
    return slot_bits, slot_lens


# --------------------------------------------------------------------------
# Packing
# --------------------------------------------------------------------------

def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """u32 word values (any integer dtype) -> big-endian uint8 stream."""
    shifts = torch.tensor([24, 16, 8, 0], device=words.device)
    w = words.to(torch.int64)[:, None]
    return ((w >> shifts) & 0xFF).to(torch.uint8).reshape(-1)


def pack_bits(
    slot_bits: torch.Tensor, slot_lens: torch.Tensor, capacity_bytes: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter-add of MSB-first slot codes at their exclusive-cumsum offsets.

    Returns (bytes (capacity_bytes,) uint8, total_bits int32 scalar). Words
    at or past capacity_bytes / 4 are dropped; total_bits is still the true
    length, which is how callers detect an overflow.
    """
    bits = slot_bits.reshape(-1)
    lens = slot_lens.reshape(-1)
    offsets = torch.cumsum(lens, 0) - lens
    total_bits = (offsets[-1] + lens[-1]).to(torch.int32)
    word = offsets >> 5
    end = (offsets & 31) + lens  # in [0, 58]
    spill = end > 32
    hi = torch.where(spill, bits >> (end - 32).clamp(min=0),
                     bits << (32 - end).clamp(min=0))
    lo = (bits << torch.where(spill, 64 - end, 0)) & 0xFFFFFFFF
    lo = torch.where(spill, lo, 0)
    num_words = capacity_bytes // 4
    words = torch.zeros(num_words + 1, dtype=torch.int64, device=bits.device)
    trash = torch.full_like(word, num_words)
    words.index_add_(0, torch.where(word < num_words, word, trash), hi)
    words.index_add_(
        0, torch.where(spill & (word + 1 < num_words), word + 1, trash), lo
    )
    return words_to_bytes(words[:num_words]), total_bits


def encode_entries(
    z: torch.Tensor,
    geom: FrameGeometry,
    capacity_bytes: int,
    init_dc: torch.Tensor | None = None,
    luts: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, 64) scan entries -> (bytes (capacity_bytes,), total_bits).

    The plain version of the entropy kernel: same operands, same result.
    """
    if capacity_bytes % 4:
        raise ValueError(
            f"capacity_bytes must be a multiple of 4, got {capacity_bytes}"
        )
    hv = geom.h_factor * geom.v_factor
    slot_bits, slot_lens = symbolize(z, hv, init_dc, luts)
    return pack_bits(slot_bits, slot_lens, capacity_bytes)


def coefficient_ranges(
    z: torch.Tensor, geom: FrameGeometry, init_dc: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(max |DC difference|, max |AC coefficient|) over the scan entries.

    The reference panics past an 11-bit DC difference or a 10-bit AC
    coefficient (entropy_coding.rs:153-155,188-191); the pipeline checks
    these on the host (pipeline.validate_scan_ranges).
    """
    hv = geom.h_factor * geom.v_factor
    zl = z.to(torch.int64)
    max_dc = dc_differences(zl[:, 0], hv, init_dc).abs().max()
    max_ac = zl[:, 1:].abs().max()
    return max_dc, max_ac
