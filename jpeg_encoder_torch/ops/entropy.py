"""Run-length + Huffman entropy coding and bit packing (the plain path).

Port of the JAX package's XLA symbolizer, packers and statistics pass
(jpeg_encoder_tpu/ops/entropy.py:309-549, :759-919). The reference walks
blocks through three running DC predictors and one append-only bit vector
(entropy_coding.rs:16-124); here every slot of every block knows on its
own what it emits:

1. scan entries: the coefficient blocks in interleaved MCU order
   (scan_layout; gathered by marshal_scan_inputs, or stored there by the
   DCT kernels through block_entries), raw DC in slot 0;
2. DC differences: each entry minus the previous entry of its component,
   found at a static scan distance, with the predictor reset to 0 at every
   restart interval's first entry;
3. run lengths: a cummax over the zigzag axis, with a ZRL on the 16th,
   32nd and 48th zero of a run that ends in a nonzero;
4. Huffman codes: a lookup in packed `length << 20 | code` tables;
5. packing: an exclusive cumsum of slot lengths gives each slot's bit
   offset in its interval, and a scatter-add writes the MSB-first codes
   into 32-bit words (the bit ranges are disjoint, so add equals or).

Slot layout per entry, as in the fused TPU kernel: slot 0 is the DC, slot
i in 1..63 is zigzag position i's emission (its nonzero coefficient, a ZRL,
or nothing), and the EOB takes slot 63 when that coefficient is zero. A
zero at position 63 emits nothing else (it ends no run), so the EOB there
keeps the reference's emission order.

A restart-framed scan (T.81 E.2.4) is the same entry stream cut every
`entries_per_interval` entries (a whole number of MCUs): each interval
packs into its own row from bit 0, and its DC predictors start at 0.
`live_entries` makes the entries at index >= live_entries emit nothing.

A batch (parallel/batch.py) is B images' entry streams one after another:
`entries_per_image` (E) entries each, the intervals restarting at every
image (an image's unbroken scan is one interval of E), one row per image
and interval, live_entries counting within each image, and optionally one
table pair per image.

Bit arithmetic is int64 throughout: torch's uint32 shifts are thin. This
is the CPU path and the spec for the CUDA kernels (kernels/entropy.py,
kernels/pack.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from jpeg_encoder_torch import constants, graphs, oracle
from jpeg_encoder_torch.config import FrameGeometry

# Upper bound on packed bits per scan entry (one 8x8 block): the DC slot
# <= 11 + 11, 63 AC slots <= 16 + 10, the EOB <= 16; the JAX package's
# round 65 * 27, kept so that both packages size the same buffers.
WORST_CASE_BITS_PER_ENTRY = 65 * 27

# Words of one entry's private buffer in the assemble tier (pack_level1):
# 1755 bits span words 0..54, plus one spill word.
ENTRY_WORDS = 56

_TRASH = 1024  # symbol id of a slot that emits nothing
_CHUNK_ENTRIES = 1 << 16  # entries of one chunk of the element-wise work


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


def _batch_entry_rows(geom: FrameGeometry, batch: int) -> np.ndarray:
    """(B * E,) int64 rows into [all Y | all Cb | all Cr] of `batch`
    images' blocks, image by image: image b's luma rows move by b * ny, its
    Cb rows by (B - 1) * ny + b * nc and its Cr rows by (B - 1) * (ny + nc)
    + b * nc from one image's entry_row."""
    row = scan_layout(geom).entry_row.astype(np.int64)
    ny, nc = geom.num_luma_blocks, geom.num_chroma_blocks
    hv = geom.h_factor * geom.v_factor
    slot = np.arange(row.size) % geom.blocks_per_mcu
    b = np.arange(batch)[:, None]
    shift = np.where(
        slot < hv, b * ny,
        np.where(slot == hv, (batch - 1) * ny + b * nc,
                 (batch - 1) * (ny + nc) + b * nc),
    )
    return (row + shift).reshape(-1)


@graphs.operand_cache(maxsize=64)
def _entry_rows(
    geom: FrameGeometry, batch: int, device: torch.device
) -> torch.Tensor:
    """_batch_entry_rows on device: the marshal's gather indices."""
    return torch.from_numpy(_batch_entry_rows(geom, batch)).to(device)


@graphs.operand_cache(maxsize=64)
def block_entries(
    geom: FrameGeometry, batch: int, device: torch.device
) -> torch.Tensor:
    """The inverse of _entry_rows: (B * (ny + 2 nc),) int32 over [all Y |
    all Cb | all Cr] of `batch` stacked images' blocks, each block's index
    in the B images' (B * E, 64) scan entries, or -1 for a block that no
    entry takes (the quirk geometries' luma superblocks past the
    chroma-driven MCU count, which oracle.luma_scan_order never emits).
    Every entry is named exactly once. The DCT kernels store through it
    (kernels/dct.scan_entries); inside graphs.pinned() a capture keeps the
    very table its warm-up got."""
    rows = _batch_entry_rows(geom, batch)
    table = np.full(
        batch * (geom.num_luma_blocks + 2 * geom.num_chroma_blocks), -1,
        np.int32)
    table[rows] = np.arange(rows.size, dtype=np.int32)
    return torch.from_numpy(table).to(device)


def scatter_entries(
    coeffs: torch.Tensor, geom: FrameGeometry, batch: int
) -> torch.Tensor:
    """(B * (ny + 2 nc), 64) coefficients [all Y | all Cb | all Cr] of B
    stacked images -> their (B * E, 64) scan entries, each row written to
    its entry by block_entries (the plain version of the DCT kernels'
    indexed store); equal to marshal_scan_inputs of the three parts."""
    table = block_entries(geom, batch, coeffs.device)
    kept = table >= 0
    out = coeffs.new_empty((batch * geom.num_scan_entries, 64))
    return out.index_copy_(0, table[kept].to(torch.int64), coeffs[kept])


def _rows_of_one_tensor(y_coeffs, cb_coeffs, cr_coeffs) -> torch.Tensor | None:
    """The (N, 64) tensor whose consecutive row views the three arrays are
    (as the plane DCT kernels return them, kernels/dct.py), else None."""
    parts = (y_coeffs, cb_coeffs, cr_coeffs)
    storage = y_coeffs.untyped_storage().data_ptr()
    if not all(t.is_contiguous() and t.dim() == 2 and t.dtype == y_coeffs.dtype
               and t.untyped_storage().data_ptr() == storage for t in parts):
        return None
    if (cb_coeffs.data_ptr() != y_coeffs.data_ptr() + y_coeffs.nbytes
            or cr_coeffs.data_ptr() != cb_coeffs.data_ptr() + cb_coeffs.nbytes):
        return None
    rows = sum(t.shape[0] for t in parts)
    return y_coeffs.as_strided((rows, y_coeffs.shape[1]),
                               (y_coeffs.shape[1], 1))


def marshal_scan_inputs(
    y_coeffs: torch.Tensor,
    cb_coeffs: torch.Tensor,
    cr_coeffs: torch.Tensor,
    geom: FrameGeometry,
) -> torch.Tensor:
    """Coefficient arrays [Y, Cb, Cr] (N_i, 64) -> (E, 64) scan entries.

    One row gather in scan order; the dtype and the coefficient order
    (zigzag when the DCT emitted zigzag) are kept, and slot 0 holds each
    block's raw DC. The arrays may hold B images' blocks, image by image
    (B * ny luma rows, B * nc of each chroma): the result is then the B
    images' (E, 64) entries one after another. Arrays that are consecutive
    row views of one tensor (the plane DCT kernels' output) are gathered
    from it, without a copy into one first.

    The main path does not run it for RealDCT and binDCT: there the DCT
    kernels store their rows straight into the entries
    (kernels/dct.scan_entries). It is their spec, and the route of
    --fast-dct and of the callers that keep the per-plane coefficients.
    """
    batch, rest = divmod(y_coeffs.shape[0], geom.num_luma_blocks)
    if rest or cb_coeffs.shape[0] != batch * geom.num_chroma_blocks:
        raise ValueError(
            f"coefficients of {y_coeffs.shape[0]} luma and "
            f"{cb_coeffs.shape[0]} chroma blocks are not whole images of "
            f"{geom.width}x{geom.height}"
        )
    allc = _rows_of_one_tensor(y_coeffs, cb_coeffs, cr_coeffs)
    if allc is None:
        allc = torch.cat([y_coeffs, cb_coeffs, cr_coeffs])
    return allc.index_select(0, _entry_rows(geom, batch, allc.device))


def final_dc(
    y_coeffs: torch.Tensor,
    cb_coeffs: torch.Tensor,
    cr_coeffs: torch.Tensor,
    geom: FrameGeometry,
) -> torch.Tensor:
    """(B, 3) int32: the last DC value of each component chain (Y, Cb, Cr)
    in scan order, of each of B stacked images.

    The arrays are marshal_scan_inputs' (B * ny luma rows, B * nc of each
    chroma, image by image; DC in column 0, zigzag or natural order). B
    bands of one image (parallel/tiled.py) give each band's final DCs,
    the predictors the next band's chains start from
    (jpeg_encoder_tpu.ops.entropy.final_dc, with a leading band axis).
    """
    ny, nc = geom.num_luma_blocks, geom.num_chroma_blocks
    band = torch.arange(y_coeffs.shape[0] // ny, device=y_coeffs.device)
    last_luma = int(scan_layout(geom).luma_order[-1])
    return torch.stack([
        y_coeffs[band * ny + last_luma, 0],
        cb_coeffs[(band + 1) * nc - 1, 0],
        cr_coeffs[(band + 1) * nc - 1, 0],
    ], dim=1).to(torch.int32)


def final_dc_of_entries(z: torch.Tensor, geom: FrameGeometry) -> torch.Tensor:
    """final_dc read from B stacked images' (B * E, 64) scan entries: each
    image's last MCU ends in its last Y, Cb and Cr entries, whose slot 0 is
    the raw DC of each chain's last block."""
    return z.reshape(-1, geom.num_scan_entries, 64)[:, -3:, 0].to(torch.int32)


def interval_rows(
    num_entries: int,
    entries_per_image: int | None,
    entries_per_interval: int | None,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The framing of B images' entries into rows: ((N,) index of each
    entry's interval's first entry, (N,) each entry's row, (n_rows,) each
    row's first entry). Image e // E, interval (e % E) // epi of it; by
    default one image of every entry and one interval an image."""
    per_image = entries_per_image or num_entries
    epi = entries_per_interval or per_image
    n_int = -(-per_image // epi)
    e = torch.arange(num_entries, device=device)
    image, local = e // per_image, e % per_image
    starts = (
        torch.arange(num_entries // per_image, device=device)[:, None]
        * per_image + torch.arange(n_int, device=device) * epi
    ).reshape(-1)
    return (image * per_image + local // epi * epi,
            image * n_int + local // epi, starts)


def entries_per_interval(geom: FrameGeometry, restart_mcus: int) -> int:
    """Scan entries of one restart interval, clamped to the image: a
    restart interval past the MCU count gives one interval (and no RSTn
    markers), never a padded one."""
    return min(restart_mcus, geom.num_mcus) * geom.blocks_per_mcu


# --------------------------------------------------------------------------
# Symbolization
# --------------------------------------------------------------------------

@graphs.operand_cache(maxsize=8)
def device_luts(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The Annex-K (dc, ac) (2, 256) int32 packed tables on device."""
    dc, ac = constants.default_packed_luts()
    return (
        torch.from_numpy(dc.copy()).to(device),
        torch.from_numpy(ac.copy()).to(device),
    )


def pack_lut(spec) -> np.ndarray:
    """One tables.HuffmanSpec -> 256-entry `length << 20 | code` LUT row."""
    return (spec.length_lut.astype(np.int32) << 20) | (
        spec.code_lut.astype(np.int32)
    )


def bit_length(values: torch.Tensor) -> torch.Tensor:
    """Magnitude category of non-negative integers below 2^24.

    frexp writes v = m * 2^e with m in [0.5, 1), so e is the bit length
    (and 0 for 0); the float32 conversion is exact below 2^24.
    """
    return torch.frexp(values.to(torch.float32))[1].to(values.dtype)


def dc_differences(
    dc: torch.Tensor,
    hv: int,
    init_dc: torch.Tensor | None = None,
    entries_per_interval: int | None = None,
    entries_per_image: int | None = None,
) -> torch.Tensor:
    """(E,) raw DCs in scan order -> (E,) differences along each
    component's predictor chain (luma, Cb, Cr).

    The previous DC of a component lies at a static distance: 1 for a
    luma block after another of its MCU, bpm - hv + 1 for an MCU's first
    luma block, bpm for chroma. A chain's first entry in its interval
    (the whole scan by default) takes init_dc's predictor; with several
    intervals that is 0, the reset T.81 E.2.4 defines at every restart
    marker (jpeg_encoder_tpu.ops.entropy.interval_dc_diffs, vmapped over
    the intervals), and at every image of a batch. init_dc is (3,), or
    (n_rows, 3) with one vector a row (interval_rows' rows): the band path
    (parallel/tiled.py) seeds each band's row from the band before it.
    """
    num_entries = dc.shape[0]
    bpm = hv + 2
    first, row, _ = interval_rows(num_entries, entries_per_image,
                                  entries_per_interval, dc.device)
    e = torch.arange(num_entries, device=dc.device)
    pos = e % bpm
    component = torch.clamp(pos - hv + 1, min=0)  # 0 luma, 1 Cb, 2 Cr
    dist = torch.where(
        pos >= hv, bpm, torch.where(pos == 0, bpm - hv + 1, 1)
    )
    prev = e - dist
    init = (
        torch.zeros((1, 3), dtype=dc.dtype, device=dc.device)
        if init_dc is None
        else init_dc.to(device=dc.device, dtype=dc.dtype).reshape(-1, 3)
    )
    row = row if init.shape[0] > 1 else torch.zeros_like(row)
    pred = torch.where(
        prev >= first, dc[prev.clamp(min=0)], init[row, component]
    )
    return dc - pred


def slot_symbols(
    z: torch.Tensor,
    hv: int,
    init_dc: torch.Tensor | None = None,
    live_entries: int | None = None,
    entries_per_interval: int | None = None,
    entries_per_image: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(E, 64) zigzag scan entries, raw DC in slot 0 -> (ids, ampl, abl),
    each (E, 64) int64, in stream order.

    ids indexes the 1024 symbols of [DC luma | DC chroma | AC luma | AC
    chroma] (256 each); a slot that emits nothing (and every slot of a
    dead entry) has id 1024. ampl/abl are the amplitude bits appended
    after the code and their count (0 for ZRL and EOB).
    """
    parts = list(_slot_symbol_chunks(z, hv, init_dc, live_entries,
                                     entries_per_interval, entries_per_image))
    return tuple(torch.cat(p) for p in zip(*parts))


def _chunks(num_entries: int) -> range:
    """First entries of the plain coder's chunks: its element-wise work
    runs _CHUNK_ENTRIES entries at a time, which bounds the (chunk, 64)
    int64 temporaries on a large image."""
    return range(0, num_entries, _CHUNK_ENTRIES)


def _slot_symbol_chunks(z, hv, init_dc, live_entries, entries_per_interval,
                        entries_per_image):
    """slot_symbols' (ids, ampl, abl), chunk by chunk (_chunks). The DC
    differences, the one dependence between entries, are taken first over
    the whole scan."""
    device = z.device
    num_entries = z.shape[0]
    diff = dc_differences(z[:, 0].to(torch.int64), hv, init_dc,
                          entries_per_interval, entries_per_image)
    e = torch.arange(num_entries, device=device)
    chroma = (e % (hv + 2) >= hv).to(torch.int64)[:, None]
    live = None
    if live_entries is not None:
        live = e % (entries_per_image or num_entries) < live_entries
    pos = torch.arange(64, device=device)
    for s in _chunks(num_entries):
        t = s + _CHUNK_ENTRIES
        yield _entry_symbols(z[s:t].to(torch.int64), diff[s:t], chroma[s:t],
                             None if live is None else live[s:t], pos)


def _entry_symbols(z, diff, chroma, live, pos):
    """(n, 64) int64 entries with their (n,) DC differences, (n, 1)
    chroma flags and (n,) live flags (None: all live) -> (ids, ampl,
    abl), as slot_symbols."""
    nonzero = (z != 0) & (pos > 0)
    marker = torch.where(nonzero, pos, 0)
    cm = torch.cummax(marker, dim=1).values
    run_base = torch.cat([torch.zeros_like(cm[:, :1]), cm[:, :-1]], dim=1)
    last_nz = cm[:, -1:]
    run_dist = pos - run_base  # distance to the previous nonzero (>= 1)

    # Slot 0 codes the DC difference with the same amplitude formulas.
    v = torch.cat([diff[:, None], z[:, 1:]], dim=1)
    bl = bit_length(v.abs())
    ampl = torch.where(v < 0, v + (1 << bl) - 1, v) & ((1 << bl) - 1)
    sym = torch.where(pos == 0, bl, (((run_dist - 1) & 15) << 4) | bl)
    emit = (pos == 0) | nonzero
    zrl = (z == 0) & (pos > 0) & (pos <= last_nz) & (run_dist % 16 == 0)
    eob = (pos == 63) & (z[:, 63:] == 0)
    ac_base = (2 + chroma) * 256
    ids = torch.where(
        emit,
        torch.where(pos == 0, chroma * 256, ac_base) + sym.clamp(max=255),
        torch.where(zrl, ac_base + 0xF0,
                    torch.where(eob, ac_base, _TRASH)),
    )
    abl = torch.where(emit, bl, 0)
    if live is not None:
        ids = torch.where(live[:, None], ids, _TRASH)
        abl = torch.where(live[:, None], abl, 0)
    return ids, torch.where(abl > 0, ampl, 0), abl


def symbolize(
    z: torch.Tensor,
    hv: int,
    init_dc: torch.Tensor | None = None,
    luts: tuple[torch.Tensor, torch.Tensor] | None = None,
    live_entries: int | None = None,
    entries_per_interval: int | None = None,
    entries_per_image: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, 64) zigzag scan entries, raw DC in slot 0 -> (slot_bits,
    slot_lens), both (E, 64) int64, in stream order. luts: (dc, ac), each
    (2, 256), or (B, 2, 256) with one table pair per image."""
    dc_lut, ac_lut = luts if luts is not None else device_luts(z.device)
    # One row of 1024 codes (and a silent 1025th) per table pair.
    lut = torch.cat(
        [dc_lut.reshape(-1, 512), ac_lut.reshape(-1, 512),
         torch.zeros_like(dc_lut.reshape(-1, 512)[:, :1])], dim=1,
    ).to(torch.int64).reshape(-1)
    per_image = entries_per_image or z.shape[0]
    slot_bits, slot_lens = [], []
    chunks = _slot_symbol_chunks(z, hv, init_dc, live_entries,
                                 entries_per_interval, entries_per_image)
    for s, (ids, ampl, abl) in zip(_chunks(z.shape[0]), chunks):
        if lut.shape[0] > _TRASH + 1:  # one table pair an image
            image = torch.arange(s, s + ids.shape[0], device=z.device)
            ids = ids + (image // per_image * (_TRASH + 1))[:, None]
        cl = lut[ids]
        slot_bits.append(((cl & 0xFFFFF) << abl) | ampl)
        slot_lens.append((cl >> 20) + abl)
    return torch.cat(slot_bits), torch.cat(slot_lens)


def symbol_histograms(
    z: torch.Tensor,
    geom: FrameGeometry,
    restart_mcus: int | None = None,
    init_dc: torch.Tensor | None = None,
    live_entries: int | None = None,
) -> torch.Tensor:
    """Huffman symbol counts of the scan: (4, 256) int64, rows Y-DC, C-DC,
    Y-AC, C-AC (jpeg_encoder_tpu.ops.entropy.symbol_histograms); for the
    entries of B > 1 images (a batch), (B, 4, 256), one an image.

    The statistics pass of the optimized-Huffman encode. restart_mcus must
    be the encode pass's: interval DC resets change the DC categories, and
    a category the tables do not cover has no code (a corrupt stream).
    init_dc is dc_differences': (3,), or one (3,) vector a row of
    restart_mcus MCUs (a band stack's rows, parallel/tiled.py).
    One index_add_ of ones over the slots' symbol ids, offset by 1025 per
    image, into batch * 1025 bins; silent slots and dead entries land in
    each image's 1025th bin, which is dropped. (torch.bincount would read
    the largest id back to size its output: a sync, which capture into a
    CUDA graph refuses.)
    """
    per_image = geom.num_scan_entries
    batch = z.shape[0] // per_image
    epi = (None if restart_mcus is None
           else entries_per_interval(geom, restart_mcus))
    ids, _, _ = slot_symbols(
        z, geom.h_factor * geom.v_factor, init_dc, live_entries, epi,
        per_image,
    )
    image = torch.arange(z.shape[0], device=z.device) // per_image
    ids = ids + (image * (_TRASH + 1))[:, None]
    ids = ids.reshape(-1)
    hist = torch.zeros(batch * (_TRASH + 1), dtype=torch.int64,
                       device=z.device).index_add_(
        0, ids, torch.ones((1,), dtype=torch.int64,
                           device=z.device).expand(ids.shape[0]))
    hist = hist.reshape(batch, _TRASH + 1)[:, :_TRASH].reshape(batch, 4, 256)
    return hist[0] if batch == 1 else hist


# --------------------------------------------------------------------------
# Packing
# --------------------------------------------------------------------------

@graphs.operand_cache(maxsize=8)
def _byte_shifts(device: torch.device) -> torch.Tensor:
    """A word's four byte shifts, most significant first, on device."""
    return torch.tensor([24, 16, 8, 0]).to(device)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """u32 word values (any integer dtype) along the last axis -> the
    big-endian uint8 stream, one row per leading index."""
    w = words.to(torch.int64)[..., None]
    return ((w >> _byte_shifts(words.device)) & 0xFF).to(torch.uint8).reshape(
        *words.shape[:-1], -1
    )


def as_u32_int32(values: torch.Tensor) -> torch.Tensor:
    """int64 u32 values in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(values >= 1 << 31, values - (1 << 32), values).to(
        torch.int32
    )


def _split_slot_words(
    bits: torch.Tensor, lens: torch.Tensor, offsets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """MSB-first alignment of each code at its bit offset: (word, hi,
    spill, lo); hi goes to `word`, lo to word + 1 where spill."""
    word = offsets >> 5
    end = (offsets & 31) + lens  # in [0, 63]
    spill = end > 32
    hi = torch.where(spill, bits >> (end - 32).clamp(min=0),
                     bits << (32 - end).clamp(min=0))
    lo = (bits << torch.where(spill, 64 - end, 0)) & 0xFFFFFFFF
    return word, hi, spill, torch.where(spill, lo, 0)


def pack_bits(
    slot_bits: torch.Tensor,
    slot_lens: torch.Tensor,
    capacity_bytes: int,
    entries_per_interval: int | None = None,
    entries_per_image: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter-add of MSB-first slot codes at their exclusive-cumsum
    offsets, one row per interval of entries_per_interval entries (the
    last of each image may be short; interval_rows), chunk by chunk of
    entries (_chunks).

    Returns (bytes (n_rows, capacity_bytes) uint8, bits (n_rows,) int64).
    Words at or past capacity_bytes / 4 of a row are dropped, never
    spilled into the next row; bits is still each row's true length,
    which is how callers detect an overflow.
    """
    num_entries, slots = slot_lens.shape
    device = slot_lens.device
    _, entry_row, starts = interval_rows(
        num_entries, entries_per_image, entries_per_interval, device
    )
    n_int = starts.shape[0]
    entry_bits = slot_lens.sum(dim=1)
    entry_end = torch.cumsum(entry_bits, 0)
    start = (entry_end - entry_bits)[starts]  # each row's first bit
    interval_bits = torch.cat([start[1:], entry_end[-1:]]) - start
    # Each entry's first bit within its row.
    entry_offset = entry_end - entry_bits - start[entry_row]
    num_words = capacity_bytes // 4
    trash = n_int * num_words
    words = torch.zeros(trash + 1, dtype=torch.int64, device=device)
    for s in _chunks(num_entries):
        t = s + _CHUNK_ENTRIES
        lens = slot_lens[s:t]
        offsets = torch.cumsum(lens, 1) - lens + entry_offset[s:t, None]
        word, hi, spill, lo = _split_slot_words(
            slot_bits[s:t].reshape(-1), lens.reshape(-1), offsets.reshape(-1)
        )
        row = (entry_row[s:t] * num_words).repeat_interleave(slots)
        words.index_add_(0, torch.where(word < num_words, row + word, trash),
                         hi)
        words.index_add_(
            0,
            torch.where(spill & (word + 1 < num_words), row + word + 1, trash),
            lo,
        )
    return (
        words_to_bytes(words[:trash].reshape(n_int, num_words)),
        interval_bits,
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
    """(E, 64) scan entries -> (bytes (capacity_bytes,), total_bits), or,
    with entries_per_interval, (bytes (n_int, capacity_bytes), bits
    (n_int,)) with one independently coded row per restart interval; for
    the entries of B images (B * geom.num_scan_entries rows), n_int rows
    an image, image by image.

    The plain version of the entropy kernel: same operands, same result.
    """
    if capacity_bytes % 4:
        raise ValueError(
            f"capacity_bytes must be a multiple of 4, got {capacity_bytes}"
        )
    hv = geom.h_factor * geom.v_factor
    per_image = geom.num_scan_entries
    slot_bits, slot_lens = symbolize(
        z, hv, init_dc, luts, live_entries, entries_per_interval, per_image
    )
    data, bits = pack_bits(
        slot_bits, slot_lens, capacity_bytes, entries_per_interval, per_image
    )
    if entries_per_interval is None:
        return data[0], bits[0]
    return data, bits


def pack_level1(
    slot_bits: torch.Tensor, slot_lens: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, S) slot codes -> ((E, ENTRY_WORDS) int32 words holding u32
    bits, (E,) int64 bit counts): every entry's slots packed MSB-first
    into a private buffer from bit 0 (jpeg_encoder_tpu.ops.entropy.
    _pack_level1). Words past ENTRY_WORDS are dropped, as there: only
    coefficients beyond the scan's 10-bit range can reach them."""
    num_entries = slot_lens.shape[0]
    ends = torch.cumsum(slot_lens, dim=1)
    word, hi, spill, lo = _split_slot_words(slot_bits, slot_lens,
                                            ends - slot_lens)
    width = ENTRY_WORDS + 1  # the last column is trash
    base = torch.arange(num_entries, device=slot_lens.device)[:, None] * width
    trash = base + ENTRY_WORDS
    words = torch.zeros(num_entries * width, dtype=torch.int64,
                        device=slot_lens.device)
    words.index_add_(
        0, torch.where(word < ENTRY_WORDS, base + word, trash).reshape(-1),
        hi.reshape(-1),
    )
    words.index_add_(
        0,
        torch.where(spill & (word + 1 < ENTRY_WORDS), base + word + 1,
                    trash).reshape(-1),
        lo.reshape(-1),
    )
    words = words.reshape(num_entries, width)[:, :ENTRY_WORDS]
    return as_u32_int32(words), ends[:, -1]


def assemble_bitstream(
    entry_words: torch.Tensor, offsets: torch.Tensor, capacity_bytes: int
) -> torch.Tensor:
    """OR every entry's words into its row's stream at its bit offset.

    entry_words: (B, E, EW) int32 holding u32 words (pack_level1's);
    offsets: (B, E) int64 bit offsets within each row; the leading axis is
    the restart intervals. Returns (B, capacity_bytes // 4) int32 words.
    The plain version of the pack kernel (kernels/pack.py). Entry e's word
    k lands at bit offsets[e] + 32 k; words at or past the row's capacity
    are dropped (the TPU kernel clamps such entries onto the buffer's tail
    instead: the two differ only on an overflow, whose payload the caller
    discards). The entries' bit ranges are disjoint, as offsets from an
    exclusive cumsum of their bit counts are, so the add below is the OR.
    """
    rows, num_entries, ew = entry_words.shape
    device = entry_words.device
    num_words = capacity_bytes // 4
    w = entry_words.to(torch.int64) & 0xFFFFFFFF
    off = offsets.to(torch.int64)[..., None]
    s = off & 31
    word = (off >> 5) + torch.arange(ew, device=device)
    hi = w >> s
    lo = torch.where(s > 0, (w << (32 - s)) & 0xFFFFFFFF, 0)
    row = torch.arange(rows, device=device)[:, None, None] * num_words
    trash = rows * num_words
    out = torch.zeros(trash + 1, dtype=torch.int64, device=device)
    out.index_add_(
        0, torch.where(word < num_words, row + word, trash).reshape(-1),
        hi.reshape(-1),
    )
    out.index_add_(
        0, torch.where(word + 1 < num_words, row + word + 1, trash).reshape(-1),
        lo.reshape(-1),
    )
    return as_u32_int32(out[:trash].reshape(rows, num_words))


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
