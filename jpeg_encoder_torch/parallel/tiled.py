"""Band-tiled single-image encode: MCU-row bands, DC predictors chained.

Port of jpeg_encoder_tpu/parallel/tiled.py to one card. The JAX package
splits one image into contiguous MCU-row bands, one per device of a mesh,
and passes each band's final DC predictors to its successor with one
ppermute. Here `bands` takes the mesh's place (the mesh size is the band
count), and the bands are the leading dimension of one launch of each
kernel:

* the band front: the image, zero-padded to bands * band_h rows, goes
  through pipeline.scan_entries as a (bands, band_h, W, 3) stack, as the
  batch path stacks images, with the rows at or past the image height
  zeroed in the Y, Cb and Cr planes (the reference's padding is 0 there,
  not in RGB, where zero pixels convert to Cb = Cr = 128). The stack's
  entries, band after band, are those of one image of bands * band_h rows
  (the stack geometry);
* the unbroken scan: K4 codes the stack in one launch as rows of one
  band's entries, row r seeded with band r - 1's final DCs
  (ops/entropy.final_dc over the stack, on the device) and row 0 with
  zeros; the image's live entry count makes the padding bands' entries
  emit nothing (dead entries are always a suffix of the stack). The host
  splices the rows at bit level (utils/bits.py);
* restart markers: every non-final band holds whole intervals (the band
  size is re-chosen when the even split puts an interval across a band
  boundary, _aligned_band_rows), so K4 codes every interval of the stack
  into its own row with its predictors reset, and the host joins the
  bands' live intervals with RSTn markers: no DC exchange, no splice;
* optimize: one table set from the statistics of all bands, one
  symbol_histograms over the stack with the same per-row predictors (the
  JAX package's psum of per-band histograms), then the encode above with
  those tables;
* overflow: a band whose payload (or any of its intervals) overflowed the
  shared per-band capacity is re-coded alone from its live entries (the
  front does not run again) up the capacity ladder, with its own
  predictors; the other bands keep their rows.

Files are byte-identical to pipeline.encode_array's. As there, the quirk
geometries (dim % (8 * factor) == 1) and a restart interval that admits no
band split fall back to encode_array with a RuntimeWarning. Like the JAX
package's band path (and the batch path), this one does not check
config.validate. On one card the bands buy nothing but the splice: the
module is the single-card form of the JAX package's multi-device encode.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.config import EncoderConfig, FrameGeometry
from jpeg_encoder_torch.io import jfif
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops
from jpeg_encoder_torch.parallel import batch
from jpeg_encoder_torch.utils.bits import splice_bitstreams


def tileable(geom: FrameGeometry) -> bool:
    """Band-local encoding requires aligned luma/chroma grids.

    dim % (8*factor) == 1 images hit the reference's global chroma/luma
    grid misalignment (oracle.subsample_plane), which band-local encoding
    cannot reproduce: encode_tiled falls back to encode_array for them.
    """
    return geom.mcu_grid_aligned


def _band_rows(geom: FrameGeometry, bands: int) -> int:
    """MCU rows per band: ceil so `bands` equal bands cover the image."""
    return -(-geom.mcu_rows // bands)


def _aligned_band_rows(
    geom: FrameGeometry, bands: int, restart: int
) -> int | None:
    """Smallest restart-aligned band size that still splits the image.

    Every NON-final band must hold a whole number of intervals (an
    interval must not straddle a band boundary); the final band may end
    mid-interval. The search runs upward from the even split and stops at
    twice it (past that most bands are dead padding and one encode is the
    cheaper program). None when no aligned split exists within the bound
    (or only the degenerate single-live-band one does).
    """
    base = _band_rows(geom, bands)
    for rows in range(base, min(2 * base + 1, geom.mcu_rows)):
        if (rows * geom.mcu_cols) % restart == 0:
            return rows
    return None


def _live_mcu_rows(geom: FrameGeometry, band_rows: int, idx: int) -> int:
    """MCU rows of band idx that lie in the image."""
    return max(0, min(geom.mcu_rows - idx * band_rows, band_rows))


def _band_geometry(geom: FrameGeometry, band_h: int) -> FrameGeometry:
    """Geometry of one full-width band of band_h pixel rows (a multiple of
    the MCU height)."""
    band = FrameGeometry(
        width=geom.width,
        height=band_h,
        h_factor=geom.h_factor,
        v_factor=geom.v_factor,
    )
    assert band.padded_height == band_h
    return band


def _band_entries(geom: FrameGeometry, band_rows: int) -> int:
    """Scan entries of a band of band_rows MCU rows."""
    return band_rows * geom.mcu_cols * geom.blocks_per_mcu


def _split_rows(geom: FrameGeometry, bands: int,
                restart: int | None) -> int | None:
    """MCU rows per band for this encode; None when a restart interval
    admits no band split (the caller falls back to one encode)."""
    band_rows = _band_rows(geom, bands)
    live_bands = -(-geom.mcu_rows // band_rows)
    if restart is None or live_bands == 1 or (
        (band_rows * geom.mcu_cols) % restart == 0
    ):
        return band_rows
    # The even split puts an interval across a band boundary; the band
    # size is ours to choose.
    aligned = _aligned_band_rows(geom, bands, restart)
    if aligned is not None and -(-geom.mcu_rows // aligned) > 1:
        return aligned
    return None


def encode_tiled(
    rgb: np.ndarray,
    config: EncoderConfig,
    bands: int,
    *,
    device: str | torch.device = "cuda",
) -> pipeline.EncodeResult:
    """Encode one (H, W, 3) uint8 image as `bands` MCU-row bands on
    `device` (the card by default; "cpu" runs the plain versions).

    With config.restart_interval the bands emit DRI/RSTn restart framing:
    every interval's predictors reset, so no DC chain crosses a band, and
    assembly is marker concatenation. When the even split misaligns with
    the interval the band size is re-chosen (_aligned_band_rows); only a
    geometry with no aligned multi-band split falls back to encode_array,
    with a warning.
    """
    pipeline.check_config(config)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("expected (H, W, 3) RGB input")
    if bands < 1:
        raise ValueError(f"bands must be at least 1, got {bands}")
    height, width = rgb.shape[:2]
    geom = config.geometry(width, height)
    restart = config.restart_interval
    if restart is not None:
        # The clear restart-vs-quirk-geometry error, before any warning.
        pipeline.check_restart_geometry(geom)
    if not tileable(geom):
        # The reference accepts these inputs (main.rs:8-68): encode them
        # in one piece, byte-identically, and say so.
        warnings.warn(
            f"dimensions {geom.width}x{geom.height} hit the reference's "
            "dim % (8*factor) == 1 chroma-grid misalignment quirk, which "
            "band-local encoding cannot reproduce; falling back to a "
            "single-band encode",
            RuntimeWarning,
            stacklevel=2,
        )
        return pipeline.encode_array(rgb, config, device=device)
    band_rows = _split_rows(geom, bands, restart)
    if band_rows is None:
        warnings.warn(
            f"restart interval {restart} admits no band split of the "
            f"{geom.mcu_rows}x{geom.mcu_cols}-MCU grid into {bands} bands "
            "(every candidate band would put an interval across a band "
            "boundary); falling back to a single-band restart encode",
            RuntimeWarning,
            stacklevel=2,
        )
        return pipeline.encode_array(rgb, config, device=device)

    band_geom = _band_geometry(geom, band_rows * 8 * geom.v_factor)
    stack_geom = _band_geometry(geom, bands * band_geom.height)
    z, chained = band_front(rgb, config, geom, bands, band_rows, device)
    live = geom.num_scan_entries
    init_dc = chained if restart is None else None
    specs = luts = None
    if config.optimize_huffman:
        # One table set from every band's statistics: rows of a band (or
        # of an interval) with the encode's predictors.
        hist = entropy_ops.symbol_histograms(
            z, stack_geom, restart or band_rows * geom.mcu_cols, init_dc,
            live_entries=live,
        )
        specs, luts = pipeline.optimal_specs_and_luts(hist.cpu().numpy(),
                                                      z.device)
    if restart is not None:
        return _encode_restart(z, geom, config, bands, band_rows, luts,
                               specs)

    capacity = pipeline.default_capacity_bytes(
        band_geom, config.capacity_bytes_per_pixel
    )
    payloads, bit_lengths = batch.fetch_chunk(*entropy_kernel.encode_entries(
        z, stack_geom, capacity, init_dc, luts, live_entries=live,
        entries_per_interval=_band_entries(geom, band_rows),
    ))
    chunks = []
    for i in range(bands):
        bits = int(bit_lengths[i])
        if bits <= 8 * capacity:
            chunks.append((payloads[i], bits))
        else:
            # This band overflowed the shared estimate: re-code it alone.
            chunks.append(_retry_band(z, geom, band_rows, i, capacity,
                                      init_dc[i], luts))
    spliced, total_bits = splice_bitstreams(chunks)
    return pipeline.EncodeResult(
        file_bytes=jfif.assemble(geom, spliced, quality=config.quality,
                                 dht_specs=specs),
        entropy_payload=spliced,
        bit_length=total_bits,
        geom=geom,
    )


def band_front(
    rgb: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    bands: int,
    band_rows: int,
    device: str | torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The band front on `device`: rgb, zero-padded to bands bands of
    band_rows MCU rows, through pipeline.scan_entries as a (bands, band_h,
    W, 3) stack, its rows at or past the image height zeroed in the Y, Cb
    and Cr planes. -> (the stack's (bands * E_band, 64) scan entries, band
    after band; (bands, 3) int32 initial DC predictors: zeros for band 0,
    then the final DCs of the band before, ops/entropy.final_dc)."""
    height, width = rgb.shape[:2]
    band_geom = _band_geometry(geom, band_rows * 8 * geom.v_factor)
    band_h = band_geom.height
    stack = torch.zeros((bands * band_h, width, 3), dtype=torch.uint8,
                        device=device)
    stack[:height].copy_(
        torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.uint8)))
    z, coeffs = pipeline.scan_entries(
        stack.reshape(bands, band_h, width, 3), band_geom,
        config.dct_algorithm, config.quality, fast_dct=config.fast_dct,
        bin_dct_descale=config.bin_dct_descale, live_rows=height,
    )
    lasts = entropy_ops.final_dc(*coeffs, band_geom)
    return z, torch.cat([torch.zeros_like(lasts[:1]), lasts[:-1]])


def _encode_restart(z, geom, config, bands, band_rows, luts, specs):
    """The restart-framed encode of the band stack: K4 codes every
    interval of the stack into its own row, then the bands' live
    intervals, in order, go to pipeline.restart_result. A band with an
    overflowing interval is re-coded alone (_retry_band_restart).

    Non-final bands hold whole intervals, so band i's intervals are rows
    i * band_mcus / restart on; a single live band starts at row 0. The
    stack's intervals are the image's: its live entries are a prefix."""
    restart = config.restart_interval
    band_geom = _band_geometry(geom, band_rows * 8 * geom.v_factor)
    stack_geom = _band_geometry(geom, bands * band_geom.height)
    capacity = pipeline.restart_default_capacity_bytes(
        band_geom, restart, config.capacity_bytes_per_pixel
    )
    payloads, bit_lengths = batch.fetch_chunk(*entropy_kernel.encode_entries(
        z, stack_geom, capacity, luts=luts,
        live_entries=geom.num_scan_entries,
        entries_per_interval=entropy_ops.entries_per_interval(stack_geom,
                                                               restart),
    ))
    per_band = band_rows * geom.mcu_cols // restart
    segments, bits_list = [], []
    for i in range(bands):
        n_live = -(-_live_mcu_rows(geom, band_rows, i) * geom.mcu_cols
                   // restart)
        rows = range(i * per_band, i * per_band + n_live)
        if n_live and int(bit_lengths[rows.start:rows.stop].max()) > (
                8 * capacity):
            band_segments = _retry_band_restart(z, geom, band_rows, i,
                                                capacity, restart, luts)
        else:
            band_segments = [(payloads[r], int(bit_lengths[r])) for r in rows]
        for payload, bits in band_segments:
            segments.append(payload)
            bits_list.append(bits)
    return pipeline.restart_result(geom, segments, bits_list, restart,
                                   config.quality, dht_specs=specs)


def _live_band(z, geom, band_rows, idx):
    """Band idx's live entries (a view of z) and their geometry: the live
    prefix of a band's entries is the scan of its live MCU rows."""
    live_rows = _live_mcu_rows(geom, band_rows, idx)
    live_geom = _band_geometry(geom, live_rows * 8 * geom.v_factor)
    start = idx * _band_entries(geom, band_rows)
    return z[start : start + live_geom.num_scan_entries], live_geom


def _retry_band(
    z: torch.Tensor,
    geom: FrameGeometry,
    band_rows: int,
    idx: int,
    capacity: int,
    init_dc: torch.Tensor,
    luts: tuple | None = None,
) -> tuple[np.ndarray, int]:
    """Re-code band idx's live entries alone, from its own (3,) init_dc,
    up the capacity ladder from the rung above the one that overflowed."""
    z_band, live_geom = _live_band(z, geom, band_rows, idx)

    def encode(cap):
        payload, bits = entropy_kernel.encode_entries(
            z_band, live_geom, cap, init_dc, luts
        )
        return {"payload": payload, "total_bits": bits}

    out = pipeline._climb_capacity_ladder(
        encode, live_geom, pipeline.next_capacity_bytes(live_geom, capacity),
        None, False,
    )
    bits = int(out["total_bits"])
    return out["payload"][: (bits + 7) // 8].cpu().numpy(), bits


def _retry_band_restart(
    z: torch.Tensor,
    geom: FrameGeometry,
    band_rows: int,
    idx: int,
    capacity: int,
    restart: int,
    luts: tuple | None = None,
) -> list[tuple[np.ndarray, int]]:
    """Re-code band idx's restart intervals alone, up the capacity ladder
    from the rung above the one that overflowed."""
    z_band, live_geom = _live_band(z, geom, band_rows, idx)
    epi = entropy_ops.entries_per_interval(live_geom, restart)

    def encode(cap):
        payloads, bits = entropy_kernel.encode_entries(
            z_band, live_geom, cap, luts=luts, entries_per_interval=epi
        )
        return {"payloads": payloads, "bits": bits}

    out = pipeline._climb_capacity_ladder(
        encode, live_geom,
        pipeline.restart_next_capacity_bytes(live_geom, restart, capacity),
        restart, False,
    )
    payloads, bits = batch.fetch_chunk(out["payloads"], out["bits"])
    return [(p, int(b)) for p, b in zip(payloads, bits)]
