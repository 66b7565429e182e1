"""The scan encoder: scan entries -> packed entropy-coded bytes.

Port of jpeg_encoder_tpu/ops/entropy.py encode_scan and encode_scan_restart
over the (E, 64) scan entries. It sits above the kernels (it picks
one), so it is a module of its own: ops/entropy.py is the plain code the
kernels' wrappers run for CPU tensors.

Packers, and the JAX package's names for them:
- "fused" (JAX "fused"; the default): K4, kernels/entropy.py, codes the
  entries in one launch;
- "assemble" (JAX "pallas"): the plain symbolizer and per-entry packer
  (ops/entropy.symbolize, pack_level1), then K5, kernels/pack.py, ORs the
  entries into the stream. Custom tables (luts) take this tier too: K5
  ORs the boundary words of entries as short as 2 bits, so it has no
  assembly window to keep them out of, as the TPU tier has.

Both give the same bytes and bit counts. The JAX package's "xla" tier is
the plain code under either wrapper: what runs on a CPU tensor.
"""

from __future__ import annotations

import torch

from jpeg_encoder_torch.config import FrameGeometry
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.kernels import pack as pack_kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops

PACKERS = ("fused", "assemble")


def assemble_operands(
    slot_bits: torch.Tensor, slot_lens: torch.Tensor, epi: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(E, 64) slot codes -> K5's operands, one row per interval of epi
    entries: ((n_int, epi, ENTRY_WORDS) int32 per-entry words, (n_int,
    epi) int64 bit offsets within the row, (n_int,) int64 row bit counts).

    ops/entropy.pack_entries_pallas under the interval vmap: pack_level1,
    then an exclusive cumsum per row. The short last interval is padded
    with silent entries, as the JAX package pads it.
    """
    num_entries = slot_lens.shape[0]
    n_int = -(-num_entries // epi)
    entry_words, entry_bits = entropy_ops.pack_level1(slot_bits, slot_lens)
    pad = n_int * epi - num_entries
    if pad:
        entry_words = torch.cat(
            [entry_words, entry_words.new_zeros((pad, entry_words.shape[1]))]
        )
        entry_bits = torch.cat([entry_bits, entry_bits.new_zeros(pad)])
    entry_bits = entry_bits.reshape(n_int, epi)
    ends = torch.cumsum(entry_bits, dim=1)
    return entry_words.reshape(n_int, epi, -1), ends - entry_bits, ends[:, -1]


def encode_entries(
    z: torch.Tensor,
    geom: FrameGeometry,
    capacity_bytes: int,
    *,
    restart_mcus: int | None = None,
    init_dc: torch.Tensor | None = None,
    live_entries: int | None = None,
    luts: tuple[torch.Tensor, torch.Tensor] | None = None,
    packer: str = "fused",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, 64) int16 scan entries (pipeline.scan_entries) ->
    (bytes (capacity_bytes,) uint8, total_bits int64), or with
    restart_mcus (bytes (n_int, capacity_bytes), bits (n_int,)): one row
    per restart interval, capacity_bytes each, its DC predictors reset to
    0 (T.81 E.2.4); the host joins the rows with RST markers.

    The payload is the first ceil(bits / 8) bytes of a row, its final
    partial byte zero-filled; bits above 8 * capacity_bytes means the
    caller must retry with a larger buffer. init_dc seeds the unbroken
    scan's DC predictors; live_entries makes the entries at index >= it
    emit nothing (interval j keeps clip(live_entries - j * epi, 0, epi) of
    its epi entries, and a fully dead interval reports 0 bits); luts are
    the (dc, ac) (2, 256) packed tables, Annex K by default.
    """
    if packer not in PACKERS:
        raise ValueError(f"packer must be one of {PACKERS}, got {packer!r}")
    epi = (None if restart_mcus is None
           else entropy_ops.entries_per_interval(geom, restart_mcus))
    if packer == "fused":
        return entropy_kernel.encode_entries(
            z, geom, capacity_bytes, init_dc, luts,
            live_entries=live_entries, entries_per_interval=epi,
        )
    slot_bits, slot_lens = entropy_ops.symbolize(
        z, geom.h_factor * geom.v_factor, init_dc, luts, live_entries, epi
    )
    entry_words, offsets, bits = assemble_operands(
        slot_bits, slot_lens, epi or z.shape[0]
    )
    data = entropy_ops.words_to_bytes(
        pack_kernel.assemble_bitstream(entry_words, offsets, capacity_bytes)
    )
    if epi is None:
        return data[0], bits[0]
    return data, bits
