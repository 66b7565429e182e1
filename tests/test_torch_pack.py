"""K5 (csrc/pack.cu) on the CPU: its precondition and a model of its walk.

The kernel writes each window of 32 output words once, a warp a window: it
finds the last entry starting at or before the window's first bit and the
first starting past its end by a 32-way search over the row's offsets,
walks the entries between a lane an entry, skips runs of entries that share
an offset, and reads an entry only up to the next entry's offset. That needs non-decreasing offsets
within a row, each entry's bits inside [offsets[e], offsets[e + 1]). These
tests hold scan.assemble_operands to that precondition (dead entries under
live_entries and the padding of a short last interval included), and a
Python model of the kernel's walk to the plain version
(ops/entropy.assemble_bitstream) on adversarial operands: long runs of
0-bit entries, entries of up to the 56 words of pack_level1, many tiny
entries a span, and capacities that cut an entry mid-word. The kernel
itself runs against the same operands in tests/test_torch_kernels.py (on
the card) and in chip_smoke.py.
"""

import bisect

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import pipeline, scan
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.kernels import pack as pack_kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops
from jpeg_encoder_torch.utils import corpus

EW = entropy_ops.ENTRY_WORDS
WINDOW = 32  # output words a warp of the kernel writes (kWindow)


def _entry_bits(case: str, rng: np.random.Generator) -> tuple[np.ndarray, int]:
    """(rows, E) bit counts of one adversarial case, and the first row's
    starting offset (the kernel takes rows that do not start at bit 0)."""
    start = 0
    if case == "zero-runs":
        rows, n = 3, 4000
        bits = rng.integers(1, 41, (rows, n))
        bits[0, :3000] = 0                      # a leading run
        bits[1, rng.random(n) < 0.8] = 0        # runs of every length
        bits[1, 1500:2700] = 0
        bits[2, 1000:] = 0                      # a dead tail, as live_entries
    elif case == "max-words":
        rows, n = 2, 200
        bits = rng.choice([EW * 32, EW * 32 - 1, EW * 32 - 31, 1760, 1729,
                           33, 32, 31, 1, 0], (rows, n))
    elif case == "tiny-entries":
        rows, n = 2, 3000
        bits = rng.integers(0, 5, (rows, n))
    elif case == "past-2^31":
        rows, n = 2, 300
        bits = rng.integers(0, 300, (rows, n))
        start = 2**31 - 7 * 1000 - 5  # row 0 crosses bit 2^31 mid-row
    else:
        raise ValueError(case)
    return bits.astype(np.int64), start


def pack_operands(case: str, seed: int = 0):
    """K5 operands that meet its precondition: ((rows, E, EW) int32 words,
    random bits MSB-first and zero past each entry's bit count; (rows, E)
    int64 offsets, an exclusive cumsum of the bit counts from the case's
    start; (rows,) int64 row end bits)."""
    rng = np.random.default_rng(seed)
    bits, start = _entry_bits(case, rng)
    rows, n = bits.shape
    words = rng.integers(0, 2**32, (rows, n, EW), dtype=np.uint64)
    k = np.arange(EW)
    full, rem = bits[..., None] // 32, bits[..., None] % 32
    partial = np.where(rem > 0, ((1 << rem) - 1) << (32 - rem), 0)
    mask = np.where(k < full, 0xFFFFFFFF, np.where(k == full, partial, 0))
    words = (words & mask.astype(np.uint64)).astype(np.uint32).view(np.int32)
    ends = np.cumsum(bits, axis=1)
    offsets = ends - bits
    offsets[0] += start
    return (torch.from_numpy(words), torch.from_numpy(offsets),
            torch.from_numpy(ends[:, -1] + np.where(np.arange(rows) == 0,
                                                    start, 0)))


def warp_upper_bound(off: list[int], lo: int, hi: int, v: int) -> int:
    """pack.cu's warp_upper_bounds for one value: the first index in
    [lo, hi) whose offset exceeds v, by 32-way steps."""
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        count = sum(1 for j in range(32)
                    if lo + j * step < hi and off[lo + j * step] <= v)
        if count == 0:
            hi = lo
        else:
            hi = min(lo + count * step, hi)
            lo = lo + (count - 1) * step + 1
    return lo + sum(1 for j in range(32) if lo + j < hi and off[lo + j] <= v)


def kernel_model(words: torch.Tensor, offsets: torch.Tensor,
                 capacity_bytes: int) -> tuple[np.ndarray, int]:
    """csrc/pack.cu's assemble_kernel, warp window by warp window, lane by
    lane, in Python: the (rows, capacity_bytes // 4) u32 words and the
    number of entry words it read."""
    rows, n, ew = words.shape
    w_all = words.numpy().view(np.uint32)
    num_words = capacity_bytes // 4
    out = np.zeros((rows, num_words), np.uint32)
    reads = 0
    for r in range(rows):
        off = offsets[r].tolist()
        w = w_all[r]
        for w0 in range(0, num_words, WINDOW):
            b0, b1 = 32 * w0, 32 * (w0 + WINDOW)
            acc = [0] * WINDOW
            if n and b1 > off[0] and b0 < off[-1] + 32 * ew:
                e = warp_upper_bound(off, 0, n, max(b0, off[0])) - 1
                e_end = warp_upper_bound(off, 0, n, b1 - 1)
                base = e
                while base < e_end:
                    has_bits = []
                    for i in range(base, min(base + 32, e_end)):
                        o = off[i]
                        end = off[i + 1] if i + 1 < n else o + 32 * ew
                        has_bits.append(end > o)
                        q, s = o >> 5, o & 31
                        lo = max(q, w0)
                        hi = min((end - 1) >> 5, q + ew, w0 + WINDOW - 1)
                        if end > o and lo <= hi:
                            k = lo - q
                            prev = int(w[i, k - 1]) if s and k >= 1 else 0
                            reads += 1 if s and k >= 1 else 0
                            for g in range(lo, hi + 1):
                                cur = int(w[i, k]) if k < ew else 0
                                reads += k < ew
                                acc[g - w0] |= cur if s == 0 else (
                                    (cur >> s) | (prev << (32 - s))
                                ) & 0xFFFFFFFF
                                prev = cur
                                k += 1
                    if not any(has_bits) and base + 32 < e_end:
                        base = warp_upper_bound(off, base + 32, e_end,
                                                off[base]) - 1
                    else:
                        base += 32
            for j in range(WINDOW):
                if w0 + j < num_words:
                    out[r, w0 + j] = acc[j]
    return out, reads


def fit_capacity(row_ends: torch.Tensor) -> int:
    """A capacity that holds every row, with a zero tail."""
    return (int(row_ends.max()) // 32 + 9) * 4


@pytest.mark.parametrize("case", ["zero-runs", "max-words", "tiny-entries"])
def test_kernel_model_matches_plain(case):
    """The model of K5's walk == ops/entropy.assemble_bitstream at a
    fitting capacity, at one that is not a multiple of 16 bytes and cuts
    an entry mid-word (scalar stores, dropped words), and at 4 bytes."""
    words, offsets, ends = pack_operands(case)
    fit = fit_capacity(ends)
    cut = 4 * (int(ends.min()) // 64 // 4 * 4 + 3)
    for cap in (fit, cut, 4):
        want = entropy_ops.assemble_bitstream(words, offsets, cap)
        got, reads = kernel_model(words, offsets, cap)
        assert np.array_equal(got.view(np.int32), want.numpy()), cap
    # Only live words are read: at most each entry's own words and, per
    # window it crosses, one word before (the phase's carry).
    bits = torch.diff(offsets, dim=1, append=ends[:, None])
    live = int(((bits + 31) // 32).sum())
    spans = int(((bits + 127) // 128 + 1).sum())
    _, reads = kernel_model(words, offsets, fit)
    assert reads <= live + 2 * spans + offsets.shape[0] * EW


def test_kernel_model_places_words_past_2_31_bits():
    """A row whose offsets cross bit 2^31 (it starts at 2^31 - 7005): the
    model's words == the plain version's on the same row moved down by a
    whole number of words (only the card can hold the full row)."""
    words, offsets, ends = pack_operands("past-2^31")
    shift = (int(offsets[0, 0]) // 32) * 32
    assert int(offsets[0, 0]) < 2**31 < int(ends[0])
    moved = offsets.clone()
    moved[0] -= shift
    cap = fit_capacity(torch.stack([ends[0] - shift, ends[1]]))
    want = entropy_ops.assemble_bitstream(words, moved, cap).numpy()
    got, _ = kernel_model(words[:1], moved[:1], cap)
    assert np.array_equal(got.view(np.int32), want[:1])
    got, _ = kernel_model(words[1:], offsets[1:], cap)
    assert np.array_equal(got.view(np.int32), want[1:])


@pytest.mark.parametrize(
    "config, live, restart",
    [(EncoderConfig(), None, None),
     (EncoderConfig(), 100, 7),             # dead entries mid-interval
     (EncoderConfig(subsampling_ratio=(4, 4, 4)), None, 7),  # padded tail
     (EncoderConfig(subsampling_ratio=(4, 2, 2)), 37, None)],
    ids=["unbroken", "live-100-restart-7", "444-restart-7", "422-live-37"],
)
def test_assemble_operands_meet_the_kernel_precondition(config, live, restart):
    """scan.assemble_operands: per row, offsets start at 0 and never
    decrease, each entry's bits lie in [offsets[e], offsets[e + 1]) (its
    words zero past its bit count), and the row's bit count is its last
    entry's end; dead entries (live_entries) and the silent padding of a
    short last interval share the next entry's offset. The model of K5 on
    these operands == the plain version."""
    geom = config.geometry(96, 80)
    rgb = corpus.landscape(80, 96, seed=2)
    z, _ = pipeline.scan_entries(torch.from_numpy(rgb), geom,
                                 config.dct_algorithm)
    epi = (None if restart is None
           else entropy_ops.entries_per_interval(geom, restart))
    slot_bits, slot_lens = entropy_ops.symbolize(
        z, geom.h_factor * geom.v_factor, live_entries=live,
        entries_per_interval=epi)
    rows_epi = epi or geom.num_scan_entries
    words, offsets, row_bits = scan.assemble_operands(slot_bits, slot_lens,
                                                      rows_epi)
    n_rows = -(-geom.num_scan_entries // rows_epi)
    assert words.shape == (n_rows, rows_epi, EW)
    if restart is not None and config.subsampling_ratio == (4, 4, 4):
        assert geom.num_scan_entries % rows_epi  # a padded last interval
    assert torch.all(offsets[:, 0] == 0)
    bits = torch.diff(offsets, dim=1, append=row_bits[:, None])
    assert torch.all(bits >= 0)
    k = torch.arange(EW)
    w = words.to(torch.int64) & 0xFFFFFFFF
    past = k * 32 >= bits[..., None]
    assert not torch.any(w[past])
    dead = bits == 0
    if live is not None or geom.num_scan_entries % rows_epi:
        assert int(dead.sum()) > 0
    cap = fit_capacity(row_bits)
    got, reads = kernel_model(words, offsets, cap)
    want = pack_kernel.assemble_bitstream(words, offsets, cap)
    assert np.array_equal(got.view(np.int32), want.numpy())
    # Real entries are short: the walk reads a few words an entry where a
    # warp an entry read all EW + 1.
    assert reads < offsets.numel() * 4
