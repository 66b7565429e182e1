"""Port entropy coder vs the JAX package and the oracle.

Scan layout, marshal, DC chains, symbolization and packing of the plain
path (ops/entropy.py) and of the entropy and pack kernels' wrappers on CPU
tensors, held exactly against jpeg_encoder_tpu's XLA packer, its fused
Pallas kernel and its assembly kernel (interpret mode, small geometries)
and the oracle's bit writer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_encoder_tpu import oracle, tables
from jpeg_encoder_tpu.config import EncoderConfig
from jpeg_encoder_tpu.kernels import pack_pallas
from jpeg_encoder_tpu.ops import entropy as jax_entropy
from jpeg_encoder_torch import scan
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.kernels import pack as pack_kernel
from jpeg_encoder_torch.ops import entropy

RATIOS = [(4, 4, 4), (4, 2, 2), (4, 2, 0)]
SIZES = [(40, 24), (33, 17), (17, 9), (49, 33)]


def _coeffs(rng, geom, sparsity=0.85, amp=600):
    """Random zigzag-order coefficients [Y, Cb, Cr], sparse toward the
    high frequencies like real quantized blocks."""
    out = []
    for n in (geom.num_luma_blocks, geom.num_chroma_blocks, geom.num_chroma_blocks):
        a = rng.integers(-amp, amp + 1, (n, 64)).astype(np.int16)
        a[:, 6:] = np.where(rng.random(a[:, 6:].shape) < sparsity, 0, a[:, 6:])
        out.append(a)
    return out


def _encode(coeffs, geom, capacity, init_dc=None):
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs), geom)
    init = None if init_dc is None else torch.tensor(init_dc, dtype=torch.int32)
    data, bits = entropy_kernel.encode_entries(z, geom, capacity, init)
    return data.numpy(), int(bits)


def _natural(zz_coeffs):
    return zz_coeffs[:, tables.ZIGZAG_INVERSE]


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("size", SIZES)
def test_scan_layout_and_marshal_match_jax(ratio, size, rng):
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(*size)
    mine, theirs = entropy.scan_layout(geom), jax_entropy.scan_layout(geom)
    for field in ("luma_order", "entry_row"):
        assert np.array_equal(getattr(mine, field), getattr(theirs, field)), field
    assert mine.num_entries == theirs.num_entries == geom.num_scan_entries
    coeffs = _coeffs(rng, geom)
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs), geom)
    rows, diff = jax_entropy.marshal_scan_inputs(
        *(jnp.asarray(c) for c in coeffs), geom, coeffs_zigzagged=True
    )
    assert z.dtype == torch.int16
    assert np.array_equal(z.numpy(), np.asarray(rows))
    dc = entropy.dc_differences(z[:, 0].to(torch.int64), geom.h_factor * geom.v_factor)
    assert np.array_equal(dc.numpy(), np.asarray(diff))


def test_bit_length_exact():
    v = torch.arange(0, 1 << 17, dtype=torch.int64)
    want = [int(x).bit_length() for x in v.tolist()]
    assert entropy.bit_length(v).tolist() == want


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("size", SIZES[:2])
def test_encode_matches_jax_xla_and_oracle(ratio, size, rng):
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(*size)
    coeffs = _coeffs(rng, geom)
    cap = 1 << 14
    got, bits = _encode(coeffs, geom, cap)
    want, want_bits = jax_entropy.encode_scan(
        *(jnp.asarray(c) for c in coeffs), geom, cap,
        coeffs_zigzagged=True, packer="xla",
    )
    assert bits == int(want_bits)
    assert np.array_equal(got, np.asarray(want))
    golden, golden_bits = oracle.entropy_encode(
        *(_natural(c) for c in coeffs), geom
    )
    assert bits == golden_bits
    assert got[: len(golden)].tobytes() == golden
    assert not got[len(golden):].any()


@pytest.mark.parametrize("ratio", RATIOS)
def test_init_dc_seeds_the_predictors(ratio, rng):
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(40, 24)
    coeffs = _coeffs(rng, geom)
    init = [7, -3, 11]
    got, bits = _encode(coeffs, geom, 1 << 14, init)
    want, want_bits = jax_entropy.encode_scan(
        *(jnp.asarray(c) for c in coeffs), geom, 1 << 14,
        init_dc=jnp.asarray(init, jnp.int32), coeffs_zigzagged=True,
        packer="xla",
    )
    assert bits == int(want_bits)
    assert np.array_equal(got, np.asarray(want))


def test_encode_matches_fused_kernel_interpret(rng):
    """The entropy kernel's wrapper on CPU tensors equals the TPU kernel it
    replaces (encode_entropy_fused, interpret mode, one small geometry)."""
    geom = EncoderConfig(subsampling_ratio=(4, 2, 0)).geometry(48, 32)
    coeffs = _coeffs(rng, geom)
    before = entropy_kernel.ENTROPY.launches
    got, bits = _encode(coeffs, geom, 1 << 14)
    assert entropy_kernel.ENTROPY.launches == before  # the CPU path launches nothing
    want, want_bits = jax_entropy.encode_scan(
        *(jnp.asarray(c) for c in coeffs), geom, 1 << 14,
        coeffs_zigzagged=True, packer="fused_interpret",
    )
    assert bits == int(want_bits)
    assert np.array_equal(got, np.asarray(want))


def _adversarial_blocks():
    """Zigzag blocks at the entropy coder's edges: all zeros; AC +-1023;
    zero runs of 15/16/17/31/32/47/48/62 ending in a nonzero (ZRLs, and at
    62 a nonzero at position 63, so no EOB); a full block of +-1023."""
    blocks = [np.zeros(64, np.int16)]
    for run in (15, 16, 17, 31, 32, 47, 48, 62):
        b = np.zeros(64, np.int16)
        b[1 + run] = -1 if run % 2 else 1
        blocks.append(b)
        b = b.copy()
        b[1] = 1023  # the run starts after an AC nonzero
        if 2 + run < 64:
            b[1 + run], b[2 + run] = 0, -1023
        blocks.append(b)
    full = np.where(np.arange(64) % 2 == 0, 1023, -1023).astype(np.int16)
    blocks.append(full)
    return np.stack(blocks)


@pytest.mark.parametrize("ratio", RATIOS)
def test_adversarial_blocks_match_oracle(ratio):
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(64, 48)
    pool = _adversarial_blocks()
    coeffs = []
    for n in (geom.num_luma_blocks, geom.num_chroma_blocks, geom.num_chroma_blocks):
        c = pool[np.arange(n) % len(pool)].copy()
        # DC values alternating between +1023 and -1024: DC differences of
        # +-2047, the largest the 11-bit category allows.
        c[:, 0] = np.where(np.arange(n) % 2 == 0, 1023, -1024)
        coeffs.append(c)
    cap = entropy.worst_case_capacity_bytes(geom)
    got, bits = _encode(coeffs, geom, cap)
    golden, golden_bits = oracle.entropy_encode(
        *(_natural(c) for c in coeffs), geom
    )
    assert bits == golden_bits
    assert got[: len(golden)].tobytes() == golden


@pytest.mark.parametrize("capacity", [4, 64, 1000])
def test_overflow_drops_words_but_reports_true_bits(capacity, rng):
    """A capacity below the payload keeps the exact prefix of the stream
    and still reports the true bit count (the capacity ladder's signal)."""
    geom = EncoderConfig(subsampling_ratio=(4, 2, 2)).geometry(40, 24)
    coeffs = _coeffs(rng, geom)
    full, full_bits = _encode(coeffs, geom, 1 << 14)
    got, bits = _encode(coeffs, geom, capacity)
    assert full_bits > 8 * capacity
    assert bits == full_bits
    assert got.shape == (capacity,)
    assert np.array_equal(got, full[:capacity])
    want, _ = jax_entropy.encode_scan(
        *(jnp.asarray(c) for c in coeffs), geom, capacity,
        coeffs_zigzagged=True, packer="xla",
    )
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("ratio", RATIOS)
def test_coefficient_ranges_match_jax(ratio, rng):
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(33, 17)
    coeffs = _coeffs(rng, geom, amp=2000)
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs), geom)
    max_dc, max_ac = entropy.coefficient_ranges(z, geom)
    want_dc, want_ac = jax_entropy.coefficient_ranges(
        *(jnp.asarray(c) for c in coeffs), geom
    )
    assert (int(max_dc), int(max_ac)) == (int(want_dc), int(want_ac))


def test_words_to_bytes_is_big_endian():
    words = torch.tensor([0x01020304, 0xFFFFFFFF, 0], dtype=torch.int64)
    got = entropy.words_to_bytes(words).tolist()
    assert got == [1, 2, 3, 4, 255, 255, 255, 255, 0, 0, 0, 0]


def test_entropy_wrapper_rejects_bad_operands():
    geom = EncoderConfig().geometry(16, 16)
    z = torch.zeros((geom.num_scan_entries, 64), dtype=torch.int16)
    with pytest.raises(ValueError):
        entropy_kernel.encode_entries(z.to(torch.int32), geom, 1024)
    with pytest.raises(ValueError):
        entropy_kernel.encode_entries(z[1:], geom, 1024)
    with pytest.raises(ValueError):
        entropy_kernel.encode_entries(z, geom, 1023)
    with pytest.raises(ValueError):
        entropy_kernel.encode_entries(z, geom, 1024, torch.zeros(2))
    # 4:4:4 at 16384 x 16384: the worst case (~2.2e10 bits) passes 2^31
    # bits, which the 64-bit offsets and counts take; the geometry is no
    # longer refused, only the z that does not fit it. The kernel's one
    # bound is a row of 2^31 words or more.
    huge = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(16384, 16384)
    assert entropy_kernel.worst_case_bits(huge) > 2**34
    with pytest.raises(ValueError, match="whole number"):
        entropy_kernel.encode_entries(z, huge, 1024)
    entropy_kernel._check_kernel_operands(4 * (2**31 - 1))
    with pytest.raises(ValueError, match="4-byte words"):
        entropy_kernel._check_kernel_operands(2**33)


def _random_slots(rng, num_entries, slots=65, max_len=27):
    """(E, S) codes of random lengths in [0, max_len], MSB-first values
    below 2^len, as int64; mostly short, like real scans."""
    lens = np.where(rng.random((num_entries, slots)) < 0.7, 0,
                    rng.integers(1, max_len + 1, (num_entries, slots)))
    bits = rng.integers(0, 1 << 30, (num_entries, slots)) & ((1 << lens) - 1)
    return bits.astype(np.int64), lens.astype(np.int64)


def test_pack_level1_matches_jax(rng):
    """Per-entry private buffers (the assemble tier's first level) against
    jpeg_encoder_tpu.ops.entropy._pack_level1, 65 slots as there."""
    bits, lens = _random_slots(rng, 200)
    lens[0] = 27  # the widest entry: 65 * 27 bits, words 0..54
    bits[0] = (1 << 27) - 1
    words, entry_bits = entropy.pack_level1(torch.from_numpy(bits),
                                            torch.from_numpy(lens))
    want_words, want_bits = jax_entropy._pack_level1(
        jnp.asarray(bits.astype(np.uint32)), jnp.asarray(lens.astype(np.int32))
    )
    assert words.dtype == torch.int32
    assert words.shape == (200, entropy.ENTRY_WORDS)
    assert np.array_equal(words.numpy().view(np.uint32), np.asarray(want_words))
    assert np.array_equal(entry_bits.numpy(), np.asarray(want_bits))


def _level1(rng, geom, cap_entries=None):
    coeffs = _coeffs(rng, geom)
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs), geom)
    slot_bits, slot_lens = entropy.symbolize(z, geom.h_factor * geom.v_factor)
    words, entry_bits = entropy.pack_level1(slot_bits, slot_lens)
    offsets = torch.cumsum(entry_bits, 0) - entry_bits
    return words, offsets, int(entry_bits.sum()), slot_bits, slot_lens


@pytest.mark.parametrize("ratio", RATIOS)
def test_assemble_bitstream_matches_pallas_interpret(ratio, rng):
    """The pack kernel's wrapper on CPU tensors (its plain version) against
    the TPU kernel it replaces, assemble_bitstream_pallas in interpret
    mode, where the stream fits; and against the scatter packer."""
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(48, 32)
    words, offsets, total, slot_bits, slot_lens = _level1(rng, geom)
    cap = 1 << 13
    assert total <= 8 * cap
    before = pack_kernel.PACK.launches
    got = pack_kernel.assemble_bitstream(words[None], offsets[None], cap)
    assert pack_kernel.PACK.launches == before  # the CPU path launches nothing
    want = pack_pallas.assemble_bitstream_pallas(
        jnp.asarray(words.numpy().view(np.uint32)),
        jnp.asarray(offsets.numpy().astype(np.int32)),
        cap, interpret=True,
    )
    assert got.shape == (1, cap // 4)
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(want))
    stream, bits = entropy.pack_bits(slot_bits, slot_lens, cap)
    assert int(bits[0]) == total
    assert torch.equal(entropy.words_to_bytes(got), stream)


def test_assemble_bitstream_rows_and_overflow(rng):
    """Rows are independent streams; a row's words at or past capacity are
    dropped (never spilled into the next row), leaving the exact prefix."""
    geom = EncoderConfig(subsampling_ratio=(4, 2, 2)).geometry(40, 24)
    rows = [_level1(rng, geom) for _ in range(3)]
    words = torch.stack([r[0] for r in rows])
    offsets = torch.stack([r[1] for r in rows])
    full = pack_kernel.assemble_bitstream(words, offsets, 1 << 13)
    for cap in (4, 64, 1000):
        assert all(r[2] > 8 * cap for r in rows)
        got = pack_kernel.assemble_bitstream(words, offsets, cap)
        assert torch.equal(got, full[:, : cap // 4])


def test_assemble_packer_matches_jax_pallas_interpret(rng):
    """As test_entropy.py::test_pallas_packer_matches_xla: the assemble
    tier (plain symbolization, then the pack kernel's wrapper) against the
    JAX package's packer="pallas_interpret"."""
    geom = EncoderConfig(subsampling_ratio=(4, 2, 0)).geometry(48, 32)
    coeffs = _coeffs(rng, geom, sparsity=0.9, amp=80)
    cap = 1 << 14
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs),
                                    geom)
    got, bits = scan.encode_entries(z, geom, cap, packer="assemble")
    want, want_bits = jax_entropy.encode_scan(
        *(jnp.asarray(c) for c in coeffs), geom, cap,
        coeffs_zigzagged=True, packer="pallas_interpret",
    )
    assert int(bits) == int(want_bits)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_pack_wrapper_rejects_bad_operands():
    words = torch.zeros((1, 6, entropy.ENTRY_WORDS), dtype=torch.int32)
    offsets = torch.zeros((1, 6), dtype=torch.int64)
    with pytest.raises(ValueError, match="capacity"):
        pack_kernel.assemble_bitstream(words, offsets, 1022)
    with pytest.raises(ValueError, match="entry_words"):
        pack_kernel.assemble_bitstream(words.to(torch.int64), offsets, 1024)
    with pytest.raises(ValueError, match="entry_words"):
        pack_kernel.assemble_bitstream(words[0], offsets, 1024)
    with pytest.raises(ValueError, match="offsets"):
        pack_kernel.assemble_bitstream(words, offsets[:, :5], 1024)
    with pytest.raises(ValueError, match="int64"):
        pack_kernel.assemble_bitstream(words, offsets.to(torch.int32), 1024)
    with pytest.raises(ValueError, match="packer"):
        scan.encode_entries(torch.zeros((6, 64), dtype=torch.int16),
                            EncoderConfig().geometry(16, 16), 64,
                            packer="pallas")


def test_entropy_wrapper_rejects_empty_scan():
    """An empty z is refused before it reaches the kernel (whose interval
    count would divide by it)."""
    geom = EncoderConfig().geometry(16, 16)
    z = torch.zeros((0, 64), dtype=torch.int16)
    for epi in (None, 6):
        with pytest.raises(ValueError, match="no entries"):
            entropy_kernel.encode_entries(z, geom, 64, entries_per_interval=epi)
