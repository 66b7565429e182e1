"""Optimized Huffman tables in the port, on CPU, vs the oracle and JAX.

The two-pass encode (symbol histograms on the device, T.81 K.2 tables on
the host, the scan coded with them) is held byte for byte to the NumPy
oracle re-encoding the oracle's coefficients with the same tables, with and
without restart intervals, as tests/test_optimize.py holds the JAX package;
the statistics pass is held to jpeg_encoder_tpu.ops.entropy's. Every
comparison is exact.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jpeg_encoder_tpu import oracle, tables
from jpeg_encoder_tpu import pipeline as jax_pipeline
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_tpu.io import jfif
from jpeg_encoder_tpu.ops import entropy as jax_entropy
from jpeg_encoder_tpu.utils import corpus
from jpeg_encoder_torch import pipeline, scan
from jpeg_encoder_torch.ops import entropy

RATIOS = [(4, 2, 0), (4, 2, 2), (4, 4, 4)]


def _oracle_file(rgb, config, specs, coeffs=None):
    """The oracle's coefficients (or the given natural-order [Y, Cb, Cr])
    coded bit-serially with `specs`, one segment per restart interval (DC
    predictors reset, 1-padded), in a JFIF file with those tables."""
    geom = config.geometry(rgb.shape[1], rgb.shape[0])
    if coeffs is None:
        ref = oracle.encode_oracle(rgb, config)
        coeffs = (ref.y_coeffs, ref.cb_coeffs, ref.cr_coeffs)
    zz = tables.ZIGZAG_ORDER
    y, cb, cr = (c.reshape(-1, 64)[:, zz] for c in coeffs)
    order = oracle.luma_scan_order(geom)
    num_mcus = geom.num_mcus
    step = config.restart_interval or num_mcus
    segments = []
    for start in range(0, num_mcus, step):
        writer = oracle.BitWriter()
        prev = [0, 0, 0]
        for mcu in range(start, min(start + step, num_mcus)):
            for block in order[mcu]:
                prev[0] = oracle.encode_block(y[block], prev[0], specs[0],
                                              specs[2], writer)
            prev[1] = oracle.encode_block(cb[mcu], prev[1], specs[1],
                                          specs[3], writer)
            prev[2] = oracle.encode_block(cr[mcu], prev[2], specs[1],
                                          specs[3], writer)
        segments.append((writer.to_bytes(), writer.bit_length))
    if config.restart_interval is None:
        (payload, bits), = segments
        return jfif.assemble(geom, payload, quality=config.quality,
                             dht_specs=specs), payload, bits
    file_bytes = jfif.assemble_restart(
        geom, [np.frombuffer(p, np.uint8) for p, _ in segments],
        [b for _, b in segments], config.restart_interval,
        quality=config.quality, dht_specs=specs,
    )
    return file_bytes, None, sum(b for _, b in segments)


def _specs(rgb, config):
    """The port's tables for this image: its statistics pass on CPU."""
    geom = config.geometry(rgb.shape[1], rgb.shape[0])
    hist, _ = pipeline.stats_core(
        torch.from_numpy(rgb), geom, config.dct_algorithm, config.quality,
        fast_dct=config.fast_dct, bin_dct_descale=config.bin_dct_descale,
        restart_mcus=config.restart_interval,
    )
    specs, _ = pipeline.optimal_specs_and_luts(hist.numpy(), "cpu")
    return specs


@pytest.mark.parametrize("restart", [None, 2, 10000])
@pytest.mark.parametrize("ratio", RATIOS)
def test_optimized_file_matches_oracle_with_same_specs(ratio, restart):
    rgb = corpus.portrait(80, 112)
    config = EncoderConfig(subsampling_ratio=ratio, restart_interval=restart,
                           optimize_huffman=True)
    got = pipeline.encode_array(rgb, config, device="cpu")
    want, payload, bits = _oracle_file(rgb, config, _specs(rgb, config))
    assert got.file_bytes == want
    assert got.bit_length == bits
    if payload is not None:
        assert got.entropy_payload == payload


@pytest.mark.parametrize("packer", scan.PACKERS)
@pytest.mark.parametrize(
    "config",
    [
        EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT, quality=85,
                      optimize_huffman=True),
        EncoderConfig(subsampling_ratio=(4, 2, 2), restart_interval=3,
                      dct_algorithm=DctAlgorithm.BIN_DCT,
                      optimize_huffman=True),
        EncoderConfig(subsampling_ratio=(4, 4, 4), quality=90,
                      restart_interval=5, optimize_huffman=True),
    ],
    ids=["bin-q85", "bin-422-restart", "real-444-q90-restart"],
)
def test_optimized_every_packer_and_dct_matches_oracle(config, packer):
    rgb = corpus.foliage(64, 96)
    got = pipeline.encode_array(rgb, config, device="cpu", packer=packer)
    want, _, bits = _oracle_file(rgb, config, _specs(rgb, config))
    assert got.file_bytes == want
    assert got.bit_length == bits


@pytest.mark.parametrize("packer", scan.PACKERS)
@pytest.mark.parametrize(
    "config",
    [
        EncoderConfig(fast_dct=True, optimize_huffman=True),
        EncoderConfig(subsampling_ratio=(4, 4, 4), restart_interval=3,
                      dct_algorithm=DctAlgorithm.BIN_DCT,
                      bin_dct_descale=True, optimize_huffman=True),
    ],
    ids=["fast", "descale-444-restart"],
)
def test_optimized_fast_and_descale_code_the_unbroken_coefficients(
    config, packer
):
    """The oracle has no --fast-dct and no descaled binDCT: code the port's
    own Annex-K-scan coefficients with the oracle's bit writer and the
    port's optimal tables instead."""
    rgb = corpus.foliage(64, 96)
    annex_k = dataclasses.replace(config, restart_interval=None,
                                  optimize_huffman=False)
    _, coeffs = pipeline.encode_array(rgb, annex_k, device="cpu",
                                      return_coeffs=True)
    got = pipeline.encode_array(rgb, config, device="cpu", packer=packer)
    want, _, bits = _oracle_file(rgb, config, _specs(rgb, config), coeffs)
    assert got.file_bytes == want
    assert got.bit_length == bits


@pytest.mark.parametrize(
    "config",
    [EncoderConfig(optimize_huffman=True),
     EncoderConfig(quality=85, optimize_huffman=True, restart_interval=2)],
    ids=["optimize", "optimize-restart"],
)
def test_optimized_file_matches_jax_pipeline(config):
    """The JAX package's optimized files on the inputs of
    tests/test_optimize.py."""
    rgb = corpus.portrait(80, 112)
    got = pipeline.encode_array(rgb, config, device="cpu")
    want = jax_pipeline.encode_array(rgb, config)
    assert got.file_bytes == want.file_bytes
    assert got.bit_length == want.bit_length


@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 4, 4)])
def test_optimized_decodes_identically_and_shrinks(ratio):
    """As test_optimize.py: PIL decodes the optimized file to the pixels of
    the Annex-K file, and the scan shrinks."""
    rgb = corpus.landscape(96, 144)
    std = pipeline.encode_array(rgb, EncoderConfig(subsampling_ratio=ratio),
                                device="cpu")
    opt = pipeline.encode_array(
        rgb, EncoderConfig(subsampling_ratio=ratio, optimize_huffman=True),
        device="cpu",
    )
    decode = [np.asarray(Image.open(io.BytesIO(r.file_bytes)).convert("RGB"))
              for r in (std, opt)]
    assert np.array_equal(*decode)
    assert opt.bit_length < std.bit_length
    assert len(opt.file_bytes) < len(std.file_bytes)


def _coeffs(rng, geom, amp=300, sparsity=0.8):
    out = []
    for n in (geom.num_luma_blocks, geom.num_chroma_blocks,
              geom.num_chroma_blocks):
        a = rng.integers(-amp, amp + 1, (n, 64)).astype(np.int16)
        a[:, 4:] = np.where(rng.random(a[:, 4:].shape) < sparsity, 0, a[:, 4:])
        out.append(a)
    return out


@pytest.mark.parametrize("restart", [None, 1, 3])
@pytest.mark.parametrize("ratio", RATIOS)
def test_symbol_histograms_match_jax(ratio, restart, rng):
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(48, 32)
    coeffs = _coeffs(rng, geom)
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs),
                                    geom)
    got = entropy.symbol_histograms(z, geom, restart)
    want = jax_entropy.symbol_histograms(
        *(jnp.asarray(c) for c in coeffs), geom, coeffs_zigzagged=True,
        restart_mcus=restart,
    )
    assert got.shape == (4, 256)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # Every coded slot is counted once: DC and AC codes, ZRLs and EOBs.
    slot_bits, slot_lens = entropy.symbolize(
        z, geom.h_factor * geom.v_factor, entries_per_interval=(
            None if restart is None
            else entropy.entries_per_interval(geom, restart)),
    )
    assert int(got.sum()) == int((slot_lens > 0).sum())


def test_symbol_histograms_init_dc_and_live_entries_match_jax(rng):
    geom = EncoderConfig(subsampling_ratio=(4, 2, 2)).geometry(48, 32)
    coeffs = _coeffs(rng, geom)
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs),
                                    geom)
    init = [40, -7, 3]
    live = geom.num_scan_entries // 2 + 1
    got = entropy.symbol_histograms(
        z, geom, init_dc=torch.tensor(init, dtype=torch.int32),
        live_entries=live,
    )
    want = jax_entropy.symbol_histograms(
        *(jnp.asarray(c) for c in coeffs), geom, coeffs_zigzagged=True,
        init_dc=jnp.asarray(init, jnp.int32), live_entries=jnp.int32(live),
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_custom_tables_match_jax_scan(rng):
    """A histogram dominated by one symbol gives 1-bit codes (entries as
    short as 2 bits, 16 to a word): every packer against the JAX scan
    encoder with the same tables, unbroken and over intervals."""
    geom = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(64, 48)
    coeffs = [np.zeros((n, 64), np.int16) for n in (
        geom.num_luma_blocks, geom.num_chroma_blocks, geom.num_chroma_blocks)]
    coeffs[0][::7, 1] = 3  # a few AC symbols beside the dominant EOB
    coeffs[1][::5, 0] = -2
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs),
                                    geom)
    hist = entropy.symbol_histograms(z, geom).numpy()
    specs, luts = pipeline.optimal_specs_and_luts(hist, "cpu")
    assert min(specs[3].length_lut[specs[3].length_lut > 0]) == 1
    jax_luts = tuple(jnp.asarray(t.numpy()) for t in luts)
    want, want_bits = jax_entropy.encode_scan(
        *(jnp.asarray(c) for c in coeffs), geom, 1024, coeffs_zigzagged=True,
        packer="xla", luts=jax_luts,
    )
    want_r, want_rbits = jax_entropy.encode_scan_restart(
        *(jnp.asarray(c) for c in coeffs), geom, 64, 5, coeffs_zigzagged=True,
        packer="xla", luts=jax_luts,
    )
    assert int(want_bits) < 3 * geom.num_scan_entries
    for packer in scan.PACKERS:
        got, bits = scan.encode_entries(z, geom, 1024, luts=luts,
                                        packer=packer)
        assert int(bits) == int(want_bits)
        assert np.array_equal(got.numpy(), np.asarray(want))
        got, bits = scan.encode_entries(z, geom, 64, restart_mcus=5,
                                        luts=luts, packer=packer)
        assert np.array_equal(bits.numpy(), np.asarray(want_rbits))
        assert np.array_equal(got.numpy(), np.asarray(want_r))


def test_pack_lut_and_optimal_luts_match_jax():
    rgb = corpus.architecture(48, 64)
    config = EncoderConfig(optimize_huffman=True)
    geom = config.geometry(64, 48)
    hist, _ = pipeline.stats_core(torch.from_numpy(rgb), geom,
                                  config.dct_algorithm)
    specs, (dc, ac) = pipeline.optimal_specs_and_luts(hist.numpy(), "cpu")
    want_specs, want_dc, want_ac = jax_pipeline.optimal_specs_and_luts(
        hist.numpy().astype(np.int32)
    )
    assert specs == want_specs
    assert np.array_equal(dc.numpy(), np.asarray(want_dc))
    assert np.array_equal(ac.numpy(), np.asarray(want_ac))
    for spec in specs:
        assert np.array_equal(entropy.pack_lut(spec),
                              jax_entropy.pack_lut(spec))


def test_optimal_specs_refuse_stuffing_slot_symbols():
    """Parity with the JAX package: an AC histogram that counts a zero run
    with size 0 (symbol (bl+1)<<4) is refused."""
    hist = np.zeros((4, 256), np.int64)
    hist[0, 0] = hist[1, 0] = hist[2, 0] = hist[3, 0] = 10
    hist[2, 0x30] = 5
    with pytest.raises(ValueError, match="zero-run with size 0"):
        pipeline.optimal_specs_and_luts(hist, "cpu")
    with pytest.raises(ValueError, match="zero-run with size 0"):
        jax_pipeline.optimal_specs_and_luts(hist)


def test_stats_core_entries_are_the_encode_pass_entries():
    """The optimized encode codes the statistics pass's own entries: the
    scan front half runs once."""
    rgb = corpus.portrait(32, 48)
    config = EncoderConfig()
    geom = config.geometry(48, 32)
    _, z = pipeline.stats_core(torch.from_numpy(rgb), geom,
                               config.dct_algorithm)
    want, _ = pipeline.scan_entries(torch.from_numpy(rgb), geom,
                                    config.dct_algorithm)
    assert torch.equal(z, want)
