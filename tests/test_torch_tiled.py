"""Band tiling in the port: jpeg_encoder_torch.parallel.tiled on the CPU.

encode_tiled(rgb, config, bands, device="cpu") must give the port's
encode_array file byte for byte at 2, 3, 4 and 8 bands, on even and uneven
splits, with restart markers (including the aligned-split search and its
fallback), with optimized tables, with both, and when one band overflows
the shared capacity (only that band is re-coded). The pieces under it are
held to the JAX package: the bit splice (utils/bits.py), final_dc, and the
plain coder's per-row init_dc against a chain of single-row codes. A few
cases compare the files with the JAX package's encode_tiled on its 8-device
virtual CPU mesh (each compiles a shard_map program: keep them few), and
one with the oracle.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_encoder_tpu.ops import entropy as jax_entropy
from jpeg_encoder_tpu.parallel import mesh as jax_mesh
from jpeg_encoder_tpu.parallel import tiled as jax_tiled
from jpeg_encoder_tpu.utils import bits as jax_bits
from jpeg_encoder_torch import native, oracle, pipeline
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_torch.io import jfif
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops
from jpeg_encoder_torch.parallel import tiled
from jpeg_encoder_torch.utils import bits, corpus
from test_torch_host import jax_config


def _image(height, width, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (height, width, 3),
                                                dtype=np.uint8)


def _single(rgb, config):
    return pipeline.encode_array(rgb, config, device="cpu")


def _tiled(rgb, config, bands):
    return tiled.encode_tiled(rgb, config, bands, device="cpu")


def _no_warning(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return fn(*args)


# -- the splice -------------------------------------------------------------

def _random_chunks(rng, count=17, longest=40):
    """(chunks, their bit string joined) for splice_bitstreams."""
    chunks, stream = [], ""
    for _ in range(count):
        nbits = int(rng.integers(0, longest))
        text = "".join(rng.choice(["0", "1"], size=nbits))
        stream += text
        nbytes = (nbits + 7) // 8
        arr = np.frombuffer(
            int(text.ljust(nbytes * 8, "0") or "0", 2).to_bytes(
                max(nbytes, 1), "big"), np.uint8)[:nbytes]
        chunks.append((arr, nbits))
    return chunks, stream


@pytest.mark.parametrize("native_lib", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("seed", range(4))
def test_splice_matches_jax_on_random_chunks(seed, native_lib, monkeypatch):
    if not native_lib:
        monkeypatch.setattr(native, "load", lambda: None)
    rng = np.random.default_rng(seed)
    chunks, stream = _random_chunks(rng, longest=[40, 9, 200, 3000][seed])
    out, total = bits.splice_bitstreams(chunks)
    assert (out, total) == jax_bits.splice_bitstreams(chunks)
    nbytes = (len(stream) + 7) // 8
    want = (int(stream.ljust(nbytes * 8, "0"), 2).to_bytes(nbytes, "big")
            if stream else b"")
    assert total == len(stream) and out == want


def test_splice_refuses_short_chunks():
    with pytest.raises(ValueError, match="holds only"):
        bits.splice_bitstreams([(np.zeros(1, np.uint8), 9)])
    with pytest.raises(ValueError, match="negative"):
        bits.splice_bitstreams([(np.zeros(1, np.uint8), -1)])


# -- per-row predictors -----------------------------------------------------

@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 4, 4)])
def test_final_dc_matches_jax(ratio):
    """final_dc over stacked bands == the JAX package's, band by band, and
    == the final DCs the band path reads from the stack's entries."""
    config = EncoderConfig(subsampling_ratio=ratio)
    geom = config.geometry(40, 32)
    stack = torch.from_numpy(_image(4 * 32, 40, seed=3).reshape(4, 32, 40, 3))
    z, coeffs = pipeline.scan_entries(stack, geom, config.dct_algorithm,
                                      with_coeffs=True)
    got = entropy_ops.final_dc(*coeffs, geom)
    entries, _ = pipeline.scan_entries(stack, geom, config.dct_algorithm)
    assert torch.equal(entries, z)
    assert torch.equal(entropy_ops.final_dc_of_entries(entries, geom), got)
    ny, nc = geom.num_luma_blocks, geom.num_chroma_blocks
    for b in range(4):
        want = jax_entropy.final_dc(
            jnp.asarray(coeffs[0][b * ny:(b + 1) * ny].numpy()),
            jnp.asarray(coeffs[1][b * nc:(b + 1) * nc].numpy()),
            jnp.asarray(coeffs[2][b * nc:(b + 1) * nc].numpy()), geom)
        assert got[b].tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 2, 2), (4, 4, 4)])
def test_per_row_init_dc_matches_a_chain_of_single_rows(ratio):
    """The plain coder with an (n_rows, 3) init_dc == each row coded alone
    from its own (3,) init_dc; a live count ending mid-stack silences the
    rest, and the statistics pass counts the same symbols."""
    config = EncoderConfig(subsampling_ratio=ratio)
    geom = config.geometry(48, 48)
    z, _ = pipeline.scan_entries(torch.from_numpy(_image(48, 48, seed=7)),
                                 geom, config.dct_algorithm)
    epi = geom.mcu_cols * geom.blocks_per_mcu  # one MCU row a row
    n_rows = geom.num_scan_entries // epi
    init = torch.from_numpy(
        np.random.default_rng(1).integers(-300, 300, (n_rows, 3))
    ).to(torch.int32)
    live = geom.num_scan_entries - epi // 2 - geom.blocks_per_mcu
    data, row_bits = entropy_kernel.encode_entries(
        z, geom, 4096, init, live_entries=live, entries_per_interval=epi)
    row_geom = config.geometry(48, 8 * geom.v_factor)
    assert row_geom.num_scan_entries == epi
    hist = torch.zeros((4, 256), dtype=torch.int64)
    for r in range(n_rows):
        row_live = min(max(live - r * epi, 0), epi)
        want, want_bits = entropy_kernel.encode_entries(
            z[r * epi:(r + 1) * epi], row_geom, 4096, init[r],
            live_entries=row_live)
        assert int(row_bits[r]) == int(want_bits), r
        assert torch.equal(data[r], want), r
        hist += entropy_ops.symbol_histograms(
            z[r * epi:(r + 1) * epi], row_geom, init_dc=init[r],
            live_entries=row_live)
    assert torch.equal(hist, entropy_ops.symbol_histograms(
        z, geom, geom.mcu_cols, init, live_entries=live))


def test_kernel_wrapper_takes_one_init_dc_a_row():
    geom = EncoderConfig().geometry(32, 32)  # 4 MCUs of 6 entries
    z = torch.zeros((geom.num_scan_entries, 64), dtype=torch.int16)
    for shape in ((3,), (3, 3), (4, 2)):
        with pytest.raises(ValueError, match="init_dc"):
            entropy_kernel.encode_entries(
                z, geom, 64, torch.zeros(shape, dtype=torch.int32),
                entries_per_interval=6)
    z[:, 0] = 5
    _, per_row = entropy_kernel.encode_entries(
        z, geom, 64, torch.full((4, 3), 5, dtype=torch.int32),
        entries_per_interval=6)
    _, reset = entropy_kernel.encode_entries(z, geom, 64,
                                             entries_per_interval=6)
    assert (per_row < reset).all()  # every first DC difference is now 0


# -- encode_tiled against encode_array --------------------------------------

@pytest.mark.parametrize("bands", [2, 3, 4, 8])
@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 2, 2), (4, 4, 4)])
def test_tiled_matches_encode_array(ratio, bands):
    rgb = _image(128, 48, seed=bands)
    config = EncoderConfig(subsampling_ratio=ratio)
    got = _no_warning(_tiled, rgb, config, bands)
    want = _single(rgb, config)
    assert got.file_bytes == want.file_bytes
    assert got.bit_length == want.bit_length
    assert got.entropy_payload == want.entropy_payload


@pytest.mark.parametrize(
    "height,ratio",
    [(48, (4, 2, 0)),   # 3 MCU rows over 8 bands: 5 dead bands
     (72, (4, 4, 4)),   # 9 MCU rows: 2-row bands, band 4 partial
     (121, (4, 2, 0))],  # 121 rows pad to 128: the last band's rows masked
)
def test_tiled_uneven_bands(height, ratio):
    rgb = _image(height, 32, seed=height)
    config = EncoderConfig(subsampling_ratio=ratio)
    got = _tiled(rgb, config, 8)
    assert got.file_bytes == _single(rgb, config).file_bytes
    if height == 121:
        golden = oracle.encode_oracle(rgb, config)
        assert got.file_bytes == jfif.assemble(golden.geom,
                                               golden.entropy_bytes)


@pytest.mark.parametrize("config", [
    EncoderConfig(quality=90),
    EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT, bin_dct_descale=True),
    EncoderConfig(fast_dct=True),
], ids=["quality90", "bindct-descale", "fast-dct"])
def test_tiled_every_dct_variant(config):
    rgb = corpus.landscape(64, 80)
    assert _tiled(rgb, config, 4).file_bytes == _single(rgb, config).file_bytes


def test_tiled_quirk_width_falls_back():
    """width % 16 == 1 at 4:2:0: one-piece encode, with the warning."""
    rgb = _image(128, 17, seed=2)
    config = EncoderConfig()
    with pytest.warns(RuntimeWarning, match="quirk"):
        got = _tiled(rgb, config, 8)
    assert got.file_bytes == _single(rgb, config).file_bytes


def test_tiled_refuses_bad_operands():
    with pytest.raises(ValueError, match="bands"):
        _tiled(_image(16, 16), EncoderConfig(), 0)
    with pytest.raises(ValueError, match="quirk geometry"):
        _tiled(_image(17, 33), EncoderConfig(restart_interval=2), 2)


def _noisy_band_image(rng_seed=0):
    """256 rows = 16 MCU rows at 4:2:0, 8 bands of 32 rows; band 3 (rows
    96-128) noise, the rest a horizontal gradient: the noise band's ~180
    kbit clears the 16384-byte capacity floor, each gradient band stays far
    under it."""
    height, width = 256, 2560
    x = np.linspace(0, 255, width)[None, :, None]
    rgb = np.broadcast_to(x, (height, width, 3)).astype(np.uint8).copy()
    rgb[96:128] = _image(32, width, seed=rng_seed)
    return rgb


@pytest.mark.parametrize("restart", [None, 160])
def test_tiled_overflow_retries_only_the_noisy_band(restart, monkeypatch):
    rgb = _noisy_band_image()
    config = EncoderConfig(capacity_bytes_per_pixel=0.04,
                           restart_interval=restart)
    name = "_retry_band" if restart is None else "_retry_band_restart"
    retried = []
    real = getattr(tiled, name)

    def spy(z, geom, band_rows, idx, *args):
        retried.append(idx)
        return real(z, geom, band_rows, idx, *args)

    monkeypatch.setattr(tiled, name, spy)
    got = _tiled(rgb, config, 8)
    monkeypatch.undo()
    assert retried == [3]
    assert got.file_bytes == _single(rgb, config).file_bytes


# -- restart markers --------------------------------------------------------

def test_restart_tiled_matches_single():
    """Intervals aligned to band boundaries: the same partition, DC resets
    at each interval, the same concatenation; and 8 bands over 6 MCU rows
    (trailing dead bands' intervals drop)."""
    rgb = _image(96, 64, seed=13)  # 4:2:0: 6 MCU rows x 4 cols
    for bands, interval in ((2, 4), (3, 2), (4, 1), (8, 4)):
        config = EncoderConfig(restart_interval=interval)
        got = _no_warning(_tiled, rgb, config, bands)
        want = _single(rgb, config)
        assert got.file_bytes == want.file_bytes, (bands, interval)
        assert got.bit_length == want.bit_length
        assert got.entropy_payload == want.entropy_payload


def test_restart_tiled_auto_aligns_band_split():
    """6x4 MCUs in 2 bands with interval 5: 5-row bands (20 MCUs, 4 whole
    intervals), the last band ends mid-interval; no warning."""
    rgb = _image(96, 64, seed=15)
    config = EncoderConfig(restart_interval=5)
    geom = config.geometry(64, 96)
    assert tiled._aligned_band_rows(geom, 2, 5) == 5
    got = _no_warning(_tiled, rgb, config, 2)
    assert got.file_bytes == _single(rgb, config).file_bytes


def test_restart_tiled_alignment_matrix():
    """Band count x interval: every cell auto-aligns (no warning) or, only
    when no aligned multi-band split exists, falls back with the warning;
    byte-identical either way."""
    rgb = _image(96, 64, seed=16)  # 24 MCUs
    geom = EncoderConfig().geometry(64, 96)
    fallbacks = 0
    for bands in (2, 3, 4):
        for interval in (1, 2, 3, 5, 7, 8, 11, 24):
            config = EncoderConfig(restart_interval=interval)
            base = -(-geom.mcu_rows // bands)
            aligned = tiled._aligned_band_rows(geom, bands, interval)
            has_aligned = (
                (base * geom.mcu_cols) % interval == 0
                or -(-geom.mcu_rows // base) == 1
                or (aligned is not None and -(-geom.mcu_rows // aligned) > 1)
            )
            if has_aligned:
                got = _no_warning(_tiled, rgb, config, bands)
            else:
                with pytest.warns(RuntimeWarning, match="no band split"):
                    got = _tiled(rgb, config, bands)
                fallbacks += 1
            assert got.file_bytes == _single(rgb, config).file_bytes, (
                bands, interval)
    assert fallbacks >= 1


# -- optimized Huffman ------------------------------------------------------

@pytest.mark.parametrize("bands", [2, 3, 8])
def test_optimized_tiled_matches_single(bands):
    """One table set from every band's statistics (chained predictors,
    dead bands masked) reproduces the one-piece optimized file."""
    rgb = corpus.landscape(96, 64)
    config = EncoderConfig(optimize_huffman=True)
    got = _tiled(rgb, config, bands)
    want = _single(rgb, config)
    assert got.file_bytes == want.file_bytes
    assert got.bit_length == want.bit_length


@pytest.mark.parametrize("bands", [2, 8])
def test_optimized_tiled_restart_matches_single(bands):
    """Tiling + restart + optimize; at 8 bands over 6 MCU rows two bands
    are dead and every band is one interval."""
    rgb = corpus.foliage(96, 64)
    config = EncoderConfig(optimize_huffman=True, restart_interval=4)
    got = _no_warning(_tiled, rgb, config, bands)
    assert got.file_bytes == _single(rgb, config).file_bytes
    assert b"\xff\xd0" in got.file_bytes


# -- against the JAX package ------------------------------------------------

@pytest.mark.parametrize(
    "content,height,width,config,bands",
    [("noise", 128, 48, EncoderConfig(), 8),
     ("noise", 72, 32, EncoderConfig(subsampling_ratio=(4, 4, 4)), 8),
     ("landscape", 96, 64, EncoderConfig(restart_interval=5), 2),
     ("portrait", 96, 64, EncoderConfig(optimize_huffman=True), 3)],
    ids=["even-8", "uneven-444-8", "restart5-2", "optimize-3"],
)
def test_tiled_matches_jax_tiled(content, height, width, config, bands, rng):
    """Inputs on which the JAX package's jitted CPU program is exact (its
    96x64 file of the seeded noise is not: ROADMAP section 3, fault 2)."""
    rgb = (rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)
           if content == "noise" else corpus.CORPUS[content](height, width))
    want = jax_tiled.encode_tiled(rgb, jax_config(config),
                                  jax_mesh.data_mesh(bands))
    got = _tiled(rgb, config, bands)
    assert got.file_bytes == want.file_bytes
    assert got.bit_length == want.bit_length
