"""The port's own host modules against the JAX package's.

jpeg_encoder_torch keeps its own copies of jpeg_encoder_tpu's JAX-free host
modules (config, tables, io.bmp, io.jfif, native, utils.bits, utils.corpus,
oracle): the port imports nothing of jpeg_encoder_tpu. These tests hold each
copy equal to its original: the tables bit for bit, optimal Huffman tables
on seeded histograms, the frame geometry over a fuzz of sizes and ratios
(the quirk geometries included), JFIF headers and files, BMP bytes, the bit
splice (native and NumPy), the oracle's files. They also hold the refusal of a foreign config: DctAlgorithm is an
Enum compared by identity, so a jpeg_encoder_tpu config would route RealDCT
to binDCT in the port.

jax_config builds the JAX package's config from a port config's fields;
the other tests that compare the two packages import it from here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jpeg_encoder_tpu import config as jax_cfg
from jpeg_encoder_tpu import oracle as jax_oracle
from jpeg_encoder_tpu import tables as jax_tables
from jpeg_encoder_tpu.io import bmp as jax_bmp
from jpeg_encoder_tpu.io import jfif as jax_jfif
from jpeg_encoder_tpu.utils import bits as jax_bits
from jpeg_encoder_tpu.utils import corpus as jax_corpus
from jpeg_encoder_torch import native, oracle, pipeline, tables
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_torch.io import bmp, jfif
from jpeg_encoder_torch.parallel import batch
from jpeg_encoder_torch.utils import bits, corpus

RATIOS = [(4, 4, 4), (4, 2, 2), (4, 2, 0)]


def jax_config(config: EncoderConfig) -> jax_cfg.EncoderConfig:
    """The JAX package's EncoderConfig with the same fields as `config`."""
    fields = {f.name: getattr(config, f.name)
              for f in dataclasses.fields(config)}
    fields["dct_algorithm"] = jax_cfg.DctAlgorithm(config.dct_algorithm.value)
    return jax_cfg.EncoderConfig(**fields)


def _same_spec(a, b) -> bool:
    return (a.bits, a.symbols) == (b.bits, b.symbols) and np.array_equal(
        a.code_lut, b.code_lut) and np.array_equal(a.length_lut, b.length_lut)


@pytest.mark.parametrize("quality", [None, 1, 25, 50, 90, 100])
def test_quant_tables_match_jax(quality):
    for got, want in zip(tables.scaled_quant_tables(quality),
                         jax_tables.scaled_quant_tables(quality)):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


def test_huffman_tables_and_zigzag_match_jax():
    for name in ("ZIGZAG_ORDER", "ZIGZAG_INVERSE", "Y_QUANT_TABLE",
                 "C_QUANT_TABLE", "DC_CODE_LUT", "DC_LEN_LUT", "AC_CODE_LUT",
                 "AC_LEN_LUT"):
        got, want = getattr(tables, name), getattr(jax_tables, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("Y_DC_HUFFMAN", "C_DC_HUFFMAN", "Y_AC_HUFFMAN",
                 "C_AC_HUFFMAN"):
        assert _same_spec(getattr(tables, name), getattr(jax_tables, name))


@pytest.mark.parametrize("seed", range(6))
def test_optimal_spec_matches_jax(seed):
    """Seeded random histograms: sparse and dense, skewed and flat, one
    that forces the BITS adjustment past 16 bits (seed 5)."""
    rng = np.random.default_rng(seed)
    freq = np.zeros(256, np.int64)
    n = [12, 162, 3, 256, 1, 256][seed]
    idx = rng.choice(256, n, replace=False)
    if seed == 5:  # Fibonacci counts: a code tree deeper than 16
        fib = [1, 1]
        while len(fib) < 30:
            fib.append(fib[-1] + fib[-2])
        freq[idx] = 1
        freq[idx[:30]] = fib
    else:
        freq[idx] = rng.integers(1, 10_000, n) ** rng.integers(1, 3)
    assert _same_spec(tables.optimal_spec(freq), jax_tables.optimal_spec(freq))


def test_native_runtime_builds_into_the_port():
    """The port's native runtime is its own library, built from its own
    copy of host_runtime.cpp into jpeg_encoder_torch/_build/."""
    lib = native.load()
    if lib is None:
        pytest.skip("no C++ compiler: the NumPy fallbacks run instead")
    assert "jpeg_encoder_torch/_build/" in lib._name
    payload = np.array([0xFF, 1, 0xFF, 0xFF, 0, 7], np.uint8)
    assert jfif.stuff_bytes(payload) == jax_jfif.stuff_bytes(payload) == bytes(
        [0xFF, 0, 1, 0xFF, 0, 0xFF, 0, 0, 7])


@pytest.mark.parametrize("ratio", RATIOS)
def test_frame_geometry_matches_jax(ratio):
    """Every field and property over a fuzz of sizes, the dim % (8 *
    factor) == 1 quirk geometries among them."""
    rng = np.random.default_rng(sum(ratio))
    sizes = [(1, 1), (17, 9), (33, 17), (1921, 1089), (1920, 1080),
             (65535, 8)] + [tuple(s) for s in rng.integers(1, 3000, (40, 2))]
    props = [name for name, v in vars(jax_cfg.FrameGeometry).items()
             if isinstance(v, property)]
    assert len(props) >= 15
    for width, height in sizes:
        got = EncoderConfig(subsampling_ratio=ratio).geometry(width, height)
        want = jax_cfg.EncoderConfig(subsampling_ratio=ratio).geometry(
            width, height)
        for name in props + [f.name for f in dataclasses.fields(want)]:
            assert getattr(got, name) == getattr(want, name), (width, height,
                                                               name)


def test_encoder_config_matches_jax():
    """The same fields, defaults and refusals; jax_config keeps every
    field."""
    assert [f.name for f in dataclasses.fields(EncoderConfig)] == [
        f.name for f in dataclasses.fields(jax_cfg.EncoderConfig)]
    assert [a.value for a in DctAlgorithm] == [
        a.value for a in jax_cfg.DctAlgorithm]
    config = EncoderConfig(subsampling_ratio=(4, 2, 2), quality=70,
                           dct_algorithm=DctAlgorithm.BIN_DCT,
                           restart_interval=9, optimize_huffman=True)
    assert jax_config(config) == jax_cfg.EncoderConfig(
        subsampling_ratio=(4, 2, 2), quality=70,
        dct_algorithm=jax_cfg.DctAlgorithm.BIN_DCT, restart_interval=9,
        optimize_huffman=True)
    assert jax_config(EncoderConfig()) == jax_cfg.EncoderConfig()
    for bad in (dict(quality=0), dict(restart_interval=65536)):
        with pytest.raises(ValueError):
            EncoderConfig(**bad)
    assert DctAlgorithm.REAL_DCT != jax_cfg.DctAlgorithm.REAL_DCT


@pytest.mark.parametrize("restart", [None, 3])
@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("quality", [None, 80])
def test_jfif_bytes_match_jax(quality, optimized, restart):
    rng = np.random.default_rng(9)
    geom = EncoderConfig(subsampling_ratio=(4, 2, 2)).geometry(33, 17)
    specs = jax_specs = None
    if optimized:
        hists = rng.integers(0, 50, (4, 256))
        specs = tuple(tables.optimal_spec(h) for h in hists)
        jax_specs = tuple(jax_tables.optimal_spec(h) for h in hists)
    assert jfif.header_bytes(geom, quality, restart, specs) == (
        jax_jfif.header_bytes(geom, quality, restart, jax_specs))
    if restart is None:
        payload = rng.integers(0, 256, 301, dtype=np.uint8)
        payload[::7] = 0xFF
        assert jfif.assemble(geom, payload, quality, specs) == (
            jax_jfif.assemble(geom, payload, quality, jax_specs))
    else:
        segments = [rng.integers(0, 256, n, dtype=np.uint8)
                    for n in (40, 17, 1)]
        bits = [317, 129, 0]
        assert jfif.assemble_restart(geom, segments, bits, restart, quality,
                                     specs) == jax_jfif.assemble_restart(
            geom, segments, bits, restart, quality, jax_specs)


@pytest.mark.parametrize("size", [(1, 1), (33, 17), (64, 48), (517, 3)])
def test_bmp_round_trip_matches_jax(size, tmp_path):
    width, height = size
    rgb = np.random.default_rng(width).integers(0, 256, (height, width, 3),
                                                np.uint8)
    data = bmp.encode(rgb)
    assert data == jax_bmp.encode(rgb)
    path = tmp_path / "x.bmp"
    bmp.write(path, rgb)
    assert path.read_bytes() == data
    assert np.array_equal(bmp.read(path), rgb)
    assert np.array_equal(jax_bmp.read(path), rgb)
    assert np.array_equal(bmp.decode(data), rgb)


@pytest.mark.parametrize("native_lib", [True, False], ids=["native", "numpy"])
def test_splice_bitstreams_matches_jax(native_lib, monkeypatch):
    """utils/bits.py, the band path's bit-level splice: "10110" + "01" +
    "111111111", then chunks of 0 to 70 bits from a seeded generator."""
    if not native_lib:
        monkeypatch.setattr(native, "load", lambda: None)
    a = np.array([0b10110000], np.uint8)
    b = np.array([0b01000000], np.uint8)
    c = np.array([0b11111111, 0b10000000], np.uint8)
    assert bits.splice_bitstreams([(a, 5), (b, 2), (c, 9)]) == (
        bytes([0b10110011, 0b11111111]), 16)
    rng = np.random.default_rng(4)
    chunks = []
    for n in rng.integers(0, 71, 25):
        arr = rng.integers(0, 256, (int(n) + 7) // 8, dtype=np.uint8)
        if n % 8:
            arr[-1] &= (0xFF << (8 - n % 8)) & 0xFF
        chunks.append((arr, int(n)))
    assert bits.splice_bitstreams(chunks) == jax_bits.splice_bitstreams(chunks)


def test_corpus_matches_jax():
    for name, fn in corpus.CORPUS.items():
        assert np.array_equal(fn(40, 56), jax_corpus.CORPUS[name](40, 56)), name


@pytest.mark.parametrize(
    "config",
    [EncoderConfig(), EncoderConfig(subsampling_ratio=(4, 2, 2), quality=90),
     EncoderConfig(subsampling_ratio=(4, 4, 4),
                   dct_algorithm=DctAlgorithm.BIN_DCT)],
    ids=["default", "422-q90", "444-bindct"],
)
@pytest.mark.parametrize("size", [(40, 24), (33, 17)])
def test_oracle_matches_jax(config, size):
    width, height = size
    rgb = np.random.default_rng(width).integers(0, 256, (height, width, 3),
                                                np.uint8)
    got = oracle.encode_oracle(rgb, config)
    want = jax_oracle.encode_oracle(rgb, jax_config(config))
    assert got.entropy_bytes == want.entropy_bytes
    assert got.bit_length == want.bit_length
    for name in ("y_coeffs", "cb_coeffs", "cr_coeffs"):
        assert np.array_equal(getattr(got, name), getattr(want, name))
    assert np.array_equal(oracle.luma_scan_order(got.geom),
                          jax_oracle.luma_scan_order(want.geom))


def test_entry_points_refuse_a_foreign_config(tmp_path):
    """A jpeg_encoder_tpu config is refused, never routed: its REAL_DCT is
    not the port's."""
    rgb = np.zeros((16, 16, 3), np.uint8)
    foreign = jax_cfg.EncoderConfig()
    with pytest.raises(TypeError, match="jpeg_encoder_torch"):
        pipeline.encode_array(rgb, foreign, device="cpu")
    src = tmp_path / "in.bmp"
    bmp.write(src, rgb)
    with pytest.raises(TypeError, match="jpeg_encoder_torch"):
        pipeline.encode_file(src, tmp_path / "out.jpg", foreign, device="cpu")
    with pytest.raises(TypeError, match="jpeg_encoder_torch"):
        batch.encode_batch(rgb[None], foreign, device="cpu")
    assert not (tmp_path / "out.jpg").exists()


def test_entry_points_default_to_the_card(tmp_path):
    """Without a device argument the encode runs on "cuda"; with no card it
    raises rather than fall back to the CPU."""
    rgb = np.random.default_rng(1).integers(0, 256, (16, 24, 3), np.uint8)
    src = tmp_path / "in.bmp"
    bmp.write(src, rgb)
    calls = (lambda: pipeline.encode_array(rgb).file_bytes,
             lambda: pipeline.encode_file(src, tmp_path / "o.jpg").file_bytes,
             lambda: batch.encode_batch(rgb[None])[0])
    want = pipeline.encode_array(rgb, device="cpu").file_bytes
    for call in calls:
        if torch.cuda.is_available():
            assert call() == want
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
