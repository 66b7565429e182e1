"""The port's end-to-end encode on CPU vs the JAX package and the oracle.

Whole JFIF files must be byte-identical: jpeg_encoder_torch.pipeline
against jpeg_encoder_tpu.pipeline (run on CPU) and against the oracle,
over every subsampling ratio, the dim % (8 * factor) == 1 quirk
geometries, two quality settings, a forced capacity-ladder retry, binDCT
with and without the descale fix (the oracle has no descale), restart
markers and optimized tables (more in test_torch_restart.py and
test_torch_optimize.py). The
exception is --fast-dct, held to its tolerance: coefficients within max
|diff| 1 of the oracle's exact RealDCT at a mismatch rate of at most 5e-4,
and a decoded picture within 0.5 dB PSNR of the exact encode.
"""

import dataclasses
import io as _io

import numpy as np
import pytest
import torch
from PIL import Image

from jpeg_encoder_tpu import oracle, tables
from jpeg_encoder_tpu import pipeline as jax_pipeline
from jpeg_encoder_tpu.io import bmp, jfif
from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from test_torch_host import jax_config

RATIOS = [(4, 4, 4), (4, 2, 2), (4, 2, 0)]


def _oracle_file(rgb, config):
    golden = oracle.encode_oracle(rgb, jax_config(config))
    return jfif.assemble(golden.geom, golden.entropy_bytes, quality=config.quality), golden


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("size", [(40, 24), (33, 17)])
def test_file_bytes_match_jax_and_oracle(ratio, size, rng):
    width, height = size
    rgb = rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=ratio)
    got = pipeline.encode_array(rgb, config, device="cpu")
    want = jax_pipeline.encode_array(rgb, jax_config(config))
    golden_file, golden = _oracle_file(rgb, config)
    assert got.bit_length == want.bit_length == golden.bit_length
    assert got.file_bytes == want.file_bytes == golden_file
    assert got.entropy_payload == want.entropy_payload


# The JAX package's jitted CPU program is not always bit-exact: XLA:CPU
# contracts the ordered DCT chain into fused multiply-adds inside its
# fusion and flips a coefficient on some inputs (ROADMAP.md, faults
# found). The oracle is ground truth everywhere; the JAX comparisons use
# inputs where the JAX package holds.
@pytest.mark.parametrize("ratio, size", [((4, 2, 0), (33, 17)), ((4, 4, 4), (40, 24))])
def test_quality_matches_jax_and_oracle(ratio, size, rng):
    width, height = size
    rgb = rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=ratio, quality=90)
    got = pipeline.encode_array(rgb, config, device="cpu")
    want = jax_pipeline.encode_array(rgb, jax_config(config))
    golden_file, _ = _oracle_file(rgb, config)
    assert got.file_bytes == want.file_bytes == golden_file


@pytest.mark.parametrize("quality", [None, 90])
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize(
    "size", [(8, 8), (17, 16), (31, 9), (17, 9), (49, 33), (9, 25)]
)
def test_file_bytes_match_oracle(size, ratio, quality, rng):
    width, height = size
    rgb = rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=ratio, quality=quality)
    got = pipeline.encode_array(rgb, config, device="cpu")
    golden_file, golden = _oracle_file(rgb, config)
    assert got.bit_length == golden.bit_length
    assert got.file_bytes == golden_file


def test_capacity_ladder_retry_matches_jax(rng):
    """Starting the ladder at 64 bytes overflows, retries at 8x, and still
    gives the same file as the default rung and as the JAX package."""
    rgb = rng.integers(0, 256, size=(24, 40, 3), dtype=np.uint8)
    config = EncoderConfig()
    geom = config.geometry(40, 24)
    assert pipeline.next_capacity_bytes(geom, 64) == 512
    got = pipeline.encode_array(rgb, config, device="cpu", _initial_capacity_bytes=64)
    assert got.bit_length > 8 * 64
    want = jax_pipeline.encode_array(rgb, jax_config(config),
                                     _initial_capacity_bytes=64)
    assert got.file_bytes == want.file_bytes
    assert got.file_bytes == pipeline.encode_array(rgb, config, device="cpu").file_bytes


def test_capacity_helpers_match_jax():
    for ratio in RATIOS:
        for size in [(8, 8), (1920, 1080), (3840, 2160), (33, 17)]:
            geom = EncoderConfig(subsampling_ratio=ratio).geometry(*size)
            assert pipeline.worst_case_capacity_bytes(geom) == (
                jax_pipeline.worst_case_capacity_bytes(geom)
            )
            for bpp in (0.5, 0.01):
                cap = pipeline.default_capacity_bytes(geom, bpp)
                assert cap == jax_pipeline.default_capacity_bytes(geom, bpp)
                assert pipeline.next_capacity_bytes(geom, cap) == (
                    jax_pipeline.next_capacity_bytes(geom, cap)
                )


def test_return_coeffs_match_jax_and_oracle(rng):
    rgb = rng.integers(0, 256, size=(17, 33, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0), validate=True)
    got, coeffs = pipeline.encode_array(rgb, config, device="cpu", return_coeffs=True)
    want, want_coeffs = jax_pipeline.encode_array(rgb, jax_config(config),
                                                  return_coeffs=True)
    golden = oracle.encode_oracle(rgb, jax_config(config))
    assert got.file_bytes == want.file_bytes
    golden_coeffs = (golden.y_coeffs, golden.cb_coeffs, golden.cr_coeffs)
    for c, w, g in zip(coeffs, want_coeffs, golden_coeffs):
        assert c.dtype == np.int16 and c.shape[1] == 64
        assert np.array_equal(c, np.asarray(w))
        assert np.array_equal(c.reshape(-1, 8, 8), g)


def test_validate_scan_ranges():
    pipeline.validate_scan_ranges(2047, 1023)
    with pytest.raises(ValueError, match="DC"):
        pipeline.validate_scan_ranges(2048, 0)
    with pytest.raises(ValueError, match="AC"):
        pipeline.validate_scan_ranges(0, 1024)


@pytest.mark.parametrize(
    "config",
    [
        EncoderConfig(restart_interval=4),
        EncoderConfig(optimize_huffman=True),
    ],
    ids=["restart_interval", "optimize_huffman"],
)
def test_restart_and_optimize_options_match_oracle(config):
    """The two options the port once refused encode on CPU, byte for byte
    as the oracle: its restart-framed scan, and its bit writer with the
    port's optimal tables."""
    rgb = np.random.default_rng(12).integers(0, 256, (32, 64, 3), np.uint8)
    got = pipeline.encode_array(rgb, config, device="cpu")
    golden = oracle.encode_oracle(rgb, jax_config(EncoderConfig()))
    coeffs = (golden.y_coeffs, golden.cb_coeffs, golden.cr_coeffs)
    if config.restart_interval is not None:
        segments, bits = oracle.entropy_encode_restart(
            *coeffs, golden.geom, config.restart_interval
        )
        assert len(segments) == 2  # 8 MCUs in intervals of 4
        want = jfif.assemble_restart(
            golden.geom, [np.frombuffer(s, np.uint8) for s in segments],
            bits, config.restart_interval,
        )
        assert got.bit_length == sum(bits)
    else:
        geom = golden.geom
        hist, _ = pipeline.stats_core(torch.from_numpy(rgb), geom,
                                      config.dct_algorithm)
        specs, _ = pipeline.optimal_specs_and_luts(hist.numpy(), "cpu")
        writer = oracle.BitWriter()
        zz = [c.reshape(-1, 64)[:, tables.ZIGZAG_ORDER] for c in coeffs]
        prev = [0, 0, 0]
        for mcu, blocks in enumerate(oracle.luma_scan_order(geom)):
            for b in blocks:
                prev[0] = oracle.encode_block(zz[0][b], prev[0], specs[0],
                                              specs[2], writer)
            for c in (1, 2):
                prev[c] = oracle.encode_block(zz[c][mcu], prev[c], specs[1],
                                              specs[3], writer)
        want = jfif.assemble(geom, writer.to_bytes(), dht_specs=specs)
        assert got.bit_length == writer.bit_length < golden.bit_length
    assert got.file_bytes == want


@pytest.mark.parametrize(
    "config",
    [
        EncoderConfig(restart_interval=4),
        EncoderConfig(optimize_huffman=True),
    ],
    ids=["restart_interval", "optimize_huffman"],
)
def test_restart_and_optimize_refuse_return_coeffs(config):
    rgb = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="return_coeffs"):
        pipeline.encode_array(rgb, config, device="cpu", return_coeffs=True)


def test_device_must_be_named():
    """The CPU runs only when named: without a device argument the encode
    goes to the card, and with no card it raises (no fallback)."""
    rgb = np.zeros((16, 16, 3), np.uint8)
    if torch.cuda.is_available():
        assert pipeline.encode_array(rgb).file_bytes == pipeline.encode_array(
            rgb, device="cpu").file_bytes
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            pipeline.encode_array(rgb, EncoderConfig())  # no device argument
    with pytest.raises(ValueError):
        pipeline.encode_array(rgb[..., :2], EncoderConfig(), device="cpu")


def test_encode_file_decodes(tmp_path):
    """BMP file in, JFIF file out; an independent decoder reads it."""
    x = np.linspace(0, 255, 50)[None, :]
    y = np.linspace(0, 255, 30)[:, None]
    rgb = np.stack(
        np.broadcast_arrays((x + y) / 2, np.abs(x - y), 255 - (x + y) / 2), -1
    ).astype(np.uint8)
    src, dst = tmp_path / "in.bmp", tmp_path / "out.jpg"
    bmp.write(src, rgb)
    result = pipeline.encode_file(src, dst, device=torch.device("cpu"))
    assert dst.read_bytes() == result.file_bytes
    img = Image.open(_io.BytesIO(result.file_bytes))
    img.load()
    assert img.size == (50, 30)
    err = np.abs(np.asarray(img, np.float64) - rgb).mean()
    assert err < 16.0  # lossy, but the picture (a scrambled scan is ~80)


BIN_DCT = EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("size", [(40, 24), (33, 17)])
def test_bindct_file_bytes_match_jax_and_oracle(ratio, size, rng):
    width, height = size
    rgb = rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)
    config = dataclasses.replace(BIN_DCT, subsampling_ratio=ratio)
    got = pipeline.encode_array(rgb, config, device="cpu")
    want = jax_pipeline.encode_array(rgb, jax_config(config))
    golden_file, golden = _oracle_file(rgb, config)
    assert got.bit_length == want.bit_length == golden.bit_length
    assert got.file_bytes == want.file_bytes == golden_file


@pytest.mark.parametrize("quality", [None, 90])
@pytest.mark.parametrize("ratio", RATIOS)
def test_bindct_descale_file_bytes_match_jax(ratio, quality, rng):
    """trunc((x * g) / q) has no add for XLA:CPU to contract, so the JAX
    package is exact here and the files must be identical."""
    rgb = rng.integers(0, 256, size=(17, 33, 3), dtype=np.uint8)
    config = dataclasses.replace(BIN_DCT, subsampling_ratio=ratio,
                                 bin_dct_descale=True, quality=quality)
    got, coeffs = pipeline.encode_array(rgb, config, device="cpu",
                                        return_coeffs=True)
    want, want_coeffs = jax_pipeline.encode_array(rgb, jax_config(config),
                                                  return_coeffs=True)
    assert got.file_bytes == want.file_bytes
    for c, w in zip(coeffs, want_coeffs):
        assert np.array_equal(c, np.asarray(w))


@pytest.mark.parametrize("ratio", RATIOS)
def test_fast_dct_coeffs_within_tolerance_of_oracle(ratio, rng):
    rgb = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=ratio, fast_dct=True)
    got, coeffs = pipeline.encode_array(rgb, config, device="cpu",
                                        return_coeffs=True)
    # The oracle's exact RealDCT.
    golden = oracle.encode_oracle(rgb, jax_config(config))
    d = np.concatenate([
        np.abs(c.astype(np.int32) - g.reshape(-1, 64).astype(np.int32))
        for c, g in zip(coeffs, (golden.y_coeffs, golden.cb_coeffs,
                                 golden.cr_coeffs))
    ])
    assert d.max() <= 1
    assert (d > 0).mean() <= 5e-4
    img = Image.open(_io.BytesIO(got.file_bytes))
    img.load()  # raises on a corrupt scan
    assert img.size == (64, 48)


def _psnr(rgb, file_bytes):
    decoded = np.asarray(Image.open(_io.BytesIO(file_bytes)).convert("RGB"))
    mse = np.mean((decoded.astype(np.float64) - rgb.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def test_fast_dct_decodes_at_exact_quality():
    """As the JAX package's test_fast_dct_pipeline_decodes_and_matches_
    exact_quality: a smooth gradient, decoded by PIL, within 0.5 dB of the
    exact encode."""
    x = np.linspace(0, 255, 64)[None, :]
    y = np.linspace(0, 255, 48)[:, None]
    rgb = np.stack(
        np.broadcast_arrays((x + y) / 2, np.abs(x - y), 255 - (x + y) / 2), -1
    ).astype(np.uint8)
    exact = pipeline.encode_array(rgb, EncoderConfig(), device="cpu")
    fast = pipeline.encode_array(rgb, EncoderConfig(fast_dct=True), device="cpu")
    assert abs(_psnr(rgb, fast.file_bytes) - _psnr(rgb, exact.file_bytes)) < 0.5


@pytest.mark.parametrize(
    "config",
    [
        dataclasses.replace(BIN_DCT, fast_dct=True),   # fast_dct ignored
        EncoderConfig(bin_dct_descale=True),            # descale ignored
    ],
    ids=["bin-dct+fast_dct", "real-dct+descale"],
)
def test_ignored_flags_match_jax(config):
    """The JAX dispatch ignores fast_dct under binDCT and bin_dct_descale
    under RealDCT; so does the port, byte for byte."""
    rgb = np.random.default_rng(5).integers(0, 256, (24, 40, 3), np.uint8)
    got = pipeline.encode_array(rgb, config, device="cpu")
    want = jax_pipeline.encode_array(rgb, jax_config(config))
    assert got.file_bytes == want.file_bytes
    plain = dataclasses.replace(config, fast_dct=False, bin_dct_descale=False)
    assert got.file_bytes == pipeline.encode_array(rgb, plain, device="cpu").file_bytes


def test_bindct_checkerboard_leaves_the_scan_range():
    """A pixel checkerboard at 4:4:4, binDCT, quality 100: AC sizes reach
    11-13 bits, which have no Annex-K code (code length 0). Without
    validate the port writes the JAX package's bytes; with it, it raises
    as the reference (and the oracle) do."""
    yy, xx = np.mgrid[0:32, 0:32]
    board = (((xx + yy) % 2) * 255).astype(np.uint8)
    rgb = np.repeat(board[..., None], 3, axis=-1)
    config = dataclasses.replace(BIN_DCT, subsampling_ratio=(4, 4, 4),
                                 quality=100)
    got, coeffs = pipeline.encode_array(rgb, config, device="cpu",
                                        return_coeffs=True)
    want = jax_pipeline.encode_array(rgb, jax_config(config))
    assert max(int(np.abs(c.astype(np.int32)).max()) for c in coeffs) >= 1 << 10
    assert got.bit_length == want.bit_length == 6032
    assert got.file_bytes == want.file_bytes
    checked = dataclasses.replace(config, validate=True)
    with pytest.raises(ValueError, match="AC coefficient bit length"):
        pipeline.encode_array(rgb, checked, device="cpu")
    with pytest.raises(ValueError, match="AC coefficient bit length"):
        oracle.encode_oracle(rgb, jax_config(config))
