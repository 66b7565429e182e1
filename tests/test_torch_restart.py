"""Restart markers in the port, on CPU, vs the oracle and the JAX package.

Files are held byte for byte to the NumPy oracle's restart-framed scan
(oracle.entropy_encode_restart + jfif.assemble_restart), as
tests/test_restart.py holds the JAX package; the scan encoder over
intervals (every packer), the interval DC resets and live_entries are held
to jpeg_encoder_tpu.ops.entropy's XLA path. Every comparison is exact.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jpeg_encoder_tpu import oracle
from jpeg_encoder_tpu import pipeline as jax_pipeline
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_tpu.io import jfif
from jpeg_encoder_tpu.ops import entropy as jax_entropy
from jpeg_encoder_torch import pipeline, scan
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.ops import entropy

RATIOS = [(4, 2, 0), (4, 2, 2), (4, 4, 4)]


def _image(h=40, w=48, seed=50):
    rng = np.random.default_rng(seed)
    return rng.normal(128, 40, (h, w, 3)).clip(0, 255).astype(np.uint8)


def _oracle_restart(rgb, config, interval):
    ref = oracle.encode_oracle(rgb, config)
    segments, bits = oracle.entropy_encode_restart(
        ref.y_coeffs, ref.cb_coeffs, ref.cr_coeffs, ref.geom, interval
    )
    file_bytes = jfif.assemble_restart(
        ref.geom, [np.frombuffer(s, np.uint8) for s in segments], bits,
        interval, quality=config.quality,
    )
    return file_bytes, segments, bits


def _coeffs(rng, geom, amp=300, sparsity=0.8):
    """Random zigzag-order coefficients [Y, Cb, Cr]."""
    out = []
    for n in (geom.num_luma_blocks, geom.num_chroma_blocks,
              geom.num_chroma_blocks):
        a = rng.integers(-amp, amp + 1, (n, 64)).astype(np.int16)
        a[:, 4:] = np.where(rng.random(a[:, 4:].shape) < sparsity, 0, a[:, 4:])
        out.append(a)
    return out


@pytest.mark.parametrize("interval", [1, 3, 7, 10000])
@pytest.mark.parametrize("ratio", RATIOS)
def test_restart_file_byte_identical_to_oracle(ratio, interval):
    """As test_restart.py::test_restart_full_file_byte_identical_to_oracle:
    file, unstuffed payload and bit length. 10000 MCUs is past the image:
    one interval, a DRI segment and no RSTn marker."""
    rgb = _image()
    config = EncoderConfig(subsampling_ratio=ratio, restart_interval=interval)
    got = pipeline.encode_array(rgb, config, device="cpu")
    want, segments, bits = _oracle_restart(
        rgb, EncoderConfig(subsampling_ratio=ratio), interval
    )
    assert got.file_bytes == want
    assert got.entropy_payload == b"".join(segments)
    assert got.bit_length == sum(bits)
    assert (b"\xff\xdd" + (4).to_bytes(2, "big")
            + interval.to_bytes(2, "big")) in got.file_bytes


@pytest.mark.parametrize("packer", scan.PACKERS)
@pytest.mark.parametrize(
    "config",
    [
        EncoderConfig(subsampling_ratio=(4, 2, 0), restart_interval=3,
                      quality=90),
        EncoderConfig(subsampling_ratio=(4, 2, 2), restart_interval=2,
                      dct_algorithm=DctAlgorithm.BIN_DCT),
        EncoderConfig(subsampling_ratio=(4, 4, 4), restart_interval=5,
                      dct_algorithm=DctAlgorithm.BIN_DCT),
    ],
    ids=["real-q90-420", "bin-422", "bin-444"],
)
def test_restart_every_packer_and_dct_matches_oracle(config, packer):
    rgb = _image(48, 64, seed=7)
    got = pipeline.encode_array(rgb, config, device="cpu", packer=packer)
    base = EncoderConfig(subsampling_ratio=config.subsampling_ratio,
                         quality=config.quality,
                         dct_algorithm=config.dct_algorithm)
    want, _, bits = _oracle_restart(rgb, base, config.restart_interval)
    assert got.file_bytes == want
    assert got.bit_length == sum(bits)


@pytest.mark.parametrize("packer", scan.PACKERS)
@pytest.mark.parametrize(
    "config",
    [
        EncoderConfig(subsampling_ratio=(4, 2, 0), restart_interval=3,
                      fast_dct=True),
        EncoderConfig(subsampling_ratio=(4, 2, 2), restart_interval=2,
                      dct_algorithm=DctAlgorithm.BIN_DCT, bin_dct_descale=True),
        EncoderConfig(subsampling_ratio=(4, 4, 4), restart_interval=5,
                      quality=90, fast_dct=True),
    ],
    ids=["fast-420", "descale-422", "fast-444-q90"],
)
def test_restart_fast_and_descale_frame_the_unbroken_coefficients(
    config, packer
):
    """The oracle has no --fast-dct and no descaled binDCT: frame the
    port's own unbroken-scan coefficients with the oracle's restart coder
    instead. The file must be that framing, byte for byte."""
    rgb = _image(48, 64, seed=11)
    unbroken = dataclasses.replace(config, restart_interval=None)
    _, coeffs = pipeline.encode_array(rgb, unbroken, device="cpu",
                                      return_coeffs=True)
    geom = config.geometry(rgb.shape[1], rgb.shape[0])
    segments, bits = oracle.entropy_encode_restart(
        *coeffs, geom, config.restart_interval
    )
    want = jfif.assemble_restart(
        geom, [np.frombuffer(s, np.uint8) for s in segments], bits,
        config.restart_interval, quality=config.quality,
    )
    got = pipeline.encode_array(rgb, config, device="cpu", packer=packer)
    assert got.file_bytes == want
    assert got.entropy_payload == b"".join(segments)
    assert got.bit_length == sum(bits)


@pytest.mark.parametrize("ratio", RATIOS)
def test_restart_file_matches_jax_pipeline(ratio):
    """The JAX package's restart files (its jitted CPU program holds on
    this input: tests/test_restart.py compares it with the oracle)."""
    rgb = _image()
    config = EncoderConfig(subsampling_ratio=ratio, restart_interval=3)
    got = pipeline.encode_array(rgb, config, device="cpu")
    want = jax_pipeline.encode_array(rgb, config)
    assert got.file_bytes == want.file_bytes
    assert got.entropy_payload == want.entropy_payload
    assert got.bit_length == want.bit_length


def test_restart_decodes_identically_to_the_unbroken_scan():
    """PIL decodes the restart file to the same pixels as the unbroken
    scan: only the framing differs."""
    rgb = _image(75, 99, seed=3)
    plain = pipeline.encode_array(rgb, EncoderConfig(), device="cpu")
    marked = pipeline.encode_array(rgb, EncoderConfig(restart_interval=2),
                                   device="cpu")
    a = np.asarray(Image.open(io.BytesIO(plain.file_bytes)).convert("RGB"))
    b = np.asarray(Image.open(io.BytesIO(marked.file_bytes)).convert("RGB"))
    assert np.array_equal(a, b)


@pytest.mark.parametrize("ratio", RATIOS)
def test_interval_dc_differences_match_jax(ratio, rng):
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(48, 32)
    coeffs = _coeffs(rng, geom)
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs),
                                    geom)
    hv = geom.h_factor * geom.v_factor
    for interval in (1, 2, geom.num_mcus):
        epi = entropy.entries_per_interval(geom, interval)
        got = entropy.dc_differences(z[:, 0].to(torch.int64), hv, None, epi)
        zi = jnp.asarray(z.numpy()).reshape(-1, epi, 64)
        want = jax.vmap(lambda x: jax_entropy.interval_dc_diffs(x, hv))(zi)
        assert np.array_equal(got.numpy(), np.asarray(want).reshape(-1))


def _jax_restart(coeffs, geom, cap, interval, live=None):
    data, bits = jax_entropy.encode_scan_restart(
        *(jnp.asarray(c) for c in coeffs), geom, cap, interval,
        coeffs_zigzagged=True, packer="xla",
        live_entries=None if live is None else jnp.int32(live),
    )
    return np.asarray(data), np.asarray(bits)


@pytest.mark.parametrize(
    "ratio, interval, live_mcus, cap",
    [((4, 2, 0), 3, None, 4096), ((4, 2, 2), 4, 5, 4096),
     ((4, 4, 4), 1, None, 4096), ((4, 2, 0), 2, None, 16)],
    ids=["short-last", "live-suffix", "one-mcu", "overflow"],
)
def test_encode_scan_restart_matches_jax(ratio, interval, live_mcus, cap, rng):
    """Per-interval bit counts and payload prefixes of every packer: with
    a short last interval, with a live_entries suffix that ends inside an
    interval and kills the ones after it, with one-MCU intervals and with
    rows that overflow their capacity."""
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(56, 40)
    coeffs = _coeffs(rng, geom)
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs),
                                    geom)
    live = None if live_mcus is None else live_mcus * geom.blocks_per_mcu - 1
    want, want_bits = _jax_restart(coeffs, geom, cap, interval, live)
    if live is not None:
        assert want_bits[-1] == 0
    for packer in scan.PACKERS:
        got, bits = scan.encode_entries(
            z, geom, cap, restart_mcus=interval, live_entries=live,
            packer=packer,
        )
        assert got.shape == (len(want_bits), cap)
        assert np.array_equal(bits.numpy(), want_bits), packer
        for row, b in enumerate(want_bits):
            n = min(cap, (int(b) + 7) // 8)
            assert np.array_equal(got[row, :n].numpy(), want[row, :n]), packer


@pytest.mark.parametrize("ratio", RATIOS)
def test_encode_scan_live_entries_matches_jax(ratio, rng):
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(48, 32)
    coeffs = _coeffs(rng, geom)
    z = entropy.marshal_scan_inputs(*(torch.from_numpy(c) for c in coeffs),
                                    geom)
    for live in (0, 1, geom.num_scan_entries // 3, geom.num_scan_entries):
        want, want_bits = jax_entropy.encode_scan(
            *(jnp.asarray(c) for c in coeffs), geom, 4096,
            coeffs_zigzagged=True, packer="xla", live_entries=jnp.int32(live),
        )
        for packer in scan.PACKERS:
            got, bits = scan.encode_entries(z, geom, 4096, live_entries=live,
                                            packer=packer)
            assert int(bits) == int(want_bits), (live, packer)
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_kernel_wrapper_refuses_bad_interval_operands():
    geom = EncoderConfig().geometry(32, 32)  # 4 MCUs of 6 entries
    z = torch.zeros((geom.num_scan_entries, 64), dtype=torch.int16)
    init = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        entropy_kernel.encode_entries(z, geom, 64, entries_per_interval=4)
    with pytest.raises(ValueError, match="init_dc"):
        entropy_kernel.encode_entries(z, geom, 64, init,
                                      entries_per_interval=6)
    # One interval of the whole scan takes init_dc like the unbroken scan.
    one, one_bits = entropy_kernel.encode_entries(
        z, geom, 64, init, entries_per_interval=24
    )
    whole, whole_bits = entropy_kernel.encode_entries(z, geom, 64, init)
    assert one.shape == (1, 64) and torch.equal(one[0], whole)
    assert int(one_bits[0]) == int(whole_bits)


@pytest.mark.parametrize("dims", [(33, 49), (41, 33), (17, 17)])
def test_restart_refuses_quirk_geometries(dims):
    h, w = dims
    rgb = _image(h, w, seed=40 + h)
    for config in (EncoderConfig(restart_interval=2),
                   EncoderConfig(restart_interval=2, optimize_huffman=True)):
        with pytest.raises(ValueError, match="quirk geometry"):
            pipeline.encode_array(rgb, config, device="cpu")


def test_restart_capacity_helpers_match_jax():
    for ratio in RATIOS:
        for size in [(8, 8), (40, 48), (1920, 1080), (3840, 2160)]:
            geom = EncoderConfig(subsampling_ratio=ratio).geometry(*size)
            for interval in (1, 7, 120, 240, 65535):
                worst = pipeline.restart_worst_case_capacity_bytes(
                    geom, interval)
                assert worst == jax_pipeline.restart_worst_case_capacity_bytes(
                    geom, interval)
                for bpp in (0.5, 0.01):
                    cap = pipeline.restart_default_capacity_bytes(
                        geom, interval, bpp)
                    assert cap == jax_pipeline.restart_default_capacity_bytes(
                        geom, interval, bpp)
                    assert pipeline.restart_next_capacity_bytes(
                        geom, interval, cap
                    ) == jax_pipeline.restart_next_capacity_bytes(
                        geom, interval, cap)


def test_restart_capacity_retry_ladder():
    """As test_restart.py::test_restart_capacity_retry_ladder: a too-small
    per-interval buffer walks the ladder to the same file."""
    rgb = np.random.default_rng(33).integers(0, 256, (128, 128, 3), np.uint8)
    big = EncoderConfig(restart_interval=10_000, quality=95)
    small = EncoderConfig(restart_interval=10_000, quality=95,
                          capacity_bytes_per_pixel=0.01)
    cap0 = pipeline.restart_default_capacity_bytes(
        big.geometry(128, 128), 10_000, 0.01
    )
    out_small = pipeline.encode_array(rgb, small, device="cpu")
    assert out_small.bit_length > 8 * cap0  # the ladder really climbed
    assert out_small.file_bytes == pipeline.encode_array(
        rgb, big, device="cpu").file_bytes
    want, _, _ = _oracle_restart(rgb, EncoderConfig(quality=95), 10_000)
    assert out_small.file_bytes == want


def test_restart_initial_capacity_rung():
    """_initial_capacity_bytes is per interval with restart markers."""
    rgb = _image(48, 64, seed=8)
    config = EncoderConfig(restart_interval=1)
    want = pipeline.encode_array(rgb, config, device="cpu")
    got = pipeline.encode_array(rgb, config, device="cpu",
                                _initial_capacity_bytes=4)
    assert got.file_bytes == want.file_bytes


@pytest.mark.parametrize(
    "config",
    [EncoderConfig(restart_interval=4), EncoderConfig(optimize_huffman=True),
     EncoderConfig(restart_interval=4, optimize_huffman=True)],
    ids=["restart", "optimize", "both"],
)
def test_return_coeffs_raises(config):
    """As the JAX package: coefficients come back only from the unbroken
    Annex-K encode."""
    with pytest.raises(ValueError, match="return_coeffs"):
        pipeline.encode_array(_image(16, 16), config, device="cpu",
                              return_coeffs=True)
    with pytest.raises(ValueError, match="return_coeffs"):
        jax_pipeline.encode_array(_image(16, 16), config, return_coeffs=True)
