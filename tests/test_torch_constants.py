"""The port's kernel operands equal the JAX package's, bit for bit."""

import numpy as np
import pytest

from jpeg_encoder_tpu import tables
from jpeg_encoder_tpu.kernels import dct_pallas
from jpeg_encoder_tpu.ops import dct as jax_dct
from jpeg_encoder_tpu.ops import entropy as jax_entropy
from jpeg_encoder_torch import constants


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("quality", [None, 1, 50, 90, 100])
def test_realdct_constants_match_jax(quality):
    got = constants.realdct_constants(quality)
    a, b, scale, q_luma = dct_pallas._realdct_constants("y", quality)
    q_chroma = dct_pallas._realdct_constants("c", quality)[3]
    for mine, theirs in zip(got, (a, b, scale, q_luma, q_chroma)):
        assert _same_bits(mine, theirs)


def test_default_packed_luts_match_jax():
    got = constants.default_packed_luts()
    want = jax_entropy.default_packed_luts()
    for mine, theirs in zip(got, want):
        assert mine.shape == (2, 256)
        assert _same_bits(mine, theirs)


@pytest.mark.parametrize("quality", [None, 35, 90])
def test_bindct_constants_match_jax(quality):
    """The binDCT kernel's zigzag quant rows (dct_pallas._bindct_constants)
    and its zigzag descale gains (ops/dct.bindct_descale_2d, permuted as
    bin_dct_quant_planes_zigzag_pallas_t permutes them)."""
    got = constants.bindct_constants(quality)
    assert _same_bits(got.q_luma, dct_pallas._bindct_constants("y", quality)[0])
    assert _same_bits(got.q_chroma, dct_pallas._bindct_constants("c", quality)[0])
    assert _same_bits(got.gains, jax_dct.bindct_descale_2d()[tables.ZIGZAG_ORDER])


def test_bindct_descale_gains_match_jax():
    assert _same_bits(constants.bindct_descale_2d(), jax_dct.bindct_descale_2d())


def test_fast_kron_zigzag_matches_jax():
    got = constants.fast_kron_zigzag()
    assert got.flags.c_contiguous
    assert _same_bits(got, dct_pallas._fast_kron_zigzag())
