"""The port's kernel operands equal the JAX package's, bit for bit."""

import numpy as np
import pytest

from jpeg_encoder_tpu.kernels import dct_pallas
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
