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


def test_fast_kron_split_matches_jax():
    """K2's operand is the TPU kernel's 3-term bf16 split of K_zz
    (dct_pallas.py:310-314), rebuilt here with jnp, bit for bit."""
    import jax.numpy as jnp

    m = jnp.asarray(dct_pallas._fast_kron_zigzag())
    m1 = m.astype(jnp.bfloat16)
    r1 = m - m1.astype(jnp.float32)
    m2 = r1.astype(jnp.bfloat16)
    m3 = (r1 - m2.astype(jnp.float32)).astype(jnp.bfloat16)
    got = constants.fast_kron_split()
    assert got.shape == (3, 64, 64) and got.dtype == np.uint16
    for mine, theirs in zip(got, (m1, m2, m3)):
        assert _same_bits(mine, np.asarray(theirs).view(np.uint16))
    terms = [constants.bf16_to_f32(t).astype(np.float64) for t in got]
    err = np.abs(sum(terms) - constants.fast_kron_zigzag())
    assert err.max() <= 2.0**-24 * np.abs(constants.fast_kron_zigzag()).max()


def _lifting_bound() -> int:
    """The largest |x| the 2-D binDCT lifting can produce from pixels in
    [-128, 127]: interval arithmetic through constants.bindct_lift8, rows
    and then columns (each column lifts the same row output of 8 rows)."""

    class Interval:
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def __add__(self, o):
            return Interval(self.lo + o.lo, self.hi + o.hi)

        def __sub__(self, o):
            return Interval(self.lo - o.hi, self.hi - o.lo)

        def __neg__(self):
            return Interval(-self.hi, -self.lo)

        def __mul__(self, c):
            assert c > 0
            return Interval(self.lo * c, self.hi * c)

    def shr(v, k):
        return Interval(v.lo >> k, v.hi >> k)  # floor: monotonic

    rows = constants.bindct_lift8([Interval(-128, 127)] * 8, shr)
    return max(max(-c.lo, c.hi) for r in rows
               for c in constants.bindct_lift8([r] * 8, shr))


def test_division_magic_is_c_division():
    """K3's bug-parity quotient ((x + mulhi(m, x)) >> s) - (x >> 31) equals
    C's truncating x / q, the reference's sign(x) * (|x| // q), for every q
    in 1..255 and every x in the lifting's output range (exhaustive)."""
    bound = _lifting_bound()
    assert 8192 < bound < 2**15
    x = np.arange(-bound, bound + 1, dtype=np.int64)
    want_num = np.sign(x)
    for q in range(1, 256):
        m, s = constants.division_magic(q)
        assert -2**31 <= m < 2**31 and 0 <= s < 8
        got = ((x + ((m * x) >> 32)) >> s) - (x >> 63)
        assert np.array_equal(got, want_num * (np.abs(x) // q)), q


@pytest.mark.parametrize("quality", [None, 1, 35, 90, 100])
def test_bindct_divisors_match_the_quant_rows(quality):
    """One (m, s) pair per zigzag position and table, for the rows the
    kernel divides by."""
    got = constants.bindct_divisors(quality)
    consts = constants.bindct_constants(quality)
    assert got.shape == (2, 64, 2) and got.dtype == np.int32
    for t, row in enumerate((consts.q_luma[0], consts.q_chroma[0])):
        assert 1 <= row.min() and row.max() <= 255
        for j, q in enumerate(row):
            assert tuple(got[t, j]) == constants.division_magic(int(q))
