"""Port ops vs the JAX package and the oracle: colour, sampling, RealDCT.

Inputs are made from seeds with NumPy and handed to both packages; every
comparison is exact (byte identity is the contract, so no tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_encoder_tpu import oracle, tables
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_tpu.kernels import dct_pallas
from jpeg_encoder_tpu.ops import color as jax_color
from jpeg_encoder_tpu.ops import dct as jax_dct
from jpeg_encoder_tpu.ops import sample as jax_sample
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.ops import color, dct, sample

RATIOS = [(4, 4, 4), (4, 2, 2), (4, 2, 0)]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def test_color_exhaustive_vs_oracle():
    """All 2^24 RGB triples, one blue value at a time (tie triples
    included): the gather-and-add form is exact, with no sampling."""
    c = np.arange(256, dtype=np.uint8)
    r, g = np.meshgrid(c, c, indexing="ij")
    for b in range(256):
        rgb = np.stack([r, g, np.full_like(r, b)], axis=-1)
        got = color.rgb_to_ycbcr(_t(rgb))
        want = oracle.rgb_to_ycbcr_exact(rgb)
        for a, e in zip(got, want):
            assert a.dtype == torch.uint8
            assert np.array_equal(a.numpy(), e)


def test_color_matches_jax(rng):
    rgb = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    got = color.rgb_to_ycbcr(_t(rgb))
    want = jax_color.rgb_to_ycbcr(jnp.asarray(rgb))
    for a, e in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(e))


# Each size hits dim % (8 * factor) == 1 for some ratio (the push-order
# quirk geometries) or is aligned, odd or tiny.
SIZES = [(16, 16), (17, 16), (33, 17), (24, 40), (20, 12), (49, 33), (9, 25)]


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("size", SIZES)
def test_pad_and_subsample_match_oracle_and_jax(ratio, size, rng):
    width, height = size
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(width, height)
    plane = rng.integers(0, 256, size=(height, width), dtype=np.uint8)
    padded = sample.pad_plane(_t(plane), geom)
    want_padded = np.zeros((geom.padded_height, geom.padded_width), np.uint8)
    want_padded[:height, :width] = plane
    assert np.array_equal(padded.numpy(), want_padded)
    got = sample.subsample_plane(padded, geom)
    assert got.shape == (geom.chroma_height, geom.chroma_width)
    assert np.array_equal(got.numpy(), oracle.subsample_plane(want_padded, geom))
    jax_got = jax_sample.subsample_plane(jnp.asarray(want_padded), geom)
    assert np.array_equal(got.numpy(), np.asarray(jax_got))


def test_blockify_matches_oracle(rng):
    plane = rng.integers(0, 256, size=(24, 40), dtype=np.uint8)
    got = sample.blockify(_t(plane))
    assert np.array_equal(got.numpy(), oracle.blockify(plane).reshape(-1, 64))


@pytest.mark.parametrize("quality", [None, 90])
@pytest.mark.parametrize("ratio", RATIOS)
def test_plain_dct_matches_jax_and_oracle(ratio, quality, rng):
    """The plain chain equals the JAX package's XLA ordered chain and the
    oracle's scalar-order RealDCT on random planes (the worst case for
    rounding ties: every pixel value occurs)."""
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(40, 24)
    yp = rng.integers(0, 256, (geom.padded_height, geom.padded_width), np.uint8)
    cp = [
        rng.integers(0, 256, (geom.chroma_height, geom.chroma_width), np.uint8)
        for _ in range(2)
    ]
    got = dct.real_dct_quant_planes_zigzag(_t(yp), _t(cp[0]), _t(cp[1]), quality)
    want = jax_dct.dct_quantize_planes(
        *(jax_sample.blockify(jnp.asarray(p)) for p in (yp, *cp)),
        DctAlgorithm.REAL_DCT, zigzag_out=True, quality=quality,
    )
    q_luma, q_chroma = tables.scaled_quant_tables(quality)
    for g, w, p, q in zip(got, want, (yp, *cp), (q_luma, q_chroma, q_chroma)):
        assert g.dtype == torch.int16
        assert np.array_equal(g.numpy(), np.asarray(w))
        exact = oracle.real_dct_quant_exact(oracle.blockify(p), q)
        assert np.array_equal(
            g.numpy(), exact.reshape(-1, 64)[:, tables.ZIGZAG_ORDER]
        )


def test_dct_wrapper_matches_pallas_kernel_interpret(rng):
    """The RealDCT kernel's wrapper, on CPU tensors, equals the TPU kernel
    it replaces (run in interpret mode, at one small geometry)."""
    yp = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    cbp = rng.integers(0, 256, (8, 16), dtype=np.uint8)
    crp = rng.integers(0, 256, (8, 16), dtype=np.uint8)
    before = dct_kernel.launches
    got = dct_kernel.real_dct_quant_planes_zigzag(_t(yp), _t(cbp), _t(crp))
    assert dct_kernel.launches == before  # the CPU path launches nothing
    want = dct_pallas.real_dct_quant_planes_zigzag_pallas_t(
        jnp.asarray(yp), jnp.asarray(cbp), jnp.asarray(crp), interpret=True
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize(
    "bad",
    [
        lambda y, c: (y.to(torch.int16), c, c),          # dtype
        lambda y, c: (y[:, :12], c, c),                   # not padded to 8
        lambda y, c: (y.t(), c, c),                       # not contiguous
        lambda y, c: (y, c, c[:8, :8].contiguous()),      # cb/cr mismatch
    ],
)
def test_dct_wrapper_rejects_bad_planes(bad):
    y = torch.zeros((16, 16), dtype=torch.uint8)
    c = torch.zeros((8, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        dct_kernel.real_dct_quant_planes_zigzag(*bad(y, c))
