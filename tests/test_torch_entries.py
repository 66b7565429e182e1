"""The DCT into scan order (kernels/dct.scan_entries) vs the JAX package.

The exact DCT kernels store each block's zigzag row straight to its scan
entry through ops/entropy.block_entries, in place of the scan marshal's
cat and gather. Held here on the CPU, exactly:

- the table is the inverse of the marshal's gather rows (_entry_rows): a
  bijection onto the B * E entries, -1 on exactly the luma blocks that
  oracle.luma_scan_order never emits (the w % (8h) == 1 and h % (8v) == 1
  quirks), for every ratio and batches of 1 and 3;
- the plain route (the plain DCT, then the scatter by the table) equals the
  JAX package's marshal_scan_inputs of its own DCT on the same seeded
  planes, RealDCT and binDCT in both quantization modes, at quality None
  and 90;
- the band path's final DCs read from the entries equal final_dc over the
  per-plane coefficients;
- encode_array's files equal the oracle's and the JAX package's, and the
  exact DCTs' main path runs no marshal;
- the marshal gathers the plane kernels' row views without a cat.

The CUDA kernels themselves are held to this route in
tests/test_torch_kernels.py (marked cuda: a file that imports no JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_encoder_tpu import config as jax_cfg
from jpeg_encoder_tpu import oracle
from jpeg_encoder_tpu import pipeline as jax_pipeline
from jpeg_encoder_tpu.io import jfif
from jpeg_encoder_tpu.ops import dct as jax_dct
from jpeg_encoder_tpu.ops import entropy as jax_entropy
from jpeg_encoder_tpu.ops import sample as jax_sample
from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.ops import entropy
from test_torch_host import jax_config

RATIOS = [(4, 4, 4), (4, 2, 2), (4, 2, 0)]
# Both quirks (w % (8h) == 1, h % (8v) == 1) and an aligned size.
SIZES = [(33, 17), (17, 33), (40, 24)]
BATCHES = [1, 3]
CPU = torch.device("cpu")
# (algorithm, quality, bin_dct_descale)
VARIANTS = [
    (DctAlgorithm.REAL_DCT, None, False),
    (DctAlgorithm.REAL_DCT, 90, False),
    (DctAlgorithm.BIN_DCT, None, False),
    (DctAlgorithm.BIN_DCT, 90, False),
    (DctAlgorithm.BIN_DCT, None, True),
    (DctAlgorithm.BIN_DCT, 90, True),
]


def _variant_id(v) -> str:
    algorithm, quality, descale = v
    return f"{algorithm.value}-q{quality}" + ("-descale" if descale else "")


def _geom(ratio, size):
    return EncoderConfig(subsampling_ratio=ratio).geometry(*size)


def _unemitted(geom, batch: int) -> np.ndarray:
    """(B * (ny + 2 nc),) bool over [all Y | all Cb | all Cr]: the luma
    blocks of superblocks at or past num_mcus, found from the superblock
    grid (the oracle's luma_scan_order keeps the first num_mcus)."""
    r, c = np.divmod(np.arange(geom.num_luma_blocks), geom.luma_blocks_x)
    superblock = (r // geom.v_factor) * geom.mcu_cols + c // geom.h_factor
    luma = np.tile(superblock >= geom.num_mcus, batch)
    return np.concatenate(
        [luma, np.zeros(2 * batch * geom.num_chroma_blocks, bool)])


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ratio", RATIOS)
def test_block_entries_invert_the_gather_rows(ratio, size, batch):
    geom = _geom(ratio, size)
    table = entropy.block_entries(geom, batch, CPU).numpy()
    rows = entropy._entry_rows(geom, batch, CPU).numpy()
    n_entries = batch * geom.num_scan_entries
    assert table.dtype == np.int32
    assert table.shape == (batch * (geom.num_luma_blocks
                                    + 2 * geom.num_chroma_blocks),)
    kept = table >= 0
    # Every entry once.
    assert np.array_equal(np.sort(table[kept]), np.arange(n_entries))
    # Scattering arange by the table gives the gather's rows exactly.
    scattered = np.full(n_entries, -1, np.int64)
    scattered[table[kept]] = np.flatnonzero(kept)
    assert np.array_equal(scattered, rows)
    # -1 on exactly the blocks no entry takes.
    assert np.array_equal(~kept, _unemitted(geom, batch))
    oracle_order = oracle.luma_scan_order(
        jax_cfg.EncoderConfig(subsampling_ratio=ratio).geometry(*size))
    assert (~kept).sum() == batch * (geom.num_luma_blocks
                                     - oracle_order.size)


def test_quirk_sizes_leave_blocks_out():
    """The quirk sizes above do exercise the -1 entries."""
    assert not (entropy.block_entries(_geom((4, 2, 0), (33, 17)), 1, CPU)
                >= 0).all()
    assert not (entropy.block_entries(_geom((4, 2, 2), (17, 33)), 1, CPU)
                >= 0).all()


def _planes(geom, batch: int, seed: int) -> list[np.ndarray]:
    """batch images' padded planes [Y, Cb, Cr], random, stacked."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (batch * h, w), dtype=np.uint8)
            for h, w in ((geom.padded_height, geom.padded_width),
                         (geom.chroma_height, geom.chroma_width),
                         (geom.chroma_height, geom.chroma_width))]


_JAX_ENTRIES: dict = {}


def _jax_entries(ratio, size, variant, batch, seed) -> np.ndarray:
    """The JAX package's entries: its eager DCT of each image's planes
    (dct_quantize_planes, zigzag out), marshal_scan_inputs, the images
    one after another. Cached for the module: the batch-1 case reuses
    image 0 of the batch-3 case."""
    key = (ratio, size, variant, seed)
    if key not in _JAX_ENTRIES:
        algorithm, quality, descale = variant
        geom = jax_cfg.EncoderConfig(subsampling_ratio=ratio).geometry(*size)
        # The stacked planes' blocks in raster order are the images'
        # blocks one image after another: one DCT call for all of them.
        coeffs = jax_dct.dct_quantize_planes(
            *(jax_sample.blockify(jnp.asarray(p))
              for p in _planes(geom, max(BATCHES), seed)),
            jax_cfg.DctAlgorithm(algorithm.value), zigzag_out=True,
            bin_dct_descale=descale, quality=quality)
        images = []
        for b in range(max(BATCHES)):
            rows, _ = jax_entropy.marshal_scan_inputs(
                *(c.reshape(max(BATCHES), -1, 64)[b] for c in coeffs), geom,
                coeffs_zigzagged=True, want_diff=False)
            images.append(np.asarray(rows))
        _JAX_ENTRIES[key] = images
    return np.concatenate(_JAX_ENTRIES[key][:batch])


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("size", SIZES[:2])
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("variant", VARIANTS, ids=_variant_id)
def test_plain_entries_match_jax_marshal(variant, ratio, size, batch):
    algorithm, quality, descale = variant
    geom = _geom(ratio, size)
    seed = 11 + RATIOS.index(ratio)
    planes = [torch.from_numpy(p) for p in _planes(geom, max(BATCHES), seed)]
    planes = [p[: p.shape[0] // max(BATCHES) * batch] for p in planes]
    before = (dct_kernel.REALDCT.launches, dct_kernel.BINDCT.launches)
    z = dct_kernel.scan_entries(*planes, geom, algorithm, quality,
                                bin_dct_descale=descale)
    # The CPU path launches nothing.
    assert (dct_kernel.REALDCT.launches, dct_kernel.BINDCT.launches) == before
    assert z.dtype == torch.int16
    assert z.shape == (batch * geom.num_scan_entries, 64)
    want = _jax_entries(ratio, size, variant, batch, seed)
    assert np.array_equal(z.numpy(), want)


@pytest.mark.parametrize("ratio", RATIOS)
def test_scan_entries_refuse_partial_images(ratio):
    geom = _geom(ratio, (40, 24))
    y, cb, cr = (torch.from_numpy(p) for p in _planes(geom, 2, 0))
    with pytest.raises(ValueError, match="whole images"):
        dct_kernel.scan_entries(y[: geom.padded_height], cb, cr, geom,
                                DctAlgorithm.REAL_DCT)


@pytest.mark.parametrize("size", [(64, 48), (33, 17)])
@pytest.mark.parametrize("ratio", RATIOS)
def test_final_dc_of_entries_matches_planes(ratio, size):
    """Three stacked bands (or images): the last Y, Cb and Cr entries of
    each hold the final DCs final_dc finds in the per-plane arrays."""
    geom = _geom(ratio, size)
    bands = 3
    rng = np.random.default_rng(5)
    coeffs = [torch.from_numpy(rng.integers(-1024, 1024, (bands * n, 64))
                               .astype(np.int16))
              for n in (geom.num_luma_blocks, geom.num_chroma_blocks,
                        geom.num_chroma_blocks)]
    z = entropy.marshal_scan_inputs(*coeffs, geom)
    got = entropy.final_dc_of_entries(z, geom)
    want = entropy.final_dc(*coeffs, geom)
    assert got.dtype == torch.int32 and got.shape == (bands, 3)
    assert torch.equal(got, want)
    jax_geom = jax_cfg.EncoderConfig(subsampling_ratio=ratio).geometry(*size)
    for b in range(bands):
        one = [c.reshape(bands, -1, 64)[b].numpy() for c in coeffs]
        assert got[b].tolist() == np.asarray(jax_entropy.final_dc(
            *(jnp.asarray(c) for c in one), jax_geom)).tolist()


@pytest.mark.parametrize("config", [
    EncoderConfig(subsampling_ratio=(4, 2, 0)),
    EncoderConfig(subsampling_ratio=(4, 2, 2), dct_algorithm=DctAlgorithm.BIN_DCT),
    EncoderConfig(subsampling_ratio=(4, 4, 4), dct_algorithm=DctAlgorithm.BIN_DCT,
                  bin_dct_descale=True, quality=90),
], ids=["realdct-420", "bindct-422", "bindct-descale-444-q90"])
def test_encode_array_matches_oracle_and_jax(config, monkeypatch):
    """The slice end to end: encode_array on the CPU goes through the
    entries route (no marshal) and its file equals the JAX package's and,
    where the oracle has the algorithm (not descale), the oracle's."""
    marshalled = []
    real = entropy.marshal_scan_inputs
    monkeypatch.setattr(entropy, "marshal_scan_inputs",
                        lambda *a, **k: marshalled.append(1) or real(*a, **k))
    rgb = np.random.default_rng(9).integers(0, 256, (17, 33, 3), np.uint8)
    got = pipeline.encode_array(rgb, config, device="cpu")
    assert not marshalled
    want = jax_pipeline.encode_array(rgb, jax_config(config))
    assert got.file_bytes == want.file_bytes
    if not config.bin_dct_descale:
        golden = oracle.encode_oracle(rgb, jax_config(config))
        assert got.file_bytes == jfif.assemble(
            golden.geom, golden.entropy_bytes, quality=config.quality)


def test_fast_dct_and_coefficients_keep_the_marshal(monkeypatch):
    """--fast-dct, and return_coeffs, take the plane kernel and the
    marshal; their files equal the entries route's where both are exact."""
    marshalled = []
    real = entropy.marshal_scan_inputs
    monkeypatch.setattr(entropy, "marshal_scan_inputs",
                        lambda *a, **k: marshalled.append(1) or real(*a, **k))
    rgb = np.random.default_rng(10).integers(0, 256, (24, 40, 3), np.uint8)
    pipeline.encode_array(rgb, EncoderConfig(fast_dct=True), device="cpu")
    assert len(marshalled) == 1
    result, coeffs = pipeline.encode_array(rgb, EncoderConfig(), device="cpu",
                                           return_coeffs=True)
    assert len(marshalled) == 2
    assert result.file_bytes == pipeline.encode_array(
        rgb, EncoderConfig(), device="cpu").file_bytes
    assert len(marshalled) == 2 and len(coeffs) == 3


def test_marshal_of_one_tensors_row_views_skips_the_cat(monkeypatch):
    """Row views of one (N, 64) tensor, as the plane kernels return them,
    are gathered from it; other arrays are concatenated first. The entries
    are the same either way."""
    geom = _geom((4, 2, 0), (40, 24))
    ny, nc = geom.num_luma_blocks, geom.num_chroma_blocks
    rng = np.random.default_rng(3)
    allc = torch.from_numpy(rng.integers(-900, 900, (2 * (ny + 2 * nc), 64))
                            .astype(np.int16))
    ny, nc = 2 * ny, 2 * nc
    views = allc[:ny], allc[ny : ny + nc], allc[ny + nc :]
    copies = tuple(v.clone() for v in views)
    cats = []
    real_cat = torch.cat
    monkeypatch.setattr(torch, "cat",
                        lambda *a, **k: cats.append(1) or real_cat(*a, **k))
    got = entropy.marshal_scan_inputs(*views, geom)
    assert not cats
    want = entropy.marshal_scan_inputs(*copies, geom)
    assert len(cats) == 1
    assert torch.equal(got, want)
    # Views out of order, or of a tensor with a gap, are not one tensor.
    swapped = views[0], views[2], views[1]
    entropy.marshal_scan_inputs(*swapped, geom)
    assert len(cats) == 2
    gapped = torch.cat([allc[:ny], allc[:1], allc[ny:]])
    assert len(cats) == 3
    gapped = gapped[:ny], gapped[ny + 1 : ny + 1 + nc], gapped[ny + 1 + nc :]
    assert torch.equal(entropy.marshal_scan_inputs(*gapped, geom), want)
    assert len(cats) == 4
    jax_rows = [np.asarray(jax_entropy.marshal_scan_inputs(
        *(jnp.asarray(c.reshape(2, -1, 64)[b].numpy()) for c in copies),
        jax_cfg.EncoderConfig().geometry(40, 24), coeffs_zigzagged=True,
        want_diff=False)[0]) for b in range(2)]
    assert np.array_equal(got.numpy(), np.concatenate(jax_rows))
