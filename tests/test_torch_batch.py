"""The port's batch encode (parallel/batch.py) on CPU.

Every file of parallel.batch.encode_batch must be byte-identical to the
port's single-image pipeline.encode_array on the same image and config:
every ratio, a quirk geometry, an odd batch, binDCT with and without the
descale fix, --fast-dct, quality, restart markers whose interval does not
divide the MCU count, optimized tables alone and with restart markers, a
member that overflows the chunk's shared capacity (retried alone), and a
budget that cuts the batch into several chunks. A few cases are held
against jpeg_encoder_tpu.parallel.batch.encode_batch on a two-device mesh
and the small ones against the oracle. The batched pieces are held to
their per-image forms: the front, the marshal, the statistics and K4's
plain version over per-image rows, intervals and tables; and the chunk
size to K4's 2^31-bit offset bound, at its boundary.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jpeg_encoder_tpu import oracle as jax_oracle
from jpeg_encoder_tpu.io import jfif as jax_jfif
from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.ops import color, entropy, sample
from jpeg_encoder_torch.parallel import batch
from jpeg_encoder_torch.utils import corpus
from test_torch_host import jax_config

BIN_DCT = EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)


def _images(count, height, width, seed=0):
    """Corpus-like content with some random members: smooth and busy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        if i % 2:
            out.append(rng.integers(0, 256, (height, width, 3), np.uint8))
        else:
            out.append(corpus.landscape(height, width, seed=seed + i))
    return np.stack(out)


def _singles(images, config):
    return [pipeline.encode_array(rgb, config, device="cpu").file_bytes
            for rgb in images]


CASES = {
    "420": (EncoderConfig(), (40, 24), 3),
    "422": (EncoderConfig(subsampling_ratio=(4, 2, 2)), (48, 32), 2),
    "444": (EncoderConfig(subsampling_ratio=(4, 4, 4)), (24, 16), 4),
    "quirk-420": (EncoderConfig(), (33, 17), 5),
    "quirk-422": (EncoderConfig(subsampling_ratio=(4, 2, 2)), (17, 9), 3),
    "one-image": (EncoderConfig(), (40, 24), 1),
    "bin-dct": (dataclasses.replace(BIN_DCT, subsampling_ratio=(4, 2, 2)),
                (40, 24), 3),
    "bin-dct-descale": (dataclasses.replace(BIN_DCT, bin_dct_descale=True,
                                            quality=90), (33, 17), 3),
    "fast-dct": (EncoderConfig(fast_dct=True), (48, 32), 3),
    "quality-30": (EncoderConfig(quality=30, subsampling_ratio=(4, 4, 4)),
                   (40, 24), 3),
    "restart-5": (EncoderConfig(restart_interval=5), (64, 48), 3),
    "restart-4-444": (EncoderConfig(restart_interval=4,
                                    subsampling_ratio=(4, 4, 4)),
                      (40, 24), 3),
    "restart-bin-1": (dataclasses.replace(BIN_DCT, restart_interval=1,
                                          subsampling_ratio=(4, 2, 2)),
                      (32, 16), 3),
    "optimize": (EncoderConfig(optimize_huffman=True), (48, 32), 3),
    "optimize-444-q90": (EncoderConfig(optimize_huffman=True, quality=90,
                                       subsampling_ratio=(4, 4, 4)),
                         (33, 17), 3),
    "optimize-restart-7": (EncoderConfig(optimize_huffman=True,
                                         restart_interval=7), (64, 48), 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_matches_single_images(case):
    config, (width, height), count = CASES[case]
    if config.restart_interval is not None:
        geom = config.geometry(width, height)
        assert geom.num_mcus % config.restart_interval or (
            config.restart_interval == 1)
    images = _images(count, height, width, seed=len(case))
    assert batch.encode_batch(images, config, device="cpu") == _singles(
        images, config)


@pytest.mark.parametrize("restart", [None, 64])
def test_overflowing_member_is_retried_alone(restart, monkeypatch):
    """Random noise at quality 100 overflows the chunk's shared capacity
    (16 KiB for the image, 4 KiB an interval); the smooth members fit. The
    member is re-encoded alone from the next rung, and its file is the
    single-image one."""
    config = EncoderConfig(subsampling_ratio=(4, 4, 4), quality=100,
                           restart_interval=restart)
    images = np.stack([corpus.portrait(128, 128, seed=1),
                       np.random.default_rng(2).integers(0, 256, (128, 128, 3),
                                                         np.uint8),
                       corpus.portrait(128, 128, seed=3)])
    geom = config.geometry(128, 128)
    assert batch.chunk_capacity_bytes(config, geom) == (
        16384 if restart is None else 4096)
    retried = []
    retry = batch._retry

    def spy(rgb, *args):
        retried.append(rgb)
        return retry(rgb, *args)

    monkeypatch.setattr(batch, "_retry", spy)
    files = batch.encode_batch(images, config, device="cpu")
    assert len(retried) == 1 and np.array_equal(retried[0], images[1])
    assert files == _singles(images, config)


@pytest.mark.parametrize("optimize", [False, True])
def test_small_budget_makes_several_chunks(optimize, monkeypatch):
    """A budget of two 40x24 images cuts seven images into four chunks
    (the last of one); the image cap does the same."""
    config = EncoderConfig(optimize_huffman=optimize, restart_interval=2)
    images = _images(7, 24, 40, seed=3)
    geom = config.geometry(40, 24)
    calls = []
    chunk_fn = "_encode_chunk_optimized" if optimize else "_encode_chunk"
    inner = getattr(batch, chunk_fn)

    def spy(chunk, *args):
        calls.append(chunk.shape[0])
        return inner(chunk, *args)

    monkeypatch.setattr(batch, chunk_fn, spy)
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 2 * 40 * 24 * 3 + 5)
    assert batch.chunk_size_images(geom) == 2
    want = _singles(images, config)
    assert batch.encode_batch(images, config, device="cpu") == want
    assert calls == [2, 2, 2, 1]
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 1 << 30)
    monkeypatch.setattr(batch, "MAX_IMAGES_PER_CHUNK", 3)
    calls.clear()
    assert batch.encode_batch(images, config, device="cpu") == want
    assert calls == [3, 3, 1]


def test_chunk_size_defaults():
    """The default budget: 21 images of 1080p (two chunks for 32), 5 of 4K
    (three chunks for 12), 64 tiny images."""
    config = EncoderConfig()
    assert batch.chunk_size_images(config.geometry(1920, 1080)) == 21
    assert batch.chunk_size_images(config.geometry(3840, 2160)) == 5
    assert batch.chunk_size_images(config.geometry(64, 48)) == 64


@pytest.mark.parametrize(
    "ratio, size, budget_images, offset_images",
    [((4, 2, 0), (1920, 1080), 21, 24),
     ((4, 2, 2), (1920, 1080), 21, 18),
     ((4, 4, 4), (1920, 1080), 21, 12),
     ((4, 4, 4), (3840, 2160), 5, 3)],
)
def test_chunks_stay_under_the_offset_bound(ratio, size, budget_images,
                                            offset_images, monkeypatch):
    """K4 sums one chunk's bits in int32: chunk_size_images caps a chunk at
    the most images whose worst case stays below 2^31 bits, and the K4
    wrapper refuses one image more, before any work (the operand is a
    broadcast view: nothing of that size is allocated)."""
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(*size)
    worst = entropy_kernel.worst_case_bits(geom)
    assert offset_images * worst < 2**31 <= (offset_images + 1) * worst
    assert batch.chunk_size_images(geom) == min(budget_images, offset_images)
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 1 << 40)
    assert batch.chunk_size_images(geom) == min(64, offset_images)
    block = torch.zeros((1, 64), dtype=torch.int16)
    too_many = block.expand((offset_images + 1) * geom.num_scan_entries, 64)
    with pytest.raises(ValueError, match="int32 offsets"):
        entropy_kernel.encode_entries(
            too_many, geom, 1024,
            entries_per_interval=geom.num_scan_entries)


def test_single_image_past_the_offset_bound_is_one_chunk():
    """A frame whose own worst case passes 2^31 bits gets a chunk of one,
    which K4 refuses as it refuses that image alone."""
    geom = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(8192, 8192)
    assert entropy_kernel.worst_case_bits(geom) >= 2**31
    assert batch.chunk_size_images(geom) == 1


# The JAX package's batch on a two-device CPU mesh (its jitted program is
# exact on these inputs; each case compiles a vmapped program, ~10 s).
@pytest.mark.parametrize(
    "config, size, count",
    [(EncoderConfig(), (40, 24), 3),
     (EncoderConfig(optimize_huffman=True), (64, 48), 2),
     (EncoderConfig(subsampling_ratio=(4, 2, 2), restart_interval=3),
      (48, 32), 3)],
    ids=["default-odd-batch", "optimize", "restart-3-422"],
)
def test_batch_matches_jax_batch(config, size, count):
    from jpeg_encoder_tpu.parallel import batch as jax_batch
    from jpeg_encoder_tpu.parallel import mesh as jax_mesh

    width, height = size
    images = np.stack([corpus.landscape(height, width, seed=s)
                       for s in range(7, 7 + count)])
    want = jax_batch.encode_batch(images, jax_config(config),
                                  jax_mesh.data_mesh(2))
    assert batch.encode_batch(images, config, device="cpu") == want


@pytest.mark.parametrize("ratio", [(4, 4, 4), (4, 2, 2), (4, 2, 0)])
def test_small_batch_matches_oracle(ratio):
    config = EncoderConfig(subsampling_ratio=ratio)
    images = _images(3, 17, 33, seed=sum(ratio))
    files = batch.encode_batch(images, config, device="cpu")
    for rgb, got in zip(images, files):
        golden = jax_oracle.encode_oracle(rgb, jax_config(config))
        assert got == jax_jfif.assemble(golden.geom, golden.entropy_bytes)


@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 2, 2)])
def test_batched_front_and_marshal_match_per_image(ratio):
    """pad_plane and subsample_plane on (B, H, W) planes, and the marshal
    of B images' stacked coefficients, equal their per-image forms at a
    quirk geometry (a flatten across the batch would shift images 1..)."""
    config = EncoderConfig(subsampling_ratio=ratio)
    geom = config.geometry(17, 9)
    images = torch.from_numpy(_images(3, 9, 17, seed=4))
    ys, cbs, crs = color.rgb_to_ycbcr(images)
    sub = sample.subsample_plane(sample.pad_plane(cbs, geom), geom)
    assert sub.shape == (3, geom.chroma_height, geom.chroma_width)
    for b in range(3):
        single = sample.subsample_plane(sample.pad_plane(cbs[b], geom), geom)
        assert torch.equal(sub[b], single)
        assert torch.equal(sample.pad_plane(ys, geom)[b],
                           sample.pad_plane(ys[b], geom))
    rng = np.random.default_rng(1)
    per_image = [[torch.from_numpy(rng.integers(-50, 50, (n, 64), np.int16))
                  for n in (geom.num_luma_blocks, geom.num_chroma_blocks,
                            geom.num_chroma_blocks)] for _ in range(3)]
    stacked = [torch.cat([c[i] for c in per_image]) for i in range(3)]
    z = entropy.marshal_scan_inputs(*stacked, geom)
    want = torch.cat([entropy.marshal_scan_inputs(*c, geom)
                      for c in per_image])
    assert torch.equal(z, want)
    with pytest.raises(ValueError, match="whole images"):
        entropy.marshal_scan_inputs(stacked[0][1:], *stacked[1:], geom)


@pytest.mark.parametrize("restart", [None, 5])
def test_batched_statistics_and_entropy_match_per_image(restart):
    """symbol_histograms gives one (4, 256) row per image; K4's plain
    version over B images' entries, with one table pair an image, gives
    each image's rows of its single-image encode (5 does not divide the
    32 MCUs, so intervals end at every image)."""
    config = EncoderConfig(restart_interval=restart)
    geom = config.geometry(64, 64)
    images = torch.from_numpy(_images(3, 64, 64, seed=6))
    z, _ = pipeline.scan_entries(images, geom, config.dct_algorithm)
    per = z.reshape(3, geom.num_scan_entries, 64)
    hists = entropy.symbol_histograms(z, geom, restart)
    assert hists.shape == (3, 4, 256)
    luts = []
    for b in range(3):
        assert torch.equal(hists[b],
                           entropy.symbol_histograms(per[b], geom, restart))
        luts.append(pipeline.optimal_specs_and_luts(hists[b].numpy(),
                                                    "cpu")[1])
    stacked = tuple(torch.stack([t[i] for t in luts]) for i in (0, 1))
    epi = (geom.num_scan_entries if restart is None
           else entropy.entries_per_interval(geom, restart))
    data, bits = entropy_kernel.encode_entries(
        z, geom, 4096, luts=stacked, entries_per_interval=epi)
    n_int = -(-geom.num_scan_entries // epi)
    assert bits.shape == (3 * n_int,)
    for b in range(3):
        want, want_bits = entropy_kernel.encode_entries(
            per[b].contiguous(), geom, 4096, luts=luts[b],
            entries_per_interval=epi)
        rows = slice(b * n_int, (b + 1) * n_int)
        assert torch.equal(bits[rows], want_bits)
        assert torch.equal(data[rows], want)


def test_chunk_stages_keep_their_contracts():
    """dispatch_chunk returns tensors on the device, fetch_chunk slices to
    the longest payload, and the pieces give encode_batch's files."""
    config = EncoderConfig(restart_interval=4)
    images = _images(2, 32, 64, seed=8)
    geom = config.geometry(64, 32)
    cap = batch.chunk_capacity_bytes(config, geom)
    payloads, bits = batch.dispatch_chunk(images, config, geom, cap,
                                          device="cpu")
    assert isinstance(payloads, torch.Tensor)
    assert payloads.shape == (2, 2, cap) and bits.shape == (2, 2)
    host_payloads, host_bits = batch.fetch_chunk(payloads, bits)
    assert host_payloads.shape == (2, 2, (int(bits.max()) + 7) // 8)
    files = batch.assemble_chunk(images, config, geom, cap, host_payloads,
                                 host_bits, device="cpu")
    assert files == batch.encode_batch(images, config, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        batch.encode_batch(images[0], config, device="cpu")
