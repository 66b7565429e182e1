"""The CUDA kernels against their plain PyTorch versions.

The tests marked `cuda` need an NVIDIA GPU with nvcc and skip elsewhere;
on the card they run with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which that machine lacks.)

They build csrc/*.cu, launch each kernel at small and at 1080p shapes and
require exact equality with the plain version run on CPU tensors, except
K2 (--fast-dct), which is held to max |diff| 1 at mismatch rates below
1e-3 against its plain version and 5e-4 against the exact K1: K4 also over
restart intervals, with live_entries and with one-symbol optimal tables,
over a batch of images (per-image rows, intervals and tables), and K5 over
one row and many; the per-block tier (K6a/b, K6c) also against K1 and K3
on the same blocks; then restart, optimized and batch encodes on the card
against the CPU path. The unmarked tests run everywhere and pin the
build's behaviour.
"""

import os

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import pipeline, scan, tables
from jpeg_encoder_torch.kernels import _build
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.kernels import pack as pack_kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_torch.parallel import batch
from jpeg_encoder_torch.utils import corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc means an error naming it, never a silent fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_failed_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    """A compile error surfaces as an exception carrying nvcc's stderr, and
    leaves no library behind."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []


def test_build_runs_one_nvcc_per_source(monkeypatch, tmp_path):
    """Every csrc/*.cu gets its own nvcc process and its own library; the
    processes run at the same time (each waits for all to have started)."""
    sources = _build.names()
    log = tmp_path / "log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        f"while [ $(wc -l < {log}) -lt {len(sources)} ]; do sleep 0.05; done\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'touch "$2"\n'
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    _build.build()
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == sorted(f"lib{name}.so" for name in sources)
    calls = log.read_text().splitlines()
    assert len(calls) == len(sources)
    for name in sources:
        (call,) = [c for c in calls if c.endswith(f"csrc/{name}.cu")]
        assert "-fmad=false" in call and "arch=compute_90a,code=sm_90a" in call


def test_every_kernel_has_its_source():
    """The seven kernels come from the five csrc sources (the per-block
    tier shares realdct.cu and bindct.cu with K1 and K3), each replacing a
    Pallas kernel at a file:line that holds a pallas_call's entry point."""
    kernels = (dct_kernel.REALDCT, dct_kernel.FASTDCT, dct_kernel.BINDCT,
               entropy_kernel.ENTROPY, pack_kernel.PACK,
               dct_kernel.REALDCT_BLOCKS, dct_kernel.BINDCT_BLOCKS)
    assert sorted({k.lib for k in kernels}) == _build.names()
    assert len({k.name for k in kernels}) == len(kernels)
    assert dct_kernel.REALDCT_BLOCKS.lib == "realdct"
    assert dct_kernel.BINDCT_BLOCKS.lib == "bindct"
    for k in kernels:
        assert k.source == f"jpeg_encoder_torch/csrc/{k.lib}.cu"
        path, line = k.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith("def ")


@pytest.mark.cuda
@pytest.mark.parametrize("quality", [None, 90])
@pytest.mark.parametrize(
    "shapes", [((16, 24), (8, 16)), ((1088, 1920), (544, 960)), ((48, 40), (48, 40))]
)
def test_dct_kernel_matches_plain(cuda, shapes, quality):
    rng = np.random.default_rng(7)
    planes = [rng.integers(0, 256, shapes[0], dtype=np.uint8)] + [
        rng.integers(0, 256, shapes[1], dtype=np.uint8) for _ in range(2)
    ]
    cpu = [torch.from_numpy(p) for p in planes]
    before = dct_kernel.REALDCT.launches
    got = dct_kernel.real_dct_quant_planes_zigzag(*(p.to(cuda) for p in cpu), quality)
    torch.cuda.synchronize()
    assert dct_kernel.REALDCT.launches == before + 1
    want = dct_kernel.real_dct_quant_planes_zigzag(*cpu, quality)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _random_planes(shapes, seed):
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 256, shapes[0], dtype=np.uint8)] + [
        rng.integers(0, 256, shapes[1], dtype=np.uint8) for _ in range(2)
    ]
    return [torch.from_numpy(p) for p in planes]


@pytest.mark.cuda
@pytest.mark.parametrize("descale", [False, True])
@pytest.mark.parametrize("quality", [None, 90, 100])
@pytest.mark.parametrize(
    "shapes", [((16, 24), (8, 16)), ((1088, 1920), (544, 960)), ((48, 40), (48, 40))]
)
def test_bindct_kernel_matches_plain(cuda, shapes, quality, descale):
    """Exact, in both quantization modes; quality 100 (q = 1) passes the
    raw lifting outputs, negative intermediates and all, straight through."""
    cpu = _random_planes(shapes, 8)
    before = dct_kernel.BINDCT.launches
    got = dct_kernel.bin_dct_quant_planes_zigzag(
        *(p.to(cuda) for p in cpu), quality, descale
    )
    torch.cuda.synchronize()
    assert dct_kernel.BINDCT.launches == before + 1
    want = dct_kernel.bin_dct_quant_planes_zigzag(*cpu, quality, descale)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("quality", [None, 90])
@pytest.mark.parametrize(
    "shapes", [((1088, 1920), (544, 960)), ((1080, 1920), (1080, 1920))]
)
def test_fastdct_kernel_within_tolerance(cuda, shapes, quality):
    """K2 against its plain version (max |diff| 1, rate < 1e-3) and against
    the exact K1 on the same planes (max |diff| 1, rate <= 5e-4)."""
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu = _random_planes(shapes, 9)
    dev = [p.to(cuda) for p in cpu]
    before = dct_kernel.FASTDCT.launches
    got = torch.cat(dct_kernel.real_dct_fast_planes_zigzag(*dev, quality))
    torch.cuda.synchronize()
    assert dct_kernel.FASTDCT.launches == before + 1
    for want, rate in (
        (torch.cat(dct_kernel.real_dct_fast_planes_zigzag(*cpu, quality)), 1e-3),
        (torch.cat(dct_kernel.real_dct_quant_planes_zigzag(*dev, quality)).cpu(),
         5e-4),
    ):
        d = (got.cpu().to(torch.int32) - want.to(torch.int32)).abs()
        assert int(d.max()) <= 1
        assert float((d > 0).float().mean()) <= rate


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 2, 2), (4, 4, 4)])
@pytest.mark.parametrize("capacity", [None, 4096])
def test_entropy_kernel_matches_plain(cuda, ratio, capacity):
    """Corpus content at 1080p, at the default capacity and at one far
    below the payload (dropped words, true bit count)."""
    config = EncoderConfig(subsampling_ratio=ratio)
    rgb = corpus.foliage(1080, 1920)
    _, coeffs = pipeline.encode_array(rgb, config, device=cuda, return_coeffs=True)
    geom = config.geometry(1920, 1080)
    zz = [torch.from_numpy(c[:, tables.ZIGZAG_ORDER].copy()) for c in coeffs]
    z = entropy_ops.marshal_scan_inputs(*zz, geom)
    cap = capacity or pipeline.default_capacity_bytes(geom)
    init = torch.tensor([5, -9, 3], dtype=torch.int32)
    want, want_bits = entropy_kernel.encode_entries(z, geom, cap, init)
    got, bits = entropy_kernel.encode_entries(z.to(cuda), geom, cap, init.to(cuda))
    assert int(bits) == int(want_bits)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 2, 2), (4, 4, 4)])
@pytest.mark.parametrize("size", [(517, 333), (33, 17), (1921, 1089)])
def test_encode_array_on_card_matches_cpu(cuda, ratio, size):
    width, height = size
    rgb = np.random.default_rng(3).integers(0, 256, (height, width, 3), np.uint8)
    config = EncoderConfig(subsampling_ratio=ratio)
    got = pipeline.encode_array(rgb, config, device=cuda)
    want = pipeline.encode_array(rgb, config, device="cpu")
    assert got.file_bytes == want.file_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("descale", [False, True])
@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 2, 2), (4, 4, 4)])
@pytest.mark.parametrize("size", [(517, 333), (33, 17)])
def test_bindct_encode_on_card_matches_cpu(cuda, ratio, size, descale):
    width, height = size
    rgb = np.random.default_rng(4).integers(0, 256, (height, width, 3), np.uint8)
    config = EncoderConfig(subsampling_ratio=ratio, quality=90,
                           dct_algorithm=DctAlgorithm.BIN_DCT,
                           bin_dct_descale=descale)
    got = pipeline.encode_array(rgb, config, device=cuda)
    want = pipeline.encode_array(rgb, config, device="cpu")
    assert got.file_bytes == want.file_bytes


def _corpus_entries(config, cuda, size=(1920, 1080)):
    """Scan entries of corpus content, coded on the card: (z on CPU, geom)."""
    width, height = size
    rgb = corpus.foliage(height, width)
    _, coeffs = pipeline.encode_array(rgb, config, device=cuda,
                                      return_coeffs=True)
    geom = config.geometry(width, height)
    zz = [torch.from_numpy(c[:, tables.ZIGZAG_ORDER].copy()) for c in coeffs]
    return entropy_ops.marshal_scan_inputs(*zz, geom), geom


@pytest.mark.cuda
@pytest.mark.parametrize("interval", [1, 7, 120, 10000])
@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 2, 2), (4, 4, 4)])
def test_entropy_kernel_intervals_match_plain(cuda, ratio, interval):
    """K4 over restart intervals at 1080p: all live, a live_entries suffix
    ending inside an interval, and a capacity far below the rows'
    payloads (dropped words, true bit counts, no spill into the next
    row)."""
    config = EncoderConfig(subsampling_ratio=ratio)
    z, geom = _corpus_entries(config, cuda)
    epi = entropy_ops.entries_per_interval(geom, interval)
    cap = pipeline.restart_default_capacity_bytes(geom, interval)
    live = geom.num_scan_entries * 2 // 3 + 1
    for live_entries, capacity in ((None, cap), (live, cap), (None, 64)):
        want, want_bits = entropy_kernel.encode_entries(
            z, geom, capacity, live_entries=live_entries,
            entries_per_interval=epi)
        before = entropy_kernel.ENTROPY.launches
        got, bits = entropy_kernel.encode_entries(
            z.to(cuda), geom, capacity, live_entries=live_entries,
            entries_per_interval=epi)
        torch.cuda.synchronize()
        assert entropy_kernel.ENTROPY.launches == before + 1
        assert torch.equal(bits.cpu(), want_bits)
        assert torch.equal(got.cpu(), want)


def _one_symbol_tables():
    """1080p 4:4:4 entries that are almost all EOB, and the optimal tables
    of their histogram: 1-bit codes, entries of 2 bits, up to 16 entries
    ORed into one word."""
    geom = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(1920, 1080)
    z = torch.zeros((geom.num_scan_entries, 64), dtype=torch.int16)
    z[::97, 1] = 1
    z[::89, 0] = 3
    hist = entropy_ops.symbol_histograms(z, geom).numpy()
    specs, luts = pipeline.optimal_specs_and_luts(hist, "cpu")
    assert min(specs[3].length_lut[specs[3].length_lut > 0]) == 1
    return z, geom, luts


@pytest.mark.cuda
def test_entropy_kernel_one_symbol_tables_match_plain(cuda):
    z, geom, luts = _one_symbol_tables()
    dev_luts = tuple(t.to(cuda) for t in luts)
    for epi in (None, entropy_ops.entries_per_interval(geom, 120)):
        want, want_bits = entropy_kernel.encode_entries(
            z, geom, 1 << 16, None, luts, entries_per_interval=epi)
        got, bits = entropy_kernel.encode_entries(
            z.to(cuda), geom, 1 << 16, None, dev_luts,
            entries_per_interval=epi)
        assert torch.equal(bits.cpu(), want_bits)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("restart", [None, 120])
def test_pack_kernel_one_symbol_tables_match_plain(cuda, restart):
    """The assemble tier with one-symbol optimal tables: K5 ORs the
    boundary words of entries that share one output word."""
    z, geom, luts = _one_symbol_tables()
    dev_luts = tuple(t.to(cuda) for t in luts)
    want, want_bits = scan.encode_entries(
        z, geom, 1 << 16, restart_mcus=restart, luts=luts, packer="assemble")
    before = pack_kernel.PACK.launches
    got, bits = scan.encode_entries(
        z.to(cuda), geom, 1 << 16, restart_mcus=restart, luts=dev_luts,
        packer="assemble")
    torch.cuda.synchronize()
    assert pack_kernel.PACK.launches == before + 1
    assert torch.equal(bits.cpu(), want_bits)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("interval", [None, 1, 120])
@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 4, 4)])
def test_pack_kernel_matches_plain(cuda, ratio, interval):
    """K5 on corpus entries at 1080p: one row (the unbroken scan) or one
    row per restart interval, at a fitting capacity and at one far below
    the payload."""
    config = EncoderConfig(subsampling_ratio=ratio)
    z, geom = _corpus_entries(config, cuda)
    slot_bits, slot_lens = entropy_ops.symbolize(
        z, geom.h_factor * geom.v_factor)
    epi = (geom.num_scan_entries if interval is None
           else entropy_ops.entries_per_interval(geom, interval))
    words, offsets, row_bits = scan.assemble_operands(slot_bits, slot_lens,
                                                      epi)
    fit = (int(row_bits.max()) // 32 + 2) * 4
    for cap in (fit, 16):
        want = pack_kernel.assemble_bitstream(words, offsets, cap)
        before = pack_kernel.PACK.launches
        got = pack_kernel.assemble_bitstream(words.to(cuda),
                                             offsets.to(cuda), cap)
        torch.cuda.synchronize()
        assert pack_kernel.PACK.launches == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("packer", ["fused", "assemble"])
@pytest.mark.parametrize(
    "config",
    [
        EncoderConfig(restart_interval=7),
        EncoderConfig(subsampling_ratio=(4, 2, 2), restart_interval=1,
                      dct_algorithm=DctAlgorithm.BIN_DCT),
        EncoderConfig(subsampling_ratio=(4, 4, 4), optimize_huffman=True),
        EncoderConfig(optimize_huffman=True, restart_interval=3, quality=90),
    ],
    ids=["restart7", "bin-422-restart1", "optimize-444", "optimize-restart3"],
)
@pytest.mark.parametrize("size", [(517, 333), (64, 48), (1920, 1080)])
def test_restart_and_optimize_on_card_match_cpu(cuda, size, config, packer):
    """Each packer's kernel really runs (K4 for "fused", K5 for
    "assemble", with custom tables too) and the file is the CPU path's."""
    width, height = size
    rgb = np.random.default_rng(5).integers(0, 256, (height, width, 3), np.uint8)
    kernel = {"fused": entropy_kernel.ENTROPY, "assemble": pack_kernel.PACK}
    before = kernel[packer].launches
    got = pipeline.encode_array(rgb, config, device=cuda, packer=packer)
    assert kernel[packer].launches > before
    want = pipeline.encode_array(rgb, config, device="cpu")
    assert got.file_bytes == want.file_bytes


def _blocks_as_plane(blocks: torch.Tensor, blocks_x: int) -> torch.Tensor:
    """The (H, W) plane whose blockify is `blocks` (row-major blocks)."""
    n = blocks.shape[0]
    return (blocks.reshape(n // blocks_x, blocks_x, 8, 8).permute(0, 2, 1, 3)
            .reshape(n // blocks_x * 8, blocks_x * 8).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("quality", [None, 35])
@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("n", [70, 32640])
def test_block_kernels_match_plain_and_plane_kernels(cuda, n, is_luma,
                                                     quality):
    """K6a/b and K6c exactly against their plain versions, and against K1
    and K3 on a plane whose blocks they are (luma: the Y plane; chroma:
    the Cb plane)."""
    rng = np.random.default_rng(n + is_luma)
    blocks = torch.from_numpy(rng.integers(0, 256, (n, 64), dtype=np.uint8))
    dev = blocks.to(cuda)
    plane = _blocks_as_plane(dev, 10 if n == 70 else 240).to(cuda)
    other = torch.zeros((8, 8), dtype=torch.uint8, device=cuda)
    planes = (plane, other, other) if is_luma else (other, plane, plane)
    for kernel, fn, planes_fn in (
        (dct_kernel.REALDCT_BLOCKS, dct_kernel.real_dct_quant_zigzag,
         dct_kernel.real_dct_quant_planes_zigzag),
        (dct_kernel.BINDCT_BLOCKS, dct_kernel.bin_dct_quant_zigzag,
         dct_kernel.bin_dct_quant_planes_zigzag),
    ):
        before = kernel.launches
        got = fn(dev, is_luma, quality)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), fn(blocks, is_luma, quality))
        three = planes_fn(*planes, quality)
        assert torch.equal(got, three[0 if is_luma else 1].to(torch.int32))


def _batch_entries(config, cuda, size, count=3):
    """count corpus images' scan entries (on the CPU) and the geometry."""
    width, height = size
    images = np.stack([corpus.landscape(height, width, seed=s)
                       for s in range(count)])
    geom = config.geometry(width, height)
    z, _ = pipeline.scan_entries(torch.from_numpy(images).to(cuda), geom,
                                 config.dct_algorithm)
    return z.cpu(), geom


@pytest.mark.cuda
@pytest.mark.parametrize("interval", [None, 17, 120])
@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 2, 2), (4, 4, 4)])
def test_entropy_kernel_batch_matches_plain(cuda, ratio, interval):
    """K4 over three 517x333 images (num_mcus % 17 and % 120 are not 0, so
    intervals end at every image): per-image rows and intervals, Annex-K
    and per-image optimal tables, and at 64 bytes a row."""
    config = EncoderConfig(subsampling_ratio=ratio)
    z, geom = _batch_entries(config, cuda, (517, 333))
    epi = (geom.num_scan_entries if interval is None
           else entropy_ops.entries_per_interval(geom, interval))
    assert interval is None or geom.num_mcus % interval
    hists = entropy_ops.symbol_histograms(z, geom, interval)
    specs_luts = [pipeline.optimal_specs_and_luts(h.numpy(), "cpu")[1]
                  for h in hists]
    per_image = tuple(torch.stack([luts[i] for luts in specs_luts])
                      for i in (0, 1))
    cap = pipeline.restart_default_capacity_bytes(geom, interval or 10**4)
    for luts, capacity in ((None, cap), (per_image, cap), (None, 64)):
        args = dict(luts=luts, entries_per_interval=epi)
        want, want_bits = entropy_kernel.encode_entries(z, geom, capacity,
                                                        **args)
        dev_args = dict(args, luts=None if luts is None else tuple(
            t.to(cuda) for t in luts))
        before = entropy_kernel.ENTROPY.launches
        got, bits = entropy_kernel.encode_entries(z.to(cuda), geom, capacity,
                                                  **dev_args)
        torch.cuda.synchronize()
        assert entropy_kernel.ENTROPY.launches == before + 1
        assert bits.shape[0] == 3 * -(-geom.num_scan_entries // epi)
        assert torch.equal(bits.cpu(), want_bits)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "config",
    [EncoderConfig(), EncoderConfig(subsampling_ratio=(4, 4, 4), quality=90),
     EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT, restart_interval=7),
     EncoderConfig(optimize_huffman=True),
     EncoderConfig(optimize_huffman=True, restart_interval=5,
                   subsampling_ratio=(4, 2, 2))],
    ids=["default", "444-q90", "bin-restart7", "optimize",
         "optimize-restart5-422"],
)
def test_encode_batch_on_card_matches_cpu(cuda, config):
    """Five 517x333 images through encode_batch on the card, each file the
    single-image encode_array's on the CPU; one K4 launch codes them all."""
    images = np.stack([corpus.portrait(333, 517, seed=s) for s in range(5)])
    before = entropy_kernel.ENTROPY.launches
    files = batch.encode_batch(images, config, device=cuda)
    assert entropy_kernel.ENTROPY.launches == before + 1
    for rgb, got in zip(images, files):
        assert got == pipeline.encode_array(rgb, config, device="cpu").file_bytes
