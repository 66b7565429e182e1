"""The CUDA kernels against their plain PyTorch versions.

The tests marked `cuda` need an NVIDIA GPU with nvcc and skip elsewhere;
on the card they run with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which that machine lacks.)

They build csrc/*.cu, launch each kernel at small and at 1080p shapes and
require exact equality with the plain version run on CPU tensors, except
K2 (--fast-dct), which is held to max |diff| 1 at mismatch rates below
1e-3 against its plain version and 5e-4 against the exact K1. The
unmarked tests run everywhere and pin the build's behaviour.
"""

import os

import numpy as np
import pytest
import torch

from jpeg_encoder_tpu import tables
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_tpu.utils import corpus
from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.kernels import _build
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops

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
    """The four kernels are the four csrc sources, each replacing a Pallas
    kernel at a file:line that holds a pallas_call's entry point."""
    kernels = (dct_kernel.REALDCT, dct_kernel.FASTDCT, dct_kernel.BINDCT,
               entropy_kernel.ENTROPY)
    assert sorted(k.name for k in kernels) == _build.names()
    for k in kernels:
        assert k.source == f"jpeg_encoder_torch/csrc/{k.name}.cu"
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
