"""The staged BMP read of the port's single-file entry, on CPU.

pipeline.encode_file reads a BMP file's stored pixel rows straight into
its thread's staging buffer (io/bmp.read(path, out=...)) and its program
strips, flips and swaps them on the device (bmp.rows_to_rgb). Held here:
the reorder against the host decode at widths with and without row
padding; encode_file's bytes against encode_array of the decoded array
and against the JAX package's NumPy oracle for every option the oracle
has (the others against encode_array alone: binDCT's descale and
--fast-dct); two files of one geometry through one buffer; the staged
read's errors against the decode's, with and without the native runtime;
the staged program's key; the programs replayed through a stand-in cache;
no unpinned buffer on a card. The oracle's helpers (and JAX with them)
are imported where a test asks for the oracle, so that the card test
runs where JAX is absent.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import graphs, pipeline
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_torch.io import bmp
from test_torch_graphs import graphed_cpu  # noqa: F401 (a fixture)

CPU = torch.device("cpu")
BIN = EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)


def _rgb(seed, height, width):
    return np.random.default_rng(seed).integers(
        0, 256, (height, width, 3), dtype=np.uint8)


def _write(tmp_path, rgb, name="in.bmp"):
    path = str(tmp_path / name)
    bmp.write(path, rgb)
    return path


# --------------------------------------------------------------------------
# The read and the reorder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("height", [1, 8, 13])
@pytest.mark.parametrize("width", [1, 2, 3, 5, 17, 33, 64])
def test_staged_rows_reorder_to_the_decoded_array(tmp_path, width, height):
    """read(out=buf) then rows_to_rgb equals read(path), into a buffer
    larger than the rows (its first bytes are used)."""
    path = _write(tmp_path, _rgb(width * 100 + height, height, width))
    stride = bmp.row_stride(width)
    assert stride % 4 == 0 and (stride == 3 * width) == (width % 4 == 0)
    buf = torch.full((height * stride + 7,), 0xAB, dtype=torch.uint8)
    staged = bmp.read(path, out=buf)
    assert (staged.width, staged.height) == (width, height)
    assert staged.rows.shape == (height, stride)
    assert staged.rows.data_ptr() == buf.data_ptr()
    with open(path, "rb") as f:
        stored = np.frombuffer(f.read()[54:], np.uint8)
    np.testing.assert_array_equal(staged.rows.numpy().ravel(), stored)
    got = bmp.rows_to_rgb(staged.rows, width)
    assert got.is_contiguous() and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), bmp.read(path))


def test_out_may_size_the_buffer_from_the_header(tmp_path):
    """out as a function: called once with the header's width and height,
    after the header is validated."""
    rgb = _rgb(3, 9, 11)
    path = _write(tmp_path, rgb)
    calls = []

    def out(width, height):
        calls.append((width, height))
        return torch.empty(height * bmp.row_stride(width), dtype=torch.uint8)

    staged = bmp.read(path, out=out)
    assert calls == [(11, 9)]
    np.testing.assert_array_equal(
        bmp.rows_to_rgb(staged.rows, staged.width).numpy(), rgb)


def test_out_too_small_or_not_bytes_raises(tmp_path):
    path = _write(tmp_path, _rgb(4, 5, 7))
    nbytes = 5 * bmp.row_stride(7)
    for buf in (torch.empty(nbytes - 1, dtype=torch.uint8),
                torch.empty(nbytes, dtype=torch.int16),
                torch.empty((5, bmp.row_stride(7)), dtype=torch.uint8)):
        with pytest.raises(ValueError, match="out must be"):
            bmp.read(path, out=buf)


def _bad_files():
    good = bmp.encode(_rgb(5, 6, 5))
    head = bytearray(good[:54])
    head[28] = 32
    return {
        "truncated": good[:-3],
        "header only": good[:54],
        "short": good[:20],
        "not a bmp": b"GIF89a" + bytes(100),
        "32-bit": bytes(head) + good[54:],
        "zero width": good[:18] + bytes(4) + good[22:],
    }


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("case", ["truncated", "header only", "short",
                                  "not a bmp", "32-bit", "zero width"])
def test_staged_errors_are_the_decodes(tmp_path, monkeypatch, native, case):
    """The staged read raises the ValueError text read(path) raises, with
    the native runtime and with the NumPy fallback."""
    if native:
        assert bmp.native.load() is not None
    else:
        monkeypatch.setattr(bmp.native, "load", lambda: None)
    path = str(tmp_path / "bad.bmp")
    with open(path, "wb") as f:
        f.write(_bad_files()[case])
    with pytest.raises(ValueError) as decoded:
        bmp.read(path)
    with pytest.raises(ValueError) as staged:
        bmp.read(path, out=torch.empty(1 << 12, dtype=torch.uint8))
    assert str(staged.value) == str(decoded.value)
    with pytest.raises(ValueError) as filed:
        pipeline.encode_file(path, str(tmp_path / "out.jpg"), device="cpu")
    assert str(filed.value) == str(decoded.value)


# --------------------------------------------------------------------------
# encode_file against encode_array and the oracle
# --------------------------------------------------------------------------

def _oracle(rgb, config):
    """The oracle's file for config, or None where it has no such option
    (--fast-dct, binDCT's descale)."""
    from jpeg_encoder_tpu import oracle
    from jpeg_encoder_tpu.io import jfif
    from test_torch_host import jax_config
    from test_torch_optimize import _oracle_file, _specs
    from test_torch_restart import _oracle_restart

    if config.fast_dct and config.dct_algorithm == DctAlgorithm.REAL_DCT:
        return None
    if config.bin_dct_descale and config.dct_algorithm == DctAlgorithm.BIN_DCT:
        return None
    if config.optimize_huffman:
        return _oracle_file(rgb, config, _specs(rgb, config))[0]
    if config.restart_interval is not None:
        return _oracle_restart(rgb, config, config.restart_interval)[0]
    golden = oracle.encode_oracle(rgb, jax_config(config))
    return jfif.assemble(golden.geom, golden.entropy_bytes,
                         quality=config.quality)


# (label, config, (height, width)): 40 * 3 bytes a row need no padding,
# 33 * 3 and 18 * 3 do; 33 x 17 is a quirk geometry at every ratio.
FILE_CASES = [
    ("4:2:0", EncoderConfig(), (24, 40)),
    ("4:2:2", EncoderConfig(subsampling_ratio=(4, 2, 2)), (24, 40)),
    ("4:4:4", EncoderConfig(subsampling_ratio=(4, 4, 4)), (24, 40)),
    ("quirk 4:2:0", EncoderConfig(), (17, 33)),
    ("quirk 4:2:2", EncoderConfig(subsampling_ratio=(4, 2, 2)), (17, 33)),
    ("quirk 4:4:4", EncoderConfig(subsampling_ratio=(4, 4, 4)), (17, 33)),
    ("quality 90", EncoderConfig(quality=90), (26, 18)),
    ("restart 2", EncoderConfig(restart_interval=2), (24, 40)),
    ("optimize", EncoderConfig(optimize_huffman=True), (26, 18)),
    ("optimize restart 3 4:4:4", EncoderConfig(
        optimize_huffman=True, restart_interval=3,
        subsampling_ratio=(4, 4, 4)), (24, 40)),
    ("bin-dct", BIN, (17, 33)),
    ("bin-dct descale", dataclasses.replace(BIN, bin_dct_descale=True),
     (24, 40)),
    ("fast-dct", EncoderConfig(fast_dct=True), (26, 18)),
]


@pytest.mark.parametrize("label,config,shape", FILE_CASES,
                         ids=[c[0] for c in FILE_CASES])
def test_encode_file_equals_encode_array_and_oracle(tmp_path, label, config,
                                                    shape):
    rgb = _rgb(sum(shape), *shape)
    path = _write(tmp_path, rgb)
    out = str(tmp_path / "out.jpg")
    result = pipeline.encode_file(path, out, config, device="cpu")
    with open(out, "rb") as f:
        got = f.read()
    want = pipeline.encode_array(bmp.read(path), config, device="cpu")
    assert got == result.file_bytes == want.file_bytes
    assert result.bit_length == want.bit_length
    assert result.entropy_payload == want.entropy_payload
    golden = _oracle(rgb, config)
    assert golden is None or got == golden


def test_staged_encode_array_keeps_return_coeffs(tmp_path):
    rgb = _rgb(6, 24, 40)
    path = _write(tmp_path, rgb)
    staged = bmp.read(path, out=torch.empty(24 * 120, dtype=torch.uint8))
    got, got_coeffs = pipeline.encode_array(staged, device="cpu",
                                            return_coeffs=True)
    want, want_coeffs = pipeline.encode_array(rgb, device="cpu",
                                              return_coeffs=True)
    assert got.file_bytes == want.file_bytes
    for a, b in zip(got_coeffs, want_coeffs):
        np.testing.assert_array_equal(a, b)


def test_two_files_of_one_geometry_through_one_buffer(tmp_path, monkeypatch):
    """Back to back through the thread's one buffer for the geometry, each
    file gives its own bytes; a second geometry gets a buffer of its own,
    and the least recently used goes past the slots."""
    staging = pipeline.StagingBuffers(slots=2)
    monkeypatch.setattr(pipeline, "STAGING", staging)
    taken = []
    take = staging.take
    monkeypatch.setattr(staging, "take", lambda *a: taken.append(take(*a))
                        or taken[-1])
    images = [_rgb(7, 24, 33), _rgb(8, 24, 33)]
    paths = [_write(tmp_path, rgb, f"in{i}.bmp")
             for i, rgb in enumerate(images)]
    files = [pipeline.encode_file(p, str(tmp_path / "out.jpg"),
                                  device="cpu").file_bytes for p in paths]
    assert files[0] != files[1]
    for rgb, got in zip(images, files):
        assert got == pipeline.encode_array(rgb, device="cpu").file_bytes
    assert taken[0] is taken[1]
    assert taken[0].buffer.numel() == 24 * bmp.row_stride(33)
    assert not taken[0].buffer.is_pinned() and taken[0].copied is None
    for shape in ((8, 8), (16, 8)):
        pipeline.encode_file(_write(tmp_path, _rgb(9, *shape)),
                             str(tmp_path / "out.jpg"), device="cpu")
    assert taken[-1] is not taken[0] and len(staging._local.held) == 2
    again = pipeline.encode_file(paths[0], str(tmp_path / "out.jpg"),
                                 device="cpu").file_bytes
    assert again == files[0] and taken[-1] is not taken[0]


def test_threads_take_buffers_of_their_own():
    import threading

    staging = pipeline.StagingBuffers()
    got = []
    thread = threading.Thread(
        target=lambda: got.append(staging.take(CPU, 8, 4)))
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    mine = staging.take(CPU, 8, 4)
    assert mine is staging.take(CPU, 8, 4) and got[0] is not mine


def test_a_card_buffer_that_is_not_pinned_raises(monkeypatch):
    """No quiet fallback to pageable memory: where pin_memory does not give
    a pinned tensor, Staging raises."""
    empty = torch.empty

    def unpinned(*args, pin_memory=False, **kwargs):
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", unpinned)
    with pytest.raises(RuntimeError, match="could not pin"):
        pipeline.Staging(torch.device("cuda", 0), 1 << 10)


# --------------------------------------------------------------------------
# The programs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("config", [EncoderConfig(),
                                    EncoderConfig(optimize_huffman=True)],
                         ids=["scan", "optimize"])
def test_staged_program_keys_differ_from_the_rgb_ones(config):
    geom = config.geometry(1920, 1080)
    capacity = pipeline.initial_capacity_bytes(geom, config)
    rgb = pipeline.program_keys(geom, config, capacity)
    rows = pipeline.program_keys(geom, config, capacity, source="bmp-rows")
    front = "stats" if config.optimize_huffman else "scan"
    assert rgb[front] != rows[front] and rows[front][-1] == "bmp-rows"
    assert rgb[front][-1] == "rgb"
    if config.optimize_huffman:
        assert rgb["custom"] == rows["custom"]


@pytest.mark.parametrize("config", [EncoderConfig(),
                                    EncoderConfig(optimize_huffman=True,
                                                  restart_interval=2)],
                         ids=["scan", "optimize restart 2"])
def test_staged_programs_replay(graphed_cpu, tmp_path, config):  # noqa: F811
    """Through a cache of stand-in programs: the first file's key runs
    eagerly, the second captures and replays, the third replays with the
    rows copied into the program's buffer; every file equals the path
    without the cache, and the staged and RGB forms hold programs of
    their own."""
    for seed in range(3):
        rgb = _rgb(seed, 24, 34)
        path = _write(tmp_path, rgb)
        got = pipeline.encode_file(path, str(tmp_path / "out.jpg"), config,
                                   device="cpu").file_bytes
        with graphs.disabled():
            want = pipeline.encode_array(rgb, config, device="cpu")
        assert got == want.file_bytes
        assert pipeline.encode_array(rgb, config,
                                     device="cpu").file_bytes == got
    keys = [key for key, _ in graphed_cpu.programs(CPU)]
    front = [k for k in keys if k[2] in ("scan", "stats")]
    assert sorted(k[-1] for k in front) == ["bmp-rows", "rgb"]
    staged = dict(graphed_cpu.programs(CPU))[
        next(k for k in front if k[-1] == "bmp-rows")]
    assert set(staged.inputs) == {"rows"} and staged.replays == 2
    assert staged.inputs["rows"].shape == (24, bmp.row_stride(34))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pinned staging and the card path")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_card_staged_files_equal_cpu(cuda, tmp_path, monkeypatch):
    staging = pipeline.StagingBuffers()
    monkeypatch.setattr(pipeline, "STAGING", staging)
    for seed in range(4):
        rgb = _rgb(seed, 1080, 1921)
        path = _write(tmp_path, rgb)
        got = pipeline.encode_file(path, str(tmp_path / "out.jpg"),
                                   device=cuda).file_bytes
        assert got == pipeline.encode_array(rgb, device="cpu").file_bytes
    buffer = staging.take(cuda, 1921, 1080).buffer
    assert buffer.is_pinned()
