"""The port's stream engine (parallel/stream.py) on the CPU, against the JAX
package's.

jpeg_encoder_torch.parallel.stream.encode_paths runs its three legs
(loader, dispatch, writer) with the kernels' plain versions on the CPU and
must emit the files of jpeg_encoder_tpu.parallel.stream.encode_paths run on
a virtual CPU mesh, on the same numpy-made BMPs: mixed dimension groups
over several chunks, restart markers every 2 MCUs, optimized Huffman. Its
StreamStats counts equal the JAX engine's, emit() follows path order within
each group and groups in first-seen order, and a failing emit() or a
corrupt BMP in the middle chunk surfaces as the caller's exception without
a hang (each such call runs in a thread joined with a timeout of the
test's own). The cases marked `cuda` run the engine on the card against
encode_batch and skip elsewhere; the JAX package is imported inside the
tests that use it, so that the card machine, which has no JAX, collects
this file (python -m pytest tests/test_torch_stream.py -m cuda
--noconftest).
"""

import sys
import threading

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.parallel import batch
from jpeg_encoder_torch.parallel import stream
from jpeg_encoder_torch.utils import corpus

TIMEOUT_S = 240  # a hang fails the test instead of stalling the suite


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _write_bmps(tmp_path, shapes, seed=0, prefix="img"):
    """One BMP a shape, corpus content and noise in turn: (paths, {path:
    rgb})."""
    rng = np.random.default_rng(seed)
    paths, images = [], {}
    for i, (height, width) in enumerate(shapes):
        if i % 2:
            rgb = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        else:
            rgb = corpus.landscape(height, width, seed=seed + i)
        path = str(tmp_path / f"{prefix}{i:02d}.bmp")
        bmp.write(path, rgb)
        paths.append(path)
        images[path] = rgb
    return paths, images


def _bounded(fn):
    """fn() in a thread joined with TIMEOUT_S: its result, or the exception
    it raised, returned as such."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the test
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(TIMEOUT_S)
    assert not t.is_alive(), f"encode_paths still running after {TIMEOUT_S} s"
    return out


MIXED = [(24, 32) if i % 3 else (16, 24) for i in range(9)]


@pytest.mark.parametrize(
    "config, shapes, budget_images, mesh_devices",
    [(EncoderConfig(), MIXED, 1, 8),
     (EncoderConfig(restart_interval=2), [(32, 48)] * 4, 1, 2),
     (EncoderConfig(optimize_huffman=True), [(32, 48)] * 5, 2, 2)],
    ids=["mixed-groups", "restart-2", "optimize"],
)
def test_stream_matches_jax_stream(tmp_path, monkeypatch, config, shapes,
                                   budget_images, mesh_devices):
    """Every file, the counts of StreamStats, and the emit order equal the
    JAX engine's (each with its own chunk budget cut to a few images, so
    both run several chunks); every file is also the port's single-image
    file."""
    import jax
    from jpeg_encoder_tpu.parallel import batch as jax_batch
    from jpeg_encoder_tpu.parallel import mesh as jax_mesh
    from jpeg_encoder_tpu.parallel import stream as jax_stream
    from test_torch_host import jax_config

    if len(jax.devices()) < mesh_devices:
        pytest.skip(f"needs {mesh_devices} virtual devices")
    height, width = shapes[-1]
    budget = budget_images * height * width * 3
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", budget)
    monkeypatch.setattr(jax_batch, "CHUNK_INPUT_BUDGET", budget)
    paths, images = _write_bmps(tmp_path, shapes, seed=len(shapes))
    geom = config.geometry(width, height)
    assert batch.chunk_size_images(geom) == budget_images

    want, want_order = {}, []

    def jax_emit(path, data):
        want[path] = data
        want_order.append(path)

    want_stats = jax_stream.encode_paths(
        paths, jax_config(config), jax_mesh.data_mesh(mesh_devices), jax_emit)
    got, order = {}, []

    def emit(path, data):
        got[path] = data
        order.append(path)

    stats = stream.encode_paths(paths, config, emit, device="cpu")
    assert got == want
    assert order == want_order
    first = [p for p in paths if images[p].shape == images[paths[0]].shape]
    assert order == first + [p for p in paths if p not in first]
    for name in ("encoded", "output_bytes", "pixels"):
        assert getattr(stats, name) == getattr(want_stats, name), name
    assert stats.encoded == len(paths)
    assert stats.seconds > 0 and stats.decode_seconds > 0
    for path in paths:
        single = pipeline.encode_array(images[path], config, device="cpu")
        assert got[path] == single.file_bytes


def test_stream_emit_failure_surfaces(tmp_path, monkeypatch):
    """An emit() failure is the caller's exception: no hang, no silent
    success, and nothing emitted after it."""
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 2 * 16 * 16 * 3)
    paths, _ = _write_bmps(tmp_path, [(16, 16)] * 6)
    calls = []

    def bad_emit(path, data):
        calls.append(path)
        raise OSError("disk full (simulated)")

    out = _bounded(lambda: stream.encode_paths(
        paths, EncoderConfig(), bad_emit, device="cpu"))
    assert isinstance(out.get("error"), OSError), out
    assert "disk full" in str(out["error"])
    assert calls == paths[:1]


def test_stream_corrupt_bmp_in_middle_chunk_surfaces(tmp_path, monkeypatch):
    """A truncated BMP in the middle of three chunks raises the decoder's
    error from the loader; the first chunk's files stand (the writer
    finishes what was dispatched), nothing past them is emitted."""
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 2 * 16 * 24 * 3)
    paths, _ = _write_bmps(tmp_path, [(16, 24)] * 6)
    with open(paths[3], "rb") as f:
        data = f.read()
    with open(paths[3], "wb") as f:
        f.write(data[: len(data) // 2])  # the header stands, pixels cut
    emitted = []
    out = _bounded(lambda: stream.encode_paths(
        paths, EncoderConfig(), lambda p, d: emitted.append(p),
        device="cpu"))
    assert isinstance(out.get("error"), ValueError), out
    assert "truncated" in str(out["error"])
    assert emitted == paths[:2]


def test_stream_many_chunks_under_fast_thread_switching(tmp_path,
                                                       monkeypatch):
    """Twenty-four one-image chunks with the interpreter switching threads
    every microsecond: every file is the single-image one, emitted once and
    in order, and the counts add up (a lost update or a race between the
    legs would break one of them)."""
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 8 * 16 * 3)
    paths, images = _write_bmps(tmp_path, [(8, 16)] * 24, seed=9)
    order = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = _bounded(lambda: stream.encode_paths(
            paths, EncoderConfig(), lambda p, d: order.append((p, d)),
            device="cpu"))
    finally:
        sys.setswitchinterval(switch)
    stats = out["value"]
    assert [p for p, _ in order] == paths
    assert stats.encoded == 24 and stats.pixels == 24 * 8 * 16
    assert stats.output_bytes == sum(len(d) for _, d in order)
    for p, d in order:
        assert d == pipeline.encode_array(images[p], EncoderConfig(),
                                          device="cpu").file_bytes


def test_read_into_fills_a_buffer_and_checks_it(tmp_path):
    """io/bmp.read_into, the loader's decode: the file's image lands in the
    given (H, W, 3) buffer; a buffer of other dimensions or not contiguous
    is refused, and so is a truncated file."""
    paths, images = _write_bmps(tmp_path, [(17, 33)])
    out = np.zeros((2, 17, 33, 3), np.uint8)
    second = out[1]
    assert bmp.read_into(paths[0], second) is second
    assert np.array_equal(second, images[paths[0]]) and not out[0].any()
    for bad in (np.zeros((17, 32, 3), np.uint8), out[:, 0]):
        with pytest.raises(ValueError, match="out must be"):
            bmp.read_into(paths[0], bad)
    with open(paths[0], "rb") as f:
        data = f.read()
    with open(paths[0], "wb") as f:
        f.write(data[:100])
    with pytest.raises(ValueError, match="truncated"):
        bmp.read_into(paths[0], out[0])


def test_stream_refuses_before_any_work(tmp_path):
    """A quirk geometry under restart markers and a foreign config raise
    before any thread starts; without a device argument the stream goes to
    the card, and with no card it raises (no fallback)."""
    from test_torch_host import jax_config

    paths, _ = _write_bmps(tmp_path, [(17, 33)])
    with pytest.raises(ValueError, match="quirk geometry"):
        stream.encode_paths(paths, EncoderConfig(restart_interval=2),
                            lambda p, d: None, device="cpu")
    with pytest.raises(TypeError):
        stream.encode_paths(paths, jax_config(EncoderConfig()),
                            lambda p, d: None, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        stream.encode_paths(paths, EncoderConfig(), lambda p, d: None,
                            device="meta")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            stream.encode_paths(paths, EncoderConfig(), lambda p, d: None)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "config",
    [EncoderConfig(), EncoderConfig(restart_interval=3),
     EncoderConfig(optimize_huffman=True),
     EncoderConfig(optimize_huffman=True, restart_interval=5,
                   subsampling_ratio=(4, 4, 4))],
    ids=["default", "restart-3", "optimize", "optimize-restart-5-444"],
)
def test_stream_on_card_matches_encode_batch(cuda, tmp_path, monkeypatch,
                                             config):
    """On the card, over two dimension groups and several chunks each, the
    engine's files == encode_batch's on the card, and K4 codes every
    chunk."""
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 3 * 333 * 517 * 3)
    shapes = [(333, 517)] * 7 + [(64, 48)] * 3
    paths, images = _write_bmps(tmp_path, shapes, seed=3)
    got = {}
    before = entropy_kernel.ENTROPY.launches
    stats = stream.encode_paths(paths, config, got.__setitem__)
    assert entropy_kernel.ENTROPY.launches - before == 3 + 1
    assert stats.encoded == len(paths)
    for group in (paths[:7], paths[7:]):
        want = batch.encode_batch(np.stack([images[p] for p in group]),
                                  config, device=cuda)
        assert [got[p] for p in group] == want
