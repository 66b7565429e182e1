"""The batch and stream programs: parallel/batch.py's three device programs
("batch", "batch_stats", "batch_custom", the JAX package's
compiled_batch_encoder, compiled_batch_stats_encoder and
compiled_batch_custom_encoder) run through graphs.run by encode_batch, every
share of a device list and the stream engine.

On the CPU no graph is built, so these tests use test_torch_graphs.py's
capture stand-in (graphed_cpu: a replay runs the program again into the
outputs its capture returned, as a graph's replay rewrites its static
outputs) and hold what the CPU can show: the keys (every EncoderConfig
field, the image count and the share), encode_batch's files over three
contents a key (eager, captured, replayed), with a short last chunk a key
of its own, equal to the eager path and to the JAX package's encode_batch,
the stream engine's files with its writer held back while the main thread
replays the key for the next chunks (and, with optimized Huffman, the main
thread held while the loader replays the statistics of the next chunks),
a second encode_paths call replaying what the first captured, and a failed
capture raising out of encode_batch and encode_paths.

The tests marked `cuda` replay real graphs against the eager card path; on
the card: python -m pytest tests/test_torch_batch_graphs.py -m cuda
--noconftest -q (JAX is imported inside the one test that compares with
it: the card's machine has none).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import graphs
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.parallel import batch, stream
from jpeg_encoder_torch.utils import corpus
from test_torch_graphs import cuda, graphed_cpu, stand_in_capture  # noqa: F401

CPU = torch.device("cpu")
BIN = EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)
OPTIMIZE = EncoderConfig(optimize_huffman=True)
HEIGHT, WIDTH = 32, 48
WAIT_S = 60  # a hold that is never released fails the test, not the suite


def _images(seed, count=3, height=HEIGHT, width=WIDTH):
    """Corpus content and noise in turn, distinct for each seed."""
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(0, 256, (height, width, 3), np.uint8) if i % 2
        else corpus.landscape(height, width, seed=10 * seed + i)
        for i in range(count)])


def _chunks_of(monkeypatch, images):
    """Cut batches into chunks of `images` images of HEIGHT x WIDTH."""
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET",
                        images * HEIGHT * WIDTH * 3)


# --------------------------------------------------------------------------
# The keys
# --------------------------------------------------------------------------

ALL = {"batch", "batch_stats", "batch_custom"}
FRONT = {"batch", "batch_stats"}   # the programs that run the front
CODED = {"batch", "batch_custom"}  # the programs that run K4

# (base config, field or "images", value, the programs whose key changes)
KEY_CASES = [
    (EncoderConfig(), "subsampling_ratio", (4, 4, 4), ALL),
    (EncoderConfig(), "dct_algorithm", DctAlgorithm.BIN_DCT, FRONT),
    (EncoderConfig(), "fast_dct", True, FRONT),
    (BIN, "fast_dct", True, set()),
    (BIN, "bin_dct_descale", True, FRONT),
    (EncoderConfig(), "bin_dct_descale", True, set()),
    (EncoderConfig(), "capacity_bytes_per_pixel", 4.0, CODED),
    (EncoderConfig(), "quality", 90, FRONT),
    (OPTIMIZE, "quality", 90, FRONT),
    (EncoderConfig(), "transposed_dct", False, set()),
    (EncoderConfig(), "optimize_huffman", True, set()),
    (EncoderConfig(), "restart_interval", 2, ALL),
    (EncoderConfig(restart_interval=2), "restart_interval", 3, ALL),
    (EncoderConfig(), "validate", True, set()),
    (EncoderConfig(), "images", 3, ALL),
]


def _keys(config, images=2):
    geom = config.geometry(1920, 1080)
    return batch.program_keys(geom, config,
                              batch.chunk_capacity_bytes(config, geom), images)


@pytest.mark.parametrize("base,field,value,changes", KEY_CASES,
                         ids=[f"{c[1]}={c[2]}-{c[0].dct_algorithm.name}"
                              f"{'-opt' if c[0].optimize_huffman else ''}"
                              for c in KEY_CASES])
def test_batch_program_keys(base, field, value, changes):
    """A field that changes what a batch program computes or its shapes
    changes that program's key, and no other; the exact image count is in
    every key (no power-of-two ladder)."""
    before = _keys(base)
    if field == "images":
        after = _keys(base, value)
    else:
        after = _keys(dataclasses.replace(base, **{field: value}))
    assert before.keys() == ALL
    assert {name for name in ALL if before[name] != after[name]} == changes


def test_every_config_field_has_a_batch_key_case():
    fields = {f.name for f in dataclasses.fields(EncoderConfig)}
    assert fields <= {c[1] for c in KEY_CASES}


@pytest.mark.parametrize("config", [EncoderConfig(), OPTIMIZE],
                         ids=["default", "optimize"])
def test_each_share_owns_its_programs(graphed_cpu, monkeypatch, config):
    """Two shares of a device (on the CPU they share a stream) get a program
    each under one key, their owners apart; three contents replay both,
    and the files are the eager path's."""
    _chunks_of(monkeypatch, 2)
    shares = ["cpu", "cpu"]
    for seed in range(3):
        images = _images(seed, 4)
        got = batch.encode_batch(images, config, device="cpu", devices=shares)
        with graphs.disabled():
            want = batch.encode_batch(images, config, device="cpu",
                                      devices=shares)
        assert got == want, seed
    programs = graphed_cpu.programs(CPU)
    names = ("batch_stats", "batch_custom") if config.optimize_huffman else (
        "batch",)
    assert sorted(key[2] for key, _ in programs) == sorted(names * 2)
    owners = {key[1] for key, _ in programs}
    assert owners == {(threading.get_ident(), 0), (threading.get_ident(), 1)}
    assert all(p.replays == 2 for _, p in programs)


# --------------------------------------------------------------------------
# encode_batch through stand-in programs
# --------------------------------------------------------------------------

REPLAY_CASES = [
    ("default", EncoderConfig()),
    ("4:2:2 bin-dct descale q90", dataclasses.replace(
        BIN, subsampling_ratio=(4, 2, 2), bin_dct_descale=True, quality=90)),
    ("4:4:4 fast-dct", EncoderConfig(subsampling_ratio=(4, 4, 4),
                                     fast_dct=True)),
    ("restart 3", EncoderConfig(restart_interval=3)),
    ("optimize", OPTIMIZE),
    ("optimize restart 2", dataclasses.replace(OPTIMIZE, restart_interval=2)),
]


@pytest.mark.parametrize("label,config", REPLAY_CASES,
                         ids=[c[0] for c in REPLAY_CASES])
def test_replayed_batch_equals_eager_and_jax(graphed_cpu, monkeypatch, label,
                                             config):
    """3 images in chunks of 2: a full chunk and a short last chunk, each a
    key. Three contents (eager, captured, replayed): every file equals the
    eager path's and the JAX package's encode_batch on a two-device CPU
    mesh."""
    from jpeg_encoder_tpu.parallel import batch as jax_batch
    from jpeg_encoder_tpu.parallel import mesh as jax_mesh
    from test_torch_host import jax_config

    _chunks_of(monkeypatch, 2)
    mesh = jax_mesh.data_mesh(2)
    for seed in range(3):
        images = _images(seed)
        got = batch.encode_batch(images, config, device="cpu")
        with graphs.disabled():
            want = batch.encode_batch(images, config, device="cpu")
        assert got == want, (label, seed)
        assert got == jax_batch.encode_batch(images, jax_config(config),
                                             mesh), (label, seed)
    geom = config.geometry(WIDTH, HEIGHT)
    capacity = batch.chunk_capacity_bytes(config, geom)
    names = (("batch_stats", "batch_custom") if config.optimize_huffman
             else ("batch",))
    programs = graphed_cpu.programs(CPU)
    assert {key[2:] for key, _ in programs} == {
        batch.program_keys(geom, config, capacity, images)[name]
        for images in (2, 1) for name in names}
    assert all(p.replays == 2 for _, p in programs)


def test_batch_retry_under_replayed_keys(graphed_cpu, monkeypatch):
    """A noise member at quality 100 overflows the chunk's shared capacity
    (16 KiB) and is retried alone through encode_array while the chunk's
    key replays (three contents): the files equal the eager path's."""
    config = EncoderConfig(subsampling_ratio=(4, 4, 4), quality=100)
    retried = []
    real_retry = batch._retry

    def retry(rgb, *args):
        retried.append(rgb)
        return real_retry(rgb, *args)

    monkeypatch.setattr(batch, "_retry", retry)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        images = np.stack([
            corpus.portrait(128, 128, seed=seed),
            rng.integers(0, 256, (128, 128, 3), np.uint8),
            corpus.portrait(128, 128, seed=seed + 5)])
        got = batch.encode_batch(images, config, device="cpu")
        with graphs.disabled():
            want = batch.encode_batch(images, config, device="cpu")
        assert got == want, seed
    assert len(retried) == 2 * 3  # the noise member, in both paths
    programs = {key[2]: p for key, p in graphed_cpu.programs(CPU)}
    assert programs.keys() == {"batch", "scan"}  # the retry's encode_array
    assert programs["batch"].replays == programs["scan"].replays == 2


def test_cpu_batch_and_stream_never_build_a_graph(monkeypatch, tmp_path):
    class Refused:
        def __init__(self, *args, **kwargs):
            raise AssertionError("a CUDA graph was built for CPU tensors")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Refused)
    monkeypatch.setattr(graphs, "CACHE", graphs.Cache())
    _chunks_of(monkeypatch, 1)
    images = _images(0)
    paths = _write(tmp_path, images)
    for config in (EncoderConfig(), OPTIMIZE):
        for _ in range(3):
            files = batch.encode_batch(images, config, device="cpu")
            got = {}
            stream.encode_paths(paths, config, got.__setitem__, device="cpu")
            assert [got[p] for p in paths] == files
    assert graphs.CACHE.programs(CPU) == []


# --------------------------------------------------------------------------
# The stream engine: outputs that outlive the next replay
# --------------------------------------------------------------------------

def _write(tmp_path, images, prefix="img"):
    paths = []
    for i, rgb in enumerate(images):
        paths.append(str(tmp_path / f"{prefix}{i:02d}.bmp"))
        bmp.write(paths[-1], rgb)
    return paths


def _counting(monkeypatch, name, calls, cond):
    """Replace batch.`name` with a spy that counts its calls in `calls`
    and notifies `cond` after each."""
    real = getattr(batch, name)

    def spy(*args):
        out = real(*args)
        with cond:
            calls.append(name)
            cond.notify_all()
        return out

    monkeypatch.setattr(batch, name, spy)


@pytest.mark.parametrize("config", [EncoderConfig(), OPTIMIZE],
                         ids=["default", "optimize"])
def test_stream_outputs_outlive_the_next_replays(graphed_cpu, monkeypatch,
                                                 tmp_path, config):
    """Six one-image chunks of one key (eager, captured, then replayed). The
    writer's first emit waits until the main thread has dispatched two more
    chunks, so it fetches chunk 1 after the key's replay for chunk 2; with
    optimized Huffman the main thread also waits, before it reads chunk 1's
    counts and entries, until the loader has replayed the statistics of
    chunks 2 and 3. Every file equals the eager path's: each leg cloned
    what another thread reads."""
    _chunks_of(monkeypatch, 1)
    images = _images(7, 6)
    paths = _write(tmp_path, images)
    with graphs.disabled():
        want = {}
        stream.encode_paths(paths, config, want.__setitem__, device="cpu")
    cond = threading.Condition()
    encoded, counted, held = [], [], []
    encode = ("dispatch_optimized_encode" if config.optimize_huffman
              else "dispatch_uploaded")
    _counting(monkeypatch, encode, encoded, cond)
    if config.optimize_huffman:
        _counting(monkeypatch, "optimized_stats_uploaded", counted, cond)
        real_luts = batch.build_chunk_luts
        tables = []

        def luts(hists):
            tables.append(hists)
            if len(tables) == 2:  # chunk 1's counts, read in place
                with cond:
                    held.append(cond.wait_for(lambda: len(counted) >= 4,
                                              WAIT_S))
            return real_luts(hists)

        monkeypatch.setattr(batch, "build_chunk_luts", luts)
    got = {}

    def emit(path, data):
        if not got:
            with cond:
                held.append(cond.wait_for(lambda: len(encoded) >= 3, WAIT_S))
        got[path] = data

    stream.encode_paths(paths, config, emit, device="cpu")
    assert held == [True] * (2 if config.optimize_huffman else 1)
    assert [got[p] for p in paths] == [want[p] for p in paths]
    assert all(p.replays == 5 for _, p in graphed_cpu.programs(CPU))


@pytest.mark.parametrize("config", [EncoderConfig(), OPTIMIZE],
                         ids=["default", "optimize"])
def test_a_second_stream_call_replays(monkeypatch, tmp_path, config):
    """The loader and writer threads are new in every call; the programs'
    owner is the calling thread with the leg and the share, so a second
    call over the same geometry replays the first call's programs and
    captures none."""
    captures = []

    def capture(*args, **kwargs):
        captures.append(1)
        return stand_in_capture(*args, **kwargs)

    cache = graphs.Cache(capture=capture)
    monkeypatch.setattr(graphs, "CACHE", cache)
    monkeypatch.setattr(graphs, "_graphed", lambda device: graphs.enabled())
    _chunks_of(monkeypatch, 1)
    images = _images(3)
    paths = _write(tmp_path, images)
    with graphs.disabled():
        want = {}
        stream.encode_paths(paths, config, want.__setitem__, device="cpu")
    got = {}
    stream.encode_paths(paths, config, got.__setitem__, device="cpu")
    first = len(captures)
    assert first == (2 if config.optimize_huffman else 1)
    got2 = {}
    stream.encode_paths(paths, config, got2.__setitem__, device="cpu")
    assert len(captures) == first
    assert got == got2 == want
    assert all(p.replays == 2 + 3 for _, p in cache.programs(CPU))


@pytest.mark.parametrize("config", [EncoderConfig(), OPTIMIZE],
                         ids=["default", "optimize"])
def test_a_failed_capture_raises(monkeypatch, tmp_path, config):
    """No fallback: the second chunk of a key captures, and a capture that
    fails raises out of encode_batch and out of encode_paths (from the
    main thread, or from the loader's statistics with optimized
    Huffman)."""

    def refuse(*args, **kwargs):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(graphs, "CACHE", graphs.Cache(capture=refuse))
    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    _chunks_of(monkeypatch, 1)
    images = _images(0, 2)
    batch.encode_batch(images[:1], config, device="cpu")
    with pytest.raises(RuntimeError, match="capture refused"):
        batch.encode_batch(images, config, device="cpu")
    graphs.CACHE.clear()
    paths = _write(tmp_path, images)
    with pytest.raises(RuntimeError, match="capture refused"):
        stream.encode_paths(paths, config, lambda p, d: None, device="cpu")


# --------------------------------------------------------------------------
# On the card: real graphs against the eager card path
# --------------------------------------------------------------------------

CARD_CONFIGS = [EncoderConfig(), EncoderConfig(restart_interval=120),
                OPTIMIZE, dataclasses.replace(
                    BIN, subsampling_ratio=(4, 4, 4), bin_dct_descale=True)]


def _frames(count, seed):
    frames = list(corpus.images(1080, 1920).values())
    return np.stack([np.roll(frames[i % len(frames)], 97 * (seed + i), 1)
                     for i in range(count)])


@pytest.mark.cuda
@pytest.mark.parametrize("config", CARD_CONFIGS,
                         ids=["default", "restart", "optimize", "bin"])
def test_card_batch_replays_equal_eager(cuda, monkeypatch, config):
    """5 1080p frames in chunks of 3 (a short last chunk of 2), alone and
    over [cuda] * 2, three contents; then one more call launches each DCT
    and K4 once a chunk and share (one replay each)."""
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 3 * 1080 * 1920 * 3)
    for seed in range(3):
        images = _frames(5, seed)
        for devices in (None, [cuda] * 2):
            got = batch.encode_batch(images, config, device=cuda,
                                     devices=devices)
            with graphs.disabled():
                want = batch.encode_batch(images, config, device=cuda,
                                          devices=devices)
            assert got == want, (seed, devices)
    for kernel in (dct_kernel.REALDCT, dct_kernel.BINDCT,
                   entropy_kernel.ENTROPY):
        kernel.launches = 0
    batch.encode_batch(_frames(5, 3), config, device=cuda)
    dct = (dct_kernel.BINDCT if config.dct_algorithm == DctAlgorithm.BIN_DCT
           else dct_kernel.REALDCT)
    assert dct.launches == 2 and entropy_kernel.ENTROPY.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("config", [EncoderConfig(), OPTIMIZE],
                         ids=["default", "optimize"])
def test_card_stream_held_writer_equals_eager(cuda, monkeypatch, tmp_path,
                                              config):
    """Six 1080p frames in chunks of 1; the writer's first emit held until
    the main thread has dispatched two more chunks; every file equals the
    eager card path's, in this call and in a second one."""
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 1080 * 1920 * 3)
    paths = _write(tmp_path, _frames(6, 0))
    with graphs.disabled():
        want = {}
        stream.encode_paths(paths, config, want.__setitem__, device=cuda)
    cond = threading.Condition()
    encoded = []
    _counting(monkeypatch, "dispatch_optimized_encode"
              if config.optimize_huffman else "dispatch_uploaded", encoded,
              cond)
    for _ in range(2):
        got, held = {}, []
        start = len(encoded)

        def emit(path, data):
            if not got:
                with cond:
                    held.append(cond.wait_for(
                        lambda: len(encoded) >= start + 3, WAIT_S))
            got[path] = data

        stream.encode_paths(paths, config, emit, device=cuda)
        assert held == [True] and got == want
