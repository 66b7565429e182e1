"""The compiled-program layer (jpeg_encoder_torch/graphs.py): the cache of
CUDA graphs that encode_array and the band path run their device programs
through.

On the CPU no graph is ever built, so these tests hold what the CPU can
show: the keys (every EncoderConfig field that changes a device program
changes its key, the others leave it alone), that CPU tensors never
construct a torch.cuda.CUDAGraph, the cache's policy (first call eager,
second captures, later calls replay; the LRU bounds; one cache a device)
with a capture stand-in, the launch bookkeeping of a replay, that a failed
capture raises out of encode_array, that a capture builds no operand even
when the operand caches were emptied since the warm-up, and the
static-buffer plumbing: with a stand-in whose replay runs the program
again into the captured outputs, every file of every option equals the
plain path's, and the JAX package's.
The capture-safe repairs (histograms without bincount, cached byte
shifts) are held to the JAX package and to their old forms.

The tests marked `cuda` replay real graphs against the eager card path;
on the card: python -m pytest tests/test_torch_graphs.py -m cuda
--noconftest -q (JAX is imported inside the two tests that compare with
it: the card's machine has none).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import graphs, pipeline
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_torch.kernels import _build
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.ops import entropy
from jpeg_encoder_torch.parallel import tiled
from jpeg_encoder_torch.utils import corpus

CPU = torch.device("cpu")
BIN = EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)


# --------------------------------------------------------------------------
# The key
# --------------------------------------------------------------------------

def _keys(config, **kw):
    geom = config.geometry(1920, 1080)
    return pipeline.program_keys(
        geom, config, pipeline.initial_capacity_bytes(geom, config), **kw)


# (base config, field or keyword, value, whether the programs change)
KEY_CASES = [
    (EncoderConfig(), "subsampling_ratio", (4, 4, 4), True),
    (EncoderConfig(), "dct_algorithm", DctAlgorithm.BIN_DCT, True),
    (EncoderConfig(), "fast_dct", True, True),
    (BIN, "fast_dct", True, False),
    (BIN, "bin_dct_descale", True, True),
    (EncoderConfig(), "bin_dct_descale", True, False),
    (EncoderConfig(), "capacity_bytes_per_pixel", 4.0, True),
    (EncoderConfig(), "quality", 90, True),
    (EncoderConfig(), "transposed_dct", False, False),
    (EncoderConfig(), "optimize_huffman", True, True),
    (EncoderConfig(), "restart_interval", 120, True),
    (EncoderConfig(restart_interval=120), "restart_interval", 7, True),
    (EncoderConfig(), "validate", True, True),
    (EncoderConfig(optimize_huffman=True), "validate", True, True),
    (EncoderConfig(optimize_huffman=True), "quality", 90, True),
    (EncoderConfig(), "with_coeffs", True, True),
    (EncoderConfig(), "packer", "assemble", True),
]


@pytest.mark.parametrize("base,field,value,changes", KEY_CASES,
                         ids=[f"{c[1]}={c[2]}-{c[0].dct_algorithm.name}"
                              f"{'-opt' if c[0].optimize_huffman else ''}"
                              for c in KEY_CASES])
def test_program_keys(base, field, value, changes):
    """A field that changes what the device program computes or its shapes
    changes the key; one the program ignores leaves it alone."""
    if field in ("with_coeffs", "packer"):
        before, after = _keys(base), _keys(base, **{field: value})
    else:
        before = _keys(base)
        after = _keys(dataclasses.replace(base, **{field: value}))
    assert (before != after) == changes


def test_every_config_field_has_a_key_case():
    fields = {f.name for f in dataclasses.fields(EncoderConfig)}
    assert fields <= {c[1] for c in KEY_CASES}


# --------------------------------------------------------------------------
# The CPU path, and a capture stand-in
# --------------------------------------------------------------------------

def _rgb(seed, height=32, width=48):
    return np.random.default_rng(seed).integers(0, 256, (height, width, 3),
                                                dtype=np.uint8)


def test_cpu_never_builds_a_graph(monkeypatch):
    """CPU tensors go around the cache: nothing constructs a CUDAGraph, and
    the cache holds nothing for the CPU."""

    class Refused:
        def __init__(self, *args, **kwargs):
            raise AssertionError("a CUDA graph was built for CPU tensors")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Refused)
    monkeypatch.setattr(graphs, "CACHE", graphs.Cache())
    rgb = _rgb(1)
    for config in (EncoderConfig(), EncoderConfig(optimize_huffman=True),
                   EncoderConfig(restart_interval=3)):
        files = {pipeline.encode_array(rgb, config, device="cpu").file_bytes
                 for _ in range(3)}
        tiles = {tiled.encode_tiled(rgb, config, 2, device="cpu",
                                    devices=["cpu", "cpu"]).file_bytes
                 for _ in range(3)}
        assert len(files) == 1 and files == tiles
    assert graphs.CACHE.programs(CPU) == []


class ReplayStandIn:
    """A graph for the CPU: replay() runs the program again on its static
    inputs and writes the result into the outputs it first returned, in
    place, as a graph's replay rewrites its static outputs."""

    def __init__(self, fn, static):
        self.fn, self.static = fn, static
        self.outputs = fn(**static)

    def replay(self):
        _copy_into(self.outputs, self.fn(**self.static))


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for name in dst:
            _copy_into(dst[name], src[name])
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


def stand_in_record(fn, buffers, device, launches=None, pool_bytes=1):
    """graphs.record for the CPU: a ReplayStandIn."""
    graph = ReplayStandIn(fn, buffers)
    return graph, graph.outputs, dict(launches or {}), 0.0, pool_bytes


# graphs.capture (static buffers, the warm-up, pinned operands) around it.
stand_in_capture = functools.partial(graphs.capture, record=stand_in_record)


@pytest.fixture
def graphed_cpu(monkeypatch):
    """CPU tensors through a cache of stand-in programs, as card tensors go
    through graphs (graphs.disabled() still turns it off)."""
    cache = graphs.Cache(capture=stand_in_capture)
    monkeypatch.setattr(graphs, "CACHE", cache)
    monkeypatch.setattr(graphs, "_graphed", lambda device: graphs.enabled())
    return cache


REPLAY_CASES = [
    ("default", EncoderConfig(), {}),
    ("4:2:2 bin-dct descale q90", EncoderConfig(
        subsampling_ratio=(4, 2, 2), dct_algorithm=DctAlgorithm.BIN_DCT,
        bin_dct_descale=True, quality=90), {}),
    ("4:4:4 fast-dct", EncoderConfig(subsampling_ratio=(4, 4, 4),
                                     fast_dct=True), {}),
    ("restart 3", EncoderConfig(restart_interval=3), {}),
    ("optimize", EncoderConfig(optimize_huffman=True), {}),
    ("optimize restart 2 bin-dct", dataclasses.replace(
        BIN, optimize_huffman=True, restart_interval=2), {}),
    ("validate", EncoderConfig(validate=True), {}),
    ("assemble", EncoderConfig(), {"packer": "assemble"}),
    ("assemble optimize restart 2", EncoderConfig(
        optimize_huffman=True, restart_interval=2), {"packer": "assemble"}),
    ("ladder", EncoderConfig(), {"_initial_capacity_bytes": 64}),
    ("ladder restart 2", EncoderConfig(restart_interval=2),
     {"_initial_capacity_bytes": 8}),
    ("ladder optimize", EncoderConfig(optimize_huffman=True),
     {"_initial_capacity_bytes": 64}),
    ("quirk 33x17", EncoderConfig(), {"shape": (17, 33)}),
]


@pytest.mark.parametrize("label,config,kw", REPLAY_CASES,
                         ids=[c[0] for c in REPLAY_CASES])
def test_replayed_files_equal_eager(graphed_cpu, label, config, kw):
    """Three contents a key: the first eager, the second captured and
    replayed, the third replayed into the same buffers; every file (and
    the coefficients) equals the path without the cache."""
    kw = dict(kw)
    shape = kw.pop("shape", (32, 48))
    for seed in range(3):
        rgb = _rgb(seed, *shape)
        got = pipeline.encode_array(rgb, config, device="cpu", **kw)
        with graphs.disabled():
            want = pipeline.encode_array(rgb, config, device="cpu", **kw)
        assert got.file_bytes == want.file_bytes, (label, seed)
    programs = graphed_cpu.programs(CPU)
    assert len(programs) == (2 if config.optimize_huffman else 1)
    assert all(p.replays == 2 for _, p in programs)


def test_replayed_coefficients_equal_eager(graphed_cpu):
    for seed in range(3):
        rgb = _rgb(seed)
        got = pipeline.encode_array(rgb, device="cpu", return_coeffs=True)
        with graphs.disabled():
            want = pipeline.encode_array(rgb, device="cpu",
                                         return_coeffs=True)
        assert got[0].file_bytes == want[0].file_bytes
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("config", [
    EncoderConfig(), EncoderConfig(restart_interval=3),
    EncoderConfig(optimize_huffman=True),
], ids=["unbroken", "restart 3", "optimize"])
def test_replayed_band_files_equal_encode_array(graphed_cpu, config):
    """The band programs (front, statistics, encode) replayed over three
    contents: one run of 3 bands, runs of 2 and 1 over two shares, and four
    runs of one band over four shares, alike but for their first band (on
    the CPU every share has the one stream). The files of encode_array."""
    for seed in range(3):
        rgb = _rgb(seed, 64, 48)
        with graphs.disabled():
            want = pipeline.encode_array(rgb, config, device="cpu").file_bytes
        for bands, devices in ((3, None), (3, ["cpu"] * 2), (4, ["cpu"] * 4)):
            got = tiled.encode_tiled(rgb, config, bands, device="cpu",
                                     devices=devices)
            assert got.file_bytes == want, (seed, bands, devices)
    assert all(p.replays == 2 for _, p in graphed_cpu.programs(CPU))


@pytest.mark.parametrize("config", [
    EncoderConfig(), EncoderConfig(optimize_huffman=True, restart_interval=2),
], ids=["default", "optimize restart 2"])
def test_replayed_files_equal_jax(graphed_cpu, config):
    """The slice as a whole against the JAX package's compiled encoders: the
    third call of a key (a replay) gives the JAX package's file."""
    from jpeg_encoder_tpu import pipeline as jax_pipeline
    from test_torch_host import jax_config

    rgb = corpus.landscape(32, 48)
    want = jax_pipeline.encode_array(rgb, jax_config(config)).file_bytes
    for _ in range(3):
        got = pipeline.encode_array(rgb, config, device="cpu").file_bytes
    assert got == want


# --------------------------------------------------------------------------
# The cache's policy and bookkeeping
# --------------------------------------------------------------------------

class Counted:
    """A program fn that counts its eager runs, and a capture stub that
    counts captures and makes programs of a given pool size."""

    def __init__(self, pool_bytes=1, launches=None):
        self.calls = self.captures = 0
        self.pool_bytes, self.launches = pool_bytes, launches or {}

    def fn(self, x=None):
        self.calls += 1
        return {"out": torch.zeros(1)}

    def capture(self, fn, inputs, device, pad=None):
        self.captures += 1
        return graphs.capture(fn, inputs, device, pad, functools.partial(
            stand_in_record, launches=self.launches,
            pool_bytes=self.pool_bytes))


def test_first_call_eager_second_captures_then_replays():
    stub = Counted()
    cache = graphs.Cache(capture=stub.capture)
    x = torch.arange(4)
    first = cache.run(("k",), stub.fn, {"x": x}, CPU)
    assert (stub.calls, stub.captures) == (1, 0)
    assert cache.programs(CPU) == []
    second = cache.run(("k",), stub.fn, {"x": x}, CPU)
    assert stub.captures == 1 and first is not second
    third = cache.run(("k",), stub.fn, {"x": x}, CPU)
    assert stub.captures == 1 and third is second
    (key, program), = cache.programs(CPU)
    assert key == ("k",) and program.replays == 2
    assert program.inputs["x"] is not x  # a static copy, not the caller's


def test_padded_input_takes_zero_rows():
    """An input named in pad reaches the program with zero rows below it,
    eager, captured and replayed; a replay copies only the input's rows."""
    seen = []

    def fn(x):
        seen.append(x.clone())
        return {"sum": x.sum(0)}

    cache = graphs.Cache(capture=stand_in_capture)
    for k in range(4):
        x = torch.full((2, 3), k + 1)
        out = cache.run(("k",), fn, {"x": x}, CPU, pad={"x": 5})
        assert torch.equal(out["sum"], torch.full((3,), 2 * (k + 1)))
    want = torch.zeros(5, 3, dtype=torch.int64)
    assert all(t.shape == (5, 3) and torch.equal(t[2:], want[2:])
               for t in seen)
    (_, program), = cache.programs(CPU)
    assert program.inputs["x"].shape == (2, 3)  # the view copied into
    assert torch.equal(graphs.eager(fn, {"x": x}, CPU, {"x": 5})["sum"],
                       out["sum"])


def _fill(cache, stub, keys):
    for key in keys:
        for _ in range(2):
            cache.run((key,), stub.fn, {}, CPU)


@pytest.mark.parametrize("bound", ["bytes", "count"])
def test_lru_bound_evicts_least_recent(bound):
    stub = Counted(pool_bytes=10)
    cache = (graphs.Cache(capture=stub.capture, max_pool_bytes=25)
             if bound == "bytes"
             else graphs.Cache(capture=stub.capture, max_programs=2))
    _fill(cache, stub, "ab")
    cache.run(("a",), stub.fn, {}, CPU)  # a is now the most recent
    _fill(cache, stub, "c")
    assert [k for k, _ in cache.programs(CPU)] == [("a",), ("c",)]
    assert cache.evictions == 1
    # The evicted key starts again: one eager call, then a capture.
    calls, captures = stub.calls, stub.captures
    cache.run(("b",), stub.fn, {}, CPU)
    assert (stub.calls - calls, stub.captures - captures) == (1, 0)
    cache.run(("b",), stub.fn, {}, CPU)
    assert stub.captures - captures == 1 and cache.evictions == 2


def test_one_cache_a_device():
    stub = Counted()
    cache = graphs.Cache(capture=stub.capture, max_programs=1)
    cards = torch.device("cuda", 0), torch.device("cuda", 1)
    for device in cards:
        for _ in range(2):
            cache.run(("k",), stub.fn, {}, device)
    assert stub.captures == 2 and cache.evictions == 0
    assert all(len(cache.programs(d)) == 1 for d in cards)


def _fake_kernel(name):
    kernel = _build.Kernel(name, "jt_none", (), replaces="none")
    kernel.__dict__["_fn"] = lambda *args: 0  # a launch that succeeds
    return kernel


def test_replay_adds_the_captured_launches():
    k1, k4 = _fake_kernel("k1"), _fake_kernel("k4")
    stub = Counted(launches={k1: 1, k4: 2})
    cache = graphs.Cache(capture=stub.capture)
    for _ in range(4):
        cache.run(("k",), stub.fn, {}, CPU)
    assert (k1.launches, k4.launches) == (3, 6)  # three replays


def test_a_capture_counts_launches_apart():
    """Inside recording() a launch goes to the capture's dict, not to the
    kernel's count; outside it counts as before."""
    kernel = _fake_kernel("k")
    with _build.recording() as captured:
        kernel.launch()
        kernel.launch()
    assert captured == {kernel: 2} and kernel.launches == 0
    kernel.launch()
    assert kernel.launches == 1


def test_replay_refuses_inputs_of_another_shape():
    stub = Counted()
    cache = graphs.Cache(capture=stub.capture)
    for _ in range(2):
        cache.run(("k",), stub.fn, {"x": torch.zeros(4)}, CPU)
    with pytest.raises(ValueError, match="missing from its key"):
        cache.run(("k",), stub.fn, {"x": torch.zeros(5)}, CPU)


@pytest.mark.parametrize("inputs", [{}, {"x": torch.zeros(4),
                                         "y": torch.zeros(4)}],
                         ids=["left out", "added"])
def test_replay_refuses_other_inputs(inputs):
    """A replay takes the inputs of its capture: one left out would leave
    its buffer's stale contents in the program."""
    stub = Counted()
    cache = graphs.Cache(capture=stub.capture)
    for _ in range(2):
        cache.run(("k",), stub.fn, {"x": torch.zeros(4)}, CPU)
    with pytest.raises(ValueError, match="missing from its key"):
        cache.run(("k",), stub.fn, inputs, CPU)


def test_disabled_runs_eagerly(graphed_cpu):
    rgb = _rgb(0)
    with graphs.disabled():
        assert not graphs.enabled()
        for _ in range(3):
            pipeline.encode_array(rgb, device="cpu")
    assert graphs.enabled() and graphed_cpu.programs(CPU) == []


def test_a_failed_capture_raises(monkeypatch):
    """No fallback: the second call of a key captures, and a capture that
    fails raises out of encode_array and encode_tiled."""

    def refuse(*args, **kwargs):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(graphs, "CACHE", graphs.Cache(capture=refuse))
    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    rgb = _rgb(0)
    pipeline.encode_array(rgb, device="cpu")
    with pytest.raises(RuntimeError, match="capture refused"):
        pipeline.encode_array(rgb, device="cpu")
    tiled.encode_tiled(rgb, EncoderConfig(), 2, device="cpu")
    with pytest.raises(RuntimeError, match="capture refused"):
        tiled.encode_tiled(rgb, EncoderConfig(), 2, device="cpu")


def test_pinned_lookups_outlive_the_cache():
    """Within pinned() a lookup gives what it gave first there, even after
    its cache dropped it, and the dict keeps it."""
    made = []

    @graphs.operand_cache(maxsize=1)
    def operand(n):
        made.append(n)
        return torch.full((1,), n)

    kept = operand(1)
    with graphs.pinned() as held:
        assert operand(1) is kept
        operand(2)  # evicts 1 from the cache, not from the pin
        operand.cache_clear()
        assert operand(1) is kept and operand(2) is held[operand, (2,)]
    assert list(held.values())[0] is kept and made == [1, 2]
    operand(1)
    assert made == [1, 2, 1] and len(held) == 2


EVICTION_CASES = [
    ("default", EncoderConfig(), {}),
    ("bin-dct descale restart 2", dataclasses.replace(
        BIN, bin_dct_descale=True, restart_interval=2), {}),
    ("fast-dct 4:4:4", EncoderConfig(fast_dct=True,
                                     subsampling_ratio=(4, 4, 4)), {}),
    ("optimize assemble", EncoderConfig(optimize_huffman=True),
     {"packer": "assemble"}),
    ("coefficients", EncoderConfig(), {"return_coeffs": True}),
    ("bands restart 2", EncoderConfig(restart_interval=2), {"bands": 3}),
    ("bands optimize", EncoderConfig(optimize_huffman=True), {"bands": 3}),
]


@pytest.mark.parametrize("label,config,kw", EVICTION_CASES,
                         ids=[c[0] for c in EVICTION_CASES])
def test_capture_builds_no_operand_after_eviction(monkeypatch, label, config,
                                                  kw):
    """Other work may evict a key's operands between its first call and its
    second: every operand cache is emptied there, and again between the
    warm-up and the capture, and no operand cache misses inside the
    capture (on a card that miss is a blocking copy, which capture
    refuses). The files stay the eager path's."""
    caches = graphs.operand_caches()
    assert len(caches) >= 10
    captures = []

    def record(fn, buffers, device):
        for c in caches:
            c.cache_clear()
        misses = sum(c.cache_info().misses for c in caches)
        out = stand_in_record(fn, buffers, device)
        assert sum(c.cache_info().misses for c in caches) == misses, (
            "an operand was built inside the capture")
        captures.append(label)
        return out

    cache = graphs.Cache(capture=functools.partial(graphs.capture,
                                                   record=record))
    monkeypatch.setattr(graphs, "CACHE", cache)
    monkeypatch.setattr(graphs, "_graphed", lambda device: graphs.enabled())
    kw = dict(kw)
    bands = kw.pop("bands", None)

    def encode(rgb):
        if bands:
            return tiled.encode_tiled(rgb, config, bands, device="cpu")
        out = pipeline.encode_array(rgb, config, device="cpu", **kw)
        return out[0] if isinstance(out, tuple) else out

    for seed in range(3):
        rgb = _rgb(seed, 64, 48)
        for c in caches:
            c.cache_clear()
        got = encode(rgb)
        with graphs.disabled():
            want = encode(rgb)
        assert got.file_bytes == want.file_bytes, (label, seed)
    assert captures and all(p.replays == 2 for _, p in cache.programs(CPU))


# --------------------------------------------------------------------------
# Capture-safe repairs in the code the programs run
# --------------------------------------------------------------------------

def _coeffs(rng, geom, images=1):
    return [rng.integers(-40, 41, (images * n, 64)).astype(np.int16)
            * (rng.random((images * n, 64)) < 0.3)
            for n in (geom.num_luma_blocks, geom.num_chroma_blocks,
                      geom.num_chroma_blocks)]


@pytest.mark.parametrize("restart", [None, 2])
def test_histograms_without_bincount_match_jax(monkeypatch, restart):
    """symbol_histograms no longer calls torch.bincount (which reads the
    card to size its output): one image and a batch of three, each image's
    counts equal to the JAX package's."""

    def refused(*args, **kwargs):
        raise AssertionError("bincount syncs: capture refuses it")

    import jax.numpy as jnp
    from jpeg_encoder_tpu.ops import entropy as jax_entropy

    rng = np.random.default_rng(5)
    geom = EncoderConfig(subsampling_ratio=(4, 2, 2)).geometry(48, 32)
    per_image = [_coeffs(rng, geom) for _ in range(3)]
    want = [np.asarray(jax_entropy.symbol_histograms(
        *(jnp.asarray(c) for c in coeffs), geom, coeffs_zigzagged=True,
        restart_mcus=restart)) for coeffs in per_image]
    monkeypatch.setattr(torch, "bincount", refused)
    for coeffs, hist in zip(per_image, want):
        z = entropy.marshal_scan_inputs(
            *(torch.from_numpy(c) for c in coeffs), geom)
        np.testing.assert_array_equal(
            entropy.symbol_histograms(z, geom, restart).numpy(), hist)
    stacked = [torch.from_numpy(np.concatenate(parts))
               for parts in zip(*per_image)]
    z = entropy.marshal_scan_inputs(*stacked, geom)
    got = entropy.symbol_histograms(z, geom, restart)
    assert got.shape == (3, 4, 256)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_words_to_bytes_uses_a_cached_shift(monkeypatch):
    """words_to_bytes builds no tensor from host values once its shifts are
    cached (a blocking upload on a card), and its bytes stay big-endian."""
    words = torch.tensor([[0x01020304, -1, 0], [0x7F00FF80, 5, 1 << 31]],
                         dtype=torch.int64)
    entropy.words_to_bytes(words)

    def refused(*args, **kwargs):
        raise AssertionError("a host tensor built per call")

    monkeypatch.setattr(torch, "tensor", refused)
    got = entropy.words_to_bytes(words).numpy()
    want = (words.numpy() & 0xFFFFFFFF).astype(">u4").view(np.uint8)
    np.testing.assert_array_equal(got, want.reshape(2, -1))


# --------------------------------------------------------------------------
# On the card: real graphs against the eager card path
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


CARD_CONFIGS = [EncoderConfig(), EncoderConfig(restart_interval=120),
                EncoderConfig(optimize_huffman=True), dataclasses.replace(
                    BIN, subsampling_ratio=(4, 4, 4), bin_dct_descale=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("config", CARD_CONFIGS,
                         ids=["default", "restart", "optimize", "bin"])
def test_card_replays_equal_eager(cuda, config):
    images = list(corpus.images(1080, 1920).values())
    for rgb in images[:3]:
        got = pipeline.encode_array(rgb, config, device=cuda).file_bytes
        with graphs.disabled():
            want = pipeline.encode_array(rgb, config, device=cuda).file_bytes
        assert got == want
    for kernel in (dct_kernel.REALDCT, dct_kernel.BINDCT,
                   entropy_kernel.ENTROPY):
        kernel.launches = 0
    pipeline.encode_array(images[3], config, device=cuda)
    dct = (dct_kernel.BINDCT if config.dct_algorithm == DctAlgorithm.BIN_DCT
           else dct_kernel.REALDCT)
    assert dct.launches == 1 and entropy_kernel.ENTROPY.launches == 1


@pytest.mark.cuda
def test_card_band_replays_equal_encode_array(cuda):
    rgb = corpus.landscape(1080, 1920)
    for config in (EncoderConfig(), EncoderConfig(restart_interval=120),
                   EncoderConfig(optimize_huffman=True)):
        want = pipeline.encode_array(rgb, config, device=cuda).file_bytes
        for _ in range(3):
            for devices in (None, [cuda] * 2):
                assert tiled.encode_tiled(rgb, config, 4, device=cuda,
                                          devices=devices).file_bytes == want
