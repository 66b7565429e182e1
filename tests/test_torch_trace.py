"""The port's own spans and counters (jpeg_encoder_torch/trace.py), on the
CPU.

With no recorder a span site returns one shared do-nothing object, which
enters as None, reads no clock, keeps no memory and computes no attr, and
nothing is recorded. With one,
encode_file, encode_array, encode_batch and stream.encode_paths each give
the spans their modules name, one request id an entry call (the decoder
pool's and the legs' spans included), every child inside its parent on
the host clock, and the counters of what ran (graphs.eager / capture /
replay, ladder.climb, upload.pieces, batch.retry); every entry's bytes are
the same with recording on and off; a span opens no profiler range. The
benchmark's readers of these spans are held in
tests/test_torch_benchmark.py.
"""

import threading
import tracemalloc
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jpeg_encoder_torch import pipeline, trace
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.parallel import batch, stream
from jpeg_encoder_torch.utils import corpus
from test_torch_graphs import graphed_cpu  # noqa: F401 (a fixture)

CPU = "cpu"
H, W = 32, 48
CONFIG = EncoderConfig()
OPTIMIZE = EncoderConfig(optimize_huffman=True)


def _images(seed, count, height=H, width=W):
    """Corpus content and noise in turn."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (height, width, 3), np.uint8) if i % 2
            else corpus.landscape(height, width, seed=seed + i)
            for i in range(count)]


def _bmps(tmp_path, images):
    paths = []
    for i, image in enumerate(images):
        path = str(tmp_path / f"in{i:02d}.bmp")
        bmp.write(path, image)
        paths.append(path)
    return paths


def _nested(spans):
    """Every span with a parent lies inside it, on the host clock, and
    shares its request."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is None:
            continue
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns, (
            s, parent)
        assert s.request == parent.request


def _requests(spans, entry):
    return [s for s in spans if s.name == entry and s.id == s.request]


# --------------------------------------------------------------------------
# No recorder
# --------------------------------------------------------------------------

def test_no_recorder_one_shared_span_and_nothing_recorded():
    first = trace.span("encode_array.upload")
    assert first is trace.NULL
    assert trace.span("upload.fill") is first
    with first as entered:
        assert entered is None
    trace.count("graphs.replay")
    trace.note("graph", "replay")
    assert trace.in_flight("stream.read") == 0
    with trace.recording() as recorder:
        pass
    assert recorder.spans == [] and recorder.counters == {}


def test_no_recorder_reads_no_clock_and_keeps_no_memory(monkeypatch,
                                                        tmp_path):
    """The span sites, the entry points' included, never read the clock a
    recorder uses; 10^4 sites keep no memory."""

    def no_clock():
        raise AssertionError("a span site read the clock")

    monkeypatch.setattr(trace, "time",
                        types.SimpleNamespace(perf_counter_ns=no_clock))
    image = _images(0, 1)[0]
    pipeline.encode_array(image, CONFIG, device=CPU)
    path = _bmps(tmp_path, [image])[0]
    pipeline.encode_file(path, str(tmp_path / "o.jpg"), CONFIG, device=CPU)

    def sites(n):
        for _ in range(n):
            with trace.span("encode_array.launch"):
                pass
            with trace.span("upload.fill") as s:
                if s:
                    s.attrs["bytes"] = n
            trace.count("upload.pieces")

    sites(100)  # warm the interpreter's caches
    tracemalloc.start()
    try:
        sites(100)
        before, _ = tracemalloc.get_traced_memory()
        sites(10_000)
        after, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before < 1024


def test_an_attr_is_computed_only_while_recording():
    def numel():
        raise AssertionError("an attr computed with no recorder")

    with trace.span("upload.fill") as s:
        if s:
            s.attrs["bytes"] = numel()
    with trace.recording() as recorder:
        with trace.span("upload.fill") as s:
            if s:
                s.attrs["bytes"] = 4 << 20
    (fill,) = recorder.spans
    assert fill.attrs == {"bytes": 4 << 20}


def test_an_entry_with_no_recorder_calls_straight_through():
    calls = []

    @trace.entry("encode_file")
    def entry_point(a, b=0):
        """Its docstring."""
        calls.append(trace._current.get())
        return a + b

    assert entry_point(1, b=2) == 3 and calls == [None]
    assert entry_point.__doc__ == "Its docstring."
    with trace.recording() as recorder:
        assert entry_point(2) == 2
    (request,) = recorder.spans
    assert request.name == "encode_file" and request.id == request.request
    assert calls[-1] is not None


def test_one_recorder_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
    assert trace.span("x") is trace.NULL


# --------------------------------------------------------------------------
# The entry points' spans
# --------------------------------------------------------------------------

FILE_SPANS = {"encode_file", "encode_file.read", "staging.wait",
              "encode_array", "encode_array.upload", "encode_array.launch",
              "encode_array.fetch_wait", "encode_array.jfif",
              "encode_file.write"}


def test_encode_file_spans(tmp_path):
    paths = _bmps(tmp_path, _images(1, 2))
    with trace.recording() as recorder:
        for i, path in enumerate(paths):
            pipeline.encode_file(path, str(tmp_path / f"o{i}.jpg"), CONFIG,
                                 device=CPU)
    spans = recorder.spans
    assert {s.name for s in spans} == FILE_SPANS
    requests = _requests(spans, "encode_file")
    assert len(requests) == 2
    for r in requests:
        mine = [s for s in spans if s.request == r.id]
        assert sorted(s.name for s in mine) == sorted(FILE_SPANS)
        # encode_array is a plain span of encode_file's request.
        inner = next(s for s in mine if s.name == "encode_array")
        assert inner.id != inner.request
        wait = next(s for s in mine if s.name == "staging.wait")
        read = next(s for s in mine if s.name == "encode_file.read")
        assert wait.parent == read.id
    _nested(spans)
    assert all(s.thread == threading.current_thread().name for s in spans)
    assert next(s for s in spans if s.name == "encode_array.launch"
                ).attrs == {"graph": "eager"}
    # Each small file's rows lie in one 4 KiB page: one range a read.
    assert recorder.counters == {"graphs.eager": 2, "read.ranges": 2}


def test_encode_array_spans_and_graph_counters(graphed_cpu):
    """Three calls of one key: eager, captured, replayed, each noted on
    its launch span; optimize adds the tables and a second launch."""
    images = _images(2, 3)
    with trace.recording() as recorder:
        for image in images:
            pipeline.encode_array(image, CONFIG, device=CPU)
    spans = recorder.spans
    requests = _requests(spans, "encode_array")
    assert len(requests) == 3 and len({r.id for r in requests}) == 3
    for r in requests:
        names = [s.name for s in spans if s.request == r.id]
        assert sorted(names) == sorted([
            "encode_array", "encode_array.upload", "encode_array.launch",
            "encode_array.fetch_wait", "encode_array.jfif"])
    assert [s.attrs["graph"] for s in spans
            if s.name == "encode_array.launch"] == ["eager", "capture",
                                                    "replay"]
    assert recorder.counters == {"graphs.eager": 1, "graphs.capture": 1,
                                 "graphs.replay": 1}
    _nested(spans)

    with trace.recording() as recorder:
        pipeline.encode_array(images[0], OPTIMIZE, device=CPU)
    names = [s.name for s in recorder.spans]
    assert names.count("encode_array.launch") == 2
    assert names.count("encode_array.tables") == 1
    _nested(recorder.spans)


def test_ladder_climb_is_counted():
    image = _images(3, 1)[0]
    want = pipeline.encode_array(image, CONFIG, device=CPU).file_bytes
    with trace.recording() as recorder:
        got = pipeline.encode_array(image, CONFIG, device=CPU,
                                    _initial_capacity_bytes=64).file_bytes
    assert got == want
    assert recorder.counters["ladder.climb"] >= 1


@pytest.fixture
def ring_on_cpu(monkeypatch):
    """pipeline.upload through a CPU ring of 1000-byte pieces, as a card
    stages an array through pinned pieces."""

    def staged(host, device):
        if not isinstance(host, torch.Tensor):
            host = torch.from_numpy(np.ascontiguousarray(host,
                                                         dtype=np.uint8))
        return pipeline.UploadRing(device, piece_bytes=1000,
                                   depth=2).staged(host)

    monkeypatch.setattr(pipeline, "upload", staged)


def test_encode_batch_spans(ring_on_cpu, monkeypatch):
    """Three images: the dispatch with the ring's fills beneath it, the
    fetch and the assembly, one request; a forced retry counts."""
    images = np.stack(_images(4, 3))
    with trace.recording() as recorder:
        batch.encode_batch(images, CONFIG, device=CPU)
    spans = recorder.spans
    assert len(_requests(spans, "encode_batch")) == 1
    assert {s.name for s in spans} == {
        "encode_batch", "batch.dispatch", "upload.fill", "batch.fetch",
        "batch.assemble"}
    dispatch = next(s for s in spans if s.name == "batch.dispatch")
    fills = [s for s in spans if s.name == "upload.fill"]
    assert all(f.parent == dispatch.id for f in fills)
    pieces = -(-images.nbytes // 1000)
    assert sum(f.attrs["bytes"] for f in fills) == images.nbytes
    assert recorder.counters == {"upload.pieces": pieces,
                                 "graphs.eager": 1}
    _nested(spans)

    # A capacity that every member overflows: each is retried alone,
    # inside the assembly, as a plain encode_array span of the request.
    monkeypatch.setattr(batch, "chunk_capacity_bytes", lambda *a: 64)
    with trace.recording() as recorder:
        batch.encode_batch(images, CONFIG, device=CPU)
    assert recorder.counters["batch.retry"] == 3
    retried = [s for s in recorder.spans if s.name == "encode_array"]
    assembly = next(s for s in recorder.spans if s.name == "batch.assemble")
    assert len(retried) == 3
    assert all(s.parent == assembly.id for s in retried)
    _nested(recorder.spans)


STREAM_SPANS = {"stream.encode_paths", "stream.probe", "stream.read",
                "stream.loader.blocked", "stream.compute.starved",
                "stream.dispatch", "stream.compute.blocked",
                "stream.assembler.starved", "stream.assemble",
                "batch.fetch", "batch.assemble",
                "stream.assembler.blocked", "stream.emitter.starved",
                "stream.emit"}


def test_stream_spans_on_every_thread(tmp_path, monkeypatch):
    """Six files in three chunks: every leg's spans, and each decoder's
    read, carry the call's request id."""
    monkeypatch.setattr(batch, "chunk_size_images", lambda *a: 2)
    paths = _bmps(tmp_path, _images(5, 6))
    emitted = []
    with trace.recording() as recorder:
        stream.encode_paths(paths, CONFIG,
                            lambda p, d: emitted.append(p), device=CPU)
    spans = recorder.spans
    assert {s.name for s in spans} == STREAM_SPANS
    (call,) = _requests(spans, "stream.encode_paths")
    assert all(s.request == call.id for s in spans)
    _nested(spans)
    named = {name: [s for s in spans if s.name == name]
             for name in STREAM_SPANS}
    assert len(named["stream.read"]) == len(named["stream.emit"]) == 6
    assert len(named["stream.dispatch"]) == 3
    assert named["stream.probe"][0].attrs == {"files": 6}
    threads = {s.thread for s in spans}
    assert {"jpeg-torch-loader", "jpeg-torch-assembler",
            "jpeg-torch-emitter"} <= threads
    assert all(s.thread.startswith("jpeg-torch-decoder")
               for s in named["stream.read"])
    assert all(isinstance(s.attrs["reads_in_flight"], int)
               for s in named["stream.emit"])
    assert emitted == paths
    # The loader reads one range a file.
    assert recorder.counters == {"graphs.eager": 3, "read.ranges": 6}


def test_in_flight_counts_open_spans_across_threads():
    entered, release = threading.Event(), threading.Event()

    def hold():
        with trace.span("stream.read"):
            entered.set()
            release.wait(30)

    with trace.recording():
        worker = threading.Thread(target=hold)
        worker.start()
        try:
            assert entered.wait(30)
            assert trace.in_flight("stream.read") == 1
        finally:
            release.set()
            worker.join(30)
        assert not worker.is_alive()
        assert trace.in_flight("stream.read") == 0


# --------------------------------------------------------------------------
# The same bytes with recording on and off
# --------------------------------------------------------------------------

def _all_entries(tmp_path, tag):
    images = _images(6, 4)
    paths = _bmps(tmp_path, images)
    out = {}
    pipeline.encode_file(paths[0], str(tmp_path / f"{tag}.jpg"), CONFIG,
                         device=CPU)
    with open(tmp_path / f"{tag}.jpg", "rb") as f:
        out["file"] = f.read()
    out["array"] = pipeline.encode_array(images[1], OPTIMIZE,
                                         device=CPU).file_bytes
    out["batch"] = batch.encode_batch(np.stack(images[:3]), CONFIG,
                                      device=CPU)
    streamed = {}
    stream.encode_paths(paths, CONFIG,
                        lambda p, d: streamed.__setitem__(p, d), device=CPU)
    out["stream"] = streamed
    return out


def test_bytes_equal_with_recording_on_and_off(tmp_path):
    off = _all_entries(tmp_path, "off")
    with trace.recording() as recorder:
        on = _all_entries(tmp_path, "on")
    assert on == off
    assert len(_requests(recorder.spans, "stream.encode_paths")) == 1


def test_spans_open_no_profiler_range():
    """A profiled, recorded call: its spans are recorded, and the
    profiler's ranges hold none of their names."""
    image = _images(7, 1)[0]
    with trace.recording() as recorder, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        pipeline.encode_array(image, CONFIG, device=CPU)
    names = {s.name for s in recorder.spans}
    assert {"encode_array", "encode_array.launch"} <= names
    assert not names & {e.key for e in prof.key_averages()}
