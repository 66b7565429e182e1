"""The device programs as CUDA graphs: the port's compiled-program layer.

The JAX package runs each static configuration's device program as one
cached executable, jax.jit under functools.lru_cache keyed by geometry,
algorithm, capacity and flags (jpeg_encoder_tpu/pipeline.py:285
compiled_encoder, :371 compiled_restart_encoder, :448
compiled_stats_encoder, :517 compiled_custom_encoder; parallel/tiled.py:184,
:289, :356, :672). PyTorch runs eagerly, one host launch an operation (~55
for one image), so here a configuration's program is captured once into a
torch.cuda.CUDAGraph and then replayed: one launch a program.

run(key, fn, inputs, device) is the interface. fn(**inputs) is the program:
it takes device tensors, enqueues its work on the current stream and
returns its outputs (tensors in dicts or tuples), reading nothing back. The
key holds everything that fixes the program's work and shapes (what the JAX
key holds: geometry, DCT flavour, quality, capacity, restart interval,
validate, coefficients, packer; for bands the live rows or entries and the
band count; for a batch the exact image count); run adds the stream the
program is replayed on and its owner (the calling thread unless the caller
names one), and keeps one cache a device. For each key:

- the first call runs fn eagerly and returns its result;
- the second call copies the inputs into static buffers that the program
  owns, runs fn once more eagerly on them (the warm-up: it builds every
  device operand the program reads, through the operand caches, with the
  blocking copies that capture refuses), captures fn on them into a graph
  on a side stream of the device, and replays it;
- every later call copies its inputs into the static buffers and replays;
  it passes the inputs of the capture, each of its shape.

An input named in `pad` reaches fn with zero rows appended up to pad[name]
leading rows: its buffer is zeroed once, and each call copies the input
into its top rows. On a card an input lies on the device or in pinned
host memory, and a pageable host input raises (check_inputs): nothing
goes up from pageable memory (pipeline.upload stages an array through a
pinned ring first). A pinned input is copied to the card without the host
waiting (the eager call and every replay): its owner writes to it again
only after the copy has completed (pipeline.Staging waits on an event
recorded on the current stream after the call).

A replay returns the same output tensors every time, and the next replay of
its key overwrites them. The stream and owner in the key keep every other
caller off a program whose outputs a caller still reads; a caller reads them
before its next call of that key, gives distinct keys to calls whose
outputs it holds at once, or clones what it holds past that call
(encode_array fetches its result; the band path keys each run's programs by
the run's first band and collects every run's rows before it returns;
encode_batch names each share an owner of its own and fetches a chunk
before the next; the stream engine clones the outputs its other threads
read). An owner other than the calling thread is for callers whose threads
come and go (the stream engine's loader, new in every call): one that no
two threads use at once, so a later call replays what an earlier one
captured.

Capture holds a process-wide lock (one capture at a time) and runs with
capture_error_mode="thread_local", so that another thread's pinned
allocation or blocking copy does not abort it. Every operand cache lookup
from the warm-up to the end of the capture is pinned: the capture gets the
very operand the warm-up got, whatever the caches evicted meanwhile, and
the program keeps it alive, so an operand evicted from its cache is not
freed under a replay that reads it. Capture does not synchronize the device
(torch.cuda.graph's entry does), and empties the allocator's caches only
when less than a quarter of the card's memory is free: the allocator frees
nothing while a capture is underway, and evicted programs' pools stay in
its cache until it is emptied.
Nothing falls back: a capture or replay that fails raises. A kernel
launched inside a capture is counted at each replay, not at capture
(kernels/_build.recording), so Kernel.launches counts what ran on the card.
Inside a capture that is already underway (bench/timing.graph_ms captures
whole calls), fn runs as it is, into that graph.

The cache is an LRU on each device. A graph keeps its private memory pool
(one call's intermediates) while it lives, so the bound is on the pools'
bytes, max_pool_bytes(device) (a quarter of the card's memory), as well as
on the count, MAX_PROGRAMS; an evicted key starts again with an eager call.

CPU tensors never touch a graph. disabled() runs the eager card path in the
calling thread (chip_smoke.py and the bench modules time it beside the
replayed one).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import functools
import sys
import threading
import time

import torch

from jpeg_encoder_torch.kernels import _build
from jpeg_encoder_torch.parallel import devices as devices_lib

# Bounds of one device's cache. chip_smoke.py measured the pools on an
# H100 80GB (PERF.md §5): 110 MB a 1920x1080 4:2:0 image's program, 386 MB
# a 3840x2160 one, more where optimize's statistics (402 and 962 MB) or the
# assemble packer (402 and 1618 MB) hold int64 slots; a batch chunk's
# program up to its image count times as much (2012 MB for 21 1080p
# images, 1916 MB for 5 4K ones, 3548 MB for the statistics of 21 1080p
# ones). The stream engine's programs for two geometries, a full and a
# short chunk each, on four shares of one card take ~16 GB: a quarter of
# the card's memory holds them. MAX_PROGRAMS is the JAX caches' count.
POOL_SHARE = 4  # the pools may hold 1 / POOL_SHARE of a card's memory
MAX_PROGRAMS = 64
MAX_SEEN = 256  # keys called once, waiting for their second call

_enabled = contextvars.ContextVar("jpeg_encoder_torch_graphs", default=True)
_capture_lock = threading.Lock()
_held = threading.local()  # .operands: the lookups this thread pinned
_operand_caches: list = []


def enabled() -> bool:
    """Whether run() replays programs for card tensors in this thread."""
    return _enabled.get()


@contextlib.contextmanager
def disabled():
    """In this thread, run every program eagerly on the card."""
    token = _enabled.set(False)
    try:
        yield
    finally:
        _enabled.reset(token)


def operand_cache(maxsize: int):
    """functools.lru_cache for the device operands a program may point at:
    within pinned() a lookup gives what it gave first there, and the
    program that is captured there keeps it."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            held = getattr(_held, "operands", None)
            if held is None:
                return cached(*args)
            if (get, args) not in held:
                held[get, args] = cached(*args)
            return held[get, args]

        get.cache_clear, get.cache_info = cached.cache_clear, cached.cache_info
        _operand_caches.append(get)
        return get

    return wrap


def operand_caches() -> list:
    """Every operand_cache made so far (emptying them all is what other
    work's evictions can do between two calls of a key)."""
    return list(_operand_caches)


@contextlib.contextmanager
def pinned():
    """Pin this thread's operand cache lookups: -> the dict of what they
    got, (lookup, args) -> operand."""
    _held.operands = {}
    try:
        yield _held.operands
    finally:
        _held.operands = None


@dataclasses.dataclass(eq=False)
class Program:
    """One captured program: its graph (anything with replay()), the views
    of its static buffers that the inputs are copied into, the outputs each
    replay overwrites, the kernel launches of one replay (Kernel -> count),
    what the capture cost, and the operands it keeps alive."""

    graph: object
    inputs: dict
    outputs: object
    launches: dict
    capture_ms: float = 0.0
    pool_bytes: int = 0
    operands: tuple = ()
    replays: int = 0

    def replay(self, inputs: dict):
        """Copy inputs into the static buffers, replay, count the launches;
        -> the outputs."""
        if inputs.keys() != self.inputs.keys():
            raise ValueError(
                f"inputs {sorted(inputs)} where the program was captured "
                f"with {sorted(self.inputs)} (a field missing from its key)")
        for name, src in inputs.items():
            dst = self.inputs[name]
            check_inputs({name: src}, dst.device)
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"input {name!r}: {src.dtype} {tuple(src.shape)} where "
                    f"the program was captured with {dst.dtype} "
                    f"{tuple(dst.shape)} (a field missing from its key)")
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        _build.add_launches(self.launches)
        self.replays += 1
        return self.outputs


def check_inputs(inputs: dict, device: torch.device) -> None:
    """Refuse a program input in pageable host memory on a card: its copy
    would be a synchronous one from pageable memory."""
    if device.type != "cuda":
        return
    for name, t in inputs.items():
        if t.device.type == "cpu" and not t.is_pinned():
            raise ValueError(
                f"input {name!r} lies in pageable host memory; a program "
                f"on {device} takes device tensors or pinned host ones "
                "(pipeline.upload stages a host array)")


def max_pool_bytes(device: torch.device) -> int:
    """The bytes of graph pools a device's cache holds: a quarter of the
    card's memory. A CPU device holds stand-in programs only (in tests):
    no bound there but the count."""
    if device.type != "cuda":
        return sys.maxsize
    return torch.cuda.get_device_properties(device).total_memory // POOL_SHARE


def static_inputs(inputs: dict, device: torch.device,
                  pad: dict | None = None) -> tuple[dict, dict]:
    """Buffers on device holding the inputs, those named in pad with zero
    rows up to pad[name] rows -> (the buffers, as fn takes them; the view
    of each that its input was copied into)."""
    buffers, views = {}, {}
    for name, t in inputs.items():
        rows = (pad or {}).get(name, t.shape[0])
        buffers[name] = torch.zeros((rows, *t.shape[1:]), dtype=t.dtype,
                                    device=device)
        views[name] = buffers[name][: t.shape[0]]
        views[name].copy_(t)
    return buffers, views


def record(fn, buffers: dict, device: torch.device):
    """Capture fn on buffers into a CUDA graph on a side stream of device
    (after the current stream's work) -> (graph, outputs, launches, capture
    ms, the bytes of the graph's private pool)."""
    with torch.cuda.device(device):
        stream = devices_lib.stream(device, "capture", 0)
        stream.wait_stream(torch.cuda.current_stream(device))
        free, total = torch.cuda.mem_get_info(device)
        if free < total // POOL_SHARE:
            # While a capture is underway the allocator returns no cached
            # memory to the card, and an evicted program's pool stays
            # cached until the caches are emptied: make room first.
            torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        start = time.perf_counter()
        with _build.recording() as launches, torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = fn(**buffers)
            finally:
                graph.capture_end()
        capture_ms = (time.perf_counter() - start) * 1e3
        pool = tuple(graph.pool())
        pool_bytes = sum(
            s["total_size"] for s in torch.cuda.memory_snapshot()
            if s["device"] == device.index
            and tuple(s["segment_pool_id"]) == pool)
    return graph, outputs, launches, capture_ms, pool_bytes


def capture(fn, inputs: dict, device: torch.device, pad: dict | None = None,
            record=record) -> Program:
    """The Program of fn on static_inputs: the warm-up, then record, with
    the operand lookups of both pinned."""
    check_inputs(inputs, device)
    buffers, views = static_inputs(inputs, device, pad)
    with pinned() as operands:
        fn(**buffers)
        graph, outputs, launches, capture_ms, pool_bytes = record(
            fn, buffers, device)
    return Program(graph, views, outputs, launches, capture_ms, pool_bytes,
                   tuple(operands.values()))


class Cache:
    """Programs by key, an LRU on each device (module docstring); capture is
    the function that makes a Program (a test may pass its own), and
    max_pool_bytes, where given, bounds every device's pools in place of
    max_pool_bytes(device)."""

    def __init__(self, capture=capture, max_pool_bytes: int | None = None,
                 max_programs: int = MAX_PROGRAMS):
        self._capture = capture
        self.max_pool_bytes = max_pool_bytes
        self.max_programs = max_programs
        self.evictions = 0
        self._lock = threading.Lock()
        self._programs = collections.defaultdict(collections.OrderedDict)
        self._seen = collections.defaultdict(collections.OrderedDict)

    def run(self, key, fn, inputs: dict, device: torch.device,
            pad: dict | None = None):
        """fn(**inputs) by the first-call policy of the module docstring."""
        with self._lock:
            programs, seen = self._programs[device], self._seen[device]
            program = programs.get(key)
            if program is not None:
                programs.move_to_end(key)
            elif key in seen:
                del seen[key]
            else:
                seen[key] = None
                if len(seen) > MAX_SEEN:
                    seen.popitem(last=False)
                program = False
        if program is False:
            return eager(fn, inputs, device, pad)
        if program is None:
            with _capture_lock:
                program = self._capture(fn, inputs, device, pad)
            with self._lock:
                programs[key] = program
                self._evict(programs, device)
        return program.replay(inputs)

    def _evict(self, programs: collections.OrderedDict,
               device: torch.device) -> None:
        """Drop the least recently used programs past the bounds (never the
        newest)."""
        while len(programs) > 1 and (
                len(programs) > self.max_programs
                or sum(p.pool_bytes for p in programs.values())
                > self._pool_bound(device)):
            programs.popitem(last=False)
            self.evictions += 1

    def _pool_bound(self, device: torch.device) -> int:
        """The bytes of pools device's programs may hold."""
        if self.max_pool_bytes is None:
            return max_pool_bytes(device)
        return self.max_pool_bytes

    def programs(self, device: torch.device) -> list:
        """(key, Program) of device, least recently used first."""
        with self._lock:
            return list(self._programs[device].items())

    def clear(self) -> None:
        """Drop every program and every key called once."""
        with self._lock:
            self._programs.clear()
            self._seen.clear()


CACHE = Cache()


def _graphed(device: torch.device) -> bool:
    """Whether device's programs go through the cache: a card, graphs
    enabled in this thread, and no capture underway on its stream."""
    return (device.type == "cuda" and enabled()
            and not torch.cuda.is_current_stream_capturing())


def eager(fn, inputs: dict, device: torch.device, pad: dict | None = None):
    """fn(**inputs) on device without a graph."""
    check_inputs(inputs, device)
    if pad:
        return fn(**static_inputs(inputs, device, pad)[0])
    return fn(**{name: t.to(device, non_blocking=True)
                 for name, t in inputs.items()})


def run(key: tuple, fn, inputs: dict, device: torch.device,
        pad: dict | None = None, owner=None):
    """fn(**inputs) on device, through the cache of programs on a card
    (module docstring), eagerly on the CPU. inputs: name -> tensor, on
    device or, on a card, in pinned host memory (pageable raises); pad:
    name -> the rows fn takes that input at; owner: who reads the outputs until its next call of the key (a
    hashable no two threads use at once; the calling thread by default)."""
    if not _graphed(device):
        return eager(fn, inputs, device, pad)
    stream = (torch.cuda.current_stream(device).cuda_stream
              if device.type == "cuda" else None)
    if owner is None:
        owner = threading.get_ident()
    return CACHE.run((stream, owner, *key), fn, inputs, device, pad)
