"""Overlapped file-to-file encoding: read | dispatch | assemble | emit.

Port of jpeg_encoder_tpu/parallel/stream.py::encode_paths; `devices` (a
count of cards or a list of devices, parallel/devices.py) takes the mesh's
place. Chunk k goes whole to share k mod len(devices), and each share has
its own copy, statistics, compute and write streams on its card. The
four legs run at once, on queues of depth QUEUE_DEPTH a share:

  loader thread    : chunk k+1's BMP files, each file's pixel rows as
                     stored (io/bmp.read(path, out=...): one pread, no
                     host decode) read straight into a slot of a pinned
                     host ring, an image a thread of a decoder pool (one
                     thread a core), each image copied to the card on a
                     copy stream as soon as it is read, so the first
                     images overlap chunk k's kernels; with optimized
                     Huffman, then the chunk's statistics pass, on a stream
                     of the loader's own
  main thread      : chunk k's encode (parallel/batch.dispatch_uploaded of
                     the chunk's rows, or dispatch_optimized_encode with
                     the chunk's tables built on the host) on a compute
                     stream that first waits on the upload's (or the
                     statistics pass's) event; the program's front
                     kernel reads the rows as stored (kernels/front.py)
  assembler thread : fetch_chunk and JFIF assembly (single-image retries
                     included) of chunk k-1, on a stream of its own that
                     waits on chunk k-1's encode
  emitter thread   : emit() for each file of chunk k-2, in order, while
                     the assembler fetches and assembles the next chunk

Before the legs start, every file's header is read in path order (one
pread a file, _probe), so the groups and chunks are those of the paths'
order. Host memory and device memory hold a few chunks whatever
the number of files; chunk sizes come from parallel/batch.chunk_size_images
(its budget counts H * W * 3 bytes an image, whatever the row padding).

The device work runs as parallel/batch's programs (graphs.run: on a card a
key's second call captures a CUDA graph, later calls replay it), keyed by
the chunk's form, "bmp-rows". A replay overwrites its key's outputs, and
here other threads still read them when the key replays again: the
assembler fetches chunk k while the main thread replays chunk k+1, k+2
..., and with optimized Huffman the main thread reads chunk k's entries
and counts while the loader replays the statistics of chunk k+1, k+2 ....
So the leg that replayed clones each output that another thread reads, on
its own stream right after the replay, and marks the clone (record_stream)
for the stream that reads it: one device copy a chunk. The programs' owner
(graphs.run) is the calling thread with the leg and the share, not the
legs' own threads, which are new in every call: a caller runs one
encode_paths at a time, so a second call over the same geometry replays
what the first captured. The assembler's single-image retries (rare) go
through encode_array, from the member's stored rows, keyed by the
assembler's thread. The legs run in copies of the caller's context, so
graphs.disabled() around the call makes every leg eager.

The pinned buffers are one ring per dimension group, QUEUE_DEPTH + 1
deep, each slot (chunk, H * row_stride(W)) bytes, allocated when the group
starts and shared by the shares; a slot is read into again only after the
copy out of it has completed (the event recorded on the copy stream of
the card that copied it). A chunk's device copy is allocated on the copy
stream and marked (record_stream) for each stream that reads it, so the
caching allocator never hands its memory out while a kernel may still
read it. All the streams come from torch's pool of non-blocking streams,
never the legacy default stream, which would serialise with them. The
kernel wrappers launch on the current stream of the thread that calls
them, so each leg runs inside its share's device and stream context
(devices.Share.on).

device="cpu" runs the same four legs and decoder pool with the kernels'
plain versions and no staging: the rows are read into an ordinary tensor,
which is the chunk's "uploaded" tensor. There is no fallback: on the card
a buffer that cannot be pinned raises, and a chunk never goes up from
pageable memory. encode_batch stays synchronous, as the JAX package's
does.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import dataclasses
import os
import queue
import threading
import time

import torch

from jpeg_encoder_torch import pipeline, trace
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.parallel import batch as batch_lib
from jpeg_encoder_torch.parallel import devices as devices_lib

QUEUE_DEPTH = 2
_DONE = object()


@dataclasses.dataclass
class StreamStats:
    encoded: int = 0
    output_bytes: int = 0
    pixels: int = 0
    seconds: float = 0.0           # wall clock, files-on-disk to files-on-disk
    decode_seconds: float = 0.0    # loader: the files' reads (overlapped)
    assemble_seconds: float = 0.0  # assembler-thread busy time (overlapped)
    emit_seconds: float = 0.0      # emitter-thread busy time (overlapped)
    write_seconds: float = 0.0     # assemble_seconds + emit_seconds


@dataclasses.dataclass
class _Loaded:
    """One chunk as the loader hands it to the main thread."""

    share: int                          # the index of its share
    dims: tuple[int, int]
    paths: list[str]
    rows: bmp.Rows                      # (B, H, stride) uint8 on the device
    ready: torch.cuda.Event | None      # the upload (and statistics) done
    z: torch.Tensor | None = None       # optimize: the chunk's scan entries
    hists: torch.Tensor | None = None   # optimize: (B, 4, 256) counts


class _PinnedRing:
    """Pinned (chunk, H * row_stride(W)) uint8 host buffers of one
    dimension group, used in turn; a slot is handed out again only after
    the copy out of it has completed."""

    def __init__(self, depth: int, shape: tuple[int, ...]):
        self.slots = []
        for _ in range(depth):
            slot = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            if not slot.is_pinned():
                raise RuntimeError(f"could not pin a {shape} staging buffer")
            self.slots.append(slot)
        self.copied: list[torch.cuda.Event | None] = [None] * depth
        self.turn = 0

    def take(self, count: int) -> tuple[int, torch.Tensor]:
        """The next slot's index and its first `count` images, once the
        copy out of it has completed."""
        i = self.turn % len(self.slots)
        self.turn += 1
        if self.copied[i] is not None:
            with trace.span("stream.ring_wait"):
                self.copied[i].synchronize()
        return i, self.slots[i][:count]

    def release(self, i: int, copied: torch.cuda.Event) -> None:
        self.copied[i] = copied


def _chunks(seq: list, size: int):
    for start in range(0, len(seq), size):
        yield seq[start : start + size]


def _probe(path: str) -> tuple[int, int]:
    """A file's (width, height) from its first 64 bytes: one open, pread
    and close, no Python file object."""
    fd = os.open(path, os.O_RDONLY)
    try:
        return bmp.probe_dimensions(os.pread(fd, 64, 0))
    finally:
        os.close(fd)


def _work(paths: list[str], config: EncoderConfig):
    """[((width, height), chunk paths)]: paths grouped by dimensions in
    first-seen order (each group feeds one chunk shape), cut into chunks;
    restart geometries are checked before any file is read. The headers
    are read in path order on the calling thread: a 64-byte read is mostly
    interpreter time, and a pool of threads, queued on the interpreter
    lock, took two to four times as long (PERF.md)."""
    groups: dict[tuple[int, int], list[str]] = {}
    with trace.span("stream.probe") as s:
        if s:
            s.attrs["files"] = len(paths)
        for path in paths:
            groups.setdefault(_probe(path), []).append(path)
    work = []
    for (width, height), group in groups.items():
        geom = config.geometry(width, height)
        if config.restart_interval is not None:
            pipeline.check_restart_geometry(geom)
        for chunk_paths in _chunks(group, batch_lib.chunk_size_images(geom)):
            work.append(((width, height), chunk_paths))
    return work


def _read_rows(path: str, out: torch.Tensor, dims: tuple[int, int]) -> None:
    """One file's stored rows into out (an image of a ring slot, or of an
    ordinary tensor on the CPU), one pread (bmp.read, one range: the
    decoder pool already reads a file a thread); a file whose header no
    longer gives its group's dimensions raises."""
    with trace.span("stream.read"):
        rows = bmp.read(path, out=out, ranges=1)
    if (rows.width, rows.height) != dims:
        raise ValueError(f"{path}: {rows.width}x{rows.height}, its group is "
                         f"{dims[0]}x{dims[1]}")


def _legs(device: torch.device, k: int) -> tuple[devices_lib.Share, ...]:
    """The k-th share of `device`'s four streams: copy and statistics
    (loader), compute (main), write (assembler), each on a stream of its
    own on a card (devices.stream, kept from call to call)."""
    return tuple(
        devices_lib.Share(device, devices_lib.stream(device, role, k)
                          if device.type == "cuda" else None)
        for role in ("copy", "stats", "compute", "write"))


@trace.entry("stream.encode_paths")
def encode_paths(
    paths: list[str],
    config: EncoderConfig,
    emit,
    *,
    device: str | torch.device = "cuda",
    devices=None,
) -> StreamStats:
    """Encode the BMP files at `paths` through the overlapped pipeline, on
    `device` (the card by default; "cpu" runs the plain versions), or over
    `devices` (a count of cards or a list of devices, which may repeat
    one): chunk k then goes to entry k mod len(devices), each entry with
    its own four streams.

    `emit(path, file_bytes)` is called once per input, from the emitter
    thread, in path order within each dimension group (groups run in
    first-seen order): callers write the output file there. Calls are
    serialised (one emitter thread, one call at a time); chunk k's emits
    overlap chunk k+1's fetch and assembly.

    Raises the first exception from any leg after every thread is joined
    (no silent partial results; files already emitted stand).

    Its steps are spans (trace.py), on the legs' threads and the decoder
    pool's under the call's request: stream.probe, stream.read (a file),
    stream.ring_wait, stream.dispatch (a chunk), stream.assemble (a
    chunk), stream.emit (a file; attr reads_in_flight, the stream.read
    spans open as it starts), and a span around each blocking queue
    operation: stream.loader.blocked, stream.compute.starved,
    stream.compute.blocked, stream.assembler.starved,
    stream.assembler.blocked, stream.emitter.starved.
    """
    t0 = time.perf_counter()
    pipeline.check_config(config)
    targets = devices_lib.resolve(device if devices is None else devices)
    cuda = targets[0].type == "cuda"
    shares = [_legs(d, k)
              for d, k in zip(targets, devices_lib.ordinals(targets))]
    work = _work(paths, config)
    optimize = config.optimize_huffman
    caller = threading.get_ident()

    # Deep enough that every share can hold a chunk in each leg.
    depth = QUEUE_DEPTH * len(shares)
    load_q: queue.Queue = queue.Queue(maxsize=depth)
    write_q: queue.Queue = queue.Queue(maxsize=depth)
    emit_q: queue.Queue = queue.Queue(maxsize=depth)
    stats = StreamStats()
    errors: list[BaseException] = []
    stop = threading.Event()          # a leg failed, or the main thread ended
    emit_failed = threading.Event()   # nothing more is assembled

    def load(dims, chunk_paths, ring, decoders, copy):
        """Read a chunk's files' stored rows, an image a thread of the
        decoder pool, into a pinned slot (on the card) or a new tensor (on
        the CPU); on the card each image is copied up on the share's copy
        stream as soon as it is read. Returns (the chunk's rows on the
        device, the copies' event or None)."""
        n = len(chunk_paths)
        if cuda:
            slot, host = ring.take(n)
            with copy.on():
                rows = torch.empty(host.shape, dtype=torch.uint8,
                                   device=copy.device)
        else:
            host = rows = torch.empty(
                (n, dims[1] * bmp.row_stride(dims[0])), dtype=torch.uint8)
        t = time.perf_counter()
        # Each read in a copy of this context: its span is the request's.
        read = [decoders.submit(contextvars.copy_context().run, _read_rows,
                                path, host[j], dims)
                for j, path in enumerate(chunk_paths)]
        for j, done in enumerate(read):
            done.result()
            if cuda:
                with copy.on():
                    rows[j].copy_(host[j], non_blocking=True)
        stats.decode_seconds += time.perf_counter() - t
        copied = copy.ready()
        if cuda:
            # The slot is read into again once this card's copy is done.
            ring.release(slot, copied)
        return bmp.Rows(rows.view(n, dims[1], -1), *dims), copied

    def loader():
        ring, ring_dims = None, None
        decoders = concurrent.futures.ThreadPoolExecutor(
            len(os.sched_getaffinity(0)),
            thread_name_prefix="jpeg-torch-decoder")
        try:
            for k, (dims, chunk_paths) in enumerate(work):
                if stop.is_set():
                    return
                share = k % len(shares)
                copy, stats_leg = shares[share][:2]
                geom = config.geometry(*dims)
                if cuda and dims != ring_dims:
                    shape = (batch_lib.chunk_size_images(geom),
                             dims[1] * bmp.row_stride(dims[0]))
                    ring, ring_dims = _PinnedRing(QUEUE_DEPTH + 1, shape), dims
                rows, ready = load(dims, chunk_paths, ring, decoders, copy)
                item = _Loaded(share, dims, chunk_paths, rows, ready)
                if optimize:
                    # Enqueued here, so chunk k+1's statistics run on the
                    # card while the main thread builds chunk k's tables
                    # and dispatches its encode.
                    with stats_leg.on():
                        stats_leg.wait(ready)
                        if cuda:
                            rows.rows.record_stream(stats_leg.stream)
                        z, hists = batch_lib.optimized_stats_uploaded(
                            rows, config, geom, (caller, "stats", share))
                        # The main thread reads them after this leg's next
                        # replays of the key.
                        item.z, item.hists = z.clone(), hists.clone()
                        if cuda:
                            compute = shares[share][2].stream
                            item.z.record_stream(compute)
                            item.hists.record_stream(compute)
                        item.ready = stats_leg.ready()
                with trace.span("stream.loader.blocked"):
                    load_q.put(item)
        except BaseException as e:  # propagate to the main thread
            errors.append(e)
        finally:
            decoders.shutdown(wait=True, cancel_futures=True)
            with trace.span("stream.loader.blocked"):
                load_q.put(_DONE)

    def assembler():
        try:
            while True:
                with trace.span("stream.assembler.starved"):
                    item = write_q.get()
                if item is _DONE:
                    break
                if emit_failed.is_set():
                    continue  # drain: nothing more is emitted
                (share, chunk_paths, rows, geom, capacity, payloads, bits,
                 specs_list, done) = item
                write = shares[share][3]
                t = time.perf_counter()
                with trace.span("stream.assemble"), write.on():
                    write.wait(done)
                    payloads_np, bits_np = batch_lib.fetch_chunk(payloads,
                                                                 bits)
                    files = batch_lib.assemble_chunk(
                        rows, config, geom, capacity, payloads_np, bits_np,
                        write.device, specs_list)
                stats.assemble_seconds += time.perf_counter() - t
                with trace.span("stream.assembler.blocked"):
                    emit_q.put((chunk_paths, files,
                                geom.width * geom.height))
        except BaseException as e:
            errors.append(e)
            stop.set()
            emit_q.put(_DONE)  # what was assembled before is still emitted
            # Drain so the main thread's put() never blocks.
            while write_q.get() is not _DONE:
                pass
        else:
            with trace.span("stream.assembler.blocked"):
                emit_q.put(_DONE)

    def emitter():
        try:
            while True:
                with trace.span("stream.emitter.starved"):
                    item = emit_q.get()
                if item is _DONE:
                    break
                chunk_paths, files, pixels = item
                t = time.perf_counter()
                for path, data in zip(chunk_paths, files):
                    with trace.span("stream.emit") as s:
                        if s:
                            s.attrs["reads_in_flight"] = trace.in_flight(
                                "stream.read")
                        emit(path, data)
                    stats.encoded += 1
                    stats.output_bytes += len(data)
                    stats.pixels += pixels
                stats.emit_seconds += time.perf_counter() - t
        except BaseException as e:
            errors.append(e)
            emit_failed.set()
            stop.set()
            # Drain so the assembler's put() never blocks.
            while emit_q.get() is not _DONE:
                pass

    # Each leg in a copy of the caller's context (graphs.disabled()).
    legs = [threading.Thread(target=contextvars.copy_context().run,
                             args=(fn,), name=f"jpeg-torch-{fn.__name__}")
            for fn in (loader, assembler, emitter)]
    for leg in legs:
        leg.start()
    loader_done = False
    try:
        while True:
            with trace.span("stream.compute.starved"):
                item = load_q.get()
            if item is _DONE:
                loader_done = True
                break
            if stop.is_set():
                continue  # drain after an assembler or emitter error
            geom = config.geometry(*item.dims)
            capacity = batch_lib.chunk_capacity_bytes(config, geom)
            compute, write = shares[item.share][2:]
            owner = (caller, "compute", item.share)
            with trace.span("stream.dispatch"), compute.on():
                compute.wait(item.ready)
                specs_list = None
                if optimize:
                    specs_list, dc_luts, ac_luts = batch_lib.build_chunk_luts(
                        item.hists.cpu().numpy())
                    payloads, bits = batch_lib.dispatch_optimized_encode(
                        item.z, dc_luts, ac_luts, config, geom, capacity,
                        owner)
                else:
                    if cuda:
                        item.rows.rows.record_stream(compute.stream)
                    payloads, bits = batch_lib.dispatch_uploaded(
                        item.rows, config, geom, capacity, owner)
                # The assembler reads them after this thread's next
                # replays of the key.
                payloads, bits = payloads.clone(), bits.clone()
                if cuda:
                    payloads.record_stream(write.stream)
                    bits.record_stream(write.stream)
                done = compute.ready()
            with trace.span("stream.compute.blocked"):
                write_q.put((item.share, item.paths, item.rows, geom,
                             capacity, payloads, bits, specs_list, done))
            del item, payloads, bits
    finally:
        stop.set()
        # Unblock a loader stuck on a full queue before joining it (the
        # error paths leave the stream mid-flight).
        while not loader_done:
            if load_q.get() is _DONE:
                loader_done = True
        with trace.span("stream.compute.blocked"):
            write_q.put(_DONE)
        for leg in legs:
            leg.join()
        if cuda:
            for d in set(targets):
                torch.cuda.synchronize(d)
    if errors:
        raise errors[0]
    stats.write_seconds = stats.assemble_seconds + stats.emit_seconds
    stats.seconds = time.perf_counter() - t0
    return stats
