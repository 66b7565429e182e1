"""Overlapped file-to-file encoding on one card: decode | dispatch | write.

Port of jpeg_encoder_tpu/parallel/stream.py::encode_paths to one device
(the mesh argument goes). The three legs run at once, on queues of depth
QUEUE_DEPTH:

  loader thread : chunk k+1's BMP files read and decoded into a pinned
                  host buffer, an image a thread of a decoder pool (one
                  thread a core; io/bmp.read_into, whose native decode
                  releases the interpreter lock), each image copied to the
                  card on a copy stream as soon as it is decoded, so the
                  first images overlap chunk k's kernels; with optimized
                  Huffman, then the chunk's statistics pass, on a stream
                  of the loader's own
  main thread   : chunk k's encode (parallel/batch.dispatch_uploaded, or
                  dispatch_optimized_encode with the chunk's tables built
                  on the host) on a compute stream that first waits on the
                  upload's (or the statistics pass's) event
  writer thread : fetch_chunk, JFIF assembly (single-image retries
                  included) and emit() for chunk k-1, on a stream of its
                  own that waits on chunk k-1's encode

Host memory and device memory hold a few chunks whatever the number of
files; chunk sizes come from parallel/batch.chunk_size_images.

The pinned buffers are one ring per dimension group, QUEUE_DEPTH + 1
deep, allocated when the group starts; a slot is decoded into again only
after the copy out of it has completed (its event). A chunk's device copy
is allocated on the copy stream and marked (record_stream) for each stream
that reads it, so the caching allocator never hands its memory out while a
kernel may still read it. All four streams come from torch's pool of
non-blocking streams, never the legacy default stream, which would
serialise with them. The kernel wrappers launch on the current stream of
the thread that calls them, so each leg runs inside its stream's context.

device="cpu" runs the same three legs and decoder pool with the kernels'
plain versions and no staging: a chunk's decoded array is its "uploaded"
tensor. There is no
fallback: on the card a buffer that cannot be pinned raises, and a chunk
never goes up from pageable memory. encode_batch stays synchronous, as the
JAX package's does.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import os
import queue
import threading
import time

import torch

from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.parallel import batch as batch_lib

QUEUE_DEPTH = 2
_DONE = object()


@dataclasses.dataclass
class StreamStats:
    encoded: int = 0
    output_bytes: int = 0
    pixels: int = 0
    seconds: float = 0.0          # wall clock, files-on-disk to files-on-disk
    decode_seconds: float = 0.0   # loader: BMP reads and decode (overlapped)
    write_seconds: float = 0.0    # writer-thread busy time (overlapped)


@dataclasses.dataclass
class _Loaded:
    """One chunk as the loader hands it to the main thread."""

    dims: tuple[int, int]
    paths: list[str]
    rgb: torch.Tensor                   # (B, H, W, 3) uint8 on the device
    ready: torch.cuda.Event | None      # the upload (and statistics) done
    z: torch.Tensor | None = None       # optimize: the chunk's scan entries
    hists: torch.Tensor | None = None   # optimize: (B, 4, 256) counts


class _PinnedRing:
    """Pinned (chunk, H, W, 3) uint8 host buffers of one dimension group,
    used in turn; a slot is handed out again only after the copy out of it
    has completed."""

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
            self.copied[i].synchronize()
        return i, self.slots[i][:count]

    def release(self, i: int, copied: torch.cuda.Event) -> None:
        self.copied[i] = copied


def _chunks(seq: list, size: int):
    for start in range(0, len(seq), size):
        yield seq[start : start + size]


def _work(paths: list[str], config: EncoderConfig):
    """[((width, height), chunk paths)]: paths grouped by dimensions in
    first-seen order (each group feeds one chunk shape), cut into chunks;
    restart geometries are checked before any file is decoded."""
    groups: dict[tuple[int, int], list[str]] = {}
    for path in paths:
        with open(path, "rb") as f:
            head = f.read(64)
        groups.setdefault(bmp.probe_dimensions(head), []).append(path)
    work = []
    for (width, height), group in groups.items():
        geom = config.geometry(width, height)
        if config.restart_interval is not None:
            pipeline.check_restart_geometry(geom)
        for chunk_paths in _chunks(group, batch_lib.chunk_size_images(geom)):
            work.append(((width, height), chunk_paths))
    return work


def _on(stream: torch.cuda.Stream | None):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(
        stream)


def encode_paths(
    paths: list[str],
    config: EncoderConfig,
    emit,
    *,
    device: str | torch.device = "cuda",
) -> StreamStats:
    """Encode the BMP files at `paths` through the overlapped pipeline, on
    `device` (the card by default; "cpu" runs the plain versions).

    `emit(path, file_bytes)` is called once per input, from the writer
    thread, in path order within each dimension group (groups run in
    first-seen order): callers write the output file there. Calls are
    serialised (one writer thread).

    Raises the first exception from any leg after unwinding the pipeline
    (no silent partial results; files already emitted stand).
    """
    t0 = time.perf_counter()
    pipeline.check_config(config)
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    # copy (loader), statistics (loader), compute (main), write (writer).
    streams = ([torch.cuda.Stream(device) for _ in range(4)] if cuda
               else [None] * 4)
    copy_s, stats_s, compute_s, write_s = streams
    work = _work(paths, config)
    optimize = config.optimize_huffman

    load_q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
    write_q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
    stats = StreamStats()
    errors: list[BaseException] = []
    stop = threading.Event()

    def load(dims, chunk_paths, ring, decoders):
        """Read and decode a chunk's files, an image a thread of the
        decoder pool, into a pinned slot (on the card) or a new array (on
        the CPU); on the card each image is copied up on the copy stream as
        soon as it is decoded. Returns (the chunk on the device, the
        copies' event or None)."""
        n = len(chunk_paths)
        if cuda:
            slot, host = ring.take(n)
            with torch.cuda.stream(copy_s):
                rgb = torch.empty(host.shape, dtype=torch.uint8, device=device)
        else:
            host = rgb = torch.empty((n, dims[1], dims[0], 3),
                                     dtype=torch.uint8)
        t = time.perf_counter()
        decoded = [decoders.submit(bmp.read_into, path, host[j].numpy())
                   for j, path in enumerate(chunk_paths)]
        for j, done in enumerate(decoded):
            done.result()
            if cuda:
                with torch.cuda.stream(copy_s):
                    rgb[j].copy_(host[j], non_blocking=True)
        stats.decode_seconds += time.perf_counter() - t
        if not cuda:
            return rgb, None
        copied = torch.cuda.Event()
        copied.record(copy_s)
        ring.release(slot, copied)
        return rgb, copied

    def loader():
        ring, ring_dims = None, None
        decoders = concurrent.futures.ThreadPoolExecutor(
            len(os.sched_getaffinity(0)))
        try:
            for dims, chunk_paths in work:
                if stop.is_set():
                    return
                geom = config.geometry(*dims)
                if cuda and dims != ring_dims:
                    shape = (batch_lib.chunk_size_images(geom), dims[1],
                             dims[0], 3)
                    ring, ring_dims = _PinnedRing(QUEUE_DEPTH + 1, shape), dims
                rgb, ready = load(dims, chunk_paths, ring, decoders)
                item = _Loaded(dims, chunk_paths, rgb, ready)
                if optimize:
                    # Enqueued here, so chunk k+1's statistics run on the
                    # card while the main thread builds chunk k's tables
                    # and dispatches its encode.
                    with _on(stats_s):
                        if cuda:
                            stats_s.wait_event(ready)
                            rgb.record_stream(stats_s)
                        item.z, item.hists = batch_lib.optimized_stats_uploaded(
                            rgb, config, geom)
                        if cuda:
                            item.ready = torch.cuda.Event()
                            item.ready.record(stats_s)
                load_q.put(item)
        except BaseException as e:  # propagate to the main thread
            errors.append(e)
        finally:
            decoders.shutdown(wait=True, cancel_futures=True)
            load_q.put(_DONE)

    def writer():
        try:
            with _on(write_s):
                while True:
                    item = write_q.get()
                    if item is _DONE:
                        return
                    (chunk_paths, rgb, geom, capacity, payloads, bits,
                     specs_list, done) = item
                    t = time.perf_counter()
                    if cuda:
                        write_s.wait_event(done)
                    payloads_np, bits_np = batch_lib.fetch_chunk(payloads,
                                                                 bits)
                    files = batch_lib.assemble_chunk(
                        rgb, config, geom, capacity, payloads_np, bits_np,
                        device, specs_list)
                    for path, data in zip(chunk_paths, files):
                        emit(path, data)
                        stats.encoded += 1
                        stats.output_bytes += len(data)
                        stats.pixels += geom.width * geom.height
                    stats.write_seconds += time.perf_counter() - t
        except BaseException as e:
            errors.append(e)
            stop.set()
            # Drain so the main thread's put() never blocks.
            while write_q.get() is not _DONE:
                pass

    lt = threading.Thread(target=loader, name="jpeg-torch-loader")
    wt = threading.Thread(target=writer, name="jpeg-torch-writer")
    lt.start()
    wt.start()
    loader_done = False
    try:
        with _on(compute_s):
            while True:
                item = load_q.get()
                if item is _DONE:
                    loader_done = True
                    break
                if stop.is_set():
                    continue  # drain after a writer error
                geom = config.geometry(*item.dims)
                capacity = batch_lib.chunk_capacity_bytes(config, geom)
                if cuda:
                    compute_s.wait_event(item.ready)
                specs_list = None
                if optimize:
                    specs_list, dc_luts, ac_luts = batch_lib.build_chunk_luts(
                        item.hists.cpu().numpy())
                    if cuda:
                        item.z.record_stream(compute_s)
                    payloads, bits = batch_lib.dispatch_optimized_encode(
                        item.z, dc_luts, ac_luts, config, geom, capacity)
                else:
                    if cuda:
                        item.rgb.record_stream(compute_s)
                    payloads, bits = batch_lib.dispatch_uploaded(
                        item.rgb, config, geom, capacity)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(compute_s)
                write_q.put((item.paths, item.rgb, geom, capacity, payloads,
                             bits, specs_list, done))
                del item, payloads, bits
    finally:
        stop.set()
        # Unblock a loader stuck on a full queue before joining it (the
        # error paths leave the stream mid-flight).
        while not loader_done:
            if load_q.get() is _DONE:
                loader_done = True
        write_q.put(_DONE)
        wt.join()
        lt.join()
        if cuda:
            torch.cuda.synchronize(device)
    if errors:
        raise errors[0]
    stats.seconds = time.perf_counter() - t0
    return stats
