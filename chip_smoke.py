"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR ...]

Builds the port's CUDA kernels from jpeg_encoder_torch/csrc (one nvcc per
source, all at once), holds each against its plain PyTorch version (F1
the front, an RGB array or a BMP file's stored rows to the padded planes,
at every ratio, full size and quirk geometries, batches and live rows,
and all 2^24 RGB triples against the oracle, with the conversion
instructions of each front_kernel counted in its SASS; K1 RealDCT, K4 entropy, K3 binDCT, K5 bitstream assembly and the per-block
tier K6a/b and K6c exactly, K4 also over restart intervals with
live_entries, over a batch of images with per-image rows, intervals and
tables, and over one image's MCU bands with one init_dc vector a row, K6
also against K1 and K3 on the same blocks, K1 and K3 also storing straight
into the scan entries, the main path's DCT (at 1080p and 4K 4:2:0, 1080p
4:2:2, 512x512 4:4:4, the quirk 1921x1081 and stacks of 21 x 1080p and 5
x 4K, against the plain DCT and the marshal, with the graph ms of F1 + K1
into the entries beside F1 + K1 + the marshal); K2 --fast-dct to max
|diff| 1 at a mismatch rate below 1e-3, and 5e-4 against K1, at quality
None and 90, and at quality 100 with every mismatch a float32 rounding
tie), drives the single-image paths
(BMP file -> JFIF file with jpeg_encoder_torch.pipeline.encode_file on the
card) with RealDCT at 1080p, 4K and odd geometries at every subsampling
ratio, with binDCT (bug-parity and descaled) at 1080p and odd geometries,
with --fast-dct at 1080p, with restart markers (1, 7, 120 and 10000 MCUs
at 1080p, RealDCT and binDCT, every ratio; 240 at 4K), with optimized
Huffman tables (alone and with restart markers) and with the assemble
packer (K5; Annex K and optimized tables), checks every exact file byte
for byte against the port's CPU path (and small ones against the NumPy
oracle, whose optimized tables count its own symbols) and the --fast-dct file
against the CPU entropy coder run on the card's own coefficients, drives
the batch path (jpeg_encoder_torch.parallel.batch.encode_batch: 32 x 1080p
and 12 x 4K at 4:2:0, 4:2:2, 4:4:4, binDCT, --fast-dct, restart 120 and 7,
optimize alone and with restart 120, a forced single-image retry; every
file against the single-image card path, a few against the CPU path) and
the per-block tier (K6 on every plane of the 1080p corpus, against K1 and
K3), each batch case three times with different content, its chunk
programs (parallel/batch.program_keys) run eagerly, captured and replayed,
every file against the eager card path (graphs.disabled()); the staged
upload of in-memory arrays (pipeline.upload: encode_batch, encode_array
and encode_tiled on views of 1080p frames against the CPU path, every
piece of the upload ring pinned, a pageable input refused by graphs.run,
the staged GB/s beside the pageable copy's, and encode_batch's ms a call
of 8 x 1080p), a large image (a 7680x4320 4:4:4 gradient, whose worst case passes
2^31 bits, against the CPU path) and the stream engine
(jpeg_encoder_torch.parallel.stream.encode_paths: 64 1080p, 15 4K and 45
1366x768 BMP files, whose rows are padded, to JFIF files, every file
against encode_batch's, every slot of the loader's ring pinned, one
emitting thread, none of the run's own programs evicted, 8 also under
restart and optimize, and, with an emitter that sleeps through the first
two chunks, under default and optimize against the eager card path; the
Mpixel/s of a pass beside the loader's, assembler's and emitter's busy
seconds; under the profiler, in replayed runs, every host-to-device
copy must be pinned and on a stream no kernel ran on, and, with the
card kept busy by matmuls on a stream of their own, one at least must
overlap a kernel of the run), the band path
(jpeg_encoder_torch.parallel.tiled.encode_tiled: 1080p at 2, 3, 4 and 8
bands, 4K at 4 and 8, 7680x4320 at 8, every ratio, binDCT, --fast-dct,
restart 120 and 7, optimize, a one-band retry, the quirk fallback; every
file against encode_array on the card, three against the CPU path) and the
CLI (python -m jpeg_encoder_torch.cli in processes of its own, which
report their launches: single images, --tile-bands, a glob, --dataset of
271 1080p and 4K files in one and in two gloo processes and resumed; every
file against encode_array on the card; the error probes' exit codes) and
the multi-card path (device lists of two and four shares: the one card
named twice and four times, or distinct cards where the machine has
several; encode_batch on a 21-image 1080p and a 5-image 4K chunk and on
every option, stream.encode_paths on 64 1080p BMP files, encode_tiled at
1080p in 4 bands over 2 shares, 4K in 8 over 4 and every option, the CLI
on a glob with --devices 1, and two gloo processes encoding the bands of
one 4K image with multihost.encode_tiled, unbroken, restart and optimize;
every file against the one-card file on the card), each
path between a reset and a read of the launch counts (each path's F1
launches equal to its plane-DCT launches: every front is the kernel), and
times the kernels (beside their bounds; F1 also from stored rows, at 4K
and on 8 x 1080p, beside the plain front, and cold: each call on another
copy of the rows, more than twice the L2 cache together), the batch against a loop of single
encodes, and the end-to-end encodes, encode_tiled against encode_array
(host ms with each stage alone, device-busy ms and the top device
operations), K4 with one init_dc a row against the (3,) form, and each
dataset process's start-up apart from its steady files/s, in one process
and in two, one share against two and four (host and device-busy ms per
image) and each gloo collective of the band encode across processes. The
trace path records the program's own spans and counters
(jpeg_encoder_torch/trace.py) around encode_file, encode_batch and
stream.encode_paths on the card: every span name of their layers, one
request a call, every child inside its parent, the counters, and every
file equal to the untraced run's; it prints the disabled span site's ns
and traced against untraced request ms. The
benchmark path runs every cell of BENCHMARK.json (benchmark/run.py in
this process, at reduced counts by kind: a file cell at 100 timed
requests, a folder cell at 32 BMP files and one timed pass, a batch cell
at 20 timed calls of 8 images), between a reset and a read of the launch
counts, and fails unless each exits 0 with every file of every run equal
to the NumPy oracle's and every metric BENCHMARK.json names for it, its
per-layer metrics not null, F1's events in its trace and no kernel of
the port's under the breakdown's torch-ops row; it prints each cell's
breakdown an image. The
staged-read path runs encode_file's staged read (the BMP file's stored
rows read into the thread's pinned staging buffer, uploaded as they are
and reordered at the head of the program) over the benchmark's 8 corpus
contents at 1920x1080, 1366x768 (rows padded) and 3840x2160, every file
against the eager RGB path's, the buffers required pinned; it prints the
upload's GB/s, the reorder's device ms and a request's ms against the
decoded path's. It fails unless the native runtime loads and each
encode_file read its rows as bmp.file_ranges(W, H) > 1 ranges on the
native read pool (the trace's read.ranges), the rows equal one pread's,
and it prints one pread against the split read, ms a file. The
bench path runs every measurement module (jpeg_encoder_torch/bench) in this
process at reduced sizes, between a reset and a read of the launch counts
(a call captured into a CUDA graph counts once): the throughput line, the
ratio x algorithm matrix and two cells, the 4K band program, datasets of
16 and 8 (optimized) 1080p files, the host I/O of the stream's legs
over 16 1080p files, the batch curve and four shares, every
kernel by CUDA-graph replay, and the parity sweeps (all 2^24 colour
triples, 24 corpus and 24 geometry files, each against the oracle); it
fails unless each exits 0 with its JSON line and every sweep is exact.
The kernel timings carry a CUDA-graph replay column (bench/timing.graph_ms)
beside the profiler's device-busy time, at 1080p and 4K. It
also prints each kernel's
registers, spills and shared memory as ptxas reports them, the
torch.matmul yardstick of K2 by events and device-busy time beside K2's
busy time and mismatch rates, the
device operations of one K4 call (failing unless they are the memset and
one kernel) and of one K5 call (failing unless it is one kernel), the
stream against a synchronous read-encode-write loop and the pinned and
pageable H2D rates. The graph phase drives the compiled-program layer
(jpeg_encoder_torch/graphs.py: each configuration's device program captured
into a CUDA graph at its second call and replayed after): every option at
1920x1080, 3840x2160 and a quirk geometry, three contents a key, each
replayed file against the eager card file (graphs.disabled()) and the CPU
path, every operand cache emptied between a key's first and second calls
(the capture must build no operand), the capacity ladder past its first
rung under a replayed key, an LRU eviction and re-capture, and encode_tiled's band programs at 4 and 8 bands
on one share and on four; it prints each key's capture ms, pool MB and
replays, and eager against replayed host, events and graph ms. The batch
and stream phases print the same for the batch programs (encode_batch and
the stream's ms an image, a chunk program's events and graph ms), and
every path prints how many programs the cache evicted while it ran. With
--parent DIR (a checkout of an earlier commit; the option may be given
again) it also builds DIR's sources of the kernels that differ and times
both builds on the same operands (F1 through DIR's own wrapper, warm and
cold, in turns with this tree's). K5 also runs on adversarial operands (runs
of 0-bit entries, 56-word entries, a row past bit 2^31, cut capacities).
Any mismatch or error exits non-zero before the final line,
which is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Needs one CUDA card, nvcc and no network; imports no JAX and nothing of
jpeg_encoder_tpu.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from jpeg_encoder_torch.bench import timing
from jpeg_encoder_torch.bench.kernels import kernel_bounds
from jpeg_encoder_torch.bench.timing import variants

REPO = os.path.dirname(os.path.abspath(__file__))
REPS = 20  # timed repetitions (median reported)
RATIOS = ((4, 2, 0), (4, 2, 2), (4, 4, 4))
INTERVALS = (1, 7, 120, 10000)  # restart intervals, MCUs


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device milliseconds of fn() by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ops(fn, reps: int = 5) -> list[tuple[str, float, float]]:
    """The device operations (kernels, memsets, copies) of fn(), from
    torch.profiler over reps warm calls: (name, count per call, device ms
    per call). The profiler now and then keeps only part of a window's
    events, so an operation's time per call is the mean duration of the
    events kept times its count per call (at least 1), never its summed
    time over reps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            per_call = max(1, round(e.count / reps))
            ops.append((e.key, per_call,
                        e.self_device_time_total / 1e3 / e.count * per_call))
    return ops


def busy_ms(fn, reps: int = REPS) -> float | None:
    """Device-busy milliseconds per fn(): the summed durations of the
    kernels, copies and fills it ran, without the gaps in which the card
    waits for the host to launch them. None if the profiler saw no device
    activity in three tries (it now and then returns an empty trace)."""
    for _ in range(3):
        total = sum(ms for _, _, ms in device_ops(fn, reps))
        if total:
            return total
    return None


def top_device_ops(fn, count: int = 6, reps: int = 5) -> list[tuple]:
    """The device operations of fn() with the most device time: (name,
    device ms per call), largest first."""
    ops = [(name, ms) for name, _, ms in device_ops(fn, reps)]
    return sorted(ops, key=lambda op: -op[1])[:count]


def fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def host_ms(fn, reps: int = 10) -> float:
    """Median wall milliseconds of fn(), which must end in a device sync."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def adversarial_entries(geom) -> np.ndarray:
    """(E, 64) zigzag scan entries at the entropy coder's edges: all-zero
    blocks, AC +-1023, zero runs of 15/16/17/31/32/47/48/62 ending in a
    nonzero (62: a nonzero at position 63, so no EOB), a block full of
    +-1023, and raw DCs that alternate +1023/-1024 along every predictor
    chain (DC differences of +-2047)."""
    pool = [np.zeros(64, np.int16)]
    for run in (15, 16, 17, 31, 32, 47, 48, 62):
        b = np.zeros(64, np.int16)
        b[1 + run] = -1 if run % 2 else 1023
        pool.append(b)
    pool.append(np.where(np.arange(64) % 2 == 0, 1023, -1023).astype(np.int16))
    pool = np.stack(pool)
    e = np.arange(geom.num_scan_entries)
    hv = geom.h_factor * geom.v_factor
    mcu, pos = e // geom.blocks_per_mcu, e % geom.blocks_per_mcu
    chain_index = np.where(pos < hv, mcu * hv + pos, mcu)
    z = pool[e % len(pool)].copy()
    z[:, 0] = np.where(chain_index % 2 == 0, 1023, -1024)
    return z


def random_planes(rng, y_shape, c_shape) -> list[torch.Tensor]:
    planes = [torch.from_numpy(rng.integers(0, 256, y_shape, dtype=np.uint8))]
    return planes + [
        torch.from_numpy(rng.integers(0, 256, c_shape, dtype=np.uint8))
        for _ in range(2)
    ]


PLANE_SHAPES = (
    ("1080p 4:2:0", (1088, 1920), (544, 960)),
    ("1080p 4:4:4", (1080, 1920), (1080, 1920)),
)


def exact_dct_phase(tag, fn, cuda, rng, variants) -> float:
    """A DCT kernel vs its plain version on CPU tensors, on random planes
    at 1080p 4:2:0 and 4:4:4, for each tuple of trailing arguments in
    variants; it must be exact. Returns the max |error|."""
    worst = 0
    for label, y_shape, c_shape in PLANE_SHAPES:
        planes = random_planes(rng, y_shape, c_shape)
        for args in variants:
            got = fn(*(p.to(cuda) for p in planes), *args)
            torch.cuda.synchronize()
            want = fn(*planes, *args)
            for g, w in zip(got, want):
                err = int((g.cpu().to(torch.int32) - w.to(torch.int32)).abs().max())
                worst = max(worst, err)
                check(err == 0, f"{tag} {label} {args}: max |err| {err}")
        print(f"{tag} {label}: kernel == plain (exact) for (quality"
              f"{', descale' if len(variants[0]) > 1 else ''}) in {variants}",
              flush=True)
    return float(worst)


def fast_ties(dev_planes, quality, mismatch: torch.Tensor) -> bool:
    """Whether every mismatching --fast-dct coefficient is a float32
    rounding tie: its exact value sum_k px[k] K_zz[j][k] (float64 on the
    card), over q, lies within 2^-15 of the sum of |terms| of a truncation
    boundary (a nonzero integer), where two float32 orders may fall on
    either side (tests/test_torch_kernels.py::assert_fast_tolerance)."""
    from jpeg_encoder_torch.ops import dct as dct_ops
    from jpeg_encoder_torch.ops import sample

    kzz = dct_ops.fast_device_constant(dev_planes[0].device).double()
    *_, q_luma, q_chroma = dct_ops.device_constants(quality,
                                                    dev_planes[0].device)
    px = [sample.blockify(p).double() - 128 for p in dev_planes]
    q = torch.cat([(q_luma if i == 0 else q_chroma).double().expand(
        p.shape[0], 64) for i, p in enumerate(px)])
    px = torch.cat(px)
    v = (px @ kzz.T) / q
    nearest = torch.round(v)
    boundary = torch.where(nearest.abs() >= 1, nearest, torch.sign(v))
    tie = (v - boundary).abs() * q <= 2.0**-15 * (px.abs() @ kzz.abs().T)
    return bool(tie[mismatch.to(tie.device).reshape(tie.shape)].all())


FAST_RATES: list[str] = []  # K2's mismatch rates, for the summary


def k2_phase(cuda, rng) -> float:
    """--fast-dct kernel vs its plain version (on CPU tensors) and vs the
    exact K1 on the card at quality None, 90 and 100; max |error| against
    the plain version. At None and 90 the rates must stay below 1e-3 (vs
    plain) and 5e-4 (vs K1); at 100 (q = 1), where the plain version itself
    misses 5e-4 against K1 on random content, every mismatch must be a
    rounding tie (fast_ties), and the rates are reported."""
    from jpeg_encoder_torch.kernels import dct as dct_kernel

    # The plain version's matmul must be full float32, never TF32.
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32")
    worst = 0
    for label, y_shape, c_shape in PLANE_SHAPES:
        planes = random_planes(rng, y_shape, c_shape)
        dev = [p.to(cuda) for p in planes]
        for quality in (None, 90, 100):
            got = torch.cat(dct_kernel.real_dct_fast_planes_zigzag(*dev, quality))
            torch.cuda.synchronize()
            got = got.cpu().to(torch.int32)
            plain = torch.cat(dct_kernel.real_dct_fast_planes_zigzag(
                *planes, quality)).to(torch.int32)
            exact = torch.cat(dct_kernel.real_dct_quant_planes_zigzag(
                *dev, quality)).cpu().to(torch.int32)
            rates = []
            for name, a, b, limit in (("K2 vs plain", got, plain, 1e-3),
                                      ("K2 vs K1", got, exact, 5e-4),
                                      ("plain vs K1", plain, exact, None)):
                d = (a - b).abs()
                err, rate = int(d.max()), float((d > 0).double().mean())
                if name == "K2 vs plain":
                    worst = max(worst, err)
                if limit is not None:
                    held = rate < limit if quality != 100 else fast_ties(
                        dev, quality, d > 0)
                    check(err <= 1 and held,
                          f"K2 {label} q={quality} {name}: max |err| {err}, "
                          f"mismatch rate {rate}")
                rates.append(f"{name} max |err| {err}, rate {rate:.3e} "
                             f"({int((d > 0).sum())} of {d.numel()})")
            line = f"q={quality}: " + "; ".join(rates)
            FAST_RATES.append(f"{label} {line}")
            print(f"K2 {label} {line}"
                  + ("; every mismatch a rounding tie" if quality == 100
                     else ""), flush=True)
    return float(worst)


def stored_rows(images: np.ndarray) -> torch.Tensor:
    """(B, H, W, 3) RGB -> the (B, H, stride) rows BMP files of them store
    (bottom row first, BGR, each row zero-padded to 4 bytes), on the CPU."""
    from jpeg_encoder_torch.io import bmp

    count, height, width, _ = images.shape
    rows = np.zeros((count, height, bmp.row_stride(width)), np.uint8)
    rows[..., : 3 * width] = images[:, ::-1, :, ::-1].reshape(
        count, height, 3 * width)
    return torch.from_numpy(rows)


def front_phase(cuda, images_1080, images_4k, card, others=()) -> float:
    """F1 (kernels/front.py) against its plain version (ops/front.planes)
    on the same card inputs, exactly, every plane contiguous and 8-byte
    aligned: 4:4:4, 4:2:2 and 4:2:0, each for an RGB array and for stored
    BMP rows, on the 1080p corpus as one batch of 8 and 8 stacked with
    live_rows (0, mid-image, near the end), the 4K corpus frames one by
    one, 1921x1089 in a batch of 2, the quirk geometries 17x17, 33x17 and
    49x33 in a batch of 3, and widths 1-20 (every row padding) in batches
    of 3; all 2^24 RGB triples through F1 against the oracle
    (bench/parity.py --color's sweep); one device operation a call; the
    conversion instructions (I2F, F2I, FRND) in each instantiation of
    front_kernel (cuobjdump -sass); then F1's graph ms (bench/timing.graph_ms)
    beside its bound and the plain version's, at 1080p and 4K, from either
    form, and 8 x 1080p rows, and from rows cold (timing.cold_graph_ms:
    each call on another copy, the copies more than twice the L2 cache).
    `others` ({label: checkout}, chip_smoke --parent) are other trees' F1,
    each its wrapper (kernels/front.py) and its csrc/front.cu, timed in
    turns with this tree's (other, this, this, other) on the same inputs,
    each line saying whether their planes equal this tree's (a parent's
    do; a probe that leaves out part of the work does not). Returns the
    largest |F1 - plain|."""
    from jpeg_encoder_torch.bench import kernels as bench_kernels
    from jpeg_encoder_torch.bench import parity
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.io import bmp
    from jpeg_encoder_torch.kernels import _build
    from jpeg_encoder_torch.kernels import front as front_kernel
    from jpeg_encoder_torch.ops import front as front_ops

    worst, cases = 0, 0
    t0 = time.perf_counter()

    def inputs(images):
        """(form, the F1 input on the card) for the RGB and the rows."""
        height, width = images.shape[1:3]
        rgb = torch.from_numpy(np.ascontiguousarray(images)).to(cuda)
        rows = bmp.Rows(stored_rows(images).to(cuda), width, height)
        return (("rgb", rgb), ("rows", rows))

    def case(label, images, live=(None,)):
        nonlocal worst, cases
        height, width = images.shape[1:3]
        for ratio in RATIOS:
            geom = EncoderConfig(subsampling_ratio=ratio).geometry(width,
                                                                   height)
            for form, image in inputs(images):
                for live_rows in live:
                    got = front_kernel.planes(image, geom, live_rows)
                    want = front_ops.planes(image, geom, live_rows)
                    for g, w in zip(got, want):
                        check(g.shape == w.shape and g.is_contiguous()
                              and g.data_ptr() % 8 == 0,
                              f"front {label} {ratio} {form}: plane "
                              f"{tuple(g.shape)} vs {tuple(w.shape)}")
                        if g.numel():
                            worst = max(worst, max_err(g, w.cpu()))
                    cases += 1
        check(worst == 0, f"front {label}: F1 != plain, max |err| {worst}")

    hd = np.stack(variants(list(images_1080.values()), 8))
    case(f"1080p corpus x {len(hd)}", hd,
         (None, 0, 3 * 1080 + 77, 8 * 1080 - 5))
    for name, rgb in images_4k.items():
        case(f"4K {name}", rgb[None])
    rng = np.random.default_rng(21)
    case("1921x1089 x 2", rng.integers(0, 256, (2, 1089, 1921, 3),
                                       dtype=np.uint8))
    for width, height in ((17, 17), (33, 17), (49, 33)):
        case(f"{width}x{height} x 3", rng.integers(
            0, 256, (3, height, width, 3), dtype=np.uint8), (None, 20))
    for width in range(1, 21):
        height = 3 + width % 5
        case(f"{width}x{height} x 3", rng.integers(
            0, 256, (3, height, width, 3), dtype=np.uint8))
    grid = parity.color_grid(1)
    bad = parity.color_mismatches(grid, cuda)
    check(bad == 0, f"front: {bad} of 2^24 RGB triples' channel values "
          "differ from the oracle's")
    print(f"front: F1 == plain (max |err| {worst}) in {cases} cases, "
          f"3 ratios x RGB and stored rows x live rows; all "
          f"{grid.shape[0] * grid.shape[1]} RGB triples == the oracle's; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    geom = EncoderConfig().geometry(hd.shape[2], hd.shape[1])
    image = inputs(hd[:1])[1][1]
    for _ in range(3):  # an empty trace is retried, as in busy_ms
        ops = device_ops(lambda: front_kernel.planes(image, geom))
        count = sum(c for _, c, _ in ops)
        if count:
            break
    check(count == 1, f"one F1 call ran other than one kernel: {ops}")
    print(f"F1 device operations per call, 1920x1080 4:2:0 rows: {count} "
          f"({'; '.join(f'{n[:50]} x{c}' for n, c, _ in ops)}) ({card})",
          flush=True)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        fronts = {label: other_front(tree, os.path.join(tmp, label))
                  for label, tree in others.items()}
        libs = {"this tree": _build.lib_path("front")}
        libs.update((label, os.path.join(tmp, label, "libfront.so"))
                    for label in others)
        for label, lib in libs.items():
            print(f"front SASS conversions, {label}: "
                  f"{sass_line(_build.sass_counts(lib, CONVERSIONS))}",
                  flush=True)
        front_times(cuda, card, hd, images_4k, inputs, fronts)
    return float(worst)


# The opcodes of the conversion unit that F1's arithmetic avoids.
CONVERSIONS = ("I2F", "F2I", "FRND")


def sass_line(counts: dict | None) -> str:
    """_build.sass_counts' result as one line."""
    if counts is None:
        return "not counted: the toolkit has no cuobjdump"
    return "; ".join(
        f"{kernel} " + (", ".join(f"{op} {n}" for op, n in sorted(ops.items()))
                        or "none")
        for kernel, ops in sorted(counts.items()))


def other_front(tree: str, build_dir: str):
    """Another checkout's F1: its kernels/front.py loaded as a module of
    its own, its FRONT taken from its csrc/front.cu built into build_dir;
    the module's planes(image, geom) runs it (its own C signature)."""
    import importlib.util

    from jpeg_encoder_torch.kernels import _build

    _build.build(["front"], csrc=os.path.join(tree, "jpeg_encoder_torch",
                                              "csrc"), build_dir=build_dir)
    spec = importlib.util.spec_from_file_location(
        f"front_of_{os.path.basename(build_dir)}",
        os.path.join(tree, "jpeg_encoder_torch", "kernels", "front.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.FRONT = module.FRONT.loaded_from(
        os.path.join(build_dir, "libfront.so"))
    return module


def front_times(cuda, card, hd, images_4k, inputs, fronts) -> None:
    """F1's warm and cold graph ms at 1080p, 4K and 8 x 1080p 4:2:0 beside
    its bound and the plain front's, and each of `fronts` (other trees'
    F1) in turns with it (front_phase)."""
    from jpeg_encoder_torch.bench import kernels as bench_kernels
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.io import bmp
    from jpeg_encoder_torch.kernels import front as front_kernel
    from jpeg_encoder_torch.ops import front as front_ops

    def in_turns(other, this):
        """(other's mean, this's mean) of the runs other, this, this,
        other."""
        o1, t1, t2, o2 = other(), this(), this(), other()
        return (o1 + o2) / 2, (t1 + t2) / 2

    for label, images in (("1920x1080", hd[:1]),
                          ("3840x2160", next(iter(images_4k.values()))[None]),
                          (f"{len(hd)} x 1920x1080", hd)):
        geom = EncoderConfig().geometry(images.shape[2], images.shape[1])
        for form, image in inputs(images):
            if len(images) > 1 and form == "rgb":
                continue
            bound_ms, by = bench_kernels.front_bound(geom, len(images),
                                                     form == "rows")

            def warm_ms(module=front_kernel):
                return timing.graph_ms(lambda: module.planes(image, geom),
                                       cuda)

            kernel = warm_ms()
            plain = timing.graph_ms(
                lambda: front_ops.planes(image, geom), cuda)
            print(f"time front {label} 4:2:0 from {form}: F1 graph "
                  f"{kernel:.4f} ms, plain graph {plain:.4f} ms, bound "
                  f"{bound_ms:.5f} ms ({by}; F1 {kernel / bound_ms:.1f}x) "
                  f"({card})", flush=True)
            cold_ms = None
            if form == "rows":
                copies = timing.past_l2(image.rows)

                def cold_ms(module=front_kernel):
                    return timing.cold_graph_ms(
                        lambda rows: module.planes(
                            bmp.Rows(rows, image.width, image.height), geom),
                        copies, cuda)

                ms = cold_ms()
                size = sum(c.numel() for c in copies)
                print(f"time front {label} 4:2:0 from rows, cold: F1 graph "
                      f"{ms:.4f} ms, a call on each of {len(copies)} copies "
                      f"({size / 1e6:.1f} MB, L2 "
                      f"{timing.l2_bytes(cuda) / 1e6:.1f} MB), bound "
                      f"{bound_ms:.5f} ms ({by}; F1 {ms / bound_ms:.1f}x) "
                      f"({card})", flush=True)
            for name, module in fronts.items():
                same = all(torch.equal(want, got) for want, got in zip(
                    front_kernel.planes(image, geom),
                    module.planes(image, geom)))
                other_ms, this_ms = in_turns(lambda: warm_ms(module),
                                             warm_ms)
                line = (f"time front {label} 4:2:0 from {form} vs {name} "
                        f"(planes {'equal' if same else 'differ'}): warm "
                        f"graph {name} {other_ms:.4f} ms, this tree "
                        f"{this_ms:.4f} ms")
                if cold_ms is not None:
                    other_ms, this_ms = in_turns(lambda: cold_ms(module),
                                                 cold_ms)
                    line += (f"; cold {name} {other_ms:.4f} ms, this tree "
                             f"{this_ms:.4f} ms")
                print(f"{line} ({card})", flush=True)


# The entries phase's geometries: (label, ratio, width, height, images
# stacked as the batch programs stack them).
ENTRY_GEOMETRIES = (
    ("1920x1080 4:2:0", (4, 2, 0), 1920, 1080, 1),
    ("3840x2160 4:2:0", (4, 2, 0), 3840, 2160, 1),
    ("1920x1080 4:2:2", (4, 2, 2), 1920, 1080, 1),
    ("512x512 4:4:4", (4, 4, 4), 512, 512, 1),
    ("1921x1081 4:2:0", (4, 2, 0), 1921, 1081, 1),
    ("21 x 1920x1080 4:2:0", (4, 2, 0), 1920, 1080, 21),
    ("5 x 3840x2160 4:2:0", (4, 2, 0), 3840, 2160, 5),
)


def entries_phase(cuda, rng, images_1080, images_4k, card) -> dict:
    """K1 and K3 storing straight into the scan entries
    (kernels/dct.scan_entries, the main path's DCT) against the plain DCT
    and marshal_scan_inputs on CPU tensors, exactly, on random planes of
    each ENTRY_GEOMETRIES geometry (the quirk one leaves 272 luma blocks
    out of its scan): K1 at quality None and 90, K3 bug-parity at None and
    descaled at 90 (the stacks at None only). Then, on the first 1080p and
    4K corpus frames, the graph ms (bench/timing.graph_ms) of F1 + K1 into
    the entries against F1 + K1 + the marshal, in turns (marshal, entries,
    entries, marshal), both equal. Returns each kernel's max |error|."""
    from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import front as front_kernel
    from jpeg_encoder_torch.ops import dct as dct_ops
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    real, binary = DctAlgorithm.REAL_DCT, DctAlgorithm.BIN_DCT
    variants = (("realdct", real, None, False), ("realdct", real, 90, False),
                ("bindct", binary, None, False), ("bindct", binary, 90, True))
    worst = {"realdct": 0, "bindct": 0}
    t0 = time.perf_counter()
    for label, ratio, width, height, images in ENTRY_GEOMETRIES:
        geom = EncoderConfig(subsampling_ratio=ratio).geometry(width, height)
        planes = random_planes(
            rng, (images * geom.padded_height, geom.padded_width),
            (images * geom.chroma_height, geom.chroma_width))
        dev = [p.to(cuda) for p in planes]
        kept = int((entropy_ops.block_entries(geom, images, cuda) >= 0).sum())
        ran = []
        for name, algorithm, quality, descale in variants:
            if images > 1 and quality is not None:
                continue
            got = dct_kernel.scan_entries(*dev, geom, algorithm, quality,
                                          bin_dct_descale=descale)
            torch.cuda.synchronize()
            coeffs = (dct_ops.real_dct_quant_planes_zigzag(*planes, quality)
                      if algorithm == real else
                      dct_ops.bin_dct_quant_planes_zigzag(*planes, quality,
                                                          descale))
            want = entropy_ops.marshal_scan_inputs(*coeffs, geom)
            check(got.shape == want.shape,
                  f"entries {label} {name}: {tuple(got.shape)} vs "
                  f"{tuple(want.shape)}")
            err = max_err(got, want)
            worst[name] = max(worst[name], err)
            check(err == 0, f"entries {label} {name} q={quality} descale="
                  f"{descale}: max |err| {err}")
            ran.append(f"{name} q={quality}{' descale' if descale else ''}")
        blocks = images * (geom.num_luma_blocks + 2 * geom.num_chroma_blocks)
        print(f"entries {label}: {', '.join(ran)} into {want.shape[0]} "
              f"entries ({kept} of {blocks} blocks kept) == plain DCT + "
              "marshal (exact)", flush=True)
    print(f"entries phase checks: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for label, rgb in (("1920x1080", next(iter(images_1080.values()))),
                       ("3840x2160", next(iter(images_4k.values())))):
        geom = EncoderConfig().geometry(rgb.shape[1], rgb.shape[0])
        image = timing.resident(rgb, cuda)

        def into_entries():
            return dct_kernel.scan_entries(*front_kernel.planes(image, geom),
                                           geom, real)

        def with_marshal():
            return entropy_ops.marshal_scan_inputs(
                *dct_kernel.real_dct_quant_planes_zigzag(
                    *front_kernel.planes(image, geom)), geom)

        check(torch.equal(into_entries(), with_marshal()),
              f"entries {label}: the two routes differ")
        m1, e1, e2, m2 = (timing.graph_ms(fn, cuda) for fn in (
            with_marshal, into_entries, into_entries, with_marshal))
        print(f"time entries {label} 4:2:0: F1 + K1 into the entries graph "
              f"{(e1 + e2) / 2:.4f} ms ({e1:.4f}, {e2:.4f}), F1 + K1 + the "
              f"marshal graph {(m1 + m2) / 2:.4f} ms ({m1:.4f}, {m2:.4f}) "
              f"({card})", flush=True)
    return worst


def card_entries(cuda, rgb: np.ndarray, geom) -> torch.Tensor:
    """(E, 64) scan entries of rgb, from F1 and K1 into the entries on the
    card (the main path's front half), on the CPU."""
    from jpeg_encoder_torch.config import DctAlgorithm
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import front as front_kernel

    return dct_kernel.scan_entries(
        *front_kernel.planes(torch.from_numpy(rgb).to(cuda), geom), geom,
        DctAlgorithm.REAL_DCT).cpu()


def max_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """max |got - want| of two integer tensors (got may be on the card)."""
    return int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())


def k4_phase(cuda, images_1080) -> float:
    """Entropy kernel vs its plain version on CPU tensors; max |error|
    over the payload bytes within capacity and the bit counts."""
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    worst = 0

    def compare(label, z, geom, capacity, init_dc=None):
        nonlocal worst
        init_cuda = None if init_dc is None else init_dc.to(cuda)
        got, bits = entropy_kernel.encode_entries(
            z.to(cuda), geom, capacity, init_cuda
        )
        torch.cuda.synchronize()
        want, want_bits = entropy_kernel.encode_entries(z, geom, capacity, init_dc)
        err = max(
            abs(int(bits) - int(want_bits)),
            int((got.cpu().to(torch.int32) - want.to(torch.int32)).abs().max()),
        )
        worst = max(worst, err)
        check(err == 0, f"K4 {label}: max |err| {err}")
        return int(want_bits)

    for ratio in RATIOS:
        config = EncoderConfig(subsampling_ratio=ratio)
        geom = config.geometry(1920, 1080)
        cap = pipeline.default_capacity_bytes(geom)
        for name, rgb in images_1080.items():
            z = card_entries(cuda, rgb, geom)
            bits = compare(f"{name} {ratio}", z, geom, cap)
            # A capacity a quarter of the payload: dropped words, true bits.
            small = max(4, bits // 32 // 4 * 4)
            compare(f"{name} {ratio} capacity {small} B", z, geom, small)
        z = torch.from_numpy(adversarial_entries(geom))
        worst_cap = entropy_ops.worst_case_capacity_bytes(geom)
        compare(f"adversarial {ratio}", z, geom, worst_cap)
        compare(
            f"adversarial {ratio} init_dc", z, geom, worst_cap,
            torch.tensor([5, -9, 3], dtype=torch.int32),
        )
        print(f"K4 1080p {ratio}: kernel == plain (corpus, adversarial, "
              "overflow)", flush=True)
    return float(worst)


def k4_interval_phase(cuda, images_1080) -> float:
    """K4 over restart intervals vs its plain version on CPU tensors: 1080p
    corpus content at every ratio, intervals of 1, 7, 120 and 10000 MCUs,
    with every entry live, with a live_entries suffix ending inside an
    interval, and at 8 bytes a row (overflowing rows: dropped words, true
    bit counts). Returns the max |error| over bytes and bit counts."""
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    worst = 0
    for ratio in RATIOS:
        geom = EncoderConfig(subsampling_ratio=ratio).geometry(1920, 1080)
        z = card_entries(cuda, images_1080["architecture"], geom)
        live = geom.num_scan_entries * 2 // 3 + 1
        for interval in INTERVALS:
            epi = entropy_ops.entries_per_interval(geom, interval)
            cap = pipeline.restart_default_capacity_bytes(geom, interval)
            for live_entries, capacity in ((None, cap), (live, cap), (None, 8)):
                args = dict(live_entries=live_entries, entries_per_interval=epi)
                got, bits = entropy_kernel.encode_entries(
                    z.to(cuda), geom, capacity, **args)
                torch.cuda.synchronize()
                want, want_bits = entropy_kernel.encode_entries(
                    z, geom, capacity, **args)
                err = max(max_err(bits, want_bits), max_err(got, want))
                worst = max(worst, err)
                check(err == 0, f"K4 intervals {ratio} every {interval} "
                      f"live {live_entries} capacity {capacity}: max |err| {err}")
                if capacity == 8:
                    overflow = int((want_bits > 64).sum())
            print(f"K4 intervals 1080p {ratio} every {interval} MCUs "
                  f"({want_bits.numel()} rows of {cap} B): kernel == plain "
                  f"(all live; live_entries {live}; 8 B rows, {overflow} "
                  "overflowing)", flush=True)
    return float(worst)


def adversarial_pack_operands(case: str, seed: int = 0):
    """K5 operands at the edges of its walk, meeting its precondition
    (offsets an exclusive cumsum of the bit counts, words zero past each
    entry's count): "zero-runs" (a leading run of 3,000 0-bit entries,
    scattered runs, a dead tail), "max-words" (entries of up to the 56
    words of pack_level1), "past-2^31" (row 0 starts at bit 2^31 - 7,005
    and crosses 2^31). Returns (words (rows, E, 56) int32, offsets (rows,
    E) int64, row end bits (rows,) int64), on the CPU."""
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    ew = entropy_ops.ENTRY_WORDS
    rng = np.random.default_rng(seed)
    start = 0
    if case == "zero-runs":
        bits = rng.integers(1, 41, (3, 4000))
        bits[0, :3000] = 0
        bits[1, rng.random(4000) < 0.8] = 0
        bits[2, 1000:] = 0
    elif case == "max-words":
        bits = rng.choice([ew * 32, ew * 32 - 1, ew * 32 - 31, 1760, 33, 32,
                           31, 1, 0], (2, 200))
    else:
        bits = rng.integers(0, 300, (2, 300))
        start = 2**31 - 7005
    bits = bits.astype(np.int64)
    words = rng.integers(0, 2**32, bits.shape + (ew,), dtype=np.uint64)
    full, rem = bits[..., None] // 32, bits[..., None] % 32
    partial = np.where(rem > 0, ((1 << rem) - 1) << (32 - rem), 0)
    k = np.arange(ew)
    mask = np.where(k < full, 0xFFFFFFFF, np.where(k == full, partial, 0))
    words = (words & mask.astype(np.uint64)).astype(np.uint32).view(np.int32)
    ends = np.cumsum(bits, axis=1)
    offsets = ends - bits
    offsets[0] += start
    row_ends = ends[:, -1] + np.where(np.arange(len(bits)) == 0, start, 0)
    return (torch.from_numpy(words), torch.from_numpy(offsets),
            torch.from_numpy(row_ends))


def k5_phase(cuda, images_1080) -> float:
    """K5 vs its plain version on CPU tensors: the assemble tier's operands
    of 1080p corpus content at 4:2:0 and 4:4:4, as one row (the unbroken
    scan) and as one row per restart interval of 120 and of 1 MCUs, at a
    fitting capacity and at 16 bytes a row; then adversarial operands
    (adversarial_pack_operands: 0-bit runs, 56-word entries, a row past
    bit 2^31) at a fitting capacity and, but past 2^31, at one that cuts an
    entry mid-word and is not a multiple of 16 bytes; and the device
    operations of one call (the kernel alone: no memset). Returns the max
    |error|."""
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch import scan
    from jpeg_encoder_torch.kernels import pack as pack_kernel
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    worst = 0

    def compare(label, words, offsets, cap):
        nonlocal worst
        got = pack_kernel.assemble_bitstream(words.to(cuda), offsets.to(cuda),
                                             cap)
        torch.cuda.synchronize()
        want = pack_kernel.assemble_bitstream(words, offsets, cap)
        err = max_err(got, want)
        worst = max(worst, err)
        check(err == 0, f"K5 {label} capacity {cap}: max |err| {err}")

    for ratio in ((4, 2, 0), (4, 4, 4)):
        geom = EncoderConfig(subsampling_ratio=ratio).geometry(1920, 1080)
        z = card_entries(cuda, images_1080["foliage"], geom)
        for interval in (None, 120, 1):
            epi = (None if interval is None
                   else entropy_ops.entries_per_interval(geom, interval))
            slot_bits, slot_lens = entropy_ops.symbolize(
                z, geom.h_factor * geom.v_factor, entries_per_interval=epi)
            words, offsets, row_bits = scan.assemble_operands(
                slot_bits, slot_lens, epi or geom.num_scan_entries)
            fit = (int(row_bits.max()) // 32 + 2) * 4
            for cap in (fit, 16):
                compare(f"{ratio} interval {interval}", words, offsets, cap)
            print(f"K5 1080p {ratio} {words.shape[0]} rows of "
                  f"{words.shape[1]} entries: kernel == plain (capacity "
                  f"{fit} B and 16 B a row)", flush=True)
    for case in ("zero-runs", "max-words", "past-2^31"):
        words, offsets, ends = adversarial_pack_operands(case)
        fit = (int(ends.max()) // 32 + 9) * 4
        caps = [fit] if case == "past-2^31" else [
            fit, 4 * (int(ends.min()) // 64 // 4 * 4 + 3)]
        for cap in caps:
            compare(case, words, offsets, cap)
        print(f"K5 adversarial {case}: {tuple(words.shape)} entries, last "
              f"offset {int(offsets.max())}: kernel == plain (capacity "
              f"{' and '.join(map(str, caps))} B a row)", flush=True)
    words, offsets, ends = adversarial_pack_operands("zero-runs")
    words, offsets = words.to(cuda), offsets.to(cuda)
    cap = (int(ends.max()) // 32 + 9) * 4
    for _ in range(3):  # an empty trace is retried, as in busy_ms
        ops = device_ops(lambda: pack_kernel.assemble_bitstream(
            words, offsets, cap))
        count = sum(c for _, c, _ in ops)
        if count:
            break
    check(count == 1 and "assemble_kernel" in ops[0][0],
          f"one K5 call ran other than its one kernel: {ops}")
    print(f"K5 device operations per call: {count:g} ("
          + "; ".join(f"{name[:50]} x{c:g}" for name, c, _ in ops) + ")",
          flush=True)
    return float(worst)


class SymbolCounter:
    """A Huffman table stand-in for oracle.encode_block that counts the
    symbols asked of it into one row of a (4, 256) histogram and codes
    them in 0 bits."""

    def __init__(self, row: np.ndarray):
        self.row = row

    def encode_symbol(self, symbol: int) -> tuple[int, int]:
        self.row[symbol] += 1
        return 0, 0


def oracle_segments(zz, geom, restart, specs):
    """The oracle's zigzag coefficients [Y, Cb, Cr] coded bit-serially
    with oracle.encode_block and specs (Y-DC, C-DC, Y-AC, C-AC), DC
    predictors reset at every restart interval: (segments, bit counts)."""
    from jpeg_encoder_torch import oracle

    order = oracle.luma_scan_order(geom)
    step = restart or geom.num_mcus
    segments, bits = [], []
    for start in range(0, geom.num_mcus, step):
        writer = oracle.BitWriter()
        prev = [0, 0, 0]
        for mcu in range(start, min(start + step, geom.num_mcus)):
            for block in order[mcu]:
                prev[0] = oracle.encode_block(zz[0][block], prev[0], specs[0],
                                              specs[2], writer)
            for c in (1, 2):
                prev[c] = oracle.encode_block(zz[c][mcu], prev[c], specs[1],
                                              specs[3], writer)
        segments.append(np.frombuffer(writer.to_bytes(), np.uint8))
        bits.append(writer.bit_length)
    return segments, bits


def oracle_file(rgb: np.ndarray, config) -> bytes:
    """The NumPy oracle's file for config: its unbroken scan; its
    restart-framed scan (oracle.entropy_encode_restart); or, with
    optimize_huffman, its coefficients coded bit-serially
    (oracle.encode_block) with the optimal tables of the symbols that
    encode_block itself counts in a first pass over the same framing, one
    1-padded segment per restart interval. Nothing of the port's encoder is
    used: only its copies of the oracle, the tables and the JFIF writer."""
    import dataclasses

    from jpeg_encoder_torch import oracle, tables
    from jpeg_encoder_torch.io import jfif

    ref = oracle.encode_oracle(rgb, dataclasses.replace(
        config, restart_interval=None, optimize_huffman=False))
    geom, restart, quality = ref.geom, config.restart_interval, config.quality
    coeffs = (ref.y_coeffs, ref.cb_coeffs, ref.cr_coeffs)
    if not config.optimize_huffman:
        if restart is None:
            return jfif.assemble(geom, ref.entropy_bytes, quality=quality)
        segments, bits = oracle.entropy_encode_restart(*coeffs, geom, restart)
        return jfif.assemble_restart(
            geom, [np.frombuffer(s, np.uint8) for s in segments], bits,
            restart, quality=quality)
    zz = [c.reshape(-1, 64)[:, tables.ZIGZAG_ORDER] for c in coeffs]
    hist = np.zeros((4, 256), np.int64)
    oracle_segments(zz, geom, restart, [SymbolCounter(r) for r in hist])
    specs = tuple(tables.optimal_spec(h) for h in hist)
    segments, bits = oracle_segments(zz, geom, restart, specs)
    if restart is None:
        return jfif.assemble(geom, segments[0], quality=quality,
                             dht_specs=specs)
    return jfif.assemble_restart(geom, segments, bits, restart,
                                 quality=quality, dht_specs=specs)


def checkerboard(size: int = 32) -> np.ndarray:
    """A black/white pixel checkerboard: at 4:4:4, binDCT and quality 100
    its raw lifting outputs leave the scan's 10-bit AC range."""
    y, x = np.mgrid[0:size, 0:size]
    return np.repeat((((x + y) % 2) * 255).astype(np.uint8)[..., None], 3, -1)


def check_fast_file(cuda, label, rgb, config, got: bytes) -> None:
    """--fast-dct on the card: its coefficients within the K2 tolerance of
    the CPU path's (and of the exact RealDCT's), and everything after the
    DCT exact: the file is the CPU entropy coder's over the card's own
    coefficients."""
    import dataclasses

    from jpeg_encoder_torch import tables
    from jpeg_encoder_torch.io import jfif
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    result, coeffs = pipeline.encode_array(rgb, config, device=cuda,
                                           return_coeffs=True)
    check(result.file_bytes == got, f"e2e {label}: card runs differ")
    rates = []
    for name, ref_config, limit in (
        ("CPU path", config, 1e-3),
        ("exact RealDCT", dataclasses.replace(config, fast_dct=False), 5e-4),
    ):
        _, want = pipeline.encode_array(rgb, ref_config, device="cpu",
                                        return_coeffs=True)
        d = np.concatenate([np.abs(c.astype(np.int32) - w.astype(np.int32))
                            for c, w in zip(coeffs, want)])
        err, rate = int(d.max()), float((d > 0).mean())
        check(err <= 1 and rate < limit,
              f"e2e {label} vs {name}: max |err| {err}, mismatch rate {rate}")
        rates.append(f"vs {name} mismatch rate {rate:.3e}")
    geom = result.geom
    zz = [torch.from_numpy(c[:, tables.ZIGZAG_ORDER].copy()) for c in coeffs]
    z = entropy_ops.marshal_scan_inputs(*zz, geom)
    payload, bits = entropy_ops.encode_entries(
        z, geom, entropy_ops.worst_case_capacity_bytes(geom)
    )
    payload = payload[: (int(bits) + 7) // 8].numpy().tobytes()
    check(got == jfif.assemble(geom, payload, quality=config.quality),
          f"e2e {label}: file != CPU entropy coder over the card's coefficients")
    print(f"e2e {label}: {len(got)} B, coefficients " + ", ".join(rates)
          + "; file == CPU entropy coder over the card's coefficients",
          flush=True)


def e2e_phase(cuda, images_1080, images_4k, tmp) -> dict[str, int]:
    """Drive the main paths on the card, then hold every file against the
    CPU path (and the small ones against the oracle; --fast-dct as
    check_fast_file says). Returns the kernel launch counts of the card runs
    alone."""
    import dataclasses

    from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_torch.io import bmp
    from jpeg_encoder_torch import pipeline

    rng = np.random.default_rng(11)
    # (label, rgb, config, check: "cpu", "oracle" or "fast"[, packer])
    cases = []
    default = EncoderConfig()
    bin_dct = EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)
    descale = dataclasses.replace(bin_dct, bin_dct_descale=True)
    for name, rgb in images_1080.items():
        cases.append((f"{name} 1920x1080 4:2:0", rgb, default, "cpu"))
    for name, rgb in images_4k.items():
        cases.append((f"{name} 3840x2160 4:2:0", rgb, default, "cpu"))
    first = next(iter(images_1080.values()))
    for ratio in ((4, 2, 2), (4, 4, 4)):
        cases.append((f"1920x1080 {ratio}", first,
                      EncoderConfig(subsampling_ratio=ratio), "cpu"))
    cases.append(("1920x1080 4:2:0 quality 90", first,
                  EncoderConfig(quality=90), "cpu"))
    for ratio in ((4, 2, 0), (4, 2, 2), (4, 4, 4)):
        cases.append((f"bin-dct 1920x1080 {ratio}", first,
                      dataclasses.replace(bin_dct, subsampling_ratio=ratio),
                      "cpu"))
    cases.append(("bin-dct descale 1920x1080 4:2:0", first, descale, "cpu"))
    cases.append(("bin-dct descale 1920x1080 4:2:0 quality 90", first,
                  dataclasses.replace(descale, quality=90), "cpu"))
    cases.append(("fast-dct 1920x1080 4:2:0", first,
                  EncoderConfig(fast_dct=True), "fast"))
    for width, height in ((517, 333), (33, 17), (1921, 1089)):
        rgb = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        kind = "oracle" if width < 1000 else "cpu"
        for ratio in ((4, 2, 0), (4, 2, 2), (4, 4, 4)):
            cases.append((f"{width}x{height} {ratio}", rgb,
                          EncoderConfig(subsampling_ratio=ratio), kind))
            if width < 1000:
                cases.append((f"bin-dct {width}x{height} {ratio}", rgb,
                              dataclasses.replace(bin_dct,
                                                  subsampling_ratio=ratio),
                              kind))
    board = dataclasses.replace(bin_dct, subsampling_ratio=(4, 4, 4),
                                quality=100)
    cases.append(("bin-dct checkerboard 32x32 4:4:4 quality 100",
                  checkerboard(), board, "cpu"))
    # Restart markers, optimized tables, and the assemble packer (K5).
    for ratio in RATIOS:
        for interval in INTERVALS:
            for name, base in (("", default), ("bin-dct ", bin_dct)):
                cases.append((
                    f"{name}restart {interval} 1920x1080 {ratio}", first,
                    dataclasses.replace(base, subsampling_ratio=ratio,
                                        restart_interval=interval), "cpu"))
    cases.append(("restart 240 3840x2160 4:2:0",
                  next(iter(images_4k.values())),
                  EncoderConfig(restart_interval=240), "cpu"))
    optimize = EncoderConfig(optimize_huffman=True)
    cases.append(("optimize 1920x1080 4:2:0", first, optimize, "cpu"))
    cases.append(("optimize restart 120 1920x1080 4:2:0", first,
                  dataclasses.replace(optimize, restart_interval=120), "cpu"))
    cases.append(("assemble restart 120 1920x1080 4:2:0", first,
                  EncoderConfig(restart_interval=120), "cpu", "assemble"))
    small = rng.integers(0, 256, (333, 517, 3), dtype=np.uint8)
    for ratio in RATIOS:
        cases.append((f"restart 7 517x333 {ratio}", small,
                      EncoderConfig(subsampling_ratio=ratio,
                                    restart_interval=7), "oracle"))
    cases.append(("optimize 517x333 4:2:0", small, optimize, "oracle"))
    cases.append(("optimize restart 7 bin-dct 517x333 4:4:4", small,
                  dataclasses.replace(bin_dct, subsampling_ratio=(4, 4, 4),
                                      optimize_huffman=True,
                                      restart_interval=7), "oracle"))
    cases.append(("assemble 517x333 4:2:2", small,
                  EncoderConfig(subsampling_ratio=(4, 2, 2)), "oracle",
                  "assemble"))
    cases.append(("assemble optimize restart 7 517x333 4:2:0", small,
                  dataclasses.replace(optimize, restart_interval=7), "oracle",
                  "assemble"))
    cases = [c if len(c) == 5 else c + ("fused",) for c in cases]
    paths = []
    for i, (label, rgb, config, _, _) in enumerate(cases):
        src = os.path.join(tmp, f"case{i}.bmp")
        bmp.write(src, rgb)
        paths.append((src, os.path.join(tmp, f"case{i}_cuda.jpg")))

    # The main paths on the card, alone between the reset and the read.
    def drive():
        for (label, _, config, _, packer), (src, dst) in zip(cases, paths):
            if packer == "fused":
                pipeline.encode_file(src, dst, config, device=cuda)
                continue
            result = pipeline.encode_array(bmp.read(src), config, device=cuda,
                                           packer=packer)
            with open(dst, "wb") as f:
                f.write(result.file_bytes)

    counts = counted("e2e", drive, E2E_KERNELS)

    for (label, rgb, config, kind, packer), (src, dst) in zip(cases, paths):
        with open(dst, "rb") as f:
            got = f.read()
        if kind == "fast":
            check_fast_file(cuda, label, rgb, config, got)
            continue
        want = pipeline.encode_array(rgb, config, device="cpu").file_bytes
        check(got == want, f"e2e {label}: card file != CPU file")
        if kind == "oracle":
            check(got == oracle_file(rgb, config),
                  f"e2e {label}: file != oracle")
        print(f"e2e {label}: {len(got)} B, card == CPU"
              + (" == oracle" if kind == "oracle" else ""), flush=True)

    # Quirk geometries refuse restart markers before any device work.
    for config in (EncoderConfig(restart_interval=2),
                   EncoderConfig(restart_interval=2, optimize_huffman=True)):
        try:
            pipeline.encode_array(rng.integers(0, 256, (17, 33, 3), np.uint8),
                                  config, device=cuda)
        except ValueError as e:
            check("quirk geometry" in str(e), str(e))
        else:
            check(False, "restart markers on 33x17 4:2:0 did not raise")
    print("e2e restart markers on 33x17 4:2:0 (a quirk geometry): "
          "ValueError on the card, as the reference", flush=True)

    # The checkerboard's AC sizes reach 11-13 bits: with validate the port
    # raises on the card as the reference (and the oracle) do.
    for device in (cuda, "cpu"):
        try:
            pipeline.encode_array(checkerboard(),
                                  dataclasses.replace(board, validate=True),
                                  device=device)
        except ValueError as e:
            check("AC coefficient bit length" in str(e), str(e))
        else:
            check(False, f"checkerboard with validate on {device} did not raise")
    print("e2e bin-dct checkerboard with validate: ValueError on the card and "
          "on CPU, as the reference", flush=True)
    return counts


# The staged read's geometries: 1920x1080 (rows of 5760 bytes),
# 1366x768, whose 4098-byte rows the file pads to 4100, and 3840x2160.
STAGED_GEOMETRIES = ((1080, 1920), (768, 1366), (2160, 3840))


def quartiles(values: list[float]) -> str:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return f"{q2:.4f} [{q1:.4f}, {q3:.4f}]"


def staged_read_phase(cuda, card, tmp) -> dict[str, int]:
    """encode_file's staged read on the card (bmp.read(path, out=) into
    the thread's pipeline.STAGING buffer, the rows uploaded as stored and
    read as stored by the program's front kernel, F1): the benchmark's 8 corpus
    contents (benchmark/contents.py, seed 0) at each of STAGED_GEOMETRIES,
    twice (each key's eager call, its capture, replays); every file equal
    to the eager RGB path's (encode_array of the decoded array under
    graphs.disabled()); the thread's buffers pinned. Then prints the
    upload's GB/s from the pinned buffer and F1's device ms on the stored
    rows (CUDA events), and a request's ms against the decoded path's (bmp.read,
    encode_array of the array, the write), in alternated rounds. The read
    is split (split_read_checks): the native runtime loaded, each
    encode_file read bmp.file_ranges(width, height) > 1 ranges, the rows
    equal one pread's."""
    from benchmark import contents
    from jpeg_encoder_torch import graphs, native, pipeline
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.io import bmp
    from jpeg_encoder_torch.kernels import front as front_kernel

    check(native.load() is not None,
          "staged read: the native runtime does not load, so encode_file "
          "would read in Python, one range")
    want = {}
    for height, width in STAGED_GEOMETRIES:
        for k in range(8):
            rgb = contents.content(0, k, height, width)
            src = os.path.join(tmp, f"staged_{width}x{height}_{k}.bmp")
            bmp.write(src, rgb)
            with graphs.disabled():
                want[src] = pipeline.encode_array(rgb, device=cuda).file_bytes

    def drive():
        for _ in range(2):
            for src, file_bytes in want.items():
                dst = src[:-4] + ".jpg"
                pipeline.encode_file(src, dst, device=cuda)
                with open(dst, "rb") as f:
                    check(f.read() == file_bytes,
                          f"staged read {src}: file != the eager RGB path's")

    counts = counted("staged read", drive, MAIN_KERNELS)
    for height, width in STAGED_GEOMETRIES:
        buffer = pipeline.STAGING.take(cuda, width, height).buffer
        check(buffer.is_pinned(),
              f"staged read {width}x{height}: the staging buffer is pageable")
        rows = torch.empty(buffer.numel(), dtype=torch.uint8, device=cuda)
        upload_ms = cuda_ms(lambda: rows.copy_(buffer, non_blocking=True))
        stored = bmp.Rows(rows.view(height, bmp.row_stride(width)), width,
                          height)
        geom = EncoderConfig().geometry(width, height)
        front_ms = cuda_ms(lambda: front_kernel.planes(stored, geom))
        print(f"staged read {width}x{height}: "
              f"{len(want) // len(STAGED_GEOMETRIES)} files x 2, "
              f"every file == the eager RGB path's; pinned buffer of "
              f"{buffer.numel()} B; upload {upload_ms:.4f} ms "
              f"({buffer.numel() / upload_ms / 1e6:.2f} GB/s); F1 from the "
              f"stored rows {front_ms:.4f} ms ({card})", flush=True)

    def decoded(src, dst):
        result = pipeline.encode_array(bmp.read(src), device=cuda)
        with open(dst, "wb") as f:
            f.write(result.file_bytes)

    height, width = STAGED_GEOMETRIES[0]
    paths = list(want)[:8]
    ways = {"staged": lambda src, dst: pipeline.encode_file(src, dst,
                                                           device=cuda),
            "decoded": decoded}
    ms = {name: [] for name in ways}
    for name, way in ways.items():  # each key's eager call and capture
        for src in paths[:2]:
            way(src, src[:-4] + ".jpg")
    for turn in range(6):
        for name in (("staged", "decoded") if turn % 2 == 0
                     else ("decoded", "staged")):
            for src in paths:
                t0 = time.perf_counter()
                ways[name](src, src[:-4] + ".jpg")
                ms[name].append((time.perf_counter() - t0) * 1e3)
    print(f"staged read {width}x{height} request ms, median [quartiles] of "
          f"{len(ms['staged'])}, alternated rounds of 8: staged "
          f"{quartiles(ms['staged'])}, decoded {quartiles(ms['decoded'])} "
          f"({card})", flush=True)
    split_read_checks(cuda, card, list(want))
    return counts


def split_read_checks(cuda, card, paths: list[str]) -> None:
    """encode_file's split read at each of STAGED_GEOMETRIES: under
    trace.recording() one encode_file of each file counts
    bmp.file_ranges(width, height) > 1 ranges (read.ranges), and the split
    rows equal one pread's, byte for byte; then
    one pread against the split read into the thread's pinned staging
    buffer, ms a file, median [quartiles] of alternated rounds of the
    geometry's files."""
    from jpeg_encoder_torch import native, pipeline, trace
    from jpeg_encoder_torch.io import bmp

    for height, width in STAGED_GEOMETRIES:
        ranges = bmp.file_ranges(width, height)
        check(ranges > 1, f"split read {width}x{height}: "
              f"bmp.file_ranges is {ranges}")
        mine = [p for p in paths if f"_{width}x{height}_" in p]
        with trace.recording() as recorder:
            for src in mine:
                pipeline.encode_file(src, src[:-4] + ".jpg", device=cuda)
        got = recorder.counters.get("read.ranges", 0)
        check(got == ranges * len(mine),
              f"split read {width}x{height}: {got} ranges in {len(mine)} "
              f"encode_file reads, not {ranges} each")
        buffer = pipeline.STAGING.take(cuda, width, height).buffer
        one = torch.empty(buffer.numel(), dtype=torch.uint8, pin_memory=True)
        for src in mine:
            split = bmp.read(src, out=buffer, ranges=ranges).rows
            whole = bmp.read(src, out=one).rows
            check(torch.equal(split, whole),
                  f"split read {src}: rows != one pread's")
        ways = {"one pread": lambda src: bmp.read(src, out=buffer),
                "split": lambda src: bmp.read(src, out=buffer,
                                              ranges=ranges)}
        ms = {name: [] for name in ways}
        for turn in range(8):
            for name in (("one pread", "split") if turn % 2 == 0
                         else ("split", "one pread")):
                for src in mine:
                    t0 = time.perf_counter()
                    ways[name](src)
                    ms[name].append((time.perf_counter() - t0) * 1e3)
        print(f"split read {width}x{height}: {len(mine)} files, "
              f"{ranges} ranges a read == one pread's rows, pool of "
              f"{native.load().jt_read_pool_threads()} threads; ms a file, "
              f"median [quartiles] of {len(ms['split'])}, alternated rounds: "
              f"one pread {quartiles(ms['one pread'])}, split "
              f"{quartiles(ms['split'])} ({card})", flush=True)


def program_of(cuda, key):
    """The cached program of a key on cuda that the calling thread owns on
    the current stream (graphs.run puts them in front of the caller's
    key), or None."""
    import threading

    from jpeg_encoder_torch import graphs

    full = (torch.cuda.current_stream(cuda).cuda_stream,
            threading.get_ident(), *key)
    return dict(graphs.CACHE.programs(cuda)).get(full)


def replay_ms(cuda, program, calls: int = 10, reps: int = REPS) -> float:
    """Median ms of one replay of a cached program's graph: `calls`
    replays between two events, as bench/timing.graph_ms times a captured
    call (its device work, no host)."""
    clock = timing.EventClock(cuda)
    times = []
    for _ in range(reps):
        clock.start()
        for _ in range(calls):
            program.graph.replay()
        times.append(clock.stop() * 1e3 / calls)
    return statistics.median(times)


def graph_options():
    """(label, config, encode_array keywords, hold against the CPU path) of
    every option the graph phase drives."""
    import dataclasses

    from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig

    bin_dct = EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)
    optimize = EncoderConfig(optimize_huffman=True)
    return [
        ("4:2:0", EncoderConfig(), {}, True),
        ("4:2:2", EncoderConfig(subsampling_ratio=(4, 2, 2)), {}, True),
        ("4:4:4", EncoderConfig(subsampling_ratio=(4, 4, 4)), {}, True),
        ("bin-dct", bin_dct, {}, True),
        ("bin-dct descale", dataclasses.replace(bin_dct, bin_dct_descale=True),
         {}, True),
        ("fast-dct", EncoderConfig(fast_dct=True), {}, False),
        ("restart 120", EncoderConfig(restart_interval=120), {}, True),
        ("restart 1", EncoderConfig(restart_interval=1), {}, False),
        ("optimize", optimize, {}, True),
        ("optimize restart 120",
         dataclasses.replace(optimize, restart_interval=120), {}, True),
        ("validate", EncoderConfig(validate=True), {}, True),
        ("assemble", EncoderConfig(), {"packer": "assemble"}, True),
        ("return_coeffs", EncoderConfig(), {"return_coeffs": True}, True),
    ]


def graph_phase(cuda, images_1080, images_4k, card) -> dict[str, int]:
    """The compiled-program layer (jpeg_encoder_torch/graphs.py), driven:
    every option of graph_options at 1920x1080 and 3840x2160 (corpus
    frames) and at 1921x1089, a quirk geometry (no restart markers there;
    restart 1 at 1080p only), three contents a key. A key's first call runs
    eagerly, its second captures a CUDA graph and replays it, its third
    replays: every file (and coefficients) == the eager card path's
    (graphs.disabled()), and the first content's eager card file == the
    CPU path's at 1080p and the quirk geometry for every exact option and
    at 4K for 4:2:0 (the e2e phase holds the rest). Then every other option
    and two band encodes at quality 77 with every operand cache emptied
    between the first and second calls (the capture warms up, and builds
    no operand itself, which on a card would be a blocking copy that
    capture refuses), the capacity ladder
    past the first rung under a replayed key (a 4 KiB first rung; 256 B an
    interval at restart 120), an eviction (distinct quality keys at 4K
    until the LRU drops one; that key captured again, still exact), and
    encode_tiled at 4 and 8 bands, alone and over [cuda] * 4, unbroken,
    restart 120 and optimize, three contents each, == encode_array. A
    failed capture or replay raises and fails the run. Prints each key's
    capture ms, pool MB and replays, and, outside the counted drive,
    eager against replayed: encode_array host ms (median of 10 warm runs)
    and its device program's events ms and graph ms at 1080p and 4K, and
    encode_tiled host ms at 4 and 8 bands at 4K. Returns the launch
    counts."""
    import dataclasses

    from jpeg_encoder_torch import graphs, pipeline
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.parallel import tiled
    from jpeg_encoder_torch.utils import corpus

    hd = list(images_1080.values())[:3]
    uhd = list(variants(list(images_4k.values()), 3))
    quirk = list(variants([corpus.landscape(1089, 1921)], 3))
    geometries = (("1920x1080", hd), ("3840x2160", uhd),
                  ("1921x1089", quirk))
    lines = []

    def encode(rgb, config, kw):
        out = pipeline.encode_array(rgb, config, device=cuda, **kw)
        return out if isinstance(out, tuple) else (out, None)

    def same(got, want) -> bool:
        if got[0].file_bytes != want[0].file_bytes:
            return False
        return got[1] is None or all(
            np.array_equal(a, b) for a, b in zip(got[1], want[1]))

    def drive_key(label, images, config, kw, cpu_check):
        geom = config.geometry(images[0].shape[1], images[0].shape[0])
        for i, rgb in enumerate(images):
            got = encode(rgb, config, kw)
            with graphs.disabled():
                want = encode(rgb, config, kw)
            check(same(got, want), f"graphs {label} content {i}: replayed "
                  "!= eager card")
            if i == 0 and cpu_check:
                cpu = pipeline.encode_array(rgb, config, device="cpu")
                check(want[0].file_bytes == cpu.file_bytes,
                      f"graphs {label}: eager card != CPU")
        capacity = kw.get("_initial_capacity_bytes") or (
            pipeline.initial_capacity_bytes(geom, config))
        keys = pipeline.program_keys(geom, config, capacity,
                                     kw.get("return_coeffs", False),
                                     kw.get("packer", "fused"))
        for name, key in keys.items():
            program = program_of(cuda, key)
            check(program is not None and program.replays >= 2,
                  f"graphs {label}: {name} program not replayed")
            lines.append(f"graphs {label} [{name}]: capture "
                         f"{program.capture_ms:.1f} ms, pool "
                         f"{program.pool_bytes / 2**20:.1f} MB, replays "
                         f"{program.replays}")
        print(f"graphs {label}: {len(images)} contents, replayed == eager "
              f"card{' == CPU' if cpu_check else ''} ({card})", flush=True)

    def drive():
        for geometry, images in geometries:
            quirky = geometry == "1921x1089"
            for label, config, kw, cpu in graph_options():
                if config.restart_interval and (
                        quirky or (config.restart_interval == 1
                                   and geometry != "1920x1080")):
                    continue
                drive_key(f"{geometry} {label}", images, config, kw,
                          cpu and (geometry != "3840x2160"
                                   or label == "4:2:0"))
        # Operands evicted between a key's first and second calls (other
        # sizes or qualities push them out of their caches): the capture
        # warms up first and builds none of them itself.
        evicted = []
        for label, config, kw, _ in graph_options()[::2]:
            config = dataclasses.replace(config, quality=77)
            for i, rgb in enumerate(hd):
                if i == 1:
                    for cached in graphs.operand_caches():
                        cached.cache_clear()
                got = encode(rgb, config, kw)
                with graphs.disabled():
                    want = encode(rgb, config, kw)
                check(same(got, want), f"graphs {label} quality 77 content "
                      f"{i}, operands evicted: replayed != eager card")
            evicted.append(label)
        for config in (EncoderConfig(quality=77, optimize_huffman=True),
                       EncoderConfig(quality=77, restart_interval=120)):
            for i, rgb in enumerate(hd):
                if i == 1:
                    for cached in graphs.operand_caches():
                        cached.cache_clear()
                got = tiled.encode_tiled(rgb, config, 4, device=cuda)
                check(got.file_bytes == pipeline.encode_array(
                    rgb, config, device=cuda).file_bytes,
                      f"graphs encode_tiled {config}, operands evicted: "
                      "!= encode_array")
        print("graphs 1920x1080 quality 77, every operand cache emptied "
              f"between a key's first and second calls ({', '.join(evicted)}"
              "; encode_tiled 4 bands optimize, restart 120): captured, "
              f"replayed == eager card ({card})", flush=True)
        # The capacity ladder past the first rung, under replayed keys.
        for label, config, first in (
                ("ladder 4 KiB", EncoderConfig(), 4096),
                ("ladder restart 120 256 B",
                 EncoderConfig(restart_interval=120), 256)):
            drive_key(f"1920x1080 {label}", hd, config,
                      {"_initial_capacity_bytes": first}, False)
            for rgb in hd:
                check(pipeline.encode_array(
                    rgb, config, device=cuda,
                    _initial_capacity_bytes=first).file_bytes
                      == pipeline.encode_array(rgb, config,
                                               device=cuda).file_bytes,
                      f"graphs 1920x1080 {label}: != the default rung's file")
        # Distinct keys until the LRU evicts one; it comes back exact.
        graphs.CACHE.clear()
        before = graphs.CACHE.evictions
        rgb = uhd[0]
        keys = []
        for quality in range(1, 101):
            config = EncoderConfig(quality=quality)
            for _ in range(2):
                pipeline.encode_array(rgb, config, device=cuda)
            keys.append(quality)
            if graphs.CACHE.evictions > before:
                break
        check(graphs.CACHE.evictions > before,
              "graphs: 100 4K keys evicted nothing")
        held = graphs.CACHE.programs(cuda)
        pool = sum(p.pool_bytes for _, p in held)
        gone = EncoderConfig(quality=keys[0])
        geom = gone.geometry(rgb.shape[1], rgb.shape[0])
        check(program_of(cuda, pipeline.program_keys(
            geom, gone, pipeline.initial_capacity_bytes(geom, gone))["scan"])
              is None, "graphs: the least recent key was not evicted")
        drive_key(f"3840x2160 quality {keys[0]} after eviction", uhd, gone,
                  {}, False)
        print(f"graphs eviction: {len(keys)} 3840x2160 keys, the cache "
              f"holds {len(held)} programs, {pool / 2**20:.1f} MB of pools "
              f"(bound {graphs.max_pool_bytes(cuda) / 2**20:.0f} MB, "
              f"{graphs.MAX_PROGRAMS} programs); quality {keys[0]} evicted, "
              f"captured again, exact ({card})", flush=True)
        # Bands: the front, statistics and encode programs of every run.
        for config in (EncoderConfig(), EncoderConfig(restart_interval=120),
                       EncoderConfig(optimize_huffman=True)):
            for rgb in hd:
                want = pipeline.encode_array(rgb, config,
                                             device=cuda).file_bytes
                for bands in (4, 8):
                    for devices in (None, [cuda] * 4):
                        got = tiled.encode_tiled(rgb, config, bands,
                                                 device=cuda, devices=devices)
                        check(got.file_bytes == want,
                              f"graphs encode_tiled {bands} bands "
                              f"{'x4 shares' if devices else ''} "
                              f"{config}: != encode_array")
        print("graphs encode_tiled 1920x1080 at 4 and 8 bands, one share and "
              "[cuda] * 4, unbroken, restart 120, optimize, 3 contents: "
              f"replayed == encode_array ({card})", flush=True)

    counts = counted("graphs", drive, E2E_KERNELS)
    for line in lines:
        print(f"{line} ({card})", flush=True)

    # Eager against replayed, outside the counted drive.
    default = EncoderConfig()
    for label, rgb in (("1920x1080", hd[0]), ("3840x2160", uhd[0])):
        geom = default.geometry(rgb.shape[1], rgb.shape[0])
        cap = pipeline.initial_capacity_bytes(geom, default)
        key = pipeline.program_keys(geom, default, cap)["scan"]
        program = pipeline.scan_program(geom, default, cap)
        rgb_dev = timing.resident(rgb, cuda)

        def call():
            return graphs.run(key, program, {"rgb": rgb_dev}, cuda)

        def array():
            return pipeline.encode_array(rgb, default, device=cuda)

        with graphs.disabled():
            eager = (host_ms(array), cuda_ms(call),
                     timing.graph_ms(call, cuda))
        replayed = (host_ms(array), cuda_ms(call),
                    replay_ms(cuda, program_of(cuda, key)))
        print(f"graphs {label} 4:2:0 encode_array host ms (median of 10) "
              f"eager {eager[0]:.4f} / replayed {replayed[0]:.4f}; its device "
              f"program events ms eager {eager[1]:.4f} / replayed "
              f"{replayed[1]:.4f}, graph ms eager {eager[2]:.4f} / replayed "
              f"{replayed[2]:.4f} ({card})", flush=True)
    rgb = uhd[0]
    for bands in (4, 8):
        def band_call():
            return tiled.encode_tiled(rgb, default, bands, device=cuda)

        with graphs.disabled():
            eager = host_ms(band_call)
        replayed = host_ms(band_call)
        print(f"graphs 3840x2160 4:2:0 encode_tiled {bands} bands host ms "
              f"(median of 10) eager {eager:.4f} / replayed {replayed:.4f} "
              f"({card})", flush=True)
    return counts


def gradient(height: int, width: int) -> np.ndarray:
    """A smooth RGB gradient: red across, green down, blue diagonal."""
    y, x = np.mgrid[0:height, 0:width]
    return np.stack([x * 255 // (width - 1), y * 255 // (height - 1),
                     (x + y) * 255 // (width + height - 2)],
                    axis=-1).astype(np.uint8)


def large_image_path(cuda) -> dict[str, int]:
    """A 7680x4320 4:4:4 gradient through pipeline.encode_array on the card
    (1,555,200 scan entries, a worst case of 2.7e9 bits, past 2^31): its
    file must equal the CPU path's, and K1 and K4 must have run. Returns
    the path's launch counts."""
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel

    config = EncoderConfig(subsampling_ratio=(4, 4, 4))
    rgb = gradient(4320, 7680)
    geom = config.geometry(7680, 4320)
    check(entropy_kernel.worst_case_bits(geom) >= 2**31,
          "the large image's worst case is below 2^31 bits")
    results = []
    counts = counted("large image", lambda: results.append(
        pipeline.encode_array(rgb, config, device=cuda)),
        MAIN_KERNELS)
    t0 = time.perf_counter()
    want = pipeline.encode_array(rgb, config, device="cpu")
    cpu_s = time.perf_counter() - t0
    check(results[0].file_bytes == want.file_bytes,
          "large image: card file != CPU file")
    print(f"large image 7680x4320 4:4:4: {len(want.file_bytes)} B, "
          f"{want.bit_length} bits, card == CPU path (CPU path "
          f"{cpu_s:.1f} s)", flush=True)
    return counts


def blocks_as_plane(blocks: torch.Tensor, blocks_x: int) -> torch.Tensor:
    """The (H, W) plane whose row-major blocks are `blocks`."""
    n = blocks.shape[0]
    return (blocks.reshape(n // blocks_x, blocks_x, 8, 8).permute(0, 2, 1, 3)
            .reshape(n // blocks_x * 8, blocks_x * 8).contiguous())


def block_pairs():
    """(name, per-block wrapper, 3-plane wrapper) of K6a/b and K6c."""
    from jpeg_encoder_torch.kernels import dct as dct_kernel

    return (("realdct_blocks", dct_kernel.real_dct_quant_zigzag,
             dct_kernel.real_dct_quant_planes_zigzag),
            ("bindct_blocks", dct_kernel.bin_dct_quant_zigzag,
             dct_kernel.bin_dct_quant_planes_zigzag))


def k6_phase(cuda, rng) -> dict[str, float]:
    """K6a/b and K6c vs their plain versions on CPU tensors, exact, on the
    32,640 random blocks of a 1088x1920 plane, luma and chroma, quality
    None and 35; and vs K1 and K3 on the plane whose blocks they are
    (tests/test_kernels.py's check of the TPU tier). Max |error| a kernel."""
    worst = {name: 0 for name, _, _ in block_pairs()}
    other = torch.zeros((8, 8), dtype=torch.uint8, device=cuda)
    for quality in (None, 35):
        blocks = torch.from_numpy(
            rng.integers(0, 256, (32640, 64), dtype=np.uint8))
        dev = blocks.to(cuda)
        plane = blocks_as_plane(dev, 240)
        for is_luma in (True, False):
            planes = (plane, other, other) if is_luma else (other, plane, plane)
            for name, fn, planes_fn in block_pairs():
                got = fn(dev, is_luma, quality)
                torch.cuda.synchronize()
                err = max_err(got, fn(blocks, is_luma, quality))
                ref = planes_fn(*planes, quality)[0 if is_luma else 1]
                err_ref = max_err(got, ref.cpu())
                worst[name] = max(worst[name], err)
                check(err == 0 and err_ref == 0,
                      f"{name} luma={is_luma} q={quality}: max |err| {err} "
                      f"vs plain, {err_ref} vs the 3-plane kernel")
    print("K6a/b realdct_blocks, K6c bindct_blocks: 32,640 random blocks, "
          "luma and chroma, quality None and 35: kernel == plain == K1 / K3 "
          "on the same blocks (exact)", flush=True)
    return {k: float(v) for k, v in worst.items()}


def block_tier_path(cuda, images_1080) -> dict[str, int]:
    """The per-block tier, driven: every 1080p corpus image's three planes
    (the main path's colour, pad and subsample) through K6a/b (RealDCT,
    quality None and 90) and K6c (binDCT), plane by plane with the
    plane's own table; then each result held against K1 and K3 on the
    same planes. Returns the tier's launch counts."""
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.kernels import front as front_kernel
    from jpeg_encoder_torch.ops import sample

    height, width = next(iter(images_1080.values())).shape[:2]
    geom = EncoderConfig().geometry(width, height)
    planes = [front_kernel.planes(torch.from_numpy(rgb).to(cuda), geom)
              for rgb in images_1080.values()]
    jobs = [(i, p, name, quality) for i, three in enumerate(planes)
            for p in range(3) for name, _, _ in block_pairs()
            for quality in ((None, 90) if name == "realdct_blocks" else (None,))]
    fns = {name: fn for name, fn, _ in block_pairs()}
    results = []

    def drive():
        for i, p, name, quality in jobs:
            blocks = sample.blockify(planes[i][p]).contiguous()
            results.append(fns[name](blocks, p == 0, quality))
        torch.cuda.synchronize()

    counts = counted("per-block tier", drive, BLOCK_KERNELS)
    planes_fns = {name: fn for name, _, fn in block_pairs()}
    for (i, p, name, quality), got in zip(jobs, results):
        want = planes_fns[name](*planes[i], quality)[p].to(torch.int32)
        check(torch.equal(got, want),
              f"per-block tier {name} image {i} plane {p} q={quality}: "
              "!= the 3-plane kernel")
    print(f"per-block tier: {len(jobs)} planes of {len(planes)} 1080p 4:2:0 "
          "images, each == K1 / K3 on the same plane", flush=True)
    return counts


def k4_batch_phase(cuda, images_1080) -> float:
    """K4 over a batch vs its plain version (run on the card's tensors):
    the four 1080p corpus images at 4:2:0, unbroken (one row an image)
    and every 7 MCUs (8,160 % 7 != 0: intervals end at every image), with
    Annex-K tables and with each image's optimal tables. Max |error|."""
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    config = EncoderConfig()
    images = torch.from_numpy(np.stack(list(images_1080.values()))).to(cuda)
    geom = config.geometry(images.shape[2], images.shape[1])
    z, _ = pipeline.scan_entries(images, geom, config.dct_algorithm)
    worst = 0
    for restart in (None, 7):
        epi = (geom.num_scan_entries if restart is None
               else entropy_ops.entries_per_interval(geom, restart))
        hists = entropy_ops.symbol_histograms(z, geom, restart).cpu()
        luts = [pipeline.optimal_specs_and_luts(h.numpy(), cuda)[1]
                for h in hists]
        per_image = tuple(torch.stack([t[i] for t in luts]) for i in (0, 1))
        cap = pipeline.restart_default_capacity_bytes(geom, restart or 10**4)
        for tables in (None, per_image):
            args = dict(luts=tables, entries_per_interval=epi)
            got, bits = entropy_kernel.encode_entries(z, geom, cap, **args)
            want, want_bits = entropy_ops.encode_entries(z, geom, cap, **args)
            torch.cuda.synchronize()
            err = max(max_err(bits, want_bits.cpu()), max_err(got, want.cpu()))
            worst = max(worst, err)
            check(err == 0, f"K4 batch restart {restart} tables "
                  f"{'per image' if tables else 'Annex K'}: max |err| {err}")
        print(f"K4 batch of {len(hists)} 1080p images, restart {restart} "
              f"({bits.numel()} rows): kernel == plain (Annex K and per-image "
              "tables)", flush=True)
    return float(worst)


def band_operands(cuda, rgb: np.ndarray, config, bands: int):
    """rgb as `bands` MCU-row bands on the card, through the band path's
    own front (parallel/tiled.band_front): (the stack's entries, its
    (bands, 3) chained init_dc, the stack geometry, the image's live
    entries, entries a band, the per-band capacity)."""
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.parallel import tiled

    geom = config.geometry(rgb.shape[1], rgb.shape[0])
    band_rows = tiled._band_rows(geom, bands)
    z, lasts = tiled.band_front(rgb, config, geom, band_rows, 0, bands, cuda)
    init = tiled.chained(lasts)
    band_geom = tiled._band_geometry(geom, band_rows * 8 * geom.v_factor)
    stack_geom = tiled._band_geometry(geom, bands * band_geom.height)
    return (z, init, stack_geom, geom.num_scan_entries,
            tiled._band_entries(geom, band_rows),
            pipeline.default_capacity_bytes(band_geom))


def host_split(cuda, rgb: np.ndarray, config, bands: int | None):
    """Host ms of the unbroken encode's stages, each timed alone: the front
    (upload and scan entries; with bands, the band front with its stack and
    final_dc; ends in a sync), K4 with the fetch of its payload (the band
    rows), the host splice of the bands, the JFIF assembly. bands None
    splits encode_array, which has no splice."""
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.io import jfif
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.parallel import batch
    from jpeg_encoder_torch.utils.bits import splice_bitstreams

    geom = config.geometry(rgb.shape[1], rgb.shape[0])
    if bands is None:
        def front():
            out = pipeline.scan_entries(
                torch.tensor(rgb, device=cuda), geom, config.dct_algorithm,
                config.quality)[0]
            torch.cuda.synchronize()
            return out

        z, cap = front(), pipeline.default_capacity_bytes(geom)

        def code():
            payload, bits = entropy_kernel.encode_entries(z, geom, cap)
            bits = int(bits)
            return payload[: (bits + 7) // 8].cpu().numpy().tobytes()

        split = {"front": host_ms(front), "K4 + fetch": host_ms(code)}
        payload = code()
    else:
        def front():
            out = band_operands(cuda, rgb, config, bands)
            torch.cuda.synchronize()
            return out

        z, init, stack_geom, live, epi, cap = front()

        def code():
            return batch.fetch_chunk(*entropy_kernel.encode_entries(
                z, stack_geom, cap, init, live_entries=live,
                entries_per_interval=epi))

        payloads, bits = code()
        chunks = [(payloads[i], int(b)) for i, b in enumerate(bits)]
        split = {"front": host_ms(front), "K4 + fetch": host_ms(code),
                 "splice": host_ms(lambda: splice_bitstreams(chunks))}
        payload = splice_bitstreams(chunks)[0]
    split["JFIF"] = host_ms(lambda: jfif.assemble(geom, payload,
                                                  quality=config.quality))
    return split


def k4_band_phase(cuda, images_1080) -> float:
    """K4 with one init_dc vector a row (the band path's stack) vs its plain
    version run on the card's tensors: the four 1080p corpus images at
    4:2:0 as 4, 8 and 16 MCU-row bands (68 MCU rows: 17-row bands; 9-row
    bands, the last with 5 live rows; 5-row bands, band 13 with 3 live rows
    and two dead bands), at the per-band capacity and at 8 bytes a row,
    with Annex-K tables and with the stack's optimal tables. Max |error|."""
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    config = EncoderConfig()
    worst = 0
    for bands in (4, 8, 16):
        for name, rgb in images_1080.items():
            z, init, stack_geom, live, epi, cap = band_operands(
                cuda, rgb, config, bands)
            hist = entropy_ops.symbol_histograms(
                z, stack_geom, epi // stack_geom.blocks_per_mcu, init,
                live_entries=live)
            luts = pipeline.optimal_specs_and_luts(hist.cpu().numpy(),
                                                   cuda)[1]
            for tables, capacity in ((None, cap), (luts, cap), (None, 8)):
                args = dict(init_dc=init, luts=tables, live_entries=live,
                            entries_per_interval=epi)
                got, bits = entropy_kernel.encode_entries(
                    z, stack_geom, capacity, **args)
                want, want_bits = entropy_ops.encode_entries(
                    z, stack_geom, capacity, **args)
                torch.cuda.synchronize()
                err = max(max_err(bits, want_bits.cpu()),
                          max_err(got, want.cpu()))
                worst = max(worst, err)
                check(err == 0, f"K4 bands {bands} {name} tables "
                      f"{'optimal' if tables else 'Annex K'} capacity "
                      f"{capacity}: max |err| {err}")
        print(f"K4 per-row init_dc, 4 x 1080p 4:2:0 as {bands} bands "
              f"({bits.numel()} rows, live {live} of {z.shape[0]} entries): "
              "kernel == plain (Annex K, optimal tables, 8 B rows)",
              flush=True)
    return float(worst)


BATCH_PROGRAMS = ("batch", "batch_stats", "batch_custom")


def program_lines(cuda, label: str, names, card) -> list[str]:
    """A line for each cached program on cuda whose key is one of `names`
    (parallel/batch.program_keys): its geometry, image count and the
    rest of its key, capture ms, pool MB and replays."""
    from jpeg_encoder_torch import graphs

    lines = []
    for full, program in graphs.CACHE.programs(cuda):
        name, geom, *rest = full[2:]
        if name not in names:
            continue
        lines.append(
            f"{label} {name} {geom.width}x{geom.height} h{geom.h_factor}"
            f"v{geom.v_factor} {tuple(str(r).split('.')[-1] for r in rest)}"
            ": capture "
            f"{program.capture_ms:.1f} ms, pool "
            f"{program.pool_bytes / 2**20:.1f} MB, replays "
            f"{program.replays} ({card})")
    return lines


def batch_phase(cuda, images_1080, images_4k, card) -> dict[str, int]:
    """The batch path, driven (parallel.batch.encode_batch on the card): 32
    1080p and 12 4K images at 4:2:0 (chunks of 21 and 11, and of 5, 5 and
    2, at the default budget: each short last chunk a key of its own), 8
    at 4:2:2 and 8 at 4:4:4, binDCT, --fast-dct, restart 120 and 7,
    optimize alone and with restart 120, and a chunk with one member that
    overflows the shared capacity (retried alone). Each case three times,
    with different content (rolled frames): its keys' eager call, capture
    and replays (graphs.py; parallel/batch.program_keys). Every file ==
    the eager card path's (graphs.disabled()), the first content's ==
    the single-image card path's, a few == the CPU path's. Prints each
    batch program's capture ms, pool MB and replays; then, eager against
    replayed, encode_batch ms per image (numpy in, JFIF bytes out) and the
    chunk program's events ms and graph ms (dispatch_uploaded on resident
    frames: 21 and 11 1080p frames, 5 and 2 4K frames), and the device
    ms per image of a chunk by operation. Then the staged upload
    (staged_upload_checks). Returns the batch path's launch counts."""
    import dataclasses

    from jpeg_encoder_torch import graphs, pipeline
    from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.parallel import batch

    base = list(images_1080.values())
    hd = variants(base, 32)
    uhd = variants(list(images_4k.values()), 12)
    noise = np.random.default_rng(5).integers(0, 256, hd[0].shape, np.uint8)
    retry_images = np.stack([hd[0], noise, hd[1], hd[2]])
    default = EncoderConfig()
    optimize = EncoderConfig(optimize_huffman=True)
    cases = [
        ("32 x 1920x1080 4:2:0", hd, default),
        ("12 x 3840x2160 4:2:0", uhd, default),
        ("8 x 1920x1080 4:2:2", hd[:8], EncoderConfig(subsampling_ratio=(4, 2, 2))),
        ("8 x 1920x1080 4:4:4", hd[8:16], EncoderConfig(subsampling_ratio=(4, 4, 4))),
        ("8 x 1920x1080 bin-dct", hd[16:24],
         EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)),
        ("8 x 1920x1080 fast-dct", hd[24:], EncoderConfig(fast_dct=True)),
        ("8 x 1920x1080 restart 120", hd[:8], EncoderConfig(restart_interval=120)),
        ("4 x 1920x1080 restart 7", hd[8:12], EncoderConfig(restart_interval=7)),
        ("8 x 1920x1080 optimize", hd[12:20], optimize),
        ("8 x 1920x1080 optimize restart 120", hd[20:28],
         dataclasses.replace(optimize, restart_interval=120)),
        ("4 x 1920x1080 retry (0.125 B/px, one noise member)", retry_images,
         EncoderConfig(capacity_bytes_per_pixel=0.125)),
    ]

    def content(images, r):
        """The r-th content of a case: its frames rolled along the width."""
        return np.roll(images, 131 * r, axis=2) if r else images

    retried = []
    retry = batch._retry

    def spy(rgb, *args):
        retried.append(rgb)
        return retry(rgb, *args)

    batch._retry = spy
    results = []
    try:
        counts = counted("batch", lambda: results.extend(
            [batch.encode_batch(content(images, r), config, device=cuda)
             for r in range(3)] for _, images, config in cases),
            BATCH_KERNELS)
        check(len(retried) == 3 and all(
            np.array_equal(rgb, content(retry_images, r)[1])
            for r, rgb in enumerate(retried)),
              f"the retry case retried {len(retried)} members, not the "
              "noise one in each of 3 contents")
        with graphs.disabled():
            eager = [[batch.encode_batch(content(images, r), config,
                                         device=cuda) for r in range(3)]
                     for _, images, config in cases]
    finally:
        batch._retry = retry
    cpu_checked = ("32 x 1920x1080 4:2:0", "8 x 1920x1080 4:4:4",
                   "8 x 1920x1080 optimize restart 120")
    for (label, images, config), files, want in zip(cases, results, eager):
        geom = config.geometry(images.shape[2], images.shape[1])
        chunk = batch.chunk_size_images(geom)
        for r in range(3):
            for i, (got, w) in enumerate(zip(files[r], want[r])):
                check(got == w, f"batch {label} content {r} member {i}: "
                      "replayed != eager card")
        for i, (rgb, got) in enumerate(zip(images, files[0])):
            want_one = pipeline.encode_array(rgb, config,
                                             device=cuda).file_bytes
            check(got == want_one, f"batch {label} member {i}: != "
                  "encode_array on the card")
        note = ""
        if label in cpu_checked:
            want_cpu = pipeline.encode_array(images[1], config, device="cpu")
            check(files[0][1] == want_cpu.file_bytes,
                  f"batch {label} member 1: != the CPU path")
            note = "; member 1 == CPU path"
        print(f"batch {label}: {len(files[0])} files in "
              f"{-(-len(files[0]) // chunk)} chunks of <= {chunk}, 3 "
              "contents, each replayed == eager card, the first == "
              f"encode_array on the card{note} ({card})", flush=True)
    for line in program_lines(cuda, "batch program", BATCH_PROGRAMS, card):
        print(line, flush=True)
        check("replays 0" not in line, f"a batch program never replayed: "
              f"{line}")

    for label, images in (("1920x1080", hd), ("3840x2160", uhd)):
        geom = default.geometry(images.shape[2], images.shape[1])
        n = len(images)

        def call_batch():
            batch.encode_batch(images, default, device=cuda)

        def loop():
            for rgb in images:
                pipeline.encode_array(rgb, default, device=cuda)

        with graphs.disabled():
            batch_eager, loop_eager = (host_ms(call_batch, reps=3),
                                       host_ms(loop, reps=3))
        batch_ms, loop_ms = host_ms(call_batch, reps=3), host_ms(loop, reps=3)
        print(f"time batch {n} x {label} 4:2:0, numpy RGB in -> JFIF bytes "
              f"out, ms/image eager / replayed: encode_batch "
              f"{batch_eager / n:.3f} / {batch_ms / n:.3f}, loop of "
              f"encode_array {loop_eager / n:.3f} / {loop_ms / n:.3f} "
              f"({card})", flush=True)
        full = batch.chunk_size_images(geom)
        cap = batch.chunk_capacity_bytes(default, geom)
        for size in (full, n % full):
            rgb = timing.resident(images[:size], cuda)
            key = batch.program_keys(geom, default, cap, size)["batch"]

            def call():
                return batch.dispatch_uploaded(rgb, default, geom, cap)

            with graphs.disabled():
                eager_ms = (cuda_ms(call, reps=5),
                            timing.graph_ms(call, cuda, calls=2, reps=5))
            replayed = (cuda_ms(call, reps=5),
                        replay_ms(cuda, program_of(cuda, key), calls=2,
                                  reps=5))
            print(f"batch {size} x {label} 4:2:0 chunk program "
                  f"(dispatch_uploaded, resident frames), ms/image eager / "
                  f"replayed: events {eager_ms[0] / size:.4f} / "
                  f"{replayed[0] / size:.4f}, graph {eager_ms[1] / size:.4f}"
                  f" / {replayed[1] / size:.4f}; a chunk: events "
                  f"{eager_ms[0]:.4f} / {replayed[0]:.4f}, graph "
                  f"{eager_ms[1]:.4f} / {replayed[1]:.4f} ({card})",
                  flush=True)
        chunk = images[:full]
        z = batch.front_entries(timing.resident(chunk, cuda), default, geom)
        stages = {
            "dispatch_chunk": lambda: batch.dispatch_chunk(
                chunk, default, geom, cap, device=cuda),
            "K4 alone": lambda: entropy_kernel.encode_entries(
                z, geom, cap, entries_per_interval=geom.num_scan_entries),
        }
        per_image = (lambda ms: None if ms is None else ms / len(chunk))
        parts = ", ".join(
            f"{k} events {cuda_ms(f, reps=5) / len(chunk):.4f}, busy "
            f"{fmt(per_image(busy_ms(f, reps=5)))}"
            for k, f in stages.items())
        print(f"device ms/image, chunk of {len(chunk)} x {label} 4:2:0 "
              f"(replayed): {parts} ({card})", flush=True)
        with graphs.disabled():
            top = top_device_ops(stages["dispatch_chunk"])
        print(f"device ms/image by operation, eager dispatch_chunk "
              f"{len(chunk)} x {label}: " + "; ".join(
                  f"{name[:60]} {ms / len(chunk):.4f}" for name, ms in top)
              + f" ({card})", flush=True)
    staged_upload_checks(cuda, hd, card)
    return counts


def staged_upload_checks(cuda, hd, card) -> None:
    """The staged upload of in-memory arrays (pipeline.upload): files of
    encode_batch, encode_array and encode_tiled (4 bands) on views of
    1080p frames (rows reversed, an int64 copy) == the CPU path's; every
    piece of the main thread's upload ring pinned; a pageable host tensor
    handed to graphs.run refused, eagerly and at a replay. Prints the
    staged upload's GB/s (host clock to a device sync) beside the pageable
    copy it replaces (by events and by the host clock) and the pinned
    DMA, and encode_batch's ms a call of 8 x 1080p frames."""
    from jpeg_encoder_torch import graphs, pipeline
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.parallel import batch, tiled

    default = EncoderConfig()
    for label, views in (("rows reversed", hd[:2, ::-1]),
                         ("int64", hd[2:4].astype(np.int64))):
        want = [pipeline.encode_array(np.ascontiguousarray(
            rgb, dtype=np.uint8), default, device="cpu").file_bytes
            for rgb in views]
        for r in range(3):  # eager, capture, replay
            check(batch.encode_batch(views, default, device=cuda) == want,
                  f"staged encode_batch ({label}) != the CPU path")
            check([pipeline.encode_array(rgb, default, device=cuda)
                   .file_bytes for rgb in views] == want,
                  f"staged encode_array ({label}) != the CPU path")
            check(tiled.encode_tiled(views[0], default, 4, device=cuda)
                  .file_bytes == want[0],
                  f"staged encode_tiled ({label}) != the CPU path")
    ring = pipeline.UPLOADS.ring(cuda)
    check(all(p.is_pinned() for p in ring.pieces),
          "an upload ring piece is not pinned")
    key = ("chip_smoke", "pageable input")
    x = torch.zeros(4, device=cuda)
    for _ in range(2):  # the eager call, then the capture and a replay
        graphs.run(key, lambda x: x + 1, {"x": x}, cuda)
    refused = 0
    for eager in (False, True):
        try:
            with graphs.disabled() if eager else contextlib.nullcontext():
                graphs.run(key, lambda x: x + 1, {"x": torch.zeros(4)}, cuda)
        except ValueError:
            refused += 1
    check(refused == 2, f"graphs.run took a pageable input "
          f"({2 - refused} of 2 times: at a replay, eagerly)")
    arr = np.ascontiguousarray(hd[:8])
    dev = torch.empty(arr.shape, dtype=torch.uint8, device=cuda)

    def pageable():
        dev.copy_(torch.from_numpy(arr))
        torch.cuda.synchronize()

    def staged():
        pipeline.upload(arr, cuda)
        torch.cuda.synchronize()

    flat = torch.from_numpy(arr).view(-1)
    step = ring.pieces[0].numel()

    def fills():
        for start in range(0, flat.numel(), step):
            part = flat[start : start + step]
            ring.fill(ring.pieces[0][: part.numel()], part)

    gb = arr.nbytes / 1e6
    pinned_gb, pageable_gb = h2d_rates(cuda, arr.shape)
    staged_ms, pageable_ms = host_ms(staged, 20), host_ms(pageable, 20)
    fill_ms = host_ms(fills, 20)
    print(f"staged upload of 8 x 1920x1080 frames ({arr.nbytes / 1e6:.1f} "
          f"MB, {len(ring.pieces)} pinned pieces of {step >> 20} MiB, host "
          f"clock): {gb / staged_ms:.2f} GB/s ({staged_ms:.4f} ms) vs the "
          f"pageable copy it replaces {gb / pageable_ms:.2f} GB/s "
          f"({pageable_ms:.4f} ms; by events {pageable_gb:.2f}); the host's "
          f"fill of the pieces alone {gb / fill_ms:.2f} GB/s "
          f"({torch.get_num_threads()} torch threads), pinned DMA alone "
          f"{pinned_gb:.2f} GB/s ({card})", flush=True)
    call_ms = host_ms(lambda: batch.encode_batch(arr, default, device=cuda),
                      20)
    print(f"encode_batch 8 x 1920x1080 4:2:0, numpy RGB in -> JFIF bytes "
          f"out: {call_ms:.4f} ms a call ({card})", flush=True)


def h2d_rates(cuda, shape) -> tuple[float, float]:
    """GB/s of one host-to-device copy of a (B, H, W, 3) uint8 chunk from
    pinned memory on a side stream (the stream engine's upload) and from
    pageable memory (encode_batch's), by CUDA events, median of 5."""
    host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    pageable = np.zeros(shape, np.uint8)
    dev = torch.empty(shape, dtype=torch.uint8, device=cuda)
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        pinned_ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True),
                            reps=5)
    pageable_ms = cuda_ms(lambda: dev.copy_(torch.from_numpy(pageable)),
                          reps=5)
    return (host.numel() / pinned_ms / 1e6, host.numel() / pageable_ms / 1e6)


# A background load's kernels (card_load's cuBLAS matmuls) carry this in
# their names; no kernel of the port does.
LOAD_KERNEL = "gemm"


def trace_overlap(trace_path: str, load: str = LOAD_KERNEL) -> dict:
    """From a torch.profiler chrome trace: the names of the host-to-device
    copies ("copies"), how many of them overlap a kernel in time
    ("overlapping", "overlap_us"), how many kernels ran ("kernels"), the
    streams the copies and the kernels ran on ("copy_streams",
    "kernel_streams"). Kernels whose names hold `load` (card_load's) are
    counted apart ("load_kernels") and left out of the rest."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    every = [e for e in events if e.get("cat") == "kernel"]
    path = [e for e in every if load not in e.get("name", "").lower()]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in path)
    overlapping, overlap_us = 0, 0.0
    for c in copies:
        a, b = c["ts"], c["ts"] + c["dur"]
        shared = sum(max(0.0, min(b, k1) - max(a, k0)) for k0, k1 in spans)
        overlapping += shared > 0
        overlap_us += shared
    return {"copies": [c["name"] for c in copies],
            "overlapping": overlapping, "overlap_us": overlap_us,
            "kernels": len(path), "load_kernels": len(every) - len(path),
            "copy_streams": {c.get("args", {}).get("stream") for c in copies},
            "kernel_streams": {e.get("args", {}).get("stream")
                               for e in path}}


@contextlib.contextmanager
def card_load(cuda, seconds: float = 60.0):
    """Keep the card's SMs busy while the block runs: a thread of its own
    runs 4096 x 4096 fp32 matmuls (cuBLAS, kernels named *gemm*, ~2 ms
    each) on a stream of its own, two in flight, until the block ends or
    `seconds` pass. A folder's chunk then takes longer on the card than
    the loader takes to read the next chunk's first file, as on a card
    that other work shares, so that the next chunk's copies start while
    its kernels run."""
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        a = torch.randn(4096, 4096, device=cuda)
        b = torch.mm(a, a)  # cuBLAS's set-up, before the block
    side.synchronize()
    stop = threading.Event()

    def run():
        end = time.monotonic() + seconds
        pending = [None, None]
        with torch.cuda.device(cuda), torch.cuda.stream(side):
            turn = 0
            while not stop.is_set() and time.monotonic() < end:
                torch.mm(a, a, out=b)
                done = torch.cuda.Event()
                done.record(side)
                if pending[turn] is not None:
                    pending[turn].synchronize()
                pending[turn], turn = done, 1 - turn
        side.synchronize()

    thread = threading.Thread(target=run, name="card-load")
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()


def stream_phase(cuda, images_1080, images_4k, card, tmp) -> dict[str, int]:
    """The stream engine, driven (parallel.stream.encode_paths on the card,
    BMP files in, JFIF files written by emit): 64 1080p frames (three
    chunks of <= 21 at the 128 MiB budget), 15 4K frames (three chunks
    of 5) and 45 1366x768 frames (rows of 4,098 bytes padded to 4,100;
    chunks of 42 and 3) at 4:2:0, corpus content, in one call (three
    dimension groups). Every file == encode_batch's on the card; every
    slot of the loader's pinned ring (one a group, each (chunk, H *
    row_stride(W)) bytes) is pinned; every emit ran on one thread, not
    the caller's; that run starts from an empty program cache and must
    evict none of the programs it captures (each chunk's device work is
    parallel/batch's "bmp-rows" program, replayed from a key's third
    call). 8 of the 1080p files also under restart 120, optimize, and
    optimize with restart 120, each == the single-image card file. Then
    the 64 1080p files with an emitter that sleeps 50 ms a file for the
    first two chunks, so that the main thread replays the key for later
    chunks (and, with optimize, the loader the statistics) while the
    assembler holds one: under default and optimize, twice each, every
    file == the eager card path's (graphs.disabled()). Then ms/image,
    files/s and the last pass's Mpixel/s of the stream, replayed and
    eager, against a synchronous loop (read_batch -> encode_batch ->
    write, chunk by chunk) over the same files, the loader's read and the
    assembler's and emitter's busy seconds, the host read of a chunk
    (read_batch, read_into and the stream's bmp.read into a pinned slot,
    an image a thread), the pinned and pageable H2D rates, and, under the
    profiler, two replayed runs of the 1080p files, alone and under
    card_load: in each, every host-to-device copy is a pinned copy on a
    stream that no kernel of the run ran on; under load, at least one
    overlaps a kernel (of another chunk: a chunk's own kernels wait on its
    copies). Returns the stream path's launch counts."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from jpeg_encoder_torch import graphs, pipeline
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.io import bmp
    from jpeg_encoder_torch.parallel import batch, stream
    from jpeg_encoder_torch.utils import corpus

    default = EncoderConfig()
    out_dir = os.path.join(tmp, "out")
    os.makedirs(out_dir)
    sets = {}
    images_768 = [corpus.CORPUS[name](768, 1366)
                  for name in ("landscape", "portrait", "foliage")]
    for label, images in (
            ("1920x1080", variants(list(images_1080.values()), 64)),
            ("3840x2160", variants(list(images_4k.values()), 15)),
            ("1366x768", variants(images_768, 45))):
        paths = []
        for i, rgb in enumerate(images):
            paths.append(os.path.join(tmp, f"{label}_{i:02d}.bmp"))
            bmp.write(paths[-1], rgb)
        sets[label] = (images, paths)

    def writing(written: dict, emitters: set | None = None):
        def emit(path, data):
            dst = os.path.join(out_dir, os.path.basename(path)[:-4] + ".jpg")
            with open(dst, "wb") as f:
                f.write(data)
            written[path] = dst
            if emitters is not None:
                emitters.add(threading.get_ident())
        return emit

    rings = []

    class Ring(stream._PinnedRing):
        """The loader's ring, kept for the pinned check."""

        def __init__(self, *args):
            super().__init__(*args)
            rings.append(self)

    written, runs, emitters = {}, [], set()
    every = [p for _, paths in sets.values() for p in paths]
    # An empty cache, so that an eviction in this run is one of the run's
    # own programs.
    graphs.CACHE.clear()
    evictions = graphs.CACHE.evictions
    ring = stream._PinnedRing
    stream._PinnedRing = Ring
    try:
        counts = counted("stream", lambda: runs.append(stream.encode_paths(
            every, default, writing(written, emitters), device=cuda)),
            MAIN_KERNELS)
    finally:
        stream._PinnedRing = ring
    check(runs[0].encoded == len(every), f"stream encoded {runs[0].encoded}")
    check(len(rings) == len(sets) and all(
        slot.is_pinned() for r in rings for slot in r.slots),
        f"stream: {len(rings)} rings for {len(sets)} groups, or a slot "
        "not pinned")
    for r, (label, (images, _)) in zip(rings, sets.items()):
        height, width = images.shape[1:3]
        shape = (batch.chunk_size_images(default.geometry(width, height)),
                 height * bmp.row_stride(width))
        check(all(tuple(slot.shape) == shape for slot in r.slots),
              f"stream {label}: ring slots {r.slots[0].shape}, not {shape}")
    check(len(emitters) == 1 and threading.get_ident() not in emitters,
          f"stream: emit ran on {len(emitters)} threads (the caller's "
          f"among them: {threading.get_ident() in emitters})")
    print(f"stream {len(every)} files in {len(sets)} groups: every ring slot "
          f"pinned ({sum(len(r.slots) for r in rings)} slots of (chunk, H * "
          f"row_stride(W)) bytes), every emit on one thread, not the "
          f"caller's ({card})", flush=True)
    held = graphs.CACHE.programs(cuda)
    check(graphs.CACHE.evictions == evictions,
          f"stream: the default run evicted "
          f"{graphs.CACHE.evictions - evictions} of its own programs")
    print(f"stream default run: {len(held)} programs captured, "
          f"{sum(p.pool_bytes for _, p in held) / 2**20:.1f} MB of pools "
          f"(bound {graphs.max_pool_bytes(cuda) / 2**20:.0f} MB), none "
          f"evicted ({card})", flush=True)
    check(all(p.replays for _, p in held), "stream: a program of the "
          "default run was never replayed")
    del held  # an evicted program's pool is freed once nothing holds it
    for label, (images, paths) in sets.items():
        geom = default.geometry(images.shape[2], images.shape[1])
        want = batch.encode_batch(images, default, device=cuda)
        for i, (path, w) in enumerate(zip(paths, want)):
            with open(written[path], "rb") as f:
                check(f.read() == w, f"stream {label} file {i} != "
                      "encode_batch on the card")
        chunks = -(-len(paths) // batch.chunk_size_images(geom))
        print(f"stream {len(paths)} x {label} 4:2:0 ({chunks} chunks): every "
              "written file == encode_batch on the card", flush=True)
    optimize = EncoderConfig(optimize_huffman=True)
    hd, hd_paths = sets["1920x1080"][0][:8], sets["1920x1080"][1][:8]
    for name, config in (
            ("restart 120", EncoderConfig(restart_interval=120)),
            ("optimize", optimize),
            ("optimize restart 120",
             dataclasses.replace(optimize, restart_interval=120))):
        got = {}
        stream.encode_paths(hd_paths, config, got.__setitem__, device=cuda)
        for i, (path, rgb) in enumerate(zip(hd_paths, hd)):
            want = pipeline.encode_array(rgb, config, device=cuda).file_bytes
            check(got[path] == want, f"stream {name} file {i} != encode_array "
                  "on the card")
        print(f"stream 8 x 1920x1080 4:2:0 {name}: every file == encode_array "
              "on the card", flush=True)

    # A slow emitter: the main thread replays the key for the next chunks
    # (and, with optimize, the loader the statistics) while the assembler
    # and the emitter still hold chunks, so each leg must have cloned what
    # another thread reads.
    paths = sets["1920x1080"][1]
    slow = 2 * batch.chunk_size_images(default.geometry(1920, 1080))
    for name, config in (("default", default), ("optimize", optimize)):
        with graphs.disabled():
            want = {}
            stream.encode_paths(paths, config, want.__setitem__, device=cuda)
        for run in range(2):
            got = {}

            def emit(path, data):
                if len(got) < slow:
                    time.sleep(0.05)
                got[path] = data

            stream.encode_paths(paths, config, emit, device=cuda)
            check(got == want, f"stream {name} with a slow emitter (run "
                  f"{run}): != the eager card path")
        print(f"stream {len(paths)} x 1920x1080 4:2:0 {name}, the emitter "
              f"sleeping 50 ms a file for the first {slow} files, two runs: "
              "every file == the eager card path", flush=True)

    for label, (images, paths) in sets.items():
        geom = default.geometry(images.shape[2], images.shape[1])
        chunk = batch.chunk_size_images(geom)
        n = len(paths)
        emit = writing({})
        stream_runs = []

        def run_stream():
            stream_runs.append(stream.encode_paths(paths, default, emit,
                                                   device=cuda))

        def run_loop():
            for start in range(0, n, chunk):
                part = paths[start:start + chunk]
                files = batch.encode_batch(bmp.read_batch(part), default,
                                           device=cuda)
                for path, data in zip(part, files):
                    emit(path, data)

        def run_eager():
            with graphs.disabled():
                run_stream()

        # Turns: stream, eager, loop, loop, eager, stream; each the mean of
        # two medians.
        s1, e1, l1, l2, e2, s2 = (host_ms(f, reps=3) for f in (
            run_stream, run_eager, run_loop, run_loop, run_eager,
            run_stream))
        stream_ms, loop_ms = (s1 + s2) / 2 / n, (l1 + l2) / 2 / n
        eager_ms = (e1 + e2) / 2 / n
        last = stream_runs[-1]
        pinned, pageable = h2d_rates(cuda, (chunk, geom.height, geom.width, 3))
        part = paths[:chunk]
        host = np.empty((len(part), geom.height, geom.width, 3), np.uint8)
        slot = torch.empty((len(part), geom.height * bmp.row_stride(
            geom.width)), dtype=torch.uint8, pin_memory=True)
        read = host_ms(lambda: bmp.read_batch(part), reps=3) / len(part)
        threads = len(os.sched_getaffinity(0))
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            pooled = host_ms(lambda: list(pool.map(
                bmp.read_into, part, host)), reps=3) / len(part)
            staged = host_ms(lambda: list(pool.map(
                lambda p, out: bmp.read(p, out=out), part, slot)),
                reps=3) / len(part)
        print(f"time host BMP input {len(part)} x {label}: read_batch "
              f"(serial reads, threaded decode; the loop's) {read:.3f} "
              f"ms/image, an image a thread of {threads}: read_into (read "
              f"and host decode) {pooled:.3f} ms/image, bmp.read of the "
              f"stored rows into a pinned slot (the stream's) {staged:.3f} "
              f"ms/image ({card})", flush=True)
        print(f"time stream {n} x {label} 4:2:0 BMP files -> JFIF files: "
              f"encode_paths {stream_ms:.3f} ms/image ({1e3 / stream_ms:.1f} "
              f"files/s; last pass "
              f"{n * geom.width * geom.height / last.seconds / 1e6:.1f} "
              f"Mpixel/s: decode_s {last.decode_seconds:.4f} s, "
              f"assemble_seconds {last.assemble_seconds:.4f} s, "
              f"emit_seconds {last.emit_seconds:.4f} s, write "
              f"{last.write_seconds:.4f} s of {last.seconds:.4f} s), eager "
              f"(graphs.disabled()) {eager_ms:.3f} ms/image, "
              f"synchronous loop read_batch -> encode_batch -> write "
              f"{loop_ms:.3f} ms/image ({1e3 / loop_ms:.1f} files/s); H2D of "
              f"a {chunk}-image chunk: pinned {pinned:.2f} GB/s, pageable "
              f"{pageable:.2f} GB/s ({card})", flush=True)

    paths = sets["1920x1080"][1]
    trace = os.path.join(tmp, "stream_trace.json")

    def profiled(load: bool) -> dict:
        """A replayed stream run of the 1080p files under the profiler
        (with card_load around it where `load`): trace_overlap's dict."""
        for _ in range(3):  # an empty trace is retried, as in busy_ms
            with (card_load(cuda) if load else contextlib.nullcontext()), \
                    profile(activities=[ProfilerActivity.CUDA]) as prof:
                stream.encode_paths(paths, default, writing({}), device=cuda)
            prof.export_chrome_trace(trace)
            seen = trace_overlap(trace)
            if seen["copies"] and seen["kernels"]:
                break
        shared = seen["copy_streams"] & seen["kernel_streams"]
        check(not shared, f"stream{' under load' if load else ''}: "
              f"host-to-device copies ran on the kernels' stream(s) {shared}")
        return seen

    # Alone, a 21-image chunk's kernels (~2 ms) may end before the loader
    # has read the next chunk's first file, so that no copy overlaps one;
    # under card_load they run longer than that read, and a copy that no
    # stream orders behind the chunk before it must overlap its kernels.
    alone, loaded = profiled(False), profiled(True)
    for seen in (alone, loaded):
        pageable_copies = [n for n in seen["copies"] if "Pinned" not in n]
        check(seen["copies"] and not pageable_copies,
              f"stream: host-to-device copies not from pinned memory: "
              f"{sorted(set(pageable_copies))} ({len(seen['copies'])} "
              "copies)")
    check(loaded["load_kernels"] > 0, "stream under load: no kernel of "
          f"card_load ran (no kernel named *{LOAD_KERNEL}*)")
    check(loaded["overlapping"] > 0,
          f"stream under load: none of {len(loaded['copies'])} "
          f"host-to-device copies overlapped any of {loaded['kernels']} "
          f"kernels of the replayed run")
    for label, seen in (("alone", alone), ("under card_load", loaded)):
        print(f"stream profile, {len(paths)} x 1920x1080, replayed, "
              f"{label}: {len(seen['copies'])} host-to-device copies, "
              f"all pinned ({sorted(set(seen['copies']))}), on stream(s) "
              f"{sorted(seen['copy_streams'], key=str)}, the kernels on "
              f"{sorted(seen['kernel_streams'], key=str)}; "
              f"{seen['overlapping']} overlap a kernel of another chunk, "
              f"{seen['overlap_us']:.0f} us in all, of {seen['kernels']} "
              f"kernels ({seen['load_kernels']} load kernels left out) "
              f"({card})", flush=True)
    for line in program_lines(cuda, "stream program", BATCH_PROGRAMS, card):
        print(line, flush=True)
    return counts


def tiled_phase(cuda, images_1080, images_4k, card) -> dict[str, int]:
    """The band path, driven (parallel.tiled.encode_tiled on the card): 1080p
    4:2:0 corpus frames at 2, 3, 4 and 8 bands, 4K at 4 and 8 (135 MCU
    rows), a 7680x4320 corpus frame at 8; at 4 bands 4:2:2, 4:4:4, binDCT
    with descale, --fast-dct, restart 120 and 7 (21-row bands: 17 rows of
    120 MCUs are not whole intervals of 7), optimize alone and with restart
    120, a gradient whose band 1 is noise at 0.04 B/px (only band 1 may
    retry), and 1921x1089, the quirk geometry (falls back, with its
    warning). Every file == encode_array on the card; three also == the
    CPU path. Then encode_tiled at 4 and 8 bands against encode_array
    (host ms, device-busy ms) at 1080p and 4K, and K4's busy time with one
    init_dc a row against the (3,) form on the same entries. Returns the
    path's launch counts."""
    import dataclasses
    import warnings

    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.parallel import tiled
    from jpeg_encoder_torch.utils import corpus

    hd, uhd = list(images_1080.values()), list(images_4k.values())
    default = EncoderConfig()
    optimize = EncoderConfig(optimize_huffman=True)
    retry_rgb = np.broadcast_to(
        np.linspace(0, 255, 1920)[None, :, None], (1080, 1920, 3)
    ).astype(np.uint8).copy()
    retry_rgb[272:544] = np.random.default_rng(8).integers(
        0, 256, (272, 1920, 3), np.uint8)
    quirk = np.random.default_rng(9).integers(0, 256, (1089, 1921, 3),
                                              np.uint8)
    check(tiled._aligned_band_rows(default.geometry(1920, 1080), 4, 7) == 21,
          "restart 7 at 1080p in 4 bands: the aligned split is not 21 rows")
    # (label, rgb, config, bands, also against the CPU path)
    cases = [(f"1920x1080 4:2:0 {b} bands", hd[i], default, b, b == 4)
             for i, b in enumerate((2, 3, 4, 8))]
    cases += [(f"3840x2160 4:2:0 {b} bands", uhd[i], default, b, False)
              for i, b in enumerate((4, 8))]
    cases += [
        ("7680x4320 4:2:0 8 bands", corpus.landscape(4320, 7680), default, 8,
         False),
        ("1920x1080 4:2:2 4 bands", hd[0],
         EncoderConfig(subsampling_ratio=(4, 2, 2)), 4, False),
        ("1920x1080 4:4:4 4 bands", hd[1],
         EncoderConfig(subsampling_ratio=(4, 4, 4)), 4, False),
        ("1920x1080 bin-dct descale 4 bands", hd[2],
         EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT,
                       bin_dct_descale=True), 4, False),
        ("1920x1080 fast-dct 4 bands", hd[3], EncoderConfig(fast_dct=True), 4,
         False),
        ("1920x1080 restart 120 4 bands", hd[0],
         EncoderConfig(restart_interval=120), 4, False),
        ("1920x1080 restart 7 4 bands", hd[1],
         EncoderConfig(restart_interval=7), 4, True),
        ("1920x1080 optimize 4 bands", hd[2], optimize, 4, False),
        ("1920x1080 optimize restart 120 4 bands", hd[3],
         dataclasses.replace(optimize, restart_interval=120), 4, True),
        ("1920x1080 retry (noise band 1, 0.04 B/px) 4 bands", retry_rgb,
         EncoderConfig(capacity_bytes_per_pixel=0.04), 4, False),
        ("1921x1089 4:2:0 (quirk geometry) 4 bands", quirk, default, 4,
         False),
    ]
    retried, results, warned = [], [], []
    retry = tiled._retry_band

    def spy(z, geom, band_rows, idx, *args):
        retried.append(idx)
        return retry(z, geom, band_rows, idx, *args)

    def drive():
        for label, rgb, config, bands, _ in cases:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                results.append(tiled.encode_tiled(rgb, config, bands,
                                                  device=cuda))
            warned.extend(label for w in caught
                          if issubclass(w.category, RuntimeWarning))

    tiled._retry_band = spy
    try:
        counts = counted("tiled", drive, BATCH_KERNELS)
    finally:
        tiled._retry_band = retry
    check(retried == [1], f"the retry case retried bands {retried}, not [1]")
    check(warned == [cases[-1][0]], f"RuntimeWarnings from {warned}")
    for (label, rgb, config, bands, cpu), got in zip(cases, results):
        want = pipeline.encode_array(rgb, config, device=cuda)
        check(got.file_bytes == want.file_bytes,
              f"tiled {label}: != encode_array on the card")
        check(got.bit_length == want.bit_length,
              f"tiled {label}: bit length != encode_array's")
        note = ""
        if cpu:
            cpu_file = tiled.encode_tiled(rgb, config, bands, device="cpu")
            check(got.file_bytes == cpu_file.file_bytes,
                  f"tiled {label}: card != CPU path")
            note = " == CPU path"
        print(f"tiled {label}: {len(got.file_bytes)} B == encode_array on "
              f"the card{note}", flush=True)
    print("tiled retry: only band 1 re-coded; quirk geometry: one-piece "
          "encode with its RuntimeWarning", flush=True)

    for label, rgb in (("1920x1080", hd[0]), ("3840x2160", uhd[0])):
        parts, ops = [], []
        for bands in (None, 4, 8):
            if bands is None:
                name = "encode_array"
                run = lambda: pipeline.encode_array(rgb, default, device=cuda)
            else:
                name = f"{bands} bands"
                run = lambda: tiled.encode_tiled(rgb, default, bands,
                                                 device=cuda)
            split = host_split(cuda, rgb, default, bands)
            parts.append(
                f"{name} host {host_ms(run):.3f} ms (alone: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in split.items())
                + f"), busy {fmt(busy_ms(run, reps=5))} ms")
            ops.append(f"{name}: " + ", ".join(
                f"{op} {ms:.4f}" for op, ms in top_device_ops(run)))
        print(f"time tiled {label} 4:2:0: " + "; ".join(parts)
              + f" ({card})", flush=True)
        print(f"tiled {label} 4:2:0 top device ops, ms a call: "
              + "; ".join(ops) + f" ({card})", flush=True)

    z, init, stack_geom, live, epi, cap = band_operands(cuda, hd[0], default,
                                                        4)
    zeros = torch.zeros(3, dtype=torch.int32, device=cuda)
    per_row = lambda: entropy_kernel.encode_entries(
        z, stack_geom, cap, init, live_entries=live, entries_per_interval=epi)
    one_row = lambda: entropy_kernel.encode_entries(
        z, stack_geom, 4 * cap, zeros, live_entries=live)
    for _ in range(3):  # an empty trace is retried, as in busy_ms
        ops = device_ops(per_row)
        count = sum(c for _, c, _ in ops)
        if count:
            break
    check(0 < count <= 2, "one K4 call with per-row init_dc ran other than "
          f"the memset and one kernel: {ops}")
    row_busy, one_busy = busy_ms(per_row), busy_ms(one_row)
    print(f"time K4 1920x1080 4:2:0 as 4 bands ({z.shape[0]} entries): "
          f"per-row init_dc (4 rows of {cap} B) device-busy {fmt(row_busy)} "
          f"ms, events {cuda_ms(per_row):.4f} ms; (3,) init_dc (one row of "
          f"{4 * cap} B) device-busy {fmt(one_busy)} ms, events "
          f"{cuda_ms(one_row):.4f} ms; device operations a per-row call "
          f"{count:g} ({card})", flush=True)
    return counts


CLI_LAUNCHER = """
import time
started = time.time()
import json, runpy, sys
import torch
torch_imported = time.time()
from jpeg_encoder_torch.kernels import dct, entropy, front, pack
imported = time.time()
try:
    runpy.run_module("jpeg_encoder_torch.cli", run_name="__main__")
finally:
    kernels = (front.FRONT, dct.REALDCT, entropy.ENTROPY, dct.BINDCT,
               dct.FASTDCT, pack.PACK, dct.REALDCT_BLOCKS, dct.BINDCT_BLOCKS)
    print("LAUNCHES " + json.dumps({k.name: k.launches for k in kernels}),
          file=sys.stderr)
    print("TIMES " + json.dumps({"started": started, "torch": torch_imported,
                                 "imported": imported}), file=sys.stderr)
"""


def run_cli(runs: list[list[str]], launches: dict | None = None,
            counting: bool = True) -> list[tuple[int, str, str, float]]:
    """Run the CLI once per argument list, all at once, in processes of
    their own (the module run as __main__, as `python -m` runs it; with
    counting, through CLI_LAUNCHER, which reports the process's kernel
    launches, added into `launches`, and the wall-clock times at which its
    interpreter started and had imported torch and the kernel wrappers).
    -> [(exit code, stdout, stderr, wall-clock time of the Popen)]."""
    head = ([sys.executable, "-c", CLI_LAUNCHER] if counting
            else [sys.executable, "-m", "jpeg_encoder_torch.cli"])
    procs, popened = [], []
    for args in runs:
        popened.append(time.time())
        procs.append(subprocess.Popen(head + args, cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p, t in zip(procs, popened):
            stdout, stderr = p.communicate(timeout=300)
            out.append((p.returncode, stdout, stderr, t))
    finally:
        for p in procs:
            p.kill()
    for _, _, stderr, _ in out:
        for line in stderr.splitlines():
            if line.startswith("LAUNCHES ") and launches is not None:
                for name, n in json.loads(line[9:]).items():
                    launches[name] = launches.get(name, 0) + n
    return out


def cli_phase(cuda, images_1080, images_4k, card, tmp) -> dict[str, int]:
    """The CLI, driven in processes of its own on 8 1080p corpus BMP files:
    one image with the default flags, one with -s 4:4:4 -d bin-dct, one with
    --tile-bands --devices 4, a glob of the 8 (all four at once); then on
    a folder of 256 1080p (64 distinct) and 15 4K corpus frames, 4:2:0,
    --dataset in one process; in two gloo processes on the one card; again
    with every file skipped on resume. Every file == encode_array's on the
    card. Then the error probes' exit codes (non-.bmp, a bad ratio,
    --tile-bands with a glob: 2). Returns the launches the CLI processes
    reported. Prints, for each dataset process, its start-up (from the
    Popen to the interpreter's start, to its imports, to its first file
    written) apart from its steady rate (files and megapixels a second over
    the files written after the first quarter, by the files' modification
    times, which the kernel keeps to a few milliseconds)."""
    import socket

    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_torch.io import bmp

    src, out = os.path.join(tmp, "src"), os.path.join(tmp, "out")
    data = os.path.join(tmp, "data")
    os.makedirs(src)
    os.makedirs(data)
    images = variants(list(images_1080.values()), 8)
    paths = [os.path.join(src, f"frame{i}.bmp") for i in range(len(images))]
    for path, rgb in zip(paths, images):
        bmp.write(path, rgb)
    # The dataset: 256 1080p files (64 distinct frames, each file written
    # once and linked three more times, to bound the disk) and 15 4K.
    data_images = {}
    for label, frames, links in (
            ("1920x1080", variants(list(images_1080.values()), 64), 4),
            ("3840x2160", variants(list(images_4k.values()), 15), 1)):
        for i, rgb in enumerate(frames):
            first = os.path.join(data, f"{label}_{i:03d}.bmp")
            bmp.write(first, rgb)
            for k in range(links):
                j = i + k * len(frames)
                data_images[f"{label}_{j:03d}"] = rgb
                if k:
                    os.link(first, os.path.join(data, f"{label}_{j:03d}.bmp"))
    names = sorted(data_images)
    default = EncoderConfig()
    glob = os.path.join(src, "*.bmp")
    port = lambda: socket.create_server(("localhost", 0))

    def dataset(dst, count):
        with port() as s:
            address = f"localhost:{s.getsockname()[1]}"
        extra = (lambda i: ["--coordinator", address, "--num-processes",
                            str(count), "--process-id", str(i)])
        return [["--dataset", data, "-o", dst, "--timing"]
                + (extra(i) if count > 1 else []) for i in range(count)]

    stages = [
        ("single", [["-i", paths[0], "-o", os.path.join(out, "single.jpeg")],
                    ["-i", paths[1], "-o", os.path.join(out, "b444.jpeg"),
                     "-s", "4:4:4", "-d", "bin-dct"],
                    ["-i", paths[2], "-o", os.path.join(out, "tiled.jpeg"),
                     "--tile-bands", "--devices", "4"],
                    ["-i", glob, "-o", os.path.join(out, "glob"),
                     "--timing"]]),
        ("dataset 1", dataset(os.path.join(out, "ds1"), 1)),
        ("dataset 2", dataset(os.path.join(out, "ds2"), 2)),
        ("dataset 2 resume", dataset(os.path.join(out, "ds2"), 2)),
    ]
    os.makedirs(out)
    results = {}

    def drive():
        launches = {}
        for name, runs in stages:
            results[name] = run_cli(runs, launches)
        return launches

    counts = counted("cli", drive, ("front", "realdct", "entropy", "bindct"))
    for name, runs in results.items():
        for args, (code, stdout, stderr, _) in zip(
                dict(stages)[name], runs):
            check(code == 0, f"cli {name} {args}: exit {code}\n{stderr}")

    def want(rgb, config=default):
        return pipeline.encode_array(rgb, config, device=cuda).file_bytes

    def read(*parts):
        with open(os.path.join(out, *parts), "rb") as f:
            return f.read()

    check(read("single.jpeg") == want(images[0]),
          "cli single image != encode_array")
    check(read("b444.jpeg") == want(images[1], EncoderConfig(
        subsampling_ratio=(4, 4, 4), dct_algorithm=DctAlgorithm.BIN_DCT)),
        "cli -s 4:4:4 -d bin-dct != encode_array")
    check(read("tiled.jpeg") == want(images[2]),
          "cli --tile-bands != encode_array")
    for i, rgb in enumerate(images):
        check(read("glob", f"frame{i}.jpeg") == want(rgb),
              f"cli glob frame{i} != encode_array")
    for name in names:
        w = want(data_images[name])
        for folder in ("ds1", "ds2"):
            check(read(folder, f"{name}.jpeg") == w,
                  f"cli --dataset {folder} {name} != encode_array")
    lines = {name: [json.loads(o.strip().splitlines()[-1])
                    for _, o, _, _ in r]
             for name, r in results.items() if name.startswith("dataset")}
    shares = [len(names[r::2]) for r in range(2)]
    check([(l["encoded"], l["skipped"]) for l in lines["dataset 2"]]
          == [(n, 0) for n in shares] and all(
              l["summary"]["encoded"] == len(names)
              for l in lines["dataset 2"]),
          f"two-process dataset: {lines['dataset 2']}")
    check([(l["encoded"], l["skipped"]) for l in lines["dataset 2 resume"]]
          == [(0, n) for n in shares], f"resume: {lines['dataset 2 resume']}")
    probes = run_cli([["-i", os.path.join(src, "x.png")],
                      ["-i", paths[0], "-s", "4:1:1"],
                      ["-i", glob, "--tile-bands"]], counting=False)
    check([code for code, _, _, _ in probes] == [2, 2, 2],
          f"cli error probes exit {[code for code, _, _, _ in probes]}, "
          "not [2, 2, 2]")
    print(f"cli: single image, -s 4:4:4 -d bin-dct, --tile-bands --devices "
          f"4, a glob of 8, --dataset of {len(names)} files in one and in two "
          "gloo processes: every file == encode_array on the card; the "
          f"resumed run skipped all {len(names)}; error probes exit 2",
          flush=True)

    def process_times(stage, folder, count):
        """Per process of a dataset run: seconds from its Popen to its
        interpreter's start, its import of torch, of the kernel wrappers
        and its first file written; (modification time, pixels) of each of
        its files, in the order written; the CLI's own seconds."""
        rows = []
        for rank, (_, stdout, stderr, popened) in enumerate(results[stage]):
            t = json.loads(next(line[6:] for line in stderr.splitlines()
                                if line.startswith("TIMES ")))
            written = sorted(
                (os.stat(os.path.join(out, folder, f"{n}.jpeg")).st_mtime,
                 data_images[n].shape[0] * data_images[n].shape[1])
                for n in names[rank::count])
            rows.append(dict(
                interpreter=t["started"] - popened,
                torch=t["torch"] - popened, imports=t["imported"] - popened,
                first=written[0][0] - popened, written=written,
                cli_seconds=json.loads(stdout.strip().splitlines()[-1])
                ["seconds"]))
        return rows

    def steady(rows):
        """Files and megapixels a second over the files written after the
        first quarter (the loader runs up to two chunks ahead of the first
        file written, so the first quarter is the pipeline filling)."""
        written = sorted(w for r in rows for w in r["written"])
        k = len(written) // 4
        span = written[-1][0] - written[k][0]
        files = len(written) - 1 - k
        mp = sum(px for _, px in written[k + 1:]) / 1e6
        return (f"{files / span:.1f} files/s, {mp / span:.1f} MP/s over the "
                f"last {files} files, {span:.3f} s")

    n_hd = sum(n.startswith("1920") for n in names)
    parts = []
    for stage, folder, count in (("dataset 1", "ds1", 1),
                                 ("dataset 2", "ds2", 2)):
        rows = process_times(stage, folder, count)
        for rank, r in enumerate(rows):
            parts.append(
                f"rank {rank} of {count}: Popen -> interpreter "
                f"{r['interpreter']:.3f} s -> torch imported "
                f"{r['torch']:.3f} s -> kernel wrappers imported "
                f"{r['imports']:.3f} s -> first file written "
                f"{r['first']:.3f} s; {len(r['written'])} files, steady "
                f"{steady([r])}; the CLI's seconds (rendezvous to summary) "
                f"{r['cli_seconds']:.3f}")
        if count > 1:
            parts.append(f"{count} processes together steady {steady(rows)}")
    print(f"time cli --dataset {len(names)} BMP files ({n_hd} x 1920x1080, "
          f"{len(names) - n_hd} x 3840x2160, 4:2:0): " + "; ".join(parts)
          + f" ({card})", flush=True)
    return counts


BAND_WORKER = """
import json, sys, time
import torch
import torch.distributed as dist
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.kernels import dct, entropy, front, pack
from jpeg_encoder_torch.parallel import multihost
from jpeg_encoder_torch.utils import corpus

address, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
multihost.initialize(address, 2, rank)
calls = []


def timed(fn):
    def run(*args, **kwargs):
        t = time.perf_counter()
        done = fn(*args, **kwargs)
        tensor = args[1] if fn.__name__ == "all_gather" else args[0]
        calls.append((fn.__name__, tensor.numel() * tensor.element_size(),
                      time.perf_counter() - t))
        return done
    return run


dist.all_gather, dist.all_reduce = timed(dist.all_gather), timed(
    dist.all_reduce)
rgb = corpus.landscape(2160, 3840)
report = {}
try:
    for mode, config in (
            ("unbroken", EncoderConfig()),
            ("restart", EncoderConfig(restart_interval=120)),
            ("optimize", EncoderConfig(optimize_huffman=True))):
        multihost.encode_tiled(rgb, config, 8)  # warm-up
        calls.clear()
        t = time.perf_counter()
        result = multihost.encode_tiled(rgb, config, 8)
        report[mode] = {"seconds": time.perf_counter() - t,
                        "collectives": list(calls)}
        with open(f"{out}/{mode}-{rank}.jpeg", "wb") as f:
            f.write(result.file_bytes)
finally:
    kernels = (front.FRONT, dct.REALDCT, entropy.ENTROPY, dct.BINDCT,
               dct.FASTDCT, pack.PACK, dct.REALDCT_BLOCKS, dct.BINDCT_BLOCKS)
    print("LAUNCHES " + json.dumps({k.name: k.launches for k in kernels}),
          file=sys.stderr)
    print("REPORT " + json.dumps(report), file=sys.stderr)
    dist.destroy_process_group()
"""


def share_lists(cuda) -> tuple[list, list, bool]:
    """The device lists of the multi-card path: two and four shares, on
    distinct cards where the machine has two or more (the peer copy then
    runs), else the one card named twice and four times."""
    n = torch.cuda.device_count()
    if n >= 2:
        return ([torch.device("cuda", i % n) for i in range(2)],
                [torch.device("cuda", i % n) for i in range(4)], True)
    return [cuda] * 2, [cuda] * 4, False


def multicard_phase(cuda, images_1080, images_4k, card, tmp) -> dict:
    """The multi-card path, driven with device lists of two and four
    shares (share_lists): encode_batch on a 21-image 1080p chunk and a
    5-image 4K chunk at 4:2:0, and on 8 1080p images at 4:2:2, 4:4:4,
    binDCT, --fast-dct, restart 120 and 7, optimize alone and with restart
    120; stream.encode_paths on the 64-file 1080p folder (and optimize on
    8 files); encode_tiled at 1080p in 4 bands over 2 shares and at 4K in
    8 bands over 4, and at 1080p over every option; the CLI on a glob with
    --devices 1; and two gloo processes on the one card, each encoding the
    bands of one 4K image with multihost.encode_tiled (8 bands, 4 a
    process; unbroken, restart 120, optimize). Every file == the single-
    card file on the card (encode_batch's for the batch and the stream,
    encode_array's for the bands and the processes). Then host ms and
    device-busy ms per image of one share against two and four, and each
    gloo collective's host seconds. Returns the path's launch counts."""
    import dataclasses
    import socket
    import warnings

    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_torch.io import bmp
    from jpeg_encoder_torch.parallel import batch, stream, tiled

    two, four, distinct = share_lists(cuda)
    hd = variants(list(images_1080.values()), 64)
    uhd = variants(list(images_4k.values()), 5)
    default = EncoderConfig()
    optimize = EncoderConfig(optimize_huffman=True)
    batch_cases = [
        ("21 x 1920x1080 4:2:0", hd[:21], default, two),
        ("21 x 1920x1080 4:2:0", hd[:21], default, four),
        ("5 x 3840x2160 4:2:0", uhd, default, two),
        ("5 x 3840x2160 4:2:0", uhd, default, four),
        ("8 x 1920x1080 4:2:2", hd[21:29],
         EncoderConfig(subsampling_ratio=(4, 2, 2)), two),
        ("8 x 1920x1080 4:4:4", hd[29:37],
         EncoderConfig(subsampling_ratio=(4, 4, 4)), four),
        ("8 x 1920x1080 bin-dct", hd[37:45],
         EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT), four),
        ("8 x 1920x1080 fast-dct", hd[45:53], EncoderConfig(fast_dct=True),
         two),
        ("8 x 1920x1080 restart 120", hd[53:61],
         EncoderConfig(restart_interval=120), two),
        ("8 x 1920x1080 restart 7", hd[:8], EncoderConfig(restart_interval=7),
         four),
        ("8 x 1920x1080 optimize", hd[8:16], optimize, four),
        ("8 x 1920x1080 optimize restart 120", hd[16:24],
         dataclasses.replace(optimize, restart_interval=120), two),
    ]
    quirk = np.random.default_rng(9).integers(0, 256, (1089, 1921, 3),
                                              np.uint8)
    band_cases = [
        ("1920x1080 4:2:0 4 bands", hd[0], default, 4, two),
        ("3840x2160 4:2:0 8 bands", uhd[0], default, 8, four),
        ("1920x1080 4:2:2 4 bands", hd[1],
         EncoderConfig(subsampling_ratio=(4, 2, 2)), 4, two),
        ("1920x1080 4:4:4 8 bands", hd[2],
         EncoderConfig(subsampling_ratio=(4, 4, 4)), 8, four),
        ("1920x1080 bin-dct descale 8 bands", hd[3],
         EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT,
                       bin_dct_descale=True), 8, four),
        ("1920x1080 fast-dct 4 bands", hd[4], EncoderConfig(fast_dct=True), 4,
         two),
        ("1920x1080 restart 120 4 bands", hd[5],
         EncoderConfig(restart_interval=120), 4, two),
        ("1920x1080 restart 7 4 bands", hd[6],
         EncoderConfig(restart_interval=7), 4, four),
        ("1920x1080 optimize 8 bands", hd[7], optimize, 8, four),
        ("3840x2160 optimize restart 120 8 bands", uhd[1],
         dataclasses.replace(optimize, restart_interval=120), 8, four),
        ("1921x1089 4:2:0 (quirk geometry) 4 bands", quirk, default, 4, two),
    ]
    src, out = os.path.join(tmp, "src"), os.path.join(tmp, "out")
    os.makedirs(src)
    os.makedirs(out)
    paths = []
    for i, rgb in enumerate(hd):
        paths.append(os.path.join(src, f"frame{i:02d}.bmp"))
        bmp.write(paths[-1], rgb)
    with socket.create_server(("localhost", 0)) as s:
        address = f"localhost:{s.getsockname()[1]}"
    workers = [[sys.executable, "-c", BAND_WORKER, address, str(rank), out]
               for rank in range(2)]
    got_batch, got_bands, streamed, worker_logs = [], [], {}, []

    def drive():
        # The gloo pair first, so its start-up overlaps the rest.
        procs = [subprocess.Popen(w, cwd=REPO, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for w in workers]
        try:
            for _, images, config, shares in batch_cases:
                got_batch.append(batch.encode_batch(images, config,
                                                    devices=shares))
            for shares in (two, four):
                streamed[len(shares)] = {}
                stream.encode_paths(paths, default,
                                    streamed[len(shares)].__setitem__,
                                    devices=shares)
            streamed["optimize"] = {}
            stream.encode_paths(paths[:8], optimize,
                                streamed["optimize"].__setitem__,
                                devices=two)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _, rgb, config, bands, shares in band_cases:
                    got_bands.append(tiled.encode_tiled(rgb, config, bands,
                                                        devices=shares))
            check([str(w.message)[:10] for w in caught] == ["dimensions"],
                  f"multicard bands warned "
                  f"{[str(w.message) for w in caught]}")
            launches = {}
            cli = run_cli([["-i", os.path.join(src, "frame0[0-7].bmp"),
                            "-o", os.path.join(out, "glob"), "--devices",
                            "1"]], launches)
            check(cli[0][0] == 0, f"cli --devices 1: exit {cli[0][0]}\n"
                  f"{cli[0][2]}")
            done = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (stdout, stderr) in zip(procs, done):
            check(p.returncode == 0, f"band worker exit {p.returncode}:\n"
                  f"{stdout}\n{stderr}")
            for line in stderr.splitlines():
                if line.startswith("LAUNCHES "):
                    for name, n in json.loads(line[9:]).items():
                        launches[name] = launches.get(name, 0) + n
        worker_logs.extend(stderr for _, stderr in done)
        return launches

    counts = counted("multicard", drive, BATCH_KERNELS)
    kind = ("distinct cards: the DC hop and the psum crossed cards (peer "
            "copies ran)" if distinct else "one card named in every entry: "
            "the peer copy between distinct cards did not run")
    print(f"multicard shares: {[str(d) for d in two]} and "
          f"{[str(d) for d in four]} ({kind})", flush=True)
    for (label, images, config, shares), files in zip(batch_cases, got_batch):
        want = batch.encode_batch(images, config, device=cuda)
        for i, (g, w) in enumerate(zip(files, want)):
            check(g == w, f"multicard batch {label} over {len(shares)} "
                  f"shares, member {i}: != the one-card batch")
        print(f"multicard batch {label} over {len(shares)} shares: every "
              "file == the one-card batch on the card", flush=True)
    for key, got in streamed.items():
        config, part = ((optimize, paths[:8]) if key == "optimize"
                        else (default, paths))
        want = batch.encode_batch(hd[: len(part)], config, device=cuda)
        check([got[p] for p in part] == want,
              f"multicard stream {key}: != the one-card batch")
        print(f"multicard stream {len(part)} x 1920x1080 "
              f"{'optimize over 2' if key == 'optimize' else f'over {key}'}"
              " shares: every file == the one-card batch on the card",
              flush=True)
    for (label, rgb, config, bands, shares), got in zip(band_cases,
                                                        got_bands):
        want = pipeline.encode_array(rgb, config, device=cuda)
        check(got.file_bytes == want.file_bytes,
              f"multicard bands {label} over {len(shares)} shares: != "
              "encode_array on the card")
        print(f"multicard bands {label} over {len(shares)} shares: == "
              "encode_array on the card", flush=True)
    for i in range(8):
        with open(os.path.join(out, "glob", f"frame{i:02d}.jpeg"), "rb") as f:
            check(f.read() == pipeline.encode_array(
                hd[i], default, device=cuda).file_bytes,
                f"multicard cli --devices 1 frame{i:02d} != encode_array")
    print("multicard cli -i 'frame0[0-7].bmp' --devices 1: 8 files == "
          "encode_array on the card", flush=True)
    reports = [json.loads(next(line[7:] for line in stderr.splitlines()
                               if line.startswith("REPORT ")))
               for stderr in worker_logs]
    rgb = images_4k["landscape"]
    for mode, config in (("unbroken", default),
                         ("restart", EncoderConfig(restart_interval=120)),
                         ("optimize", optimize)):
        want = pipeline.encode_array(rgb, config, device=cuda).file_bytes
        for rank in range(2):
            with open(os.path.join(out, f"{mode}-{rank}.jpeg"), "rb") as f:
                check(f.read() == want, f"multicard gloo {mode} rank {rank}:"
                      " != encode_array on the card")
        calls = "; ".join(
            f"rank {rank} {r[mode]['seconds'] * 1e3:.3f} ms: " + ", ".join(
                f"{name} {nbytes} B {sec * 1e3:.3f} ms"
                for name, nbytes, sec in r[mode]["collectives"])
            for rank, r in enumerate(reports))
        print(f"multicard gloo 3840x2160 8 bands over 2 processes {mode}: "
              f"both files == encode_array on the card; host {calls} "
              f"({card})", flush=True)

    # One share against two and four, in turns (1, 2, 4, 4, 2, 1).
    timings = [
        ("batch 21 x 1920x1080", 21, lambda **kw: batch.encode_batch(
            hd[:21], default, **kw)),
        ("batch 5 x 3840x2160", 5, lambda **kw: batch.encode_batch(
            uhd, default, **kw)),
        ("stream 64 x 1920x1080 BMP files", 64, lambda **kw:
            stream.encode_paths(paths, default, lambda p, d: None, **kw)),
        ("bands 1920x1080 4 bands", 1, lambda **kw: tiled.encode_tiled(
            hd[0], default, 4, **kw)),
        ("bands 3840x2160 8 bands", 1, lambda **kw: tiled.encode_tiled(
            uhd[0], default, 8, **kw)),
    ]
    for label, n, run in timings:
        forms = (("one share", dict(device=cuda)),
                 ("2 shares", dict(devices=two)),
                 ("4 shares", dict(devices=four)))
        host = {name: [] for name, _ in forms}

        def call(kw):
            run(**kw)
            torch.cuda.synchronize()

        for name, kw in forms + forms[::-1]:
            host[name].append(host_ms(lambda: call(kw), reps=3))
        busy = {name: busy_ms(lambda: call(kw), reps=3) for name, kw in forms}
        launched = {name: sum(c for _, c, _ in device_ops(
            lambda: call(kw), reps=2)) for name, kw in forms}
        print(f"time multicard {label} 4:2:0, ms per image, host (mean of "
              "two medians of 3) / device-busy, and device operations a "
              "call: " + "; ".join(
                  f"{name} {sum(host[name]) / 2 / n:.3f} / "
                  f"{fmt(None if busy[name] is None else busy[name] / n)}, "
                  f"{launched[name]:g} ops" for name, _ in forms)
              + f" ({card})", flush=True)
    return counts


# The smoke's reduced traffic of each kind of cell (benchmark/cells.py):
# 100 timed requests of a single-file cell (a p90 needs 100 samples), a
# folder of 32 BMP files and one timed pass, 20 timed calls of 8 images.
SMOKE_COUNTS = {
    "file": dict(requests=100),
    "folder": dict(files=32, passes=1),
    "batch": dict(images=8, calls=20),
}


def port_symbols() -> list[str]:
    """The names of the port's __global__ kernels (jpeg_encoder_torch/csrc):
    none may be filed under the breakdown's torch-ops row."""
    import re

    from jpeg_encoder_torch.kernels import _build

    names = []
    for source in sorted(os.listdir(_build.CSRC)):
        with open(os.path.join(_build.CSRC, source)) as f:
            names += re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)", f.read())
    check(names, f"no __global__ kernel found in {_build.CSRC}")
    return names


def benchmark_phase(card) -> None:
    """Every cell of BENCHMARK.json (benchmark/cells.CELLS) through the
    runner's on_card in this process, at the reduced counts of its kind
    (SMOKE_COUNTS). Each must exit 0 with "correct" true, failed_share 0,
    every file of every run equal to the oracle's, every metric
    BENCHMARK.json names for its cell (the per-layer ones, the program's
    spans' among them, not null), the program's counters, and the card's
    operations in its trace: F1's events among them, and no kernel of the
    port's (port_symbols) filed under the torch-ops row."""
    import contextlib
    import io

    from benchmark import cells as benchmark_cells
    from benchmark import run as benchmark_run
    from benchmark import trace as benchmark_trace

    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        metrics = json.load(f)["metrics"]
    symbols = port_symbols()
    for cell in benchmark_cells.CELLS:
        counts = benchmark_cells.Counts(
            **SMOKE_COUNTS[benchmark_cells.TABLE[cell].kind])
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = benchmark_run.on_card(cell, 0, counts)
        text = out.getvalue().strip()
        print(text, flush=True)
        lines = text.splitlines()
        line = json.loads(lines[-1])
        check(rc == 0 and line["correct"] is True
              and line["failed_share"] == 0,
              f"benchmark {cell} exited {rc}: {line}")
        check(all(good == n for good, n in line["files_checked"].values()),
              f"benchmark {cell}: {line['files_checked']}")
        names = [m["name"] for group in ("end_to_end", "per_layer")
                 for m in metrics[group] if cell in m["workloads"]]
        check(all(name in line for name in names),
              f"benchmark {cell}: the line lacks one of {names}")
        layers = [m["name"] for m in metrics["per_layer"]
                  if cell in m["workloads"]]
        check(all(line[name] is not None for name in layers),
              f"benchmark {cell}: a per-layer metric is null: "
              f"{ {name: line[name] for name in layers} }")
        check(set(line["counters"]) == set(benchmark_trace.COUNTERS)
              and line["counters"]["graphs.replay"] > 0,
              f"benchmark {cell}: counters {line['counters']}")
        check(line["device_busy_ms"] and line["device"]["platform"] == "gpu",
              f"benchmark {cell}: no device operation in its trace: {line}")
        breakdown = next(
            extra["breakdown"] for extra in map(
                json.loads, (text for text in lines if text.startswith("{")))
            if "breakdown" in extra)
        check(breakdown["f1_events"] > 0,
              f"benchmark {cell}: no F1 event in its trace: {breakdown}")
        in_torch_ops = [op["name"] for op in breakdown["top_ops"]
                        if op["label"] == benchmark_trace.TORCH_OPS
                        and any(name in op["name"] for name in symbols)]
        check(not in_torch_ops, f"benchmark {cell}: the port's kernels "
              f"{in_torch_ops} are filed under {benchmark_trace.TORCH_OPS}")
        rows = {row["label"]: row["ms"] / breakdown["images"]
                for row in breakdown["by_label"]}
        print(f"benchmark {cell}: exit 0 in {time.perf_counter() - t0:.1f} s;"
              f" breakdown ms an image: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in rows.items())
              + f"; f1_events {breakdown['f1_events']}, k1_events "
              f"{breakdown['k1_events']} ({card})", flush=True)


# The program's span names (jpeg_encoder_torch/trace.py) each entry must
# record on the card.
FILE_SPANS = {"encode_file", "encode_file.read", "staging.wait",
              "encode_array", "encode_array.upload", "encode_array.launch",
              "encode_array.fetch_wait", "encode_array.jfif",
              "encode_file.write"}
BATCH_SPANS = {"encode_batch", "batch.dispatch", "upload.ring_wait",
               "upload.fill", "batch.fetch", "batch.assemble"}
STREAM_SPANS = {"stream.encode_paths", "stream.probe", "stream.read",
                "stream.ring_wait", "stream.loader.blocked",
                "stream.compute.starved", "stream.dispatch",
                "stream.compute.blocked", "stream.assembler.starved",
                "stream.assemble", "batch.fetch", "batch.assemble",
                "stream.assembler.blocked", "stream.emitter.starved",
                "stream.emit"}


def check_nesting(label: str, spans, entry: str, calls: int) -> None:
    """calls request spans named `entry`, every span in one of them, and
    every child inside its parent on the host clock, in its request."""
    requests = [s for s in spans if s.name == entry and s.id == s.request]
    check(len(requests) == calls,
          f"trace {label}: {len(requests)} {entry} requests, not {calls}")
    ids = {r.id for r in requests}
    by_id = {s.id: s for s in spans}
    for s in spans:
        check(s.request in ids, f"trace {label}: {s} outside a request")
        if s.parent is not None:
            p = by_id[s.parent]
            check(p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
                  and p.request == s.request,
                  f"trace {label}: {s} not inside its parent {p}")


def disabled_site_ns(calls: int = 100_000, rounds: int = 100) -> dict:
    """What a span site costs with no recorder active, on this host's CPU:
    ns a site, the median of `rounds` rounds of calls // rounds sites, for
    a site with no attrs, one with an attr and a counter, beside the loop
    alone."""
    from jpeg_encoder_torch import trace

    def loop(n):
        for _ in range(n):
            pass

    def site(n):
        for _ in range(n):
            with trace.span("encode_array.launch"):
                pass

    def site_attr(n):
        for _ in range(n):
            with trace.span("upload.fill") as s:
                if s:
                    s.attrs["bytes"] = n

    def counter(n):
        for _ in range(n):
            trace.count("upload.pieces")

    per = calls // rounds
    out = {}
    for label, fn in (("loop", loop), ("span", site),
                      ("span with an attr", site_attr), ("count", counter)):
        ns = []
        for _ in range(rounds):
            t0 = time.perf_counter_ns()
            fn(per)
            ns.append((time.perf_counter_ns() - t0) / per)
        out[label] = statistics.median(ns)
    return out


def trace_phase(cuda, images_1080, card, tmp) -> dict[str, int]:
    """The program's spans and counters on the card (jpeg_encoder_torch/
    trace.py): encode_file over 8 1080p BMP files (and one optimize
    file), encode_batch twice on a pageable (8, 1080, 1920, 3) array,
    stream.encode_paths over 64 1080p BMP files (four chunks, so the
    loader waits on its ring), each with recording on: every span name of
    its layers, one request a call, every child inside its parent, the
    counters, and every file == the untraced run's. Prints the disabled
    span site's ns, the traced requests' ms against untraced ones in
    alternated rounds and, with no profiler, encode_array's parts against
    its span."""
    from benchmark import trace as benchmark_trace
    from jpeg_encoder_torch import pipeline, trace
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.io import bmp
    from jpeg_encoder_torch.parallel import batch, stream

    default = EncoderConfig()
    optimize = EncoderConfig(optimize_huffman=True)
    frames = variants(list(images_1080.values()), 64)
    paths = []
    for i, rgb in enumerate(frames):
        paths.append(os.path.join(tmp, f"trace_{i:02d}.bmp"))
        bmp.write(paths[-1], rgb)

    def files(config, label, count=8):
        out = []
        for i, path in enumerate(paths[:count]):
            dst = os.path.join(tmp, f"{label}_{i:02d}.jpg")
            pipeline.encode_file(path, dst, config, device=cuda)
            with open(dst, "rb") as f:
                out.append(f.read())
        return out

    for config in (default, optimize):  # the keys' eager call and capture
        files(config, "warm", 2)
    want = files(default, "untraced")
    want_opt = files(optimize, "untraced_opt", 1)
    with trace.recording() as recorder:
        got = files(default, "traced")
    check(got == want, "trace: a traced encode_file file != the untraced")
    names = {s.name for s in recorder.spans}
    check(names == FILE_SPANS, f"trace encode_file: spans {sorted(names)}")
    check_nesting("encode_file", recorder.spans, "encode_file", 8)
    check(recorder.counters.get("graphs.replay") == 8
          and not recorder.counters.get("ladder.climb"),
          f"trace encode_file: counters {recorder.counters}")
    with trace.recording() as recorder:
        got = files(optimize, "traced_opt", 1)
    check(got == want_opt, "trace: a traced optimize file != the untraced")
    names = [s.name for s in recorder.spans]
    check(names.count("encode_array.tables") == 1
          and names.count("encode_array.launch") == 2,
          f"trace optimize encode_file: spans {names}")

    # Traced against untraced requests, in alternated rounds; each traced
    # round's encode_array parts against its span, with no profiler.
    ms = {"untraced": [], "traced": []}
    shares, self_ms = [], []
    for r in range(10):
        for traced in ((False, True) if r % 2 else (True, False)):
            with (trace.recording() if traced
                  else contextlib.nullcontext()) as recorder:
                for i, path in enumerate(paths[:8]):
                    t0 = time.perf_counter()
                    pipeline.encode_file(path, os.path.join(
                        tmp, f"round_{i}.jpg"), default, device=cuda)
                    ms["traced" if traced else "untraced"].append(
                        (time.perf_counter() - t0) * 1e3)
            if traced:
                _, whole, _ = benchmark_trace.file_layers(recorder.spans)
                shares.append(whole["parts_share"])
                self_ms.append(whole["encode_array_self_ms"])
    medians = {k: statistics.median(v) for k, v in ms.items()}

    arr = np.ascontiguousarray(frames[:8])
    want = batch.encode_batch(arr, default, device=cuda)
    for _ in range(2):  # the capture, then a replay
        check(batch.encode_batch(arr, default, device=cuda) == want,
              "trace: an untraced encode_batch file differs")
    with trace.recording() as recorder:
        for _ in range(2):
            check(batch.encode_batch(arr, default, device=cuda) == want,
                  "trace: a traced encode_batch file != the untraced")
    names = {s.name for s in recorder.spans}
    check(names == BATCH_SPANS, f"trace encode_batch: spans {sorted(names)}")
    check_nesting("encode_batch", recorder.spans, "encode_batch", 2)
    pieces = 2 * -(-arr.nbytes // pipeline.PIECE_BYTES)
    check(recorder.counters.get("upload.pieces") == pieces
          and recorder.counters.get("graphs.replay") == 2,
          f"trace encode_batch: counters {recorder.counters}, "
          f"{pieces} pieces")
    fills = sorted(s.seconds * 1e3 for s in recorder.spans
                   if s.name == "upload.fill")

    def stream_files():
        out = {}
        stream.encode_paths(paths, default, out.__setitem__, device=cuda)
        return out

    want = stream_files()
    with trace.recording() as recorder:
        got = stream_files()
    check(got == want, "trace: a traced stream file != the untraced")
    names = {s.name for s in recorder.spans}
    check(names == STREAM_SPANS,
          f"trace encode_paths: spans {sorted(names)}")
    check_nesting("encode_paths", recorder.spans, "stream.encode_paths", 1)
    emits = [s for s in recorder.spans if s.name == "stream.emit"]
    reads = [s for s in recorder.spans if s.name == "stream.read"]
    check(len(emits) == len(reads) == len(paths)
          and {s.thread for s in emits} == {"jpeg-torch-emitter"}
          and all(s.thread.startswith("jpeg-torch-decoder") for s in reads),
          "trace encode_paths: not one read and one emit a file on the "
          "decoder pool and the emitter")
    in_flight = [s.attrs["reads_in_flight"] for s in emits]

    sites = disabled_site_ns()
    print("trace: disabled span site ns (median of 100 rounds of 1000): "
          + ", ".join(f"{k} {v:.1f}" for k, v in sites.items())
          + f"; encode_file 1080p ms traced {medians['traced']:.4f} vs "
          f"untraced {medians['untraced']:.4f} (+"
          f"{medians['traced'] / medians['untraced'] - 1:.2%}, "
          f"80 requests each, alternated), encode_array's parts "
          f"{statistics.median(shares):.4f} of its span, self ms "
          f"{statistics.median(self_ms):.4f} (no profiler; median of 10 "
          f"rounds' medians); encode_batch 8 x 1080p "
          f"upload.fill ms p50 {statistics.median(fills):.4f} max "
          f"{fills[-1]:.4f} over {len(fills)} pieces; stream emits' "
          f"reads in flight: mean {statistics.mean(in_flight):.2f}, max "
          f"{max(in_flight)} ({card})", flush=True)


def bench_runs(tmp: str, launches: dict) -> list[tuple]:
    """(label, module, argv, JSON keys its last line must have) of every
    bench module at reduced sizes: windows of 0.1 s, a dataset of 16 (and
    8 optimized) 1080p files, the host I/O of 16 1080p files and the split
    read's candidates at 1080p and 4K, the parity sweep in all three modes
    at full size. Scaling runs the batch curve and four shares of the card
    (its weak-scaling loop; on one card its default is that loop's first
    row)."""
    short = ["--min-seconds", "0.1"]
    dataset = ["--images", "16", "--width", "1920", "--height", "1080",
               "--dir", os.path.join(tmp, "dataset"), "--verify", "4"]
    return [
        ("bench", "__main__", short, ("metric", "value", "vs_baseline")),
        ("matrix", "matrix", short, ("rows",)),
        ("matrix cell fast", "matrix", short + ["--cell", "4:2:0", "fast"],
         ("value",)),
        ("matrix cell restart optimize", "matrix",
         short + ["--cell", "4:2:2", "bin", "restart=120", "optimize"],
         ("value", "two_pass")),
        ("tiled", "tiled", short, ("rows", "encode_core")),
        ("dataset", "dataset", dataset, ("value", "device_hbm_peak_mb")),
        ("dataset optimize", "dataset",
         dataset[:1] + ["8"] + dataset[2:] + ["--optimize"],
         ("value", "verified_byte_identical")),
        ("scaling batch curve", "scaling", short + ["--batch-curve"],
         ("rows",)),
        ("scaling shares", "scaling", short + ["--shares", "4"], ("rows",)),
        ("kernels", "kernels", short + ["--launches", json.dumps(launches)],
         ("kernels", "stages", "matmul_ms")),
        ("host io", "host_io", ["--images", "16", "--reps", "3"],
         ("probe_serial", "read_native_pool", "emit_alone")),
        ("host io split", "host_io", ["--split", "--reps", "9"],
         ("geometries", "pool_threads", "exact")),
        ("parity color", "parity", ["--color"], ("triples", "mismatched")),
        ("parity corpus", "parity", ["--corpus"], ("cases", "identical")),
        ("parity geometry", "parity", [], ("cases", "identical")),
    ]


def bench_phase(cuda, launches: dict, tmp: str) -> dict:
    """Every bench module (jpeg_encoder_torch/bench) in this process
    through its main(argv) on the card: exit code 0 and a last line of
    JSON with its keys, or fail; the parity sweeps must find 0 of 2^24
    colour triples and 24 of 24 files in each sweep byte-identical.
    Returns each run's JSON line."""
    import contextlib
    import importlib
    import io

    lines = {}
    for label, module, argv, keys in bench_runs(tmp, launches):
        mod = importlib.import_module(f"jpeg_encoder_torch.bench.{module}")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mod.main([*argv, "--device", str(cuda)])
        seconds = time.perf_counter() - t0
        text = out.getvalue().strip()
        print(text, flush=True)
        check(rc == 0, f"bench {label} exited {rc}")
        line = json.loads(text.splitlines()[-1])
        check(all(k in line for k in keys),
              f"bench {label}: the JSON line lacks one of {keys}: {line}")
        print(f"bench {label}: exit 0 in {seconds:.1f} s", flush=True)
        lines[label] = line
    check(lines["parity color"]["triples"] == 2 ** 24
          and lines["parity color"]["mismatched"] == 0,
          f"colour parity: {lines['parity color']}")
    for sweep in ("parity corpus", "parity geometry"):
        check(lines[sweep]["cases"] == lines[sweep]["identical"] == 24,
              f"{sweep}: {lines[sweep]}")
    return lines


def interval_pairs(z, geom):
    """(name, kernel, plain) of K4 in interval mode (restart every 120 MCUs,
    one MCU row at 1080p, and every MCU) and of K5 on the assemble tier's
    row of the unbroken scan, on z's device (bench/kernels.kernel_calls
    has K5 at restart 120)."""
    import functools

    from jpeg_encoder_torch import pipeline, scan
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.kernels import pack as pack_kernel
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    pairs = []
    for interval in (120, 1):
        epi = entropy_ops.entries_per_interval(geom, interval)
        cap = pipeline.restart_default_capacity_bytes(geom, interval)
        pairs.append((
            f"entropy intervals {interval}",
            functools.partial(entropy_kernel.encode_entries, z, geom, cap,
                              entries_per_interval=epi),
            functools.partial(entropy_ops.encode_entries, z, geom, cap,
                              entries_per_interval=epi)))
    epi = geom.num_scan_entries
    slot_bits, slot_lens = entropy_ops.symbolize(
        z, geom.h_factor * geom.v_factor, entries_per_interval=epi)
    words, offsets, _ = scan.assemble_operands(slot_bits, slot_lens, epi)
    cap = pipeline.default_capacity_bytes(geom)
    pairs.append((
        "pack one row",
        functools.partial(pack_kernel.assemble_bitstream, words, offsets, cap),
        functools.partial(entropy_ops.assemble_bitstream, words, offsets,
                          cap)))
    return pairs


def timing_phase(cuda, images_1080, images_4k, card) -> tuple[dict, ...]:
    """Kernel vs plain times (CUDA events around each call, and the
    device-busy time inside it), the device time of each encode stage, and
    the end-to-end time per image, at 1080p and 4K (4:2:0, corpus
    content), each kernel also by CUDA-graph replay (bench/timing.graph_ms:
    its device work alone, no host, no dropped events). Returns the 1080p
    kernel and plain event times, the kernels' device-busy and graph times,
    each kernel's bound on the same inputs, and the time of one PyTorch
    call computing the same function where there is one (K2's matmul), by
    events, device-busy and graph."""
    import dataclasses

    from jpeg_encoder_torch.bench import kernels as bench_kernels
    from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.kernels import front as front_kernel
    from jpeg_encoder_torch.ops import entropy as entropy_ops
    from jpeg_encoder_torch.ops import front as front_ops

    config = EncoderConfig()
    bin_dct = EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)
    fast = EncoderConfig(fast_dct=True)
    times, busy, graph = {}, {}, {}
    for label, rgb in (
        ("1920x1080", next(iter(images_1080.values()))),
        ("3840x2160", next(iter(images_4k.values()))),
    ):
        ops = bench_kernels.Operands.build(rgb, cuda)
        geom, rgb_dev, planes, coeffs, z, cap = (
            ops.geom, ops.rgb, ops.planes, ops.coeffs, ops.z, ops.cap)
        if label == "1920x1080":
            bounds = kernel_bounds(geom, planes, z, cap, ops.y_blocks)
            library = dict.fromkeys(bounds)
            library_busy = dict.fromkeys(bounds)
            library_graph = dict.fromkeys(bounds)
            matmul, shape = bench_kernels.matmul_call(ops)
            library["fastdct"] = cuda_ms(matmul)
            library_busy["fastdct"] = busy_ms(matmul)
            library_graph["fastdct"] = timing.graph_ms(matmul, cuda)
            print(f"time library torch.matmul ({shape[0]}, 64) x "
                  f"(64, 64) f32, TF32 off (K2's product): events "
                  f"{library['fastdct']:.4f} ms, device-busy "
                  f"{fmt(library_busy['fastdct'])} ms, graph "
                  f"{library_graph['fastdct']:.4f} ms ({card})", flush=True)
            for _ in range(3):  # an empty trace is retried, as in busy_ms
                k4_ops = device_ops(lambda: entropy_kernel.encode_entries(
                    z, geom, cap))
                count = sum(c for _, c, _ in k4_ops)
                if count:
                    break
            check(0 < count <= 2, "one K4 call ran other than the memset and "
                  f"one kernel: {k4_ops}")
            print(f"K4 device operations per call, 1920x1080 4:2:0 unbroken: "
                  f"{count:g} (" + "; ".join(f"{name[:50]} x{c:g}"
                                              for name, c, _ in k4_ops)
                  + f") ({card})", flush=True)

        # Turns: plain, kernel, kernel, plain; each figure is the mean of
        # the two runs' medians.
        for name, kernel, plain in (bench_kernels.kernel_calls(ops)
                                    + interval_pairs(z, geom)):
            if label == "1920x1080":
                KERNEL_CALLS[name] = kernel
            p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
            times.setdefault(name, ((k1 + k2) / 2, (p1 + p2) / 2))
            kernel_busy = busy_ms(kernel)
            busy.setdefault(name, kernel_busy)  # 1080p first
            kernel_graph = timing.graph_ms(kernel, cuda)
            graph.setdefault(name, kernel_graph)
            print(f"time {name} {label} 4:2:0: kernel {(k1 + k2) / 2:.4f} ms, "
                  f"plain {(p1 + p2) / 2:.4f} ms; device-busy kernel "
                  f"{fmt(kernel_busy)} ms, plain {fmt(busy_ms(plain))} ms; "
                  f"graph kernel {kernel_graph:.4f} ms "
                  f"({card})", flush=True)

        cap120 = pipeline.restart_default_capacity_bytes(geom, 120)
        stages = {
            "colour+pad+subsample": lambda: front_ops.planes(rgb_dev, geom),
            "front kernel": lambda: front_kernel.planes(rgb_dev, geom),
            "realdct kernel":
                lambda: dct_kernel.real_dct_quant_planes_zigzag(*planes),
            "scan marshal":
                lambda: entropy_ops.marshal_scan_inputs(*coeffs, geom),
            "realdct into entries": lambda: dct_kernel.scan_entries(
                *planes, geom, config.dct_algorithm),
            "entropy kernel":
                lambda: entropy_kernel.encode_entries(z, geom, cap),
            "encode_core": lambda: pipeline.encode_core(
                rgb_dev, geom, config.dct_algorithm, cap, with_coeffs=False),
            "encode_core bin-dct": lambda: pipeline.encode_core(
                rgb_dev, geom, bin_dct.dct_algorithm, cap, with_coeffs=False),
            "encode_core fast-dct": lambda: pipeline.encode_core(
                rgb_dev, geom, fast.dct_algorithm, cap, with_coeffs=False,
                fast_dct=True),
            "encode_core_restart 120": lambda: pipeline.encode_core_restart(
                rgb_dev, geom, config.dct_algorithm, cap120, 120),
            "custom_core restart 120 assemble": lambda: pipeline.custom_core(
                z, geom, cap120, restart_mcus=120, packer="assemble"),
        }
        parts = ", ".join(f"{k} {cuda_ms(f):.4f}" for k, f in stages.items())
        print(f"device ms {label} 4:2:0: {parts} ({card})", flush=True)
        parts = ", ".join(f"{k} {fmt(busy_ms(f))}" for k, f in stages.items()
                          if "_core" in k)
        print(f"device-busy ms {label} 4:2:0: {parts} ({card})", flush=True)

        optimize = EncoderConfig(optimize_huffman=True)
        variants = [("real-dct", config, "fused")]
        if label == "1920x1080":
            variants += [
                ("bin-dct", bin_dct, "fused"), ("fast-dct", fast, "fused"),
                ("restart 1", EncoderConfig(restart_interval=1), "fused"),
                ("restart 120", EncoderConfig(restart_interval=120), "fused"),
                ("restart 120 assemble", EncoderConfig(restart_interval=120),
                 "assemble"),
                ("optimize", optimize, "fused"),
                ("optimize restart 120",
                 dataclasses.replace(optimize, restart_interval=120), "fused"),
            ]
        else:
            variants += [("restart 240", EncoderConfig(restart_interval=240),
                          "fused")]
        for name, cfg, packer in variants:
            ms = host_ms(lambda: pipeline.encode_array(rgb, cfg, device=cuda,
                                                       packer=packer))
            print(f"time e2e encode_array {name} {label} 4:2:0: {ms:.3f} "
                  f"ms/image, numpy RGB in -> JFIF bytes out ({card})",
                  flush=True)

    # The host's share of restart markers at their finest: joining 8,160
    # interval segments (1-padding, byte stuffing, RSTn markers).
    rgb = next(iter(images_1080.values()))
    geom = config.geometry(1920, 1080)
    cap = pipeline.restart_default_capacity_bytes(geom, 1)
    out = pipeline.encode_core_restart(torch.from_numpy(rgb).to(cuda), geom,
                                       config.dct_algorithm, cap, 1)
    bits = out["bits"].cpu().numpy()
    payloads = list(out["payloads"][:, : (int(bits.max()) + 7) // 8].cpu()
                    .numpy())
    bit_list = [int(b) for b in bits]
    ms = host_ms(lambda: pipeline.restart_result(geom, payloads, bit_list, 1,
                                                 None))
    print(f"time host restart_result 1920x1080 4:2:0 restart 1 "
          f"({len(bit_list)} segments): {ms:.3f} ms", flush=True)
    return times, busy, graph, bounds, library, library_busy, library_graph


KERNEL_CALLS = {}  # timing name -> its 1080p kernel call (timing_phase)


def parent_phase(parent: str, cuda, card) -> None:
    """With --parent DIR, a checkout of an earlier commit: every kernel
    whose source differs from DIR's is built from DIR too, and both builds
    run timing_phase's 1080p 4:2:0 calls of that kernel (same operands):
    their results must be equal, and their device-busy times are printed,
    in turns (parent, this tree, this tree, parent). The parent's C entry
    must take the same arguments. F1 is not among them: front_phase times
    the parent's F1 through its own wrapper."""
    import filecmp

    from jpeg_encoder_torch.kernels import _build
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.kernels import front as front_kernel
    from jpeg_encoder_torch.kernels import pack as pack_kernel

    parent_csrc = os.path.join(parent, "jpeg_encoder_torch", "csrc")
    # A kernel the parent does not have is not compared.
    changed = [k for k in all_kernels() if k is not front_kernel.FRONT
               and os.path.exists(os.path.join(parent_csrc, f"{k.lib}.cu"))
               and not filecmp.cmp(os.path.join(_build.CSRC, f"{k.lib}.cu"),
                                   os.path.join(parent_csrc, f"{k.lib}.cu"),
                                   shallow=False)]
    print(f"parent {parent}: kernels whose source differs: "
          f"{[k.name for k in changed]}", flush=True)
    if not changed:
        return
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        _build.build(sorted({k.lib for k in changed}), csrc=parent_csrc,
                     build_dir=tmp)
        for k in changed:
            module, attr = next(
                (m, a) for m in (dct_kernel, entropy_kernel, front_kernel,
                                 pack_kernel)
                for a, v in vars(m).items() if v is k)
            old = k.loaded_from(os.path.join(tmp, f"lib{k.lib}.so"))
            for name, fn in KERNEL_CALLS.items():
                if name != k.name and not name.startswith(k.name + " "):
                    continue
                results, busy = {}, []
                for rec in (old, k, k, old):
                    setattr(module, attr, rec)
                    results[rec is k] = fn()
                    busy.append(busy_ms(fn))
                setattr(module, attr, k)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(
                    *(r if isinstance(r, tuple) else (r,)
                      for r in results.values())))
                check(same, f"{name}: the parent's kernel and this tree's "
                      "differ on the same operands")
                mean = lambda a, b: None if None in (a, b) else (a + b) / 2
                print(f"time {name} 1920x1080 4:2:0 vs parent: device-busy "
                      f"parent {fmt(mean(busy[0], busy[3]))} ms, this tree "
                      f"{fmt(mean(busy[1], busy[2]))} ms; results equal "
                      f"({card})", flush=True)


def all_kernels():
    """Every kernel of the port: F1 front, K1 realdct, K4 entropy, K3
    bindct, K2 fastdct, K5 pack, K6a/b realdct_blocks, K6c
    bindct_blocks."""
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.kernels import front as front_kernel
    from jpeg_encoder_torch.kernels import pack as pack_kernel

    return (front_kernel.FRONT, dct_kernel.REALDCT, entropy_kernel.ENTROPY,
            dct_kernel.BINDCT, dct_kernel.FASTDCT, pack_kernel.PACK,
            dct_kernel.REALDCT_BLOCKS, dct_kernel.BINDCT_BLOCKS)


# The kernels each path must launch.
MAIN_KERNELS = ("front", "realdct", "entropy")
E2E_KERNELS = ("front", "realdct", "entropy", "bindct", "fastdct", "pack")
BATCH_KERNELS = ("front", "realdct", "entropy", "bindct", "fastdct")
BLOCK_KERNELS = ("realdct_blocks", "bindct_blocks")
PLANE_DCT = ("realdct", "fastdct", "bindct")


def counted(path: str, drive, required, fronts: bool = True
            ) -> dict[str, int]:
    """Set every launch count to 0, drive one path, read the counts; fail
    unless every kernel in `required` launched and, with fronts (a path of
    the program, not a timing of its kernels one by one), unless F1
    launched as often as the plane DCTs together. A drive that runs the path
    in processes of its own returns the launches they reported (run_cli),
    which are added in."""
    from jpeg_encoder_torch import graphs

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    evictions = graphs.CACHE.evictions
    children = drive() or {}
    counts = {k.name: k.launches + children.get(k.name, 0) for k in kernels}
    check(all(counts[name] for name in required),
          f"a kernel of the {path} path never ran: {counts}")
    # Every plane DCT of a path takes the planes of one front launch
    # (pipeline.scan_entries): no path's front runs as plain ops.
    check(not fronts
          or counts["front"] == sum(counts[name] for name in PLANE_DCT),
          f"the {path} path's front launches differ from its plane-DCT "
          f"launches: {counts}")
    pools = sum(p.pool_bytes for _, p in graphs.CACHE.programs(
        torch.device("cuda", torch.cuda.current_device())))
    print(f"{path} launches: {counts}; graph programs evicted "
          f"{graphs.CACHE.evictions - evictions}; pools held "
          f"{pools / 2**30:.2f} GiB, memory reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)
    return counts


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--parent", metavar="DIR", action="append", default=[],
        help="a checkout of an earlier commit (may be given again for "
             "another): also time its builds of the kernels whose sources "
             "differ, on the same operands (F1 with its own wrapper)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from jpeg_encoder_torch.utils import corpus
    from jpeg_encoder_torch.kernels import _build

    cuda = torch.device("cuda", torch.cuda.current_device())
    card = timing.card_line(cuda)
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(cuda)}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    for name in _build.names():
        _build.load(name)
    print(f"build: {len(_build.names())} nvcc in parallel, "
          f"{' '.join(_build.NVCC_FLAGS)} -> {_build.BUILD_DIR}/lib*.so "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.names():
        for line in _build.ptxas_usage(name):
            print(f"ptxas {name}.cu: {line}", flush=True)

    rng = np.random.default_rng(20260)
    images_1080 = {name: fn(1080, 1920) for name, fn in corpus.CORPUS.items()}
    images_4k = {name: corpus.CORPUS[name](2160, 3840)
                 for name in ("landscape", "architecture")}

    from jpeg_encoder_torch.kernels import dct as dct_kernel

    errors = {
        "realdct": exact_dct_phase(
            "K1", dct_kernel.real_dct_quant_planes_zigzag, cuda, rng,
            [(None,), (90,)]),
        "bindct": exact_dct_phase(
            "K3", dct_kernel.bin_dct_quant_planes_zigzag, cuda, rng,
            [(q, d) for q in (None, 90) for d in (False, True)]),
    }
    t0 = time.perf_counter()
    for name, err in entries_phase(cuda, rng, images_1080, images_4k,
                                   card).items():
        errors[name] = max(errors[name], float(err))
    entries_s = time.perf_counter() - t0
    errors["fastdct"] = k2_phase(cuda, rng)
    errors["entropy"] = max(k4_phase(cuda, images_1080),
                            k4_interval_phase(cuda, images_1080),
                            k4_batch_phase(cuda, images_1080),
                            k4_band_phase(cuda, images_1080))
    errors["pack"] = k5_phase(cuda, images_1080)
    errors.update(k6_phase(cuda, rng))
    errors["front"] = front_phase(
        cuda, images_1080, images_4k, card,
        {os.path.basename(os.path.normpath(d)): d for d in args.parent})
    phase_s = {"entries": entries_s}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        path_counts = [e2e_phase(cuda, images_1080, images_4k, tmp)]
    phase_s["e2e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        path_counts.append(staged_read_phase(cuda, card, tmp))
    phase_s["staged read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_counts.append(graph_phase(cuda, images_1080, images_4k, card))
    phase_s["graphs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_counts.append(batch_phase(cuda, images_1080, images_4k, card))
    phase_s["batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_counts.append(block_tier_path(cuda, images_1080))
    phase_s["per-block tier"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_counts.append(large_image_path(cuda))
    phase_s["large image"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        path_counts.append(stream_phase(cuda, images_1080, images_4k, card,
                                        tmp))
    phase_s["stream"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_counts.append(tiled_phase(cuda, images_1080, images_4k, card))
    phase_s["tiled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        path_counts.append(cli_phase(cuda, images_1080, images_4k, card,
                                     tmp))
    phase_s["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        path_counts.append(multicard_phase(cuda, images_1080, images_4k,
                                           card, tmp))
    phase_s["multicard"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        path_counts.append(counted(
            "trace", lambda: trace_phase(cuda, images_1080, card, tmp),
            MAIN_KERNELS))
    phase_s["trace"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_counts.append(counted("benchmark", lambda: benchmark_phase(card),
                               MAIN_KERNELS))
    phase_s["benchmark"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    main_launches = {k.name: sum(c[k.name] for c in path_counts)
                     for k in all_kernels()}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        # Its launches are the timing windows' (a kernel captured into a
        # CUDA graph counts once, at capture): read and checked, but not
        # added to the main paths' launches of the kernels line.
        counted("bench", lambda: bench_phase(cuda, main_launches, tmp)
                and None, [k.name for k in all_kernels()], fronts=False)
    phase_s["bench"] = time.perf_counter() - t0
    print(f"bench phase: {phase_s['bench']:.1f} s wall ({card})", flush=True)
    t0 = time.perf_counter()
    times, busy, graph, bounds, library, library_busy, library_graph = (
        timing_phase(cuda, images_1080, images_4k, card))
    phase_s["timing"] = time.perf_counter() - t0
    if args.parent:
        t0 = time.perf_counter()
        for parent in args.parent:
            parent_phase(parent, cuda, card)
        phase_s["parent"] = time.perf_counter() - t0
    print(f"K2 fastdct 1920x1080 4:2:0 device-busy {fmt(busy['fastdct'])} ms, "
          f"graph {graph['fastdct']:.4f} ms vs torch.matmul (its product "
          f"alone) {fmt(library_busy['fastdct'])} ms, graph "
          f"{library_graph['fastdct']:.4f} ms: K2 is "
          f"{'slower' if graph['fastdct'] > library_graph['fastdct'] else 'not slower'}"
          " by graph replay; mismatch rates: " + " | ".join(FAST_RATES)
          + f" ({card})", flush=True)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                        phase_s.items()) + f" ({card})",
          flush=True)
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "jpeg_encoder_tpu")]
    check(not leaked, f"something imported {leaked}")

    kernels = [{
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces,
        "launches": sum(c[k.name] for c in path_counts),
        "max_abs_err": errors[k.name], "ms": times[k.name][0],
        "plain_ms": times[k.name][1], "bound_ms": bounds[k.name][0],
        "bound_by": bounds[k.name][1], "library_ms": library[k.name],
        "library_busy_ms": library_busy[k.name], "busy_ms": busy[k.name],
    } for k in all_kernels()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
