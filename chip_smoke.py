"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from jpeg_encoder_torch/csrc (one nvcc per
source, all at once), holds each against its plain PyTorch version (K1
RealDCT, K4 entropy, K3 binDCT, K5 bitstream assembly and the per-block
tier K6a/b and K6c exactly, K4 also over restart intervals with
live_entries and over a batch of images with per-image rows, intervals and
tables, K6 also against K1 and K3 on the same blocks; K2 --fast-dct to max
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
K3), a large image (a 7680x4320 4:4:4 gradient, whose worst case passes
2^31 bits, against the CPU path) and the stream engine
(jpeg_encoder_torch.parallel.stream.encode_paths: 64 1080p and 15 4K BMP
files to JFIF files, every file against encode_batch's, 8 also under
restart and optimize; under the profiler every host-to-device copy must be
pinned and one at least must overlap a kernel), each path between a reset
and a read of the launch counts, and times
the kernels (beside their bounds), the batch against a loop of single
encodes, and the end-to-end encodes. It also prints each kernel's
registers, spills and shared memory as ptxas reports them, the
torch.matmul yardstick of K2 by events and device-busy time beside K2's
busy time and mismatch rates, the
device operations of one K4 call (failing unless they are the memset and
one kernel) and of one K5 call (failing unless it is one kernel), the
stream against a synchronous read-encode-write loop and the pinned and
pageable H2D rates. With --parent DIR (a checkout of an earlier commit)
it also builds DIR's sources of the kernels that differ and times both
builds on the same operands. K5 also runs on adversarial operands (runs
of 0-bit entries, 56-word entries, a row past bit 2^31, cut capacities).
Any mismatch or error exits non-zero before the final line,
which is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Needs one CUDA card, nvcc and no network; imports no JAX and nothing of
jpeg_encoder_tpu.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
REPS = 20  # timed repetitions (median reported)
RATIOS = ((4, 2, 0), (4, 2, 2), (4, 4, 4))
INTERVALS = (1, 7, 120, 10000)  # restart intervals, MCUs


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


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


def front_planes(rgb: torch.Tensor, geom):
    """The main path's colour, pad and subsample stages (plain ops)."""
    from jpeg_encoder_torch.ops import color, sample

    y, cb, cr = color.rgb_to_ycbcr(rgb)
    y = sample.pad_plane(y, geom)
    cb = sample.subsample_plane(sample.pad_plane(cb, geom), geom)
    cr = sample.subsample_plane(sample.pad_plane(cr, geom), geom)
    return y, cb, cr


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


def card_entries(cuda, rgb: np.ndarray, geom) -> torch.Tensor:
    """(E, 64) scan entries of rgb, from K1 on the card, on the CPU."""
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    coeffs = dct_kernel.real_dct_quant_planes_zigzag(
        *front_planes(torch.from_numpy(rgb).to(cuda), geom)
    )
    return entropy_ops.marshal_scan_inputs(*coeffs, geom).cpu()


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
        ("realdct", "entropy"))
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
    from jpeg_encoder_torch.ops import sample

    height, width = next(iter(images_1080.values())).shape[:2]
    geom = EncoderConfig().geometry(width, height)
    planes = [front_planes(torch.from_numpy(rgb).to(cuda), geom)
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


def variants(images: list[np.ndarray], count: int) -> np.ndarray:
    """count distinct images from a few: rolled, flipped, channel-swapped."""
    out = []
    for k in range(count):
        rgb = images[k % len(images)]
        j = k // len(images)
        if j % 2:
            rgb = rgb[:, ::-1]
        if j % 4 >= 2:
            rgb = rgb[::-1, :, ::-1]
        out.append(np.roll(rgb, 97 * j, axis=1))
    return np.ascontiguousarray(np.stack(out))


def batch_phase(cuda, images_1080, images_4k, card) -> dict[str, int]:
    """The batch path, driven (parallel.batch.encode_batch on the card): 32
    1080p and 12 4K images at 4:2:0 (two and three chunks at the default
    budget), 8 at 4:2:2 and 8 at 4:4:4, binDCT, --fast-dct, restart 120
    and 7, optimize alone and with restart 120, and a chunk with one
    member that overflows the shared capacity (retried alone). Every file
    == the single-image card path's, a few == the CPU path's. Then ms per
    image of the batch against a loop of encode_array on the same images.
    Returns the batch path's launch counts."""
    import dataclasses

    from jpeg_encoder_torch import pipeline
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
    retried = []
    retry = batch._retry

    def spy(rgb, *args):
        retried.append(rgb)
        return retry(rgb, *args)

    batch._retry = spy
    results = []
    try:
        counts = counted("batch", lambda: results.extend(
            batch.encode_batch(images, config, device=cuda)
            for _, images, config in cases), BATCH_KERNELS)
    finally:
        batch._retry = retry
    check(len(retried) == 1 and np.array_equal(retried[0], noise),
          f"the retry case retried {len(retried)} members, not the noise one")
    cpu_checked = ("32 x 1920x1080 4:2:0", "8 x 1920x1080 4:4:4",
                   "8 x 1920x1080 optimize restart 120")
    for (label, images, config), files in zip(cases, results):
        geom = config.geometry(images.shape[2], images.shape[1])
        chunk = batch.chunk_size_images(geom)
        for i, (rgb, got) in enumerate(zip(images, files)):
            want = pipeline.encode_array(rgb, config, device=cuda).file_bytes
            check(got == want, f"batch {label} member {i}: != encode_array "
                  "on the card")
        note = ""
        if label in cpu_checked:
            want = pipeline.encode_array(images[1], config, device="cpu")
            check(files[1] == want.file_bytes,
                  f"batch {label} member 1: != the CPU path")
            note = "; member 1 == CPU path"
        print(f"batch {label}: {len(files)} files in "
              f"{-(-len(files) // chunk)} chunks of <= {chunk}, each == "
              f"encode_array on the card{note}", flush=True)

    for label, images in (("1920x1080", hd), ("3840x2160", uhd)):
        geom = default.geometry(images.shape[2], images.shape[1])
        chunk = images[: batch.chunk_size_images(geom)]
        cap = batch.chunk_capacity_bytes(default, geom)
        z = batch.front_entries(batch.upload_chunk(chunk, cuda), default, geom)
        stages = {
            "dispatch_chunk": lambda: batch.dispatch_chunk(
                chunk, default, geom, cap, device=cuda),
            "K4 alone": lambda: entropy_kernel.encode_entries(
                z, geom, cap, entries_per_interval=geom.num_scan_entries),
        }
        parts = ", ".join(
            f"{k} events {cuda_ms(f, reps=5) / len(chunk):.4f}, busy "
            f"{busy_ms(f, reps=5) / len(chunk):.4f}" for k, f in stages.items())
        print(f"device ms/image, chunk of {len(chunk)} x {label} 4:2:0: "
              f"{parts} ({card})", flush=True)
        top = top_device_ops(stages["dispatch_chunk"])
        print(f"device ms/image by operation, dispatch_chunk {len(chunk)} x "
              f"{label}: " + "; ".join(f"{name[:60]} {ms / len(chunk):.4f}"
                                       for name, ms in top)
              + f" ({card})", flush=True)
        n = len(images)
        batch_ms = host_ms(lambda: batch.encode_batch(images, default,
                                                      device=cuda), reps=3)
        loop_ms = host_ms(lambda: [pipeline.encode_array(rgb, default,
                                                         device=cuda)
                                   for rgb in images], reps=3)
        print(f"time batch {n} x {label} 4:2:0: encode_batch "
              f"{batch_ms / n:.3f} ms/image, loop of encode_array "
              f"{loop_ms / n:.3f} ms/image, numpy RGB in -> JFIF bytes out "
              f"({card})", flush=True)
    return counts


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


def trace_overlap(trace_path: str) -> tuple[list[str], int, int, float]:
    """From a torch.profiler chrome trace: (the names of the host-to-device
    copies, how many copies overlap a kernel in time, how many kernels ran,
    the overlapped microseconds)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    overlapping, overlap_us = 0, 0.0
    for c in copies:
        a, b = c["ts"], c["ts"] + c["dur"]
        shared = sum(max(0.0, min(b, k1) - max(a, k0)) for k0, k1 in kernels)
        overlapping += shared > 0
        overlap_us += shared
    return [c["name"] for c in copies], overlapping, len(kernels), overlap_us


def stream_phase(cuda, images_1080, images_4k, card, tmp) -> dict[str, int]:
    """The stream engine, driven (parallel.stream.encode_paths on the card,
    BMP files in, JFIF files written by emit): 64 1080p frames (three
    chunks of <= 21 at the 128 MiB budget) and 15 4K frames (three chunks
    of 5) at 4:2:0, corpus content, in one call (two dimension groups).
    Every file == encode_batch's on the card; 8 of the 1080p files also
    under restart 120, optimize, and optimize with restart 120, each ==
    the single-image card file. Then ms/image and files/s of the stream
    against a synchronous loop (read_batch -> encode_batch -> write, chunk
    by chunk) over the same files, the loader's decode and the writer's
    busy seconds, the pinned and pageable H2D rates, and, under the
    profiler, a check that every host-to-device copy of a 1080p stream run
    is a pinned copy and that at least one overlaps a kernel (of another
    chunk: a chunk's own kernels wait on its copies). Returns the stream
    path's launch counts."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.config import EncoderConfig
    from jpeg_encoder_torch.io import bmp
    from jpeg_encoder_torch.parallel import batch, stream

    default = EncoderConfig()
    out_dir = os.path.join(tmp, "out")
    os.makedirs(out_dir)
    sets = {}
    for label, images in (
            ("1920x1080", variants(list(images_1080.values()), 64)),
            ("3840x2160", variants(list(images_4k.values()), 15))):
        paths = []
        for i, rgb in enumerate(images):
            paths.append(os.path.join(tmp, f"{label}_{i:02d}.bmp"))
            bmp.write(paths[-1], rgb)
        sets[label] = (images, paths)

    def writing(written: dict):
        def emit(path, data):
            dst = os.path.join(out_dir, os.path.basename(path)[:-4] + ".jpg")
            with open(dst, "wb") as f:
                f.write(data)
            written[path] = dst
        return emit

    written, runs = {}, []
    every = sets["1920x1080"][1] + sets["3840x2160"][1]
    counts = counted("stream", lambda: runs.append(stream.encode_paths(
        every, default, writing(written), device=cuda)), ("realdct", "entropy"))
    check(runs[0].encoded == len(every), f"stream encoded {runs[0].encoded}")
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

        # Turns: stream, loop, loop, stream; each the mean of two medians.
        s1, l1, l2, s2 = (host_ms(f, reps=3) for f in
                          (run_stream, run_loop, run_loop, run_stream))
        stream_ms, loop_ms = (s1 + s2) / 2 / n, (l1 + l2) / 2 / n
        last = stream_runs[-1]
        pinned, pageable = h2d_rates(cuda, (chunk, geom.height, geom.width, 3))
        part = paths[:chunk]
        host = np.empty((len(part), geom.height, geom.width, 3), np.uint8)
        read = host_ms(lambda: bmp.read_batch(part), reps=3) / len(part)
        with concurrent.futures.ThreadPoolExecutor(
                len(os.sched_getaffinity(0))) as pool:
            pooled = host_ms(lambda: list(pool.map(
                bmp.read_into, part, host)), reps=3) / len(part)
        print(f"time host BMP input {len(part)} x {label}: read_batch "
              f"(serial reads, threaded decode; the loop's) {read:.3f} "
              f"ms/image, read_into an image a thread of "
              f"{len(os.sched_getaffinity(0))} (the stream's) {pooled:.3f} "
              f"ms/image ({card})", flush=True)
        print(f"time stream {n} x {label} 4:2:0 BMP files -> JFIF files: "
              f"encode_paths {stream_ms:.3f} ms/image ({1e3 / stream_ms:.1f} "
              f"files/s; last run decode {last.decode_seconds:.3f} s, write "
              f"{last.write_seconds:.3f} s of {last.seconds:.3f} s), "
              f"synchronous loop read_batch -> encode_batch -> write "
              f"{loop_ms:.3f} ms/image ({1e3 / loop_ms:.1f} files/s); H2D of "
              f"a {chunk}-image chunk: pinned {pinned:.2f} GB/s, pageable "
              f"{pageable:.2f} GB/s ({card})", flush=True)

    paths = sets["1920x1080"][1]
    trace = os.path.join(tmp, "stream_trace.json")
    for _ in range(3):  # an empty trace is retried, as in busy_ms
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stream.encode_paths(paths, default, writing({}), device=cuda)
        prof.export_chrome_trace(trace)
        names, overlapping, kernels, overlap_us = trace_overlap(trace)
        if names and kernels:
            break
    pageable_copies = [n for n in names if "Pinned" not in n]
    check(names and not pageable_copies,
          f"stream: host-to-device copies not from pinned memory: "
          f"{sorted(set(pageable_copies))} ({len(names)} copies)")
    check(overlapping > 0, f"stream: none of {len(names)} host-to-device "
          f"copies overlapped any of {kernels} kernels")
    print(f"stream profile, {len(paths)} x 1920x1080: {len(names)} "
          f"host-to-device copies, all pinned ({sorted(set(names))}); "
          f"{overlapping} overlap a kernel of another chunk, "
          f"{overlap_us:.0f} us in all ({card})", flush=True)
    return counts


def interval_pairs(z, geom):
    """(name, kernel, plain) of K4 in interval mode (restart every 120 MCUs,
    one MCU row at 1080p, and every MCU) and of K5 on the assemble tier's
    rows for one MCU row and for the unbroken scan, on z's device."""
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
    for interval in (120, None):
        epi = (geom.num_scan_entries if interval is None
               else entropy_ops.entries_per_interval(geom, interval))
        slot_bits, slot_lens = entropy_ops.symbolize(
            z, geom.h_factor * geom.v_factor, entries_per_interval=epi)
        words, offsets, row_bits = scan.assemble_operands(
            slot_bits, slot_lens, epi)
        cap = (pipeline.default_capacity_bytes(geom) if interval is None
               else pipeline.restart_default_capacity_bytes(geom, interval))
        pairs.append((
            "pack" if interval else "pack one row",
            functools.partial(pack_kernel.assemble_bitstream, words, offsets,
                              cap),
            functools.partial(entropy_ops.assemble_bitstream, words, offsets,
                              cap)))
    return pairs


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes
# a second, float32 FLOP a second outside the tensor cores (a fused
# multiply-add counts 2), dense bf16 FLOP a second on the tensor cores.
# Without FMAs the FP32 pipes issue half that many operations; INT32 has
# half the FP32 lanes, so a quarter of the FLOP rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
FP32_ISSUE_OPS = FP32_FLOPS / 2
INT32_OPS = FP32_FLOPS / 4
# Operations per 8x8 block: RealDCT, the least work its function needs, 8
# first products px[k] * B[u][x_k] a step (one per u, shared by the 8
# coefficients of that u: the same operands give the same rounded product),
# 64 second products and 64 adds a step, over 64 steps, then a scale
# multiply and a divide a coefficient; binDCT, 16 8-point lifts of 43
# integer operations, 64 level shifts, and 64 divides by invariant integers
# of MAGIC_DIVIDE_OPS each ((x + mulhi(m, x)) >> s) - (x >> 31)); --fast-dct,
# the three bf16 split products of 64 x 64 multiply-adds (FAST_BLOCK_FLOPS,
# at BF16_TENSOR_FLOPS).
REALDCT_BLOCK_OPS = 8 * 64 + 64 * 64 * 2 + 2 * 64
MAGIC_DIVIDE_OPS = 5
BINDCT_BLOCK_OPS = 16 * 43 + 64 + 64 * MAGIC_DIVIDE_OPS
FAST_BLOCK_FLOPS = 3 * 2 * 64 * 64


def bound(num_bytes: int, ops: int = 0, rate: float = 1.0) -> tuple:
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the operations over their peak."""
    t_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_phase(cuda, images_1080, images_4k, card) -> tuple[dict, ...]:
    """Kernel vs plain times (CUDA events around each call, and the
    device-busy time inside it), the device time of each encode stage, and
    the end-to-end time per image, at 1080p and 4K (4:2:0, corpus
    content). Returns the 1080p kernel and plain event times, the kernels'
    device-busy times, each kernel's bound on the same inputs, and the time
    of one PyTorch call computing the same function where there is one
    (K2's matmul), by events and device-busy."""
    import dataclasses

    from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.ops import dct as dct_ops
    from jpeg_encoder_torch.ops import entropy as entropy_ops
    from jpeg_encoder_torch.ops import sample

    config = EncoderConfig()
    bin_dct = EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)
    fast = EncoderConfig(fast_dct=True)
    times, busy = {}, {}
    for label, rgb in (
        ("1920x1080", next(iter(images_1080.values()))),
        ("3840x2160", next(iter(images_4k.values()))),
    ):
        geom = config.geometry(rgb.shape[1], rgb.shape[0])
        rgb_dev = torch.from_numpy(rgb).to(cuda)
        planes = front_planes(rgb_dev, geom)
        coeffs = dct_kernel.real_dct_quant_planes_zigzag(*planes)
        z = entropy_ops.marshal_scan_inputs(*coeffs, geom)
        cap = pipeline.default_capacity_bytes(geom)
        y_blocks = sample.blockify(planes[0]).contiguous()
        block_pairs_1080 = [
            ("realdct_blocks",
             lambda: dct_kernel.real_dct_quant_zigzag(y_blocks, True),
             lambda: dct_ops.real_dct_quant_zigzag(y_blocks, True)),
            ("bindct_blocks",
             lambda: dct_kernel.bin_dct_quant_zigzag(y_blocks, True),
             lambda: dct_ops.bin_dct_quant_zigzag(y_blocks, True)),
        ]
        if label == "1920x1080":
            bounds = kernel_bounds(geom, planes, z, cap, y_blocks)
            library = dict.fromkeys(bounds)
            library_busy = dict.fromkeys(bounds)
            shifted = (torch.cat([sample.blockify(p) for p in planes])
                       .to(torch.int16) - 128).to(torch.float32)
            kzz = dct_ops.fast_device_constant(cuda)
            matmul = lambda: torch.matmul(shifted, kzz.T)
            library["fastdct"] = cuda_ms(matmul)
            library_busy["fastdct"] = busy_ms(matmul)
            print(f"time library torch.matmul ({shifted.shape[0]}, 64) x "
                  f"(64, 64) f32, TF32 off (K2's product): events "
                  f"{library['fastdct']:.4f} ms, device-busy "
                  f"{fmt(library_busy['fastdct'])} ms ({card})", flush=True)
            for _ in range(3):  # an empty trace is retried, as in busy_ms
                ops = device_ops(lambda: entropy_kernel.encode_entries(
                    z, geom, cap))
                count = sum(c for _, c, _ in ops)
                if count:
                    break
            check(0 < count <= 2, "one K4 call ran other than the memset and "
                  f"one kernel: {ops}")
            print(f"K4 device operations per call, 1920x1080 4:2:0 unbroken: "
                  f"{count:g} (" + "; ".join(f"{name[:50]} x{c:g}"
                                              for name, c, _ in ops)
                  + f") ({card})", flush=True)

        # Turns: plain, kernel, kernel, plain; each figure is the mean of
        # the two runs' medians.
        for name, kernel, plain in [
            ("realdct",
             lambda: dct_kernel.real_dct_quant_planes_zigzag(*planes),
             lambda: dct_ops.real_dct_quant_planes_zigzag(*planes)),
            ("entropy",
             lambda: entropy_kernel.encode_entries(z, geom, cap),
             lambda: entropy_ops.encode_entries(z, geom, cap)),
            ("bindct",
             lambda: dct_kernel.bin_dct_quant_planes_zigzag(*planes),
             lambda: dct_ops.bin_dct_quant_planes_zigzag(*planes)),
            ("fastdct",
             lambda: dct_kernel.real_dct_fast_planes_zigzag(*planes),
             lambda: dct_ops.real_dct_fast_planes_zigzag(*planes)),
        ] + (interval_pairs(z, geom) + block_pairs_1080
             if label == "1920x1080" else []):
            if label == "1920x1080":
                KERNEL_CALLS[name] = kernel
            p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
            times.setdefault(name, ((k1 + k2) / 2, (p1 + p2) / 2))
            kernel_busy = busy_ms(kernel)
            busy.setdefault(name, kernel_busy)  # 1080p first
            print(f"time {name} {label} 4:2:0: kernel {(k1 + k2) / 2:.4f} ms, "
                  f"plain {(p1 + p2) / 2:.4f} ms; device-busy kernel "
                  f"{fmt(kernel_busy)} ms, plain {fmt(busy_ms(plain))} ms "
                  f"({card})", flush=True)

        cap120 = pipeline.restart_default_capacity_bytes(geom, 120)
        stages = {
            "colour+pad+subsample": lambda: front_planes(rgb_dev, geom),
            "realdct kernel":
                lambda: dct_kernel.real_dct_quant_planes_zigzag(*planes),
            "scan marshal":
                lambda: entropy_ops.marshal_scan_inputs(*coeffs, geom),
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
    return times, busy, bounds, library, library_busy


KERNEL_CALLS = {}  # timing name -> its 1080p kernel call (timing_phase)


def parent_phase(parent: str, cuda, card) -> None:
    """With --parent DIR, a checkout of an earlier commit: every kernel
    whose source differs from DIR's is built from DIR too, and both builds
    run timing_phase's 1080p 4:2:0 calls of that kernel (same operands):
    their results must be equal, and their device-busy times are printed,
    in turns (parent, this tree, this tree, parent). The parent's C entry
    must take the same arguments."""
    import filecmp

    from jpeg_encoder_torch.kernels import _build
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.kernels import pack as pack_kernel

    parent_csrc = os.path.join(parent, "jpeg_encoder_torch", "csrc")
    changed = [k for k in all_kernels()
               if not filecmp.cmp(os.path.join(_build.CSRC, f"{k.lib}.cu"),
                                  os.path.join(parent_csrc, f"{k.lib}.cu"),
                                  shallow=False)]
    print(f"parent {parent}: kernels whose source differs: "
          f"{[k.name for k in changed]}", flush=True)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        _build.build(sorted({k.lib for k in changed}), csrc=parent_csrc,
                     build_dir=tmp)
        for k in changed:
            module, attr = next(
                (m, a) for m in (dct_kernel, entropy_kernel, pack_kernel)
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


def kernel_bounds(geom, planes, z, cap, y_blocks) -> dict[str, tuple]:
    """Each kernel's bound on the inputs its timing uses at 1080p 4:2:0
    (every input byte read once, every output byte written once)."""
    from jpeg_encoder_torch import pipeline, scan
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    n = sum(p.numel() for p in planes) // 64
    plane_bytes = sum(p.numel() for p in planes) + n * 64 * 2
    n_y = y_blocks.shape[0]
    epi = entropy_ops.entries_per_interval(geom, 120)
    rows = -(-geom.num_scan_entries // epi)
    cap120 = pipeline.restart_default_capacity_bytes(geom, 120)
    slot_bits, slot_lens = entropy_ops.symbolize(
        z, geom.h_factor * geom.v_factor, entries_per_interval=epi)
    pack_row_bits = scan.assemble_operands(slot_bits, slot_lens, epi)[2]
    bounds = {
        "realdct": bound(plane_bytes, n * REALDCT_BLOCK_OPS, FP32_ISSUE_OPS),
        "fastdct": bound(plane_bytes, n * FAST_BLOCK_FLOPS,
                         BF16_TENSOR_FLOPS),
        "bindct": bound(plane_bytes, n * BINDCT_BLOCK_OPS, INT32_OPS),
        # z in, the two (2, 256) tables, one row of cap bytes and its count.
        "entropy": bound(z.numel() * 2 + 4096 + cap + 4),
        # K5 at restart 120 (timing's "pack"): 8 bytes of offset an entry
        # and the live words in (a row's bit count over 32, rounded up: the
        # words past an entry's bits are zero and need not be read), one
        # row of cap120 bytes per interval out.
        "pack": bound(rows * epi * 8 + int(((pack_row_bits + 31) // 32).sum())
                      * 4 + rows * cap120),
        "realdct_blocks": bound(n_y * 64 * 5, n_y * REALDCT_BLOCK_OPS,
                                FP32_ISSUE_OPS),
        "bindct_blocks": bound(n_y * 64 * 5, n_y * BINDCT_BLOCK_OPS,
                               INT32_OPS),
    }
    return bounds


def all_kernels():
    """Every kernel of the port: K1 realdct, K4 entropy, K3 bindct, K2
    fastdct, K5 pack, K6a/b realdct_blocks, K6c bindct_blocks."""
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.kernels import pack as pack_kernel

    return (dct_kernel.REALDCT, entropy_kernel.ENTROPY, dct_kernel.BINDCT,
            dct_kernel.FASTDCT, pack_kernel.PACK, dct_kernel.REALDCT_BLOCKS,
            dct_kernel.BINDCT_BLOCKS)


# The kernels each path must launch.
E2E_KERNELS = ("realdct", "entropy", "bindct", "fastdct", "pack")
BATCH_KERNELS = ("realdct", "entropy", "bindct", "fastdct")
BLOCK_KERNELS = ("realdct_blocks", "bindct_blocks")


def counted(path: str, drive, required) -> dict[str, int]:
    """Set every launch count to 0, drive one path, read the counts; fail
    unless every kernel in `required` launched."""
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    drive()
    counts = {k.name: k.launches for k in kernels}
    check(all(counts[name] for name in required),
          f"a kernel of the {path} path never ran: {counts}")
    print(f"{path} launches: {counts}", flush=True)
    return counts


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--parent", metavar="DIR",
        help="a checkout of an earlier commit: also time its builds of the "
             "kernels whose sources differ, on the same operands")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from jpeg_encoder_torch.utils import corpus
    from jpeg_encoder_torch.kernels import _build

    cuda = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
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
    errors["fastdct"] = k2_phase(cuda, rng)
    errors["entropy"] = max(k4_phase(cuda, images_1080),
                            k4_interval_phase(cuda, images_1080),
                            k4_batch_phase(cuda, images_1080))
    errors["pack"] = k5_phase(cuda, images_1080)
    errors.update(k6_phase(cuda, rng))
    phase_s = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        path_counts = [e2e_phase(cuda, images_1080, images_4k, tmp)]
    phase_s["e2e"] = time.perf_counter() - t0
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
    times, busy, bounds, library, library_busy = timing_phase(
        cuda, images_1080, images_4k, card)
    phase_s["timing"] = time.perf_counter() - t0
    if args.parent:
        t0 = time.perf_counter()
        parent_phase(args.parent, cuda, card)
        phase_s["parent"] = time.perf_counter() - t0
    print(f"K2 fastdct 1920x1080 4:2:0 device-busy {fmt(busy['fastdct'])} ms "
          f"vs torch.matmul (its product alone) {fmt(library_busy['fastdct'])}"
          f" ms; mismatch rates: " + " | ".join(FAST_RATES) + f" ({card})",
          flush=True)
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
