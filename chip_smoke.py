"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from jpeg_encoder_torch/csrc (one nvcc per
source, all at once), holds each against its plain PyTorch version (K1
RealDCT, K4 entropy, K3 binDCT and K5 bitstream assembly exactly, K4 also
over restart intervals with live_entries; K2 --fast-dct to max |diff| 1 at
a mismatch rate below 1e-3, and 5e-4 against K1), drives the main paths
(BMP file -> JFIF file with jpeg_encoder_torch.pipeline.encode_file on the
card) with RealDCT at 1080p, 4K and odd geometries at every subsampling
ratio, with binDCT (bug-parity and descaled) at 1080p and odd geometries,
with --fast-dct at 1080p, with restart markers (1, 7, 120 and 10000 MCUs
at 1080p, RealDCT and binDCT, every ratio; 240 at 4K), with optimized
Huffman tables (alone and with restart markers) and with the assemble
packer (K5; Annex K and optimized tables), checks every exact file byte
for byte against the port's CPU path (and small ones against the NumPy
oracle, whose optimized tables count its own symbols) and the --fast-dct file
against the CPU entropy coder run on the card's own coefficients, and
times the kernels and the end-to-end encodes. Any mismatch or error exits
non-zero before the final line, which is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Needs one CUDA card, nvcc and no network; imports no JAX.
"""

from __future__ import annotations

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


def busy_ms(fn, reps: int = REPS) -> float | None:
    """Device-busy milliseconds per fn() from torch.profiler: the summed
    durations of the kernels, copies and fills it ran, without the gaps in
    which the card waits for the host to launch them. None if the profiler
    saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return total_us / 1e3 / reps if total_us else None


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


def k2_phase(cuda, rng) -> float:
    """--fast-dct kernel vs its plain version (on CPU tensors) and vs the
    exact K1 on the card; max |error| against the plain version."""
    from jpeg_encoder_torch.kernels import dct as dct_kernel

    # The plain version's matmul must be full float32, never TF32.
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32")
    worst = 0
    for label, y_shape, c_shape in PLANE_SHAPES:
        planes = random_planes(rng, y_shape, c_shape)
        dev = [p.to(cuda) for p in planes]
        for quality in (None, 90):
            got = torch.cat(dct_kernel.real_dct_fast_planes_zigzag(*dev, quality))
            torch.cuda.synchronize()
            got = got.cpu().to(torch.int32)
            rates = []
            for name, want, limit in (
                ("plain", dct_kernel.real_dct_fast_planes_zigzag(*planes, quality),
                 1e-3),
                ("K1", dct_kernel.real_dct_quant_planes_zigzag(*dev, quality),
                 5e-4),
            ):
                d = (got - torch.cat(want).cpu().to(torch.int32)).abs()
                err, rate = int(d.max()), float((d > 0).double().mean())
                if name == "plain":
                    worst = max(worst, err)
                check(err <= 1 and rate < limit,
                      f"K2 {label} q={quality} vs {name}: max |err| {err}, "
                      f"mismatch rate {rate}")
                rates.append(f"vs {name} max |err| {err}, mismatch rate "
                             f"{rate:.3e} ({int((d > 0).sum())} of {d.numel()})")
            print(f"K2 {label} q={quality}: " + "; ".join(rates), flush=True)
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
    from jpeg_encoder_tpu.config import EncoderConfig
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
    from jpeg_encoder_tpu.config import EncoderConfig
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


def k5_phase(cuda, images_1080) -> float:
    """K5 vs its plain version on CPU tensors: the assemble tier's operands
    of 1080p corpus content at 4:2:0 and 4:4:4, as one row (the unbroken
    scan) and as one row per restart interval of 120 and of 1 MCUs, at a
    fitting capacity and at 16 bytes a row. Returns the max |error|."""
    from jpeg_encoder_tpu.config import EncoderConfig
    from jpeg_encoder_torch import scan
    from jpeg_encoder_torch.kernels import pack as pack_kernel
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    worst = 0
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
                got = pack_kernel.assemble_bitstream(
                    words.to(cuda), offsets.to(cuda), cap)
                torch.cuda.synchronize()
                want = pack_kernel.assemble_bitstream(words, offsets, cap)
                err = max_err(got, want)
                worst = max(worst, err)
                check(err == 0, f"K5 {ratio} interval {interval} capacity "
                      f"{cap}: max |err| {err}")
            print(f"K5 1080p {ratio} {words.shape[0]} rows of "
                  f"{words.shape[1]} entries: kernel == plain (capacity "
                  f"{fit} B and 16 B a row)", flush=True)
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
    from jpeg_encoder_tpu import oracle

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
    1-padded segment per restart interval. Nothing of the port is used."""
    import dataclasses

    from jpeg_encoder_tpu import oracle, tables
    from jpeg_encoder_tpu.io import jfif

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

    from jpeg_encoder_tpu import tables
    from jpeg_encoder_tpu.io import jfif
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

    from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_tpu.io import bmp
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
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    for (label, _, config, _, packer), (src, dst) in zip(cases, paths):
        if packer == "fused":
            pipeline.encode_file(src, dst, config, device=cuda)
            continue
        result = pipeline.encode_array(bmp.read(src), config, device=cuda,
                                       packer=packer)
        with open(dst, "wb") as f:
            f.write(result.file_bytes)
    counts = {k.name: k.launches for k in kernels}
    check(all(counts.values()), f"a kernel of the main paths never ran: {counts}")
    print(f"e2e launches: {counts}", flush=True)

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


def timing_phase(cuda, images_1080, images_4k, card) -> dict[str, tuple]:
    """Kernel vs plain times (CUDA events around each call, and the
    device-busy time inside it), the device time of each encode stage, and
    the end-to-end time per image, at 1080p and 4K (4:2:0, corpus
    content). Returns the 1080p kernel and plain event times."""
    import dataclasses

    from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.ops import dct as dct_ops
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    config = EncoderConfig()
    bin_dct = EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)
    fast = EncoderConfig(fast_dct=True)
    times = {}
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
        ] + (interval_pairs(z, geom) if label == "1920x1080" else []):
            p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
            times.setdefault(name, ((k1 + k2) / 2, (p1 + p2) / 2))
            print(f"time {name} {label} 4:2:0: kernel {(k1 + k2) / 2:.4f} ms, "
                  f"plain {(p1 + p2) / 2:.4f} ms; device-busy kernel "
                  f"{fmt(busy_ms(kernel))} ms, plain {fmt(busy_ms(plain))} ms "
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
    return times


def all_kernels():
    """Every kernel of the port: K1 realdct, K4 entropy, K3 bindct, K2
    fastdct, K5 pack."""
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.kernels import pack as pack_kernel

    return (dct_kernel.REALDCT, entropy_kernel.ENTROPY, dct_kernel.BINDCT,
            dct_kernel.FASTDCT, pack_kernel.PACK)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from jpeg_encoder_tpu.utils import corpus
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
                            k4_interval_phase(cuda, images_1080))
    errors["pack"] = k5_phase(cuda, images_1080)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        counts = e2e_phase(cuda, images_1080, images_4k, tmp)
    times = timing_phase(cuda, images_1080, images_4k, card)
    check("jax" not in sys.modules, "something imported JAX")

    kernels = [{
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": counts[k.name],
        "max_abs_err": errors[k.name], "ms": times[k.name][0],
        "plain_ms": times[k.name][1],
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
