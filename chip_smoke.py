"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from jpeg_encoder_torch/csrc (one nvcc per
source, all at once), holds each against its plain PyTorch version (K1
RealDCT, K4 entropy and K3 binDCT exactly; K2 --fast-dct to max |diff| 1 at
a mismatch rate below 1e-3, and 5e-4 against K1), drives the main paths
(BMP file -> JFIF file with jpeg_encoder_torch.pipeline.encode_file on the
card) with RealDCT at 1080p, 4K and odd geometries at every subsampling
ratio, with binDCT (bug-parity and descaled) at 1080p and odd geometries,
and with --fast-dct at 1080p, checks every exact file byte for byte
against the port's CPU path (and small ones against the NumPy oracle) and
the --fast-dct file against the CPU entropy coder run on the card's own
coefficients, and times the kernels and the end-to-end encodes. Any
mismatch or error exits non-zero before the final line, which is

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


def k4_phase(cuda, images_1080) -> float:
    """Entropy kernel vs its plain version on CPU tensors; max |error|
    over the payload bytes within capacity and the bit counts."""
    from jpeg_encoder_tpu.config import EncoderConfig
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.kernels import dct as dct_kernel
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

    for ratio in ((4, 2, 0), (4, 2, 2), (4, 4, 4)):
        config = EncoderConfig(subsampling_ratio=ratio)
        geom = config.geometry(1920, 1080)
        cap = pipeline.default_capacity_bytes(geom)
        for name, rgb in images_1080.items():
            coeffs = dct_kernel.real_dct_quant_planes_zigzag(
                *front_planes(torch.from_numpy(rgb).to(cuda), geom)
            )
            z = entropy_ops.marshal_scan_inputs(*coeffs, geom).cpu()
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

    from jpeg_encoder_tpu import oracle
    from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
    from jpeg_encoder_tpu.io import bmp, jfif
    from jpeg_encoder_torch import pipeline

    rng = np.random.default_rng(11)
    cases = []  # (label, rgb, config, check: "cpu", "oracle" or "fast")
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
    paths = []
    for i, (label, rgb, config, _) in enumerate(cases):
        src = os.path.join(tmp, f"case{i}.bmp")
        bmp.write(src, rgb)
        paths.append((src, os.path.join(tmp, f"case{i}_cuda.jpg")))

    # The main paths on the card, alone between the reset and the read.
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    for (label, _, config, _), (src, dst) in zip(cases, paths):
        pipeline.encode_file(src, dst, config, device=cuda)
    counts = {k.name: k.launches for k in kernels}
    check(all(counts.values()), f"a kernel of the main paths never ran: {counts}")
    print(f"e2e launches: {counts}", flush=True)

    for (label, rgb, config, kind), (src, dst) in zip(cases, paths):
        with open(dst, "rb") as f:
            got = f.read()
        if kind == "fast":
            check_fast_file(cuda, label, rgb, config, got)
            continue
        want = pipeline.encode_array(rgb, config, device="cpu").file_bytes
        check(got == want, f"e2e {label}: card file != CPU file")
        if kind == "oracle":
            golden = oracle.encode_oracle(rgb, config)
            check(got == jfif.assemble(golden.geom, golden.entropy_bytes,
                                       quality=config.quality),
                  f"e2e {label}: file != oracle")
        print(f"e2e {label}: {len(got)} B, card == CPU"
              + (" == oracle" if kind == "oracle" else ""), flush=True)

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


def timing_phase(cuda, images_1080, images_4k, card) -> dict[str, tuple]:
    """Kernel vs plain times (CUDA events around each call, and the
    device-busy time inside it), the device time of each encode stage, and
    the end-to-end time per image, at 1080p and 4K (4:2:0, corpus
    content). Returns the 1080p kernel and plain event times."""
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
        for name, kernel, plain in (
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
        ):
            p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
            times.setdefault(name, ((k1 + k2) / 2, (p1 + p2) / 2))
            print(f"time {name} {label} 4:2:0: kernel {(k1 + k2) / 2:.4f} ms, "
                  f"plain {(p1 + p2) / 2:.4f} ms; device-busy kernel "
                  f"{fmt(busy_ms(kernel))} ms, plain {fmt(busy_ms(plain))} ms "
                  f"({card})", flush=True)

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
        }
        parts = ", ".join(f"{k} {cuda_ms(f):.4f}" for k, f in stages.items())
        print(f"device ms {label} 4:2:0: {parts} ({card})", flush=True)
        parts = ", ".join(f"{k} {fmt(busy_ms(f))}" for k, f in stages.items()
                          if k.startswith("encode_core"))
        print(f"device-busy ms {label} 4:2:0: {parts} ({card})", flush=True)

        variants = [("real-dct", config)]
        if label == "1920x1080":
            variants += [("bin-dct", bin_dct), ("fast-dct", fast)]
        for name, cfg in variants:
            ms = host_ms(lambda: pipeline.encode_array(rgb, cfg, device=cuda))
            print(f"time e2e encode_array {name} {label} 4:2:0: {ms:.3f} "
                  f"ms/image, numpy RGB in -> JFIF bytes out ({card})",
                  flush=True)
    return times


def all_kernels():
    """Every kernel of the port: K1 realdct, K4 entropy, K3 bindct, K2
    fastdct."""
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel

    return (dct_kernel.REALDCT, entropy_kernel.ENTROPY, dct_kernel.BINDCT,
            dct_kernel.FASTDCT)


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
    errors["entropy"] = k4_phase(cuda, images_1080)
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
