"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from jpeg_encoder_torch/csrc, holds each
against its plain PyTorch version, drives the main path (BMP file -> JFIF
file with jpeg_encoder_torch.pipeline.encode_file on the card) at 1080p,
4K and odd geometries at every subsampling ratio, checks every file
byte for byte against the port's CPU path (and small ones against the
NumPy oracle), and times the kernels and the end-to-end encode. Any
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


def k1_phase(cuda, rng) -> float:
    """RealDCT kernel vs its plain version on CPU tensors; max |error|."""
    from jpeg_encoder_torch.kernels import dct as dct_kernel

    worst = 0
    for label, y_shape, c_shape in (
        ("1080p 4:2:0", (1088, 1920), (544, 960)),
        ("1080p 4:4:4", (1080, 1920), (1080, 1920)),
    ):
        planes = [torch.from_numpy(rng.integers(0, 256, y_shape, dtype=np.uint8))]
        planes += [
            torch.from_numpy(rng.integers(0, 256, c_shape, dtype=np.uint8))
            for _ in range(2)
        ]
        for quality in (None, 90):
            got = dct_kernel.real_dct_quant_planes_zigzag(
                *(p.to(cuda) for p in planes), quality
            )
            torch.cuda.synchronize()
            want = dct_kernel.real_dct_quant_planes_zigzag(*planes, quality)
            for g, w in zip(got, want):
                err = int((g.cpu().to(torch.int32) - w.to(torch.int32)).abs().max())
                worst = max(worst, err)
                check(err == 0, f"K1 {label} q={quality}: max |err| {err}")
        print(f"K1 {label}: kernel == plain (exact), quality None and 90", flush=True)
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


def e2e_phase(cuda, images_1080, images_4k, tmp) -> dict[str, int]:
    """Drive the main path on the card, then hold every file against the
    CPU path (and the small ones against the oracle). Returns the kernel
    launch counts of the card runs alone."""
    from jpeg_encoder_tpu import oracle
    from jpeg_encoder_tpu.config import EncoderConfig
    from jpeg_encoder_tpu.io import bmp, jfif
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel

    rng = np.random.default_rng(11)
    cases = []  # (label, rgb, config, oracle_check)
    default = EncoderConfig()
    for name, rgb in images_1080.items():
        cases.append((f"{name} 1920x1080 4:2:0", rgb, default, False))
    for name, rgb in images_4k.items():
        cases.append((f"{name} 3840x2160 4:2:0", rgb, default, False))
    first = next(iter(images_1080.values()))
    for ratio in ((4, 2, 2), (4, 4, 4)):
        cases.append((f"1920x1080 {ratio}", first,
                      EncoderConfig(subsampling_ratio=ratio), False))
    cases.append(("1920x1080 4:2:0 quality 90", first,
                  EncoderConfig(quality=90), False))
    for width, height in ((517, 333), (33, 17), (1921, 1089)):
        rgb = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        for ratio in ((4, 2, 0), (4, 2, 2), (4, 4, 4)):
            cases.append((f"{width}x{height} {ratio}", rgb,
                          EncoderConfig(subsampling_ratio=ratio),
                          width < 1000))
    paths = []
    for i, (label, rgb, config, _) in enumerate(cases):
        src = os.path.join(tmp, f"case{i}.bmp")
        bmp.write(src, rgb)
        paths.append((src, os.path.join(tmp, f"case{i}_cuda.jpg")))

    # The main path on the card, alone between the reset and the read.
    dct_kernel.launches = 0
    entropy_kernel.launches = 0
    for (label, _, config, _), (src, dst) in zip(cases, paths):
        pipeline.encode_file(src, dst, config, device=cuda)
    counts = {"realdct": dct_kernel.launches, "entropy": entropy_kernel.launches}
    check(counts["realdct"] > 0 and counts["entropy"] > 0,
          f"the main path launched no kernel: {counts}")

    for (label, rgb, config, with_oracle), (src, dst) in zip(cases, paths):
        with open(dst, "rb") as f:
            got = f.read()
        want = pipeline.encode_array(rgb, config, device="cpu").file_bytes
        check(got == want, f"e2e {label}: card file != CPU file")
        if with_oracle:
            golden = oracle.encode_oracle(rgb, config)
            check(got == jfif.assemble(golden.geom, golden.entropy_bytes,
                                       quality=config.quality),
                  f"e2e {label}: file != oracle")
        print(f"e2e {label}: {len(got)} B, card == CPU"
              + (" == oracle" if with_oracle else ""), flush=True)
    return counts


def timing_phase(cuda, images_1080, images_4k, card) -> dict[str, tuple]:
    """Kernel vs plain times, the device time of each encode stage, and
    the end-to-end time per image, at 1080p and 4K (4:2:0, corpus
    content). Returns the 1080p kernel and plain times."""
    from jpeg_encoder_tpu.config import EncoderConfig
    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel
    from jpeg_encoder_torch.ops import dct as dct_ops
    from jpeg_encoder_torch.ops import entropy as entropy_ops

    config = EncoderConfig()
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
        ):
            p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
            times.setdefault(name, ((k1 + k2) / 2, (p1 + p2) / 2))
            print(f"time {name} {label} 4:2:0: kernel {(k1 + k2) / 2:.4f} ms, "
                  f"plain {(p1 + p2) / 2:.4f} ms ({card})", flush=True)

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
        }
        parts = ", ".join(f"{k} {cuda_ms(f):.4f}" for k, f in stages.items())
        print(f"device ms {label} 4:2:0: {parts} ({card})", flush=True)

        ms = host_ms(lambda: pipeline.encode_array(rgb, config, device=cuda))
        print(f"time e2e encode_array {label} 4:2:0: {ms:.3f} ms/image, "
              f"numpy RGB in -> JFIF bytes out ({card})", flush=True)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from jpeg_encoder_tpu.utils import corpus
    from jpeg_encoder_torch.kernels import _build
    from jpeg_encoder_torch.kernels import dct as dct_kernel
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel

    cuda = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(cuda)}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> {_build.LIB_PATH} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(20260)
    images_1080 = {name: fn(1080, 1920) for name, fn in corpus.CORPUS.items()}
    images_4k = {name: corpus.CORPUS[name](2160, 3840)
                 for name in ("landscape", "architecture")}

    k1_err = k1_phase(cuda, rng)
    k4_err = k4_phase(cuda, images_1080)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as tmp:
        counts = e2e_phase(cuda, images_1080, images_4k, tmp)
    times = timing_phase(cuda, images_1080, images_4k, card)
    check("jax" not in sys.modules, "something imported JAX")

    kernels = []
    for name, module, err in (
        ("realdct", dct_kernel, k1_err), ("entropy", entropy_kernel, k4_err),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": module.SOURCE,
            "replaces": module.REPLACES, "launches": counts[name],
            "max_abs_err": err, "ms": times[name][0], "plain_ms": times[name][1],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
