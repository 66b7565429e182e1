"""Byte-exactness on the device against the NumPy oracle:
tools/hw_parity_sweep.py for the port.

    python -m jpeg_encoder_torch.bench.parity [--color | --corpus]
        [--device cuda|cpu]

The default sweep encodes the tool's 24 cases (3 ratios x {RealDCT,
binDCT} x 4 content kinds, the geometries (96,160), (89,157), (96,129)
and (130,17) taken on a diagonal stride, default_rng(123)) with
pipeline.encode_array on the device and compares each file byte for byte
with the oracle's (jpeg_encoder_torch/oracle.py). --corpus does the same
for the 4 corpus frames at 256x384 x 3 ratios x {RealDCT, binDCT}.
--color converts all 2^24 RGB triples, as one 4096x4096 image, through
the front at 4:4:4 (kernels/front.planes: the F1 kernel on a card) on the
device and compares every channel value
with oracle.rgb_to_ycbcr_exact (--step S takes every S-th value of each
channel instead). Every run exits 1 on any mismatch; the last line of
stdout is one JSON line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from jpeg_encoder_torch import oracle, pipeline
from jpeg_encoder_torch.bench import timing
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_torch.io import jfif
from jpeg_encoder_torch.kernels import front as front_kernel
from jpeg_encoder_torch.parallel.devices import resolve_device
from jpeg_encoder_torch.utils import corpus

RATIOS = ((4, 4, 4), (4, 2, 2), (4, 2, 0))
ALGORITHMS = (DctAlgorithm.REAL_DCT, DctAlgorithm.BIN_DCT)
DIMS = ((96, 160), (89, 157), (96, 129), (130, 17))


def content(rng: np.random.Generator, kind: int, h: int, w: int):
    """The tool's content kinds: 0 noise, 1 gradient + mild noise, 2 flat,
    3 binary."""
    if kind == 0:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == 1:
        x = np.linspace(0, 255, w)[None, :, None]
        y = np.linspace(0, 255, h)[:, None, None]
        return (
            ((x + y) / 2 + rng.normal(0, 3, (h, w, 3))).clip(0, 255)
        ).astype(np.uint8)
    if kind == 2:
        return np.full((h, w, 3), rng.integers(0, 256), np.uint8)
    return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)


def geometry_cases():
    """The tool's 24 (label, config, rgb) cases, in its order: geometry
    cycles on the diagonal stride (i + i // 4) so that every content kind
    meets several geometries."""
    rng = np.random.default_rng(123)
    combos = [(ratio, alg, kind) for ratio in RATIOS for alg in ALGORITHMS
              for kind in range(4)]
    for i, (ratio, alg, kind) in enumerate(combos):
        h, w = DIMS[(i + i // len(DIMS)) % len(DIMS)]
        config = EncoderConfig(subsampling_ratio=ratio, dct_algorithm=alg)
        yield (f"ratio={ratio} alg={alg.value} kind={kind} {w}x{h}", config,
               content(rng, kind, h, w))


def corpus_cases(height: int = 256, width: int = 384):
    """The 4 corpus frames x 3 ratios x {RealDCT, binDCT}."""
    for name, rgb in corpus.images(height, width).items():
        for ratio in RATIOS:
            for alg in ALGORITHMS:
                config = EncoderConfig(subsampling_ratio=ratio,
                                       dct_algorithm=alg)
                yield f"{name} ratio={ratio} alg={alg.value}", config, rgb


def oracle_file(rgb: np.ndarray, config: EncoderConfig) -> bytes:
    gold = oracle.encode_oracle(rgb, config)
    return jfif.assemble(gold.geom, gold.entropy_bytes)


def sweep(cases, device: torch.device) -> tuple[int, list[str]]:
    """(cases run, labels of the files that differ from the oracle's)."""
    count, bad = 0, []
    for label, config, rgb in cases:
        got = pipeline.encode_array(rgb, config, device=device).file_bytes
        count += 1
        if got != oracle_file(rgb, config):
            bad.append(label)
            print(f"MISMATCH: {label}", flush=True)
    return count, bad


def color_grid(step: int = 1) -> np.ndarray:
    """Every step-th value of each channel as an (n, n*n, 3) image; step 1
    is all 2^24 triples as 4096x4096."""
    values = np.arange(0, 256, step, dtype=np.uint8)
    r, g, b = np.meshgrid(values, values, values, indexing="ij")
    n = len(values)
    side = 4096 if step == 1 else n
    return np.stack([r.ravel(), g.ravel(), b.ravel()], -1).reshape(
        side, n ** 3 // side, 3)


def color_mismatches(rgb: np.ndarray, device: torch.device) -> int:
    """Channel values of the front (kernels/front.planes at 4:4:4: on a
    card the F1 kernel, on the CPU its plain version) on `device` that
    differ from the oracle's colour conversion."""
    height, width = rgb.shape[:2]
    geom = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(width, height)
    got = front_kernel.planes(timing.resident(rgb, device), geom)
    want = oracle.rgb_to_ycbcr_exact(rgb)
    return sum(int((g[:height, :width].cpu().numpy() != w).sum())
               for g, w in zip(got, want))


def main(argv: list[str] | None = None) -> int:
    ap = timing.parser(__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--color", action="store_true",
                      help="all 2^24 RGB triples through the front kernel")
    mode.add_argument("--corpus", action="store_true",
                      help="4 corpus frames x 3 ratios x 2 algorithms")
    ap.add_argument("--step", type=int, default=1,
                    help="--color: every S-th value of each channel")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = timing.card_line(device)
    if args.color:
        rgb = color_grid(args.step)
        bad = color_mismatches(rgb, device)
        print(f"exhaustive color ({rgb.shape[0] * rgb.shape[1]} triples) on "
              f"{card}: {bad} mismatched channel values", flush=True)
        timing.emit({"metric": "parity_color", "triples":
                     rgb.shape[0] * rgb.shape[1], "mismatched": bad,
                     "card": card})
        return 1 if bad else 0
    name = "corpus" if args.corpus else "geometry"
    cases = corpus_cases() if args.corpus else geometry_cases()
    count, bad = sweep(cases, device)
    print(f"{name} parity sweep on {card}: {count - len(bad)}/{count} "
          "byte-identical", flush=True)
    timing.emit({"metric": f"parity_{name}", "cases": count,
                 "identical": count - len(bad), "mismatched": bad,
                 "card": card})
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
