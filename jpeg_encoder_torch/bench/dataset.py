"""File-to-file dataset throughput: tools/bench_dataset.py for the port.

    python -m jpeg_encoder_torch.bench.dataset [--images 100] [--width 3840]
        [--height 2160] [--dir DIR] [--keep] [--ratio 4:2:0] [--optimize]
        [--chunk-budget BYTES] [--verify 3] [--device cuda|cpu]

Writes N BMP files of corpus content (io/bmp.write; 4 corpus frames, later
files brightness-shifted copies), encodes them with
parallel/multihost.encode_dataset in one process (the --dataset CLI body:
the stream engine's decode | encode | write legs, every leg paid), then
compares --verify of the files byte for byte with pipeline.encode_array
on the same device, in optimize mode too. Prints bench_dataset.py's JSON
keys; device_hbm_peak_mb is torch.cuda.max_memory_allocated over the run
(null on the CPU), the host RSS peak comes from resource.getrusage. 100
4K files take about 2.5 GB of disk.
"""

from __future__ import annotations

import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.bench import timing
from jpeg_encoder_torch.config import EncoderConfig, parse_subsampling_ratio
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.parallel import batch, multihost
from jpeg_encoder_torch.parallel.devices import resolve_device
from jpeg_encoder_torch.utils import corpus


def write_bmps(src: str, count: int, height: int, width: int) -> list[str]:
    """count BMP files of corpus content in src (kept if present)."""
    bases = list(corpus.images(h=height, w=width).values())
    paths = []
    for i in range(count):
        path = os.path.join(src, f"img{i:04d}.bmp")
        paths.append(path)
        if os.path.exists(path):
            continue
        img = bases[i % len(bases)]
        if i >= len(bases):
            img = ((img.astype(np.int16) + (i * 7) % 32) % 256).astype(
                np.uint8)
        bmp.write(path, img)
    return paths


def main(argv: list[str] | None = None) -> int:
    ap = timing.parser(__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=100)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--dir", default="")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--ratio", default="4:2:0")
    ap.add_argument("--optimize", action="store_true",
                    help="per-image optimized Huffman (two passes)")
    ap.add_argument("--chunk-budget", type=int, default=0,
                    help="input bytes a chunk (batch.CHUNK_INPUT_BUDGET)")
    ap.add_argument("--verify", type=int, default=3,
                    help="files compared byte for byte with encode_array")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = timing.card_line(device)
    budget = batch.CHUNK_INPUT_BUDGET
    if args.chunk_budget:
        batch.CHUNK_INPUT_BUDGET = args.chunk_budget
    try:
        return run(args, device, card)
    finally:
        batch.CHUNK_INPUT_BUDGET = budget


def run(args, device: torch.device, card: str) -> int:
    """The benchmark of main's arguments on `device`."""
    root = args.dir or tempfile.mkdtemp(prefix="jpeg_torch_ds_")
    src, out = os.path.join(root, "bmp"), os.path.join(root, "out")
    os.makedirs(src, exist_ok=True)
    h, w = args.height, args.width
    timing.log(f"{card}: writing {args.images} {w}x{h} BMP files into {src}")
    t0 = time.perf_counter()
    paths = write_bmps(src, args.images, h, w)
    timing.log(f"written in {time.perf_counter() - t0:.1f} s")

    config = EncoderConfig(
        subsampling_ratio=parse_subsampling_ratio(args.ratio),
        optimize_huffman=args.optimize,
    )
    geom = config.geometry(w, h)
    chunk = batch.chunk_size_images(geom)
    # Warm the kernels and the operand caches, so that the run is the
    # steady state (a fresh process builds them once).
    batch.encode_batch(np.zeros((1, h, w, 3), np.uint8), config,
                       device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    result = multihost.encode_dataset(paths, out, config, device=device,
                                      resume=False)
    wall = time.perf_counter() - t0
    rss_peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    hbm_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)

    step = max(1, args.images // max(1, args.verify))
    checked = list(range(0, args.images, step))[: args.verify]
    for i in checked:
        with open(os.path.join(out, f"img{i:04d}.jpeg"), "rb") as f:
            got = f.read()
        want = pipeline.encode_array(bmp.read(paths[i]), config,
                                     device=device).file_bytes
        if got != want:
            raise RuntimeError(f"img{i:04d}.jpeg differs from encode_array's")

    timing.emit({
        "metric": "dataset_file_to_file_throughput",
        "value": result.pixels / result.seconds / 1e6,
        "unit": "Mpixel/s",
        "images": result.encoded,
        "optimize": args.optimize,
        "geometry": f"{w}x{h}",
        "chunk_images": chunk,
        "wall_seconds": wall,
        "encode_seconds": result.seconds,
        "decode_seconds": result.decode_seconds,
        "write_seconds": result.write_seconds,
        "assemble_seconds": result.assemble_seconds,
        "emit_seconds": result.emit_seconds,
        "output_mb": result.output_bytes / 1e6,
        "host_rss_peak_mb": rss_peak_kb / 1024,
        "host_rss_before_mb": rss0 / 1024,
        "device_hbm_peak_mb": None if hbm_peak is None else hbm_peak / 1e6,
        "verified_byte_identical": len(checked),
        "clock": "host",
        "card": card,
    })
    if not args.keep and not args.dir:
        shutil.rmtree(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
