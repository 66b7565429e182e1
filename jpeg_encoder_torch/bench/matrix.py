"""Throughput matrix and single cells: tools/bench_matrix.py and
tools/bench_cell.py for the port.

    python -m jpeg_encoder_torch.bench.matrix [--device cuda|cpu]
    python -m jpeg_encoder_torch.bench.matrix --cell RATIO [bin] [restart=N]
        [optimize] [fast]

The matrix times the 3 subsampling ratios x {RealDCT, binDCT} on a batch of
8 corpus frames of 1088x1920 resident on the card, each through
parallel/batch.dispatch_uploaded (front, DCT kernel into the entries,
K4; nothing fetched) by the window timer, in Mpixel/s. --cell times one configuration:
restart=N codes every N-MCU restart interval into its own row, fast runs
--fast-dct (K2), and optimize reports two numbers, as bench_cell.py does:
the two-pass cost (the statistics pass on the resident batch,
batch.optimized_stats_uploaded; its histograms fetched and each image's
tables built on the host, build_chunk_luts; the encode pass,
dispatch_optimized_encode) and the encode pass alone with those tables.
Each program runs as a replayed CUDA graph (graphs.py; a replay first
copies its inputs, the resident frames or the entries and tables, into the
program's buffers: one device copy more a call than the eager path), and
again eagerly under graphs.disabled(): the "_eager" keys.

Markdown rows go to stdout, then one JSON line.
"""

from __future__ import annotations

import sys

from jpeg_encoder_torch.bench import timing
from jpeg_encoder_torch.config import (DctAlgorithm, EncoderConfig,
                                       parse_subsampling_ratio)
from jpeg_encoder_torch.parallel import batch
from jpeg_encoder_torch.parallel.devices import resolve_device

RATIOS = ((4, 2, 0), (4, 2, 2), (4, 4, 4))


def parse_cell(tokens: list[str]) -> EncoderConfig:
    """bench_cell.py's argv (RATIO [bin] [restart=N] [optimize] [fast]) ->
    the cell's config."""
    ratio, *flags = tokens
    known = {"bin", "optimize", "fast"}
    for flag in flags:
        if flag not in known and not flag.startswith("restart="):
            raise ValueError(f"unknown cell option {flag!r}")
    restart = next((int(f.split("=", 1)[1]) for f in flags
                    if f.startswith("restart=")), None)
    return EncoderConfig(
        subsampling_ratio=parse_subsampling_ratio(ratio),
        dct_algorithm=(DctAlgorithm.BIN_DCT if "bin" in flags
                       else DctAlgorithm.REAL_DCT),
        restart_interval=restart,
        optimize_huffman="optimize" in flags,
        fast_dct="fast" in flags,
    )


def label(config: EncoderConfig) -> dict:
    return {
        "ratio": ":".join(map(str, config.subsampling_ratio)),
        "algorithm": config.dct_algorithm.value,
        "restart": config.restart_interval,
        "fast": config.fast_dct,
        "optimize": config.optimize_huffman,
    }


def time_fixed(rgb, config, min_seconds, clock) -> timing.Window:
    """One dispatch_uploaded of the resident batch a call."""
    geom = config.geometry(rgb.shape[2], rgb.shape[1])
    capacity = batch.chunk_capacity_bytes(config, geom)
    return timing.window(
        lambda: batch.dispatch_uploaded(rgb, config, geom, capacity),
        min_seconds, clock)


def time_optimized(rgb, config, min_seconds, clock):
    """(the two-pass window, the encode-pass window) of an optimize cell."""
    geom = config.geometry(rgb.shape[2], rgb.shape[1])
    capacity = batch.chunk_capacity_bytes(config, geom)

    def two_pass():
        z, hists = batch.optimized_stats_uploaded(rgb, config, geom)
        _, dc, ac = batch.build_chunk_luts(hists.cpu().numpy())
        return batch.dispatch_optimized_encode(z, dc, ac, config, geom,
                                               capacity)

    z, hists = batch.optimized_stats_uploaded(rgb, config, geom)
    _, dc, ac = batch.build_chunk_luts(hists.cpu().numpy())
    full = timing.window(two_pass, min_seconds, clock)
    encode = timing.window(
        lambda: batch.dispatch_optimized_encode(z, dc, ac, config, geom,
                                                capacity),
        min_seconds, clock)
    return full, encode


def main(argv: list[str] | None = None) -> int:
    ap = timing.parser(__doc__.splitlines()[0])
    ap.add_argument("--cell", nargs="+", metavar="ARG",
                    help="one cell: RATIO [bin] [restart=N] [optimize] "
                         "[fast]")
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    clock = timing.clock_for(device)
    card = timing.card_line(device)
    pixels = args.batch * args.height * args.width
    images = timing.corpus_batch(args.height, args.width, args.batch)
    rgb = timing.resident(images, device)
    timing.log(f"{card}: batch {args.batch} x {args.width}x{args.height} "
               "corpus RGB, resident")

    if args.cell:
        config = parse_cell(args.cell)
        line = {"metric": "encode_cell_throughput", **label(config),
                "unit": "Mpixel/s"}
        if config.optimize_huffman:
            (full, encode), (full_eager, encode_eager) = (
                timing.replayed_and_eager(lambda: time_optimized(
                    rgb, config, args.min_seconds, clock)))
            line.update(two_pass=full.rate(pixels)["value"],
                        two_pass_ms=full.median * 1e3,
                        two_pass_eager=full_eager.rate(pixels)["value"],
                        two_pass_ms_eager=full_eager.median * 1e3,
                        **encode.rate(pixels), **encode.per_call_ms(),
                        **timing.eager_keys(encode_eager, pixels))
            print(f"{' '.join(args.cell)}: two-pass {full.median * 1e3:.4f} "
                  f"ms/batch {line['two_pass']:.1f} Mpix/s (eager "
                  f"{full_eager.median * 1e3:.4f}) | encode pass "
                  f"{encode.median * 1e3:.4f} ms/batch "
                  f"{line['value']:.1f} Mpix/s (eager "
                  f"{encode_eager.median * 1e3:.4f}) ({card})", flush=True)
        else:
            win, eager = timing.replayed_and_eager(lambda: time_fixed(
                rgb, config, args.min_seconds, clock))
            line.update(**win.rate(pixels), **win.per_call_ms(),
                        **timing.eager_keys(eager, pixels))
            print(f"{' '.join(args.cell)}: {win.median * 1e3:.4f} ms/batch "
                  f"{line['value']:.1f} Mpix/s (eager "
                  f"{eager.median * 1e3:.4f} ms/batch "
                  f"{line['value_eager']:.1f} Mpix/s) ({card})", flush=True)
        timing.emit({**line, "card": card})
        return 0

    print("| ratio | algorithm | Mpixel/s replayed / eager | ms/batch "
          "replayed (min-max) / eager |")
    print("|---|---|---|---|", flush=True)
    rows = []
    for ratio in RATIOS:
        for algorithm in (DctAlgorithm.REAL_DCT, DctAlgorithm.BIN_DCT):
            config = EncoderConfig(subsampling_ratio=ratio,
                                   dct_algorithm=algorithm)
            win, eager = timing.replayed_and_eager(lambda: time_fixed(
                rgb, config, args.min_seconds, clock))
            row = {**label(config), **win.rate(pixels), **win.per_call_ms(),
                   **timing.eager_keys(eager, pixels)}
            rows.append(row)
            print(f"| {row['ratio']} | {row['algorithm']} | "
                  f"{row['value']:.1f} / {row['value_eager']:.1f} | "
                  f"{row['ms']:.4f} ({row['ms_min']:.4f}-{row['ms_max']:.4f})"
                  f" / {row['ms_eager']:.4f} |", flush=True)
    timing.emit({"metric": "encode_throughput_matrix_1080p",
                 "unit": "Mpixel/s", "rows": rows, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
