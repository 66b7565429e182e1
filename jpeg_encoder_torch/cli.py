"""Command-line interface: BMP -> baseline JPEG, on the card.

    python -m jpeg_encoder_torch.cli -i photo.bmp [-o photo.jpeg] [options]

Port of jpeg_encoder_tpu/cli.py, with the same flags, stage banners, exit
codes (2 for argument errors, 1 for OSError/ValueError) and --timing JSON.
Feature parity with the reference CLI (arguments.rs:4-67, main.rs:8-68):
`--image` (required, must end in .bmp), `--output` (defaults to the input
path with a .jpeg suffix), `--subsampling-ratio {4:4:4,4:2:2,4:2:0}`
(default 4:2:0), `--dct-algorithm {real-dct,bin-dct}` (default real-dct);
plus multi-image batch input (globs, through the stream engine), datasets
across processes, band tiling, --fast-dct and stage timing.

--device picks where the encode runs: "cuda" by default, "cpu" for the
kernels' plain versions, "cuda:K" to pin everything to card K. There is no
fallback: without a card the default exits 1. --devices N has the JAX
package's meaning: batch and dataset input are sharded over the first N
cards (default: every card present; N above the cards present exits 2),
and under --tile-bands N is the band count, the bands spread over the
cards present.
"""

from __future__ import annotations

import argparse
import contextlib
import glob as globlib
import json
import os
import sys
import time

from jpeg_encoder_torch.config import (
    DctAlgorithm,
    EncoderConfig,
    parse_subsampling_ratio,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="jpeg-encoder-torch",
        description="BMP to baseline JPEG (JFIF) encoder on an NVIDIA GPU",
    )
    parser.add_argument(
        "-i", "--image", action="append", default=None,
        help="input BMP path or glob (repeatable; must end in .bmp)",
    )
    parser.add_argument(
        "--dataset", default="", metavar="DIR",
        help="encode every .bmp in DIR (top level) as a dataset that "
        "processes share: each process takes a strided share, writes "
        "outputs plus a resumable manifest into -o, and the final summary "
        "adds up every process. Single-process runs encode everything "
        "locally",
    )
    parser.add_argument(
        "--coordinator", default="", metavar="HOST:PORT",
        help="with --dataset: the process group's rendezvous address for "
        "multi-process runs (every process passes the same address; "
        "process 0 listens there)",
    )
    parser.add_argument(
        "--process-id", type=int, default=None, metavar="N",
        help="with --coordinator: this process's index in 0..num-processes",
    )
    parser.add_argument(
        "--num-processes", type=int, default=None, metavar="M",
        help="with --coordinator: total process count",
    )
    parser.add_argument(
        "--no-resume", action="store_true",
        help="with --dataset: re-encode files the manifest already records "
        "instead of skipping them",
    )
    parser.add_argument(
        "-o", "--output", default="",
        help="output JPEG path (default: input path with .jpeg suffix; "
        "for batch input, a directory)",
    )
    parser.add_argument(
        "-s", "--subsampling-ratio", default="4:2:0",
        help="chroma subsampling ratio: 4:4:4, 4:2:2 or 4:2:0 (default 4:2:0)",
    )
    parser.add_argument(
        "-d", "--dct-algorithm", default="real-dct",
        choices=[a.value for a in DctAlgorithm],
        help="DCT algorithm (default real-dct)",
    )
    parser.add_argument(
        "--bin-dct-descale", action="store_true",
        help="with -d bin-dct: fold the lifting network's diagonal gains "
        "into quantization (the corrected binDCT-C) instead of reproducing "
        "the reference's de-scaling bug",
    )
    parser.add_argument(
        "-q", "--quality", type=int, default=None, metavar="1..100",
        help="scale the quantization tables with the standard libjpeg "
        "quality formula (50 = the default Annex-K tables; higher = better "
        "fidelity, bigger files). Omit for reference-parity fixed tables",
    )
    parser.add_argument(
        "--optimize-huffman", action="store_true",
        help="two-pass encode with per-image optimal Huffman tables "
        "(smaller files, custom DHT segments; libjpeg's -optimize analog). "
        "Off by default (reference parity: fixed Annex-K tables)",
    )
    parser.add_argument(
        "--restart-interval", type=int, default=None, metavar="N",
        help="emit DRI/RSTn restart markers every N MCUs: each interval is "
        "an independently decodable scan segment (DC predictors reset, "
        "byte-aligned), making the file parallel-decodable. Off by default "
        "(reference parity: one unbroken scan)",
    )
    parser.add_argument(
        "--fast-dct", action="store_true",
        help="use the tensor-core RealDCT (fastest; measured against the "
        "exact RealDCT on an H100, 3.0e-05 of the quantized coefficients "
        "differ, by one, at the default tables, 2.2e-04 at -q 90 and "
        "1.1e-03 at -q 100)",
    )
    parser.add_argument(
        "--device", default="cuda", metavar="DEVICE",
        help="where to encode: cuda (default: the cards --devices names; "
        "cuda:N pins everything to card N) or cpu (the kernels' plain "
        "versions). No fallback",
    )
    parser.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="shard batch and dataset input over the first N cards "
        "(default: every card present; N above the cards present is an "
        "error); with --tile-bands: the band count (default: the cards "
        "present, 1 on the CPU), the bands spread over the cards present",
    )
    parser.add_argument(
        "--tile-bands", action="store_true",
        help="single-image mode: encode the image as MCU-row bands (DC "
        "predictors chained from band to band, the band streams spliced), "
        "byte-identical to the one-piece encode",
    )
    parser.add_argument(
        "--timing", action="store_true", help="print per-image timing as JSON"
    )
    parser.add_argument(
        "--trace", default="", metavar="DIR",
        help="capture a torch.profiler trace of the encode into DIR "
        "(view with TensorBoard or Perfetto)",
    )
    return parser


def default_output_path(image_path: str) -> str:
    return image_path[: -len(".bmp")] + ".jpeg"


def _maybe_trace(trace_dir: str, device):
    """torch.profiler trace context when --trace is given (else a no-op).

    The reference's only observability is println! stage banners
    (main.rs:16-67); here there is a profiler trace of the host and the
    card, plus the --timing JSON counters.
    """
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))


def _cards(device) -> int:
    """Devices of the encode's kind: the cards present, or 1 for the CPU."""
    import torch

    return torch.cuda.device_count() if device.type == "cuda" else 1


def _placement(device, count: int | None) -> dict:
    """The device keywords of an entry point: the first `count` cards for
    an unindexed --device cuda (None: the entry point's default), else the
    one device asked for (a card given by index, or the CPU)."""
    if device.type == "cuda" and device.index is None:
        return {"devices": count}
    return {"device": device}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if not args.image and not args.dataset:
        print("error: provide --image or --dataset", file=sys.stderr)
        return 2

    inputs: list[str] = []
    for pattern in args.image or []:
        matches = sorted(globlib.glob(pattern)) or [pattern]
        inputs.extend(matches)
    for path in inputs:
        if not path.endswith(".bmp"):
            print(f"error: input image must be a .bmp file: {path}", file=sys.stderr)
            return 2
    if args.tile_bands and (args.dataset or len(inputs) > 1):
        print("error: --tile-bands encodes one image; it does not apply to "
              "batch or --dataset input", file=sys.stderr)
        return 2

    try:
        ratio = parse_subsampling_ratio(args.subsampling_ratio)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    try:
        config = EncoderConfig(
            subsampling_ratio=ratio,
            dct_algorithm=DctAlgorithm(args.dct_algorithm),
            fast_dct=args.fast_dct,
            bin_dct_descale=args.bin_dct_descale,
            quality=args.quality,
            restart_interval=args.restart_interval,
            optimize_huffman=args.optimize_huffman,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    import torch  # deferred past the argument errors

    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        print(f"error: --device {args.device}: {e}", file=sys.stderr)
        return 2
    if device.type not in ("cuda", "cpu"):
        print(f"error: --device must be cuda or cpu, got {args.device}",
              file=sys.stderr)
        return 2
    if args.devices < 0:
        print("error: --devices must not be negative", file=sys.stderr)
        return 2
    if (args.dataset or len(inputs) > 1) and args.devices > _cards(device):
        print(f"error: --devices {args.devices}: only {_cards(device)} "
              f"{device.type} device(s) present to shard batch or dataset "
              "input over", file=sys.stderr)
        return 2
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False); "
              "pass --device cpu to encode on the CPU", file=sys.stderr)
        return 1

    if args.dataset:
        return _run_dataset(inputs, args, config, device)
    if len(inputs) > 1:
        return _run_batch(inputs, args, config, device)

    image_path = inputs[0]
    output_path = args.output or default_output_path(image_path)
    print(f'image: "{image_path}"')
    print(f'output: "{output_path}"')
    print(f'subsampling ratio: "{ratio}"')
    print(f'dct algorithm: "{args.dct_algorithm}"')
    print()

    from jpeg_encoder_torch import pipeline
    from jpeg_encoder_torch.io import bmp

    # Stage banners match the reference's println! sequence (main.rs:16-67).
    # The middle three stages run as one device program (pipeline's front
    # half and scan encoder), so their banners bracket one encode call;
    # they mark reference-parity checkpoints, not separate host stages.
    t0 = time.perf_counter()
    try:
        with _maybe_trace(args.trace, device):
            print("Loading bmp...")
            rgb = bmp.read(image_path)
            print("Loaded!")
            print("Chrominance downsampling...")
            print("Done!")
            print("Performing Discrete Cosine Transform + Quantization...")
            print("Done!")
            print("Entropy encoding...")
            if args.tile_bands:
                from jpeg_encoder_torch.parallel import tiled

                bands = args.devices or _cards(device)
                result = tiled.encode_tiled(
                    rgb, config, bands,
                    **_placement(device, min(bands, _cards(device))),
                )
            else:
                result = pipeline.encode_array(rgb, config, device=device)
            print("Done!")
            print("Creating file")
            with open(output_path, "wb") as f:
                f.write(result.file_bytes)
            print("Done!")
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - t0
    print(f"wrote {output_path} ({len(result.file_bytes)} bytes)")
    if args.timing:
        pixels = result.geom.width * result.geom.height
        print(json.dumps({
            "seconds": elapsed,
            "megapixels_per_second": pixels / elapsed / 1e6,
            "output_bytes": len(result.file_bytes),
        }))
    return 0


def _run_dataset(inputs: list[str], args, config: EncoderConfig,
                 device) -> int:
    """Dataset mode: the CLI surface of parallel/multihost.

    A process group joined when --coordinator is given, strided file
    assignment by rank, the stream engine on this process's cards, a
    resumable per-process manifest, and a summary gathered from every
    process. The default --device (cuda, no index) without --devices lets
    encode_dataset take every card in one process and put rank r on card
    r % cards in several; --devices N takes the first N cards.
    """
    import torch.distributed as dist

    from jpeg_encoder_torch.parallel import multihost

    kwargs = {}
    if args.coordinator:
        kwargs = dict(coordinator_address=args.coordinator,
                      num_processes=args.num_processes,
                      process_id=args.process_id)
    joined = not dist.is_initialized()
    try:
        idx, count = multihost.initialize(**kwargs)
    except (RuntimeError, ValueError) as e:
        print(f"error: distributed initialization failed: {e}",
              file=sys.stderr)
        return 1
    joined = joined and dist.is_initialized()
    try:
        paths = sorted(globlib.glob(os.path.join(args.dataset, "*.bmp")))
        paths.extend(inputs)
        if not paths:
            print(f"error: no .bmp files under {args.dataset}",
                  file=sys.stderr)
            return 1
        out_dir = args.output or "."

        t0 = time.perf_counter()
        try:
            result = multihost.encode_dataset(
                paths, out_dir, config, resume=not args.no_resume,
                **_placement(device, args.devices or None),
            )
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        summary = multihost.global_summary(result)
        elapsed = time.perf_counter() - t0
    finally:
        if joined:
            dist.destroy_process_group()
    line = {
        "process_index": idx,
        "process_count": count,
        "encoded": result.encoded,
        "skipped": result.skipped,
        "output_bytes": result.output_bytes,
        "manifest": result.manifest_path,
        "summary": summary,
    }
    if args.timing:
        line["seconds"] = elapsed
        if result.seconds > 0:
            # File-to-file throughput of THIS process's encode loop (the
            # honest end-to-end number: BMPs on disk in, JPEGs out).
            line["megapixels_per_second"] = (
                result.pixels / result.seconds / 1e6
            )
            line["decode_seconds"] = result.decode_seconds
            line["write_seconds"] = result.write_seconds
    print(json.dumps(line))
    return 0


def _run_batch(inputs: list[str], args, config: EncoderConfig,
               device) -> int:
    """Batch encode through the overlapped decode | compute | write engine
    (parallel/stream.py over parallel/batch.py): BMP decode of chunk k+1
    and file writes of chunk k-1 run while chunk k's kernels run; chunks
    go to the first --devices cards in turn (default: every card)."""
    from jpeg_encoder_torch.parallel import stream

    out_dir = args.output or "."
    os.makedirs(out_dir, exist_ok=True)

    def emit(path: str, data: bytes):
        name = os.path.splitext(os.path.basename(path))[0] + ".jpeg"
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        print(f"encoded {path} -> {os.path.join(out_dir, name)}")

    try:
        stats = stream.encode_paths(
            inputs, config, emit,
            **_placement(device, args.devices or _cards(device)))
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.timing:
        print(json.dumps({
            "images": stats.encoded,
            "seconds": stats.seconds,
            "megapixels_per_second": stats.pixels / stats.seconds / 1e6,
            "decode_seconds": stats.decode_seconds,
            "write_seconds": stats.write_seconds,
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
