"""Throughput of one card: the port's counterpart of bench.py.

    python -m jpeg_encoder_torch.bench [--device cuda|cpu] [--min-seconds S]

Times parallel/batch.dispatch_uploaded (the front, K1 into the scan
entries and K4; nothing fetched) on a batch of 8 corpus frames of 1088x1920 at 4:2:0
with RealDCT, uploaded once and resident on the card: the counterpart of
bench.py's vmapped encode_core, in Mpixel/s of input pixels, by the window
timer (bench/timing.py). The call runs the chunk's program as a replayed
CUDA graph (graphs.py; the window's two warm calls are the key's eager
call and its capture), which first copies the resident frames into the
program's buffer: one device copy more a call than the eager path, timed
again under graphs.disabled() (the "_eager" keys). After the timing,
outside the window, it checks
that every payload fitted the batch's capacity and that one image's file
(fetch_chunk + assemble_chunk) equals pipeline.encode_array's on the CPU.

Details go to stderr; the last line of stdout is bench.py's JSON line with
the windows' spread, the clock and the card added. vs_baseline is null:
bench.py's base (BASELINE.json) is a TPU figure, and the port states none.
"""

from __future__ import annotations

import sys

from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.bench import timing
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.parallel import batch
from jpeg_encoder_torch.parallel.devices import resolve_device

METRIC = "single_chip_encode_throughput_1080p_420_realdct"


def check_batch(images, rgb, config, geom, capacity, out) -> None:
    """Raise unless every payload fitted `capacity` and image 0's file
    equals encode_array's on the CPU."""
    payloads, bits = batch.fetch_chunk(*out)
    if int(bits.max()) > 8 * capacity:
        raise RuntimeError(
            f"a payload of {int(bits.max())} bits overflowed the batch's "
            f"capacity of {capacity} bytes")
    got = batch.assemble_chunk(images[:1], config, geom, capacity,
                               payloads[:1], bits[:1], rgb.device)[0]
    want = pipeline.encode_array(images[0], config, device="cpu").file_bytes
    if got != want:
        raise RuntimeError("image 0's file differs from encode_array's on "
                           "the CPU")


def main(argv: list[str] | None = None) -> int:
    ap = timing.parser(__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    geom = config.geometry(args.width, args.height)
    capacity = batch.chunk_capacity_bytes(config, geom)
    images = timing.corpus_batch(args.height, args.width, args.batch)
    rgb = timing.resident(images, device)
    card = timing.card_line(device)
    timing.log(f"{card}: batch {args.batch} x {args.width}x{args.height} "
               "corpus RGB, RealDCT 4:2:0, dispatch_uploaded")

    def encode():
        return batch.dispatch_uploaded(rgb, config, geom, capacity)

    win, eager = timing.replayed_and_eager(lambda: timing.window(
        encode, args.min_seconds, timing.clock_for(device)))
    check_batch(images, rgb, config, geom, capacity, encode())
    pixels = args.batch * args.height * args.width
    line = {"metric": METRIC, **win.rate(pixels), "unit": "Mpixel/s",
            "vs_baseline": None, **win.per_call_ms(),
            **timing.eager_keys(eager, pixels), "card": card}
    timing.log(f"steady state: {win.median * 1e3:.4f} ms/batch (windows "
               f"{win.min * 1e3:.4f}-{win.max * 1e3:.4f}, {win.iters} calls "
               f"each), {line['value']:.1f} Mpixel/s replayed; eager "
               f"{eager.median * 1e3:.4f} ms/batch, "
               f"{line['value_eager']:.1f} Mpixel/s; byte check passed")
    timing.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
