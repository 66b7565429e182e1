"""Throughput over devices and batch sizes: tools/bench_scaling.py for the
port.

    python -m jpeg_encoder_torch.bench.scaling --batch-curve  # one card
    python -m jpeg_encoder_torch.bench.scaling                # every card
    python -m jpeg_encoder_torch.bench.scaling --shares 4     # one card, 4x

--batch-curve times batches of 1, 2, 4 and 8 corpus frames on one card (the
dispatch-overhead curve: per-image work against fixed cost). The default
is weak scaling over the cards present (1, 2, 4, ... of them), each with
--per-device-batch images resident on it: encode_batch(devices=)'s device
part, every share's parallel/batch.dispatch_uploaded enqueued on its own
stream, then joined to the timing stream. --shares N names the one device
(or the CPU) N times through parallel/devices.resolve, the counterpart of
bench_scaling.py's --virtual-devices: shares of one card measure what the
shares cost, not a speed-up. All by the window timer; 1088x1920 RealDCT
4:2:0. Each share's program runs as a replayed CUDA graph (graphs.py; a
replay first copies the resident frames into the program's buffer: one
device copy more a call than the eager path), and again eagerly under
graphs.disabled(): the "_eager" keys of each row. A markdown table, then
one JSON line.
"""

from __future__ import annotations

import sys

import torch

from jpeg_encoder_torch.bench import timing
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.parallel import batch
from jpeg_encoder_torch.parallel import devices as devices_lib


def sharded_dispatch(images, config, geom, shares):
    """fn() enqueuing one dispatch_uploaded a share (its contiguous images,
    uploaded once to its device), each share's stream joined to the
    caller's current stream at the end."""
    capacity = batch.chunk_capacity_bytes(config, geom)
    parts = []
    for share, (lo, hi) in zip(shares, devices_lib.split(len(images),
                                                        len(shares))):
        with share.on():
            parts.append((share, timing.resident(images[lo:hi],
                                                 share.device)))

    def dispatch():
        done = []
        for share, rgb in parts:
            with share.on():
                batch.dispatch_uploaded(rgb, config, geom, capacity)
                done.append(share.ready())
        if shares[0].cuda:
            current = torch.cuda.current_stream(shares[0].device)
            for event in done:
                current.wait_event(event)

    return dispatch


def main(argv: list[str] | None = None) -> int:
    ap = timing.parser(__doc__.splitlines()[0])
    ap.add_argument("--batch-curve", action="store_true",
                    help="batch 1, 2, 4 and 8 on one device")
    ap.add_argument("--shares", type=int, default=0,
                    help="name the device N times (shares of one card)")
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--per-device-batch", type=int, default=4)
    args = ap.parse_args(argv)
    device = devices_lib.resolve_device(args.device)
    clock = timing.clock_for(device)
    card = timing.card_line(device)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    geom = config.geometry(args.width, args.height)
    image_pixels = args.height * args.width
    timing.log(f"{card}: {args.width}x{args.height} RealDCT 4:2:0")

    rows = []
    most = 8 if args.batch_curve else args.per_device_batch * (
        args.shares or max(1, torch.cuda.device_count()))
    frames = timing.corpus_batch(args.height, args.width, most)
    if args.batch_curve:
        mode = "batch-curve"
        print("| batch | Mpix/s replayed / eager | Mpix/s per image | vs "
              "linear |")
        print("|---|---|---|---|")
        base = None
        for size in (1, 2, 4, 8):
            dispatch = sharded_dispatch(frames[:size], config, geom,
                                        devices_lib.shares(device))
            win, eager = timing.replayed_and_eager(
                lambda: timing.window(dispatch, args.min_seconds, clock))
            mpix = win.rate(size * image_pixels)["value"]
            base = base or mpix
            rows.append({"batch": size, "value": mpix,
                         "per_image": mpix / size,
                         "vs_linear": mpix / (base * size),
                         **win.per_call_ms(),
                         **timing.eager_keys(eager, size * image_pixels)})
            print(f"| {size} | {mpix:.1f} / {rows[-1]['value_eager']:.1f} | "
                  f"{mpix / size:.1f} | {mpix / (base * size):.1%} |",
                  flush=True)
    else:
        if args.shares:
            mode = f"shares of {device}"
            present = [device] * args.shares
        else:
            mode = "cards"
            present = list(devices_lib.resolve(torch.cuda.device_count())
                           if device.type == "cuda" else [device])
        counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(present)]
        print(f"| {'shares' if args.shares else 'cards'} | aggregate "
              "Mpix/s replayed / eager | per-device Mpix/s | efficiency |")
        print("|---|---|---|---|")
        base = None
        for n in counts:
            size = n * args.per_device_batch
            shares = devices_lib.shares(device, present[:n])
            dispatch = sharded_dispatch(frames[:size], config, geom, shares)
            win, eager = timing.replayed_and_eager(
                lambda: timing.window(dispatch, args.min_seconds, clock))
            mpix = win.rate(size * image_pixels)["value"]
            base = base or mpix
            rows.append({"devices": n, "value": mpix, "per_device": mpix / n,
                         "efficiency": mpix / (base * n),
                         **win.per_call_ms(),
                         **timing.eager_keys(eager, size * image_pixels)})
            print(f"| {n} | {mpix:.1f} / {rows[-1]['value_eager']:.1f} | "
                  f"{mpix / n:.1f} | {mpix / (base * n):.1%} |", flush=True)
        if args.shares:
            print("(shares of one device: the rows measure what the shares "
                  "cost, not a speed-up)", flush=True)
    timing.emit({"metric": "encode_scaling", "mode": mode,
                 "unit": "Mpixel/s", "rows": rows, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
