"""Band-tiled encode of one image: tools/bench_tiled.py for the port.

    python -m jpeg_encoder_torch.bench.tiled [--height 2160 --width 3840]
        [--bands 4 8] [--device cuda|cpu]

One corpus frame (4:2:0, RealDCT) resident on the card, as 4 and 8 MCU-row
bands on the one device. Times, by the window timer on the device's clock,
the band program's device part (parallel/tiled.stack_front on the resident
rows, the chained DC predictors, one K4 launch of a row a band:
encode_tiled without its upload, fetch and splice) against
pipeline.encode_core on the same resident image; then, by the host clock,
tiled.encode_tiled against pipeline.encode_array (numpy RGB in, JFIF bytes
out, upload and fetch included), after checking that their files are
equal. The band programs and encode_array run as replayed CUDA graphs
(graphs.py), and again eagerly under graphs.disabled(): the "_eager" keys.
Either way the device part includes one device-to-device copy of the
resident rows into the top of the band stack (the front program's zeroed
buffer when replayed; a stack zeroed each call when eager).
A markdown table, then one JSON line.
"""

from __future__ import annotations

import sys

from jpeg_encoder_torch import graphs, pipeline
from jpeg_encoder_torch.bench import timing
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.parallel import tiled
from jpeg_encoder_torch.parallel.devices import resolve_device
from jpeg_encoder_torch.utils import corpus


def band_program(rgb, rgb_dev, config, bands, device):
    """fn() -> the enqueued (payloads, bits) of the band program's device
    part over rgb_dev, rgb resident on device, as `bands` bands."""
    geom, band_rows = tiled.prepare(rgb, config, bands)
    if band_rows is None:
        raise ValueError(f"{geom.width}x{geom.height} admits no band split")
    run = tiled.BandRun(geom, band_rows, 0, bands)

    def program():
        z, lasts = tiled.stack_front(rgb_dev, config, run.band_geom, 0,
                                     bands, device)
        return run.encode(z, tiled.chained(lasts), None, config)

    return program


def main(argv: list[str] | None = None) -> int:
    ap = timing.parser(__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--bands", type=int, nargs="+", default=[4, 8])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    clock = timing.clock_for(device)
    card = timing.card_line(device)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    rgb = corpus.landscape(args.height, args.width)
    geom = config.geometry(args.width, args.height)
    pixels = args.height * args.width
    rgb_dev = timing.resident(rgb, device)
    cap = pipeline.default_capacity_bytes(geom, config.capacity_bytes_per_pixel)
    timing.log(f"{card}: {args.width}x{args.height} corpus landscape, "
               "RealDCT 4:2:0")
    core = timing.window(
        lambda: pipeline.encode_core(rgb_dev, geom, config.dct_algorithm,
                                     cap, with_coeffs=False),
        args.min_seconds, clock)
    single = pipeline.encode_array(rgb, config, device=device).file_bytes

    def both(fn, clock):
        """fn's window replayed, then eager."""
        replayed = timing.window(fn, args.min_seconds, clock)
        with graphs.disabled():
            return replayed, timing.window(fn, args.min_seconds, clock)

    array, array_eager = both(
        lambda: pipeline.encode_array(rgb, config, device=device),
        timing.HostClock())
    print(f"| program | device ms ({clock.name}), replayed / eager | Mpix/s "
          "| host ms (encode_tiled / encode_array), replayed / eager |")
    print("|---|---|---|---|")
    print(f"| encode_core | {core.median * 1e3:.4f} | "
          f"{core.rate(pixels)['value']:.1f} | {array.median * 1e3:.4f} / "
          f"{array_eager.median * 1e3:.4f} |", flush=True)
    rows = []
    for bands in args.bands:
        device_part, device_eager = both(
            band_program(rgb, rgb_dev, config, bands, device), clock)
        got = tiled.encode_tiled(rgb, config, bands, device=device)
        if got.file_bytes != single:
            raise RuntimeError(f"encode_tiled at {bands} bands differs from "
                               "encode_array")
        host, host_eager = both(
            lambda: tiled.encode_tiled(rgb, config, bands, device=device),
            timing.HostClock())
        rows.append({"bands": bands, "device": device_part.per_call_ms(),
                     "device_eager": device_eager.per_call_ms(),
                     "host": host.per_call_ms(),
                     "host_eager": host_eager.per_call_ms(),
                     "mpixel_s": device_part.rate(pixels)["value"]})
        print(f"| {bands} bands | {device_part.median * 1e3:.4f} / "
              f"{device_eager.median * 1e3:.4f} | "
              f"{rows[-1]['mpixel_s']:.1f} | {host.median * 1e3:.4f} / "
              f"{host_eager.median * 1e3:.4f} |", flush=True)
    timing.emit({"metric": "tiled_encode", "geometry":
                 f"{args.width}x{args.height}", "encode_core":
                 core.per_call_ms(), "encode_array": array.per_call_ms(),
                 "encode_array_eager": array_eager.per_call_ms(),
                 "rows": rows, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
