"""A folder's passes leg by leg: where the stream engine's pass time goes.

    python -m jpeg_encoder_torch.bench.folder_legs [--files 384]
        [--width 1920] [--height 1080] [--warm 2] [--passes 5]
        [--switch-interval S] [--dir DIR] [--device cuda|cpu]

The folder cell's pass (benchmark/cells.folder_pass) without the cell's
checks and tracing: --files BMP files of corpus content
(bench/dataset.write_bmps, kept where --dir holds them already), --warm
passes of parallel/stream.encode_paths at 4:2:0 (a key's eager call, its
capture), then --passes untraced ones, each emit writing its JFIF file
into an emptied output folder. For each untraced pass, by the host clock:
its seconds from the call until it returns ("wall_s"), its StreamStats
(the loader's reads, the assembler's and emitter's busy seconds), the
process's CPU seconds, the calling thread's (the compute leg, which
dispatches every chunk, and waits on the loader), each other leg's
(its threads' CPU seconds, read by each thread as it ends: the loader,
the assembler, the emitter, the loader's decoder pool) and the rest
("other_cpu_s": threads that run no Python, such as the native read
pool's and CUDA's own), and the process's voluntary and
involuntary context switches. --switch-interval sets
sys.setswitchinterval first (the interpreter's default is 0.005 s).

The last line of stdout is one JSON object: each quantity's list over the
passes, their medians, the passes' Mpixel/s and the card. The module uses
only what the stream engine has had since its four legs (StreamStats and
encode_paths), so a copy of it also runs in an older checkout: a parent
and a change can be compared pass by pass in one call on one card.

    python -m jpeg_encoder_torch.bench.folder_legs --compare A1.json ...
        --against B1.json ...

reads the last lines of such runs, paired in the order given (A1 with
B1, ...), and prints for each quantity the median over the runs of each
run's median, A's and B's, B's change in percent, and in how many pairs
B's is lower; and the same of the runs' Mpixel/s.
"""

from __future__ import annotations

import json
import os
import resource
import shutil
import statistics
import sys
import tempfile
import threading
import time

from jpeg_encoder_torch.bench import dataset, timing
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.parallel import stream
from jpeg_encoder_torch.parallel.devices import resolve_device


# The Python threads of a pass, by the start of their names (the legs'
# names in parallel/stream.py, the decoder pool's prefix).
LEGS = {"loader": "jpeg-torch-loader", "assembler": "jpeg-torch-assembler",
        "emitter": "jpeg-torch-emitter", "decoders": "jpeg-torch-decoder"}


class _Timed(threading.Thread):
    """A thread that adds its CPU seconds, as it ends, to its class's
    `seconds` under the LEGS key its name starts with ("other" if none)."""

    seconds: dict[str, float] = {}
    lock = threading.Lock()

    def run(self) -> None:
        t = time.thread_time()
        try:
            super().run()
        finally:
            leg = next((k for k, prefix in LEGS.items()
                        if self.name.startswith(prefix)), "other")
            with _Timed.lock:
                _Timed.seconds[leg] = (_Timed.seconds.get(leg, 0.0)
                                       + time.thread_time() - t)


def one_pass(paths: list[str], out_dir: str, config, device) -> dict:
    """One encode_paths pass over paths, its files written into out_dir
    (emptied first): the pass's quantities (the module's docstring)."""
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))

    def emit(path: str, data: bytes) -> None:
        name = os.path.splitext(os.path.basename(path))[0] + ".jpg"
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)

    before = resource.getrusage(resource.RUSAGE_SELF)
    _Timed.seconds = {}
    threading.Thread = _Timed  # the threads the pass starts time themselves
    try:
        cpu, thread = time.process_time(), time.thread_time()
        t0 = time.perf_counter()
        stats = stream.encode_paths(paths, config, emit, device=device)
        wall = time.perf_counter() - t0
        cpu, thread = time.process_time() - cpu, time.thread_time() - thread
    finally:
        threading.Thread = _Timed.__bases__[0]
    after = resource.getrusage(resource.RUSAGE_SELF)
    legs = {f"{leg}_cpu_s": _Timed.seconds.get(leg, 0.0) for leg in LEGS}
    written = len(os.listdir(out_dir))
    if stats.encoded != len(paths) or written != len(paths):
        raise RuntimeError(f"a pass encoded {stats.encoded} and wrote "
                           f"{written} of {len(paths)} files")
    return {"wall_s": wall, "decode_s": stats.decode_seconds,
            "assemble_s": stats.assemble_seconds,
            "emit_s": stats.emit_seconds, "cpu_s": cpu,
            "compute_leg_cpu_s": thread, **legs,
            "other_cpu_s": cpu - thread - sum(legs.values()),
            "voluntary_switches": after.ru_nvcsw - before.ru_nvcsw,
            "involuntary_switches": after.ru_nivcsw - before.ru_nivcsw}


def compare(first: list[str], second: list[str]) -> int:
    """--compare: the runs' last lines, paired, side by side."""
    def lines(paths):
        out = []
        for path in paths:
            with open(path) as f:
                out.append(json.loads(f.read().strip().splitlines()[-1]))
        return out

    a, b = lines(first), lines(second)
    if len(a) != len(b) or not a:
        raise SystemExit(f"--compare has {len(a)} runs, --against {len(b)}")
    rows = {"mpix_per_s": ([r["mpix_per_s"] for r in a],
                           [r["mpix_per_s"] for r in b])}
    for key in a[0]["median"]:
        rows[key] = ([r["median"][key] for r in a],
                     [r["median"][key] for r in b])
    for key, (x, y) in rows.items():
        mx, my = statistics.median(x), statistics.median(y)
        print(f"{key}: {mx:.6g} -> {my:.6g} "
              f"({100 * (my / mx - 1) if mx else float('nan'):+.2f}%), "
              f"lower in {sum(q < p for p, q in zip(x, y))} of {len(x)} "
              f"pairs")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = timing.parser(__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=384)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--switch-interval", type=float, default=None)
    ap.add_argument("--dir", default="")
    ap.add_argument("--compare", nargs="+", default=None)
    ap.add_argument("--against", nargs="+", default=None)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(args.compare, args.against or [])
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    device = resolve_device(args.device)
    card = timing.card_line(device)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    root = args.dir or tempfile.mkdtemp(prefix="jpeg_torch_legs_")
    out_dir = None
    try:
        src = os.path.join(root, f"bmp_{args.width}x{args.height}")
        os.makedirs(src, exist_ok=True)
        paths = dataset.write_bmps(src, args.files, args.height, args.width)
        out_dir = tempfile.mkdtemp(prefix="out_", dir=root)
        for _ in range(args.warm):
            one_pass(paths, out_dir, config, device)
        passes = [one_pass(paths, out_dir, config, device)
                  for _ in range(args.passes)]
    finally:
        if out_dir is not None:
            shutil.rmtree(out_dir)
        if not args.dir:
            shutil.rmtree(root)
    keys = list(passes[0])
    walls = [p["wall_s"] for p in passes]
    print(json.dumps({
        "files": args.files, "width": args.width, "height": args.height,
        "warm": args.warm, "switch_interval": sys.getswitchinterval(),
        "mpix_per_s": (args.files * args.width * args.height * len(walls)
                       / sum(walls) / 1e6),
        "passes": {k: [p[k] for p in passes] for k in keys},
        "median": {k: statistics.median(p[k] for p in passes) for k in keys},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
