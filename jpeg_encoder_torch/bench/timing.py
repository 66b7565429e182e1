"""The bench modules' timers, device, inputs and output.

window(fn, min_seconds, clock) is bench.py's discipline (bench.py:98-123)
done the card's way: two warm calls, the per-call time estimated over
four, iters = clamp(min_seconds / estimate, 8, 2048) calls enqueued
between two CUDA events on the current stream and synchronised once, the
window repeated WINDOWS times; it returns the median, min and max seconds
per call. The JAX package could trust only a scalar fetched after the last
call; a CUDA event recorded after the last launch completes when the card
has run everything before it, so no fetch is needed.

graph_ms(fn, device, calls) times the device work of a call without the
host: fn runs once outside capture (the per-device operand caches, e.g.
kernels/entropy._zero_dc, ops/entropy.device_luts,
ops/dct.fast_device_constant, are blocking copies that capture refuses),
then `calls` calls are captured into one CUDA graph on a side stream and
the graph is replayed between two events, GRAPH_REPS times; -> the median
ms per call. Unlike the profiler's busy time it drops nothing, and unlike
events around one call it holds no Python. A kernel wrapper counts its
launch at capture, not at replay. Its input stays in the card's L2 cache
from one call to the next: cold_graph_ms(fn, inputs, device) replays one
call on each of several distinct inputs in turn, more bytes together than
twice the L2 cache (past_l2 makes such copies), so each call finds its
input evicted and reads it from device memory.

With device "cpu" both timers read the host clock (clock "host"); a
"cuda" device without a card raises (parallel/devices.resolve_device).
Nothing falls back.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from jpeg_encoder_torch import graphs
from jpeg_encoder_torch.utils import corpus

WARM_CALLS = 2
ESTIMATE_CALLS = 4
MIN_ITERS, MAX_ITERS = 8, 2048
WINDOWS = 5
GRAPH_REPS = 20


class HostClock:
    """Seconds between start() and stop() on the host clock: the work must
    be done when fn returns (the CPU path, or calls that end in a fetch)."""

    name = "host"

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        return time.perf_counter() - self._t0


class EventClock:
    """Seconds between two CUDA events recorded on the device's current
    stream; stop() synchronises on the second. Work enqueued on other
    streams must be joined to the current stream by the caller."""

    name = "events"

    def __init__(self, device: torch.device):
        self.device = device

    def _record(self) -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def start(self) -> None:
        self._start = self._record()

    def stop(self) -> float:
        end = self._record()
        end.synchronize()
        return self._start.elapsed_time(end) / 1e3


def clock_for(device: torch.device):
    """The device's clock: events on a card, the host clock on the CPU."""
    return EventClock(device) if device.type == "cuda" else HostClock()


@dataclasses.dataclass(frozen=True)
class Window:
    """Seconds per call over WINDOWS windows of `iters` calls each."""

    median: float
    min: float
    max: float
    iters: int
    windows: int
    clock: str

    def per_call_ms(self) -> dict:
        return {"ms": self.median * 1e3, "ms_min": self.min * 1e3,
                "ms_max": self.max * 1e3, "iters": self.iters,
                "windows": self.windows, "clock": self.clock}

    def rate(self, units: float) -> dict:
        """`units` a call as millions a second: the median window's, the
        slowest's and the fastest's."""
        return {"value": units / self.median / 1e6,
                "value_min": units / self.max / 1e6,
                "value_max": units / self.min / 1e6}


def iterations(estimate_s: float, min_seconds: float) -> int:
    """Calls a window: enough to last min_seconds, within 8..2048."""
    wanted = int(min_seconds / max(estimate_s, 1e-9))
    return max(MIN_ITERS, min(MAX_ITERS, wanted))


def window(fn, min_seconds: float, clock) -> Window:
    """Time fn() by bench.py's discipline on `clock` (module docstring)."""
    for _ in range(WARM_CALLS):
        fn()
    clock.start()
    for _ in range(ESTIMATE_CALLS):
        fn()
    iters = iterations(clock.stop() / ESTIMATE_CALLS, min_seconds)
    samples = []
    for _ in range(WINDOWS):
        clock.start()
        for _ in range(iters):
            fn()
        samples.append(clock.stop() / iters)
    return Window(statistics.median(samples), min(samples), max(samples),
                  iters, WINDOWS, clock.name)


def graph_ms(fn, device: torch.device, calls: int = 10,
             reps: int = GRAPH_REPS) -> float:
    """Median ms per call of fn's device work by CUDA-graph replay
    (module docstring); the host clock over `calls` calls on the CPU."""
    if device.type == "cpu":
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
        return statistics.median(times)
    with torch.cuda.device(device):
        fn()
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize(device)
        clock = EventClock(device)
        times = []
        for _ in range(reps):
            clock.start()
            graph.replay()
            times.append(clock.stop() * 1e3 / calls)
        graph.reset()
        return statistics.median(times)


def l2_bytes(device: torch.device) -> int:
    """The card's L2 cache in bytes."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def past_l2(tensor: torch.Tensor) -> list[torch.Tensor]:
    """tensor and distinct copies of it on its card, more bytes together
    than twice the card's L2 cache: cold_graph_ms's inputs."""
    size = tensor.numel() * tensor.element_size()
    count = 2 * l2_bytes(tensor.device) // size + 1
    return [tensor] + [tensor.clone() for _ in range(count - 1)]


def cold_graph_ms(fn, inputs: list[torch.Tensor], device: torch.device,
                  reps: int = GRAPH_REPS) -> float:
    """Median ms per call of fn(x) by CUDA-graph replay, as graph_ms, with
    one call on each of `inputs` in turn: distinct tensors of more bytes
    together than twice the card's L2 cache (raises otherwise), so that
    every call reads its input from device memory; the host clock on the
    CPU."""
    if device.type == "cpu":
        turn = itertools.cycle(inputs)
        return graph_ms(lambda: fn(next(turn)), device, 1, reps)
    size = sum(x.numel() * x.element_size() for x in inputs)
    if size <= 2 * l2_bytes(device):
        raise ValueError(f"{len(inputs)} inputs of {size} bytes together "
                         f"fit in twice the L2 cache of {device}")
    with torch.cuda.device(device):
        for x in inputs:
            fn(x)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for x in inputs:
                fn(x)
        graph.replay()
        torch.cuda.synchronize(device)
        clock = EventClock(device)
        times = []
        for _ in range(reps):
            clock.start()
            graph.replay()
            times.append(clock.stop() * 1e3 / len(inputs))
        graph.reset()
        return statistics.median(times)


def replayed_and_eager(measure):
    """measure() with the device programs replayed (graphs.py), then again
    with them eager (graphs.disabled()) -> (replayed, eager)."""
    replayed = measure()
    with graphs.disabled():
        return replayed, measure()


def eager_keys(win: Window, units: float) -> dict:
    """The eager window's rate of `units` a call and its per-call ms under
    "_eager" keys (value_eager, ms_eager, ...), beside the replayed
    window's keys."""
    return {f"{k}_eager": v
            for k, v in {**win.rate(units), **win.per_call_ms()}.items()}


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them ("cpu" on
    the CPU): every number a bench prints stands beside it. The card is
    found by its UUID: nvidia-smi numbers the cards in PCI order, whatever
    CUDA_VISIBLE_DEVICES makes of torch's indices (and the card machine
    reports no PCI bus id). No card of that UUID raises."""
    if device.type == "cpu":
        return "cpu"
    uuid = uuid_hex(torch.cuda.get_device_properties(device).uuid)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    for line in out.splitlines():
        if line.count(",") < 2:
            continue
        card, rest = line.split(",", 1)
        name, power = rest.rsplit(",", 1)
        if uuid_hex(card) == uuid:
            return f"{name.strip()}, {power.strip()}"
    raise RuntimeError(f"nvidia-smi lists no card of {device}'s UUID {uuid}")


def uuid_hex(uuid) -> str:
    """A card's UUID as 32 lower-case hex digits: torch's (its bytes, or
    its text) or nvidia-smi's ("GPU-" and the dashed form)."""
    raw = getattr(uuid, "bytes", None)
    if isinstance(raw, (bytes, bytearray)):
        return bytes(raw).hex()
    text = str(uuid).strip().lower()
    return text.removeprefix("gpu-").replace("-", "")


def parser(description: str, min_seconds: float = 3.0):
    """An argument parser with the options every bench module takes."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; cuda without a card "
                         "raises (parallel/devices.resolve_device)")
    ap.add_argument("--min-seconds", type=float, default=min_seconds,
                    help="least length of one timing window")
    return ap


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(line: dict) -> None:
    """The module's one JSON line, its last line of standard output."""
    print(json.dumps(line), flush=True)


def corpus_batch(height: int, width: int, count: int) -> np.ndarray:
    """(count, height, width, 3) uint8 corpus frames (utils/corpus.py),
    made distinct by variants(): photographic content, not noise."""
    return variants(list(corpus.images(height, width).values()), count)


def resident(images: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host images uploaded once (complete when this returns): every timed
    call reads them on the device."""
    out = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def variants(images: list[np.ndarray], count: int) -> np.ndarray:
    """count distinct images from a few: rolled, flipped, channel-swapped."""
    out = []
    for k in range(count):
        rgb = images[k % len(images)]
        j = k // len(images)
        if j % 2:
            rgb = rgb[:, ::-1]
        if j % 4 >= 2:
            rgb = rgb[::-1, :, ::-1]
        out.append(np.roll(rgb, 97 * j, axis=1))
    return np.ascontiguousarray(np.stack(out))
