"""Devices of an encode, resolved once, and the shares that run on them.

The counterpart of jpeg_encoder_tpu/parallel/mesh.py::data_mesh, which
takes the first N devices and raises above the count present. Every entry
point of the port resolves its `device` or `devices` here before it
touches a device tensor, so what reaches the operand caches (keyed by
device) and the kernel launches is always an indexed torch.device: an
unindexed "cuda" would mean whichever card is current at the time.

A share is one entry of a device list with its own streams: a list may
name a card more than once, and each entry is then a share of that card
(the one-card machine runs the multi-card paths that way).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """"cuda", "cuda:N", "cpu" or a torch.device -> an indexed device:
    "cuda" is the current card. Raises without a card, above the cards
    present, and on any other kind of device."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.device("cpu")
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{device}: no CUDA device (torch.cuda.is_available() is False);"
            " pass device='cpu' to encode on the CPU")
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.index >= torch.cuda.device_count():
        raise ValueError(f"{device}: only {torch.cuda.device_count()} "
                         "CUDA device(s) present")
    return device


def resolve(devices) -> tuple[torch.device, ...]:
    """A count, one device or a list of them -> a tuple of indexed devices.

    A count N is the first N cards (as data_mesh(N)) and raises above the
    cards present; a list keeps its order and its repeats, every entry of
    one kind (all cards or all "cpu")."""
    if isinstance(devices, int):
        present = torch.cuda.device_count()
        if devices < 1 or devices > present:
            raise ValueError(
                f"requested {devices} CUDA devices, have {present}")
        return tuple(torch.device("cuda", i) for i in range(devices))
    if isinstance(devices, (str, torch.device)):
        return (resolve_device(devices),)
    out = tuple(resolve_device(d) for d in devices)
    if not out:
        raise ValueError("an empty device list")
    if len({d.type for d in out}) > 1:
        raise ValueError(f"devices of more than one kind: {out}")
    return out


@dataclasses.dataclass(frozen=True)
class Share:
    """One entry of a device list: its device and, on a card, the stream
    its work is enqueued on (None: the device's current stream)."""

    device: torch.device
    stream: torch.cuda.Stream | None = None

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    @contextlib.contextmanager
    def on(self):
        """Context that makes this share's device and stream current."""
        if not self.cuda:
            yield
            return
        with torch.cuda.device(self.device):
            if self.stream is None:
                yield
            else:
                with torch.cuda.stream(self.stream):
                    yield

    def ready(self) -> torch.cuda.Event | None:
        """An event recorded on this share's stream now (None on the
        CPU)."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(self.stream or torch.cuda.current_stream(self.device))
        return event

    def wait(self, event: torch.cuda.Event | None) -> None:
        """Make this share's later work wait for `event`."""
        if event is not None:
            (self.stream or torch.cuda.current_stream(self.device)
             ).wait_event(event)


def shares(device, devices=None) -> tuple[Share, ...]:
    """The shares of an encode: with `devices` (a count or a list), one
    share an entry, each with a stream of its own on a card; without, one
    share of `device` on its current stream (the one-device form)."""
    if devices is None:
        return (Share(resolve_device(device)),)
    targets = resolve(devices)
    return tuple(Share(d, stream(d, "share", k) if d.type == "cuda" else None)
                 for d, k in zip(targets, ordinals(targets)))


def ordinals(targets) -> list[int]:
    """Each entry's count of earlier entries naming the same device: the
    k-th share of a card takes that card's k-th stream."""
    seen: dict[torch.device, int] = {}
    out = []
    for d in targets:
        out.append(seen.get(d, 0))
        seen[d] = out[-1] + 1
    return out


@functools.cache
def stream(device: torch.device, role: str, k: int) -> torch.cuda.Stream:
    """The k-th stream of `role` on `device`, made once (from torch's pool
    of non-blocking streams) and kept: the caching allocator keeps a
    stream's freed memory for that stream, so a share that took a new
    stream each call would allocate afresh each call."""
    return torch.cuda.Stream(device)


def send(tensor: torch.Tensor, src: Share, dst: Share) -> torch.Tensor:
    """`tensor`, written on src's stream, as a tensor on dst's device that
    dst's stream may read: copied on src's stream (after the work that
    wrote it), then an event recorded there that dst's stream waits on.
    On the same card it is the same tensor, ordered by the event alone."""
    if not src.cuda:
        return tensor.to(dst.device)
    with src.on():
        out = tensor.to(dst.device, non_blocking=True)
        event = src.ready()
    dst.wait(event)
    if dst.stream is not None:
        out.record_stream(dst.stream)
    return out


def split(count: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous runs [start, stop) of `count` items over at most `parts`
    shares: the first count % parts runs one longer (np.array_split's
    sizes); runs that would be empty are left out."""
    base, extra = divmod(count, parts)
    runs, start = [], 0
    for i in range(parts):
        stop = start + base + (i < extra)
        if stop > start:
            runs.append((start, stop))
        start = stop
    return runs
