"""Work across processes: a dataset in strided shares, one image's bands.

Port of jpeg_encoder_tpu/parallel/multihost.py (and of the multi-process
mesh of jpeg_encoder_tpu/parallel/tiled.py) on torch.distributed:

* initialize() joins a gloo process group when the process was launched
  as one of several (an explicit coordinator address, or torchrun's
  environment), with a timeout, so that a missing peer fails instead of
  hanging;
* each process takes a strided share of the file list (whole images are
  independent: no coordination) and pushes it through the stream engine
  (parallel/stream.py): one process on every card present (the JAX
  package's mesh of its local devices), several on cuda:(rank % cards);
* every process writes its outputs and a JSON manifest of the files it
  finished, persisted every 32 files and at the end; a rerun skips the
  files its manifest records (and whose outputs exist), so a failed
  process can simply be started again;
* the only traffic between processes is the final summary, three integers
  gathered from every process (global_summary);
* encode_tiled encodes one image across the processes: every process holds
  the image (as the JAX package's make_array_from_callback hands each its
  rows) and codes its contiguous run of bands (parallel/tiled.BandRun) on
  its own card; the final DCs cross in one all_gather of a (world, 3)
  int32 host tensor (the ppermute), optimized Huffman sums the (4, 256)
  statistics in one all_reduce (the psum), and the bit lengths, then the
  payload bytes, are all-gathered, so every process returns the same file
  (the JAX package's replicate_out). Restart framing gathers the intervals
  with no DC exchange. Every collective runs on the host over gloo, whose
  CUDA support is partial (and NCCL refuses two ranks on one card).

One process encodes everything itself with the same code.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.parallel import batch, stream, tiled
from jpeg_encoder_torch.parallel import devices as devices_lib

# Seconds a rendezvous or a collective waits for the other processes.
TIMEOUT_S = 120.0
# Files between two writes of the manifest.
PERSIST_EVERY = 32


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    timeout: float = TIMEOUT_S,
) -> tuple[int, int]:
    """Join the gloo process group when launched as one of several
    processes; else do nothing. -> (rank, world size).

    coordinator_address ("host:port", the same in every process; rank 0
    listens there), num_processes and process_id are the JAX package's
    keyword names. Without an address, torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) is used when present.
    The rendezvous and every later collective raise after `timeout`
    seconds.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    wait = datetime.timedelta(seconds=timeout)
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError(
                "a coordinator address needs num_processes and process_id"
            )
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=wait,
        )
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo", init_method="env://", timeout=wait)
    return _rank_world()


def _rank_world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _own_card(rank: int) -> torch.device:
    """The card of process `rank` when it is one of several: rank % cards,
    so the processes of one machine spread over its cards."""
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


@dataclasses.dataclass
class DatasetResult:
    encoded: int
    skipped: int
    output_bytes: int
    manifest_path: str
    pixels: int = 0            # pixels encoded this run (not skipped ones)
    seconds: float = 0.0       # file-to-file wall clock of the encode loop
    decode_seconds: float = 0.0  # loader-thread busy time (overlapped)
    write_seconds: float = 0.0   # assemble_seconds + emit_seconds
    assemble_seconds: float = 0.0  # assembler-thread busy time (overlapped)
    emit_seconds: float = 0.0      # emitter-thread busy time (overlapped)


def _manifest_path(out_dir: str, process_index: int) -> str:
    return os.path.join(out_dir, f"manifest-{process_index:05d}.json")


def _load_manifest(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"files": {}}


def encode_dataset(
    paths: list,
    out_dir: str,
    config: EncoderConfig = EncoderConfig(),
    *,
    device: str | torch.device | None = None,
    devices=None,
    resume: bool = True,
) -> DatasetResult:
    """Encode this process's share of `paths` into out_dir.

    Files are assigned round-robin by rank (strided) and encoded through
    stream.encode_paths on `device`, or over `devices` (a count of cards
    or a list). By default one process takes every card present and each
    of several processes card rank % cards, so the processes of one
    machine spread over its cards ("cpu" runs the plain versions). A
    manifest records every finished file with its output size; with
    `resume`, files already in the manifest (and present on disk) are
    skipped.
    """
    os.makedirs(out_dir, exist_ok=True)
    rank, world = _rank_world()
    mine = [str(p) for p in paths][rank::world]
    if device is None and devices is None:
        if world == 1 and torch.cuda.device_count() > 1:
            devices = torch.cuda.device_count()
        else:
            device = _own_card(rank)

    manifest_file = _manifest_path(out_dir, rank)
    manifest = _load_manifest(manifest_file)
    done = manifest["files"]

    def out_name(path: str) -> str:
        return os.path.splitext(os.path.basename(path))[0] + ".jpeg"

    todo = []
    skipped = 0
    for path in mine:
        name = out_name(path)
        if (
            resume
            and name in done
            and os.path.exists(os.path.join(out_dir, name))
        ):
            skipped += 1
        else:
            todo.append(path)

    def persist_manifest():
        manifest["updated"] = time.time()
        with open(manifest_file, "w") as f:
            json.dump(manifest, f, indent=1)

    emitted = 0

    def emit(path: str, data: bytes):
        nonlocal emitted
        name = out_name(path)
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        done[name] = {"bytes": len(data), "source": path}
        emitted += 1
        # A crash loses at most PERSIST_EVERY files of bookkeeping (the
        # files are on disk; a rerun re-encodes the ones not recorded).
        if emitted % PERSIST_EVERY == 0:
            persist_manifest()

    try:
        stats = stream.encode_paths(todo, config, emit, device=device,
                                    devices=devices)
    finally:
        persist_manifest()

    return DatasetResult(
        encoded=stats.encoded,
        skipped=skipped,
        output_bytes=stats.output_bytes,
        manifest_path=manifest_file,
        pixels=stats.pixels,
        seconds=stats.seconds,
        decode_seconds=stats.decode_seconds,
        write_seconds=stats.write_seconds,
        assemble_seconds=stats.assemble_seconds,
        emit_seconds=stats.emit_seconds,
    )


def global_summary(result: DatasetResult) -> dict:
    """The results of every process summed (one all_gather of three
    integers over gloo); one process's own results otherwise."""
    _, world = _rank_world()
    mine = torch.tensor(
        [result.encoded, result.skipped, result.output_bytes],
        dtype=torch.int64,
    )
    if world > 1:
        every = [torch.zeros_like(mine) for _ in range(world)]
        dist.all_gather(every, mine)
        mine = torch.stack(every).sum(dim=0)
    encoded, skipped, output_bytes = (int(v) for v in mine)
    return {
        "processes": world,
        "encoded": encoded,
        "skipped": skipped,
        "output_bytes": output_bytes,
    }


def encode_tiled(
    rgb: np.ndarray,
    config: EncoderConfig,
    bands: int | None = None,
    *,
    device: str | torch.device | None = None,
) -> pipeline.EncodeResult:
    """Encode one (H, W, 3) uint8 image as `bands` MCU-row bands (default:
    one a process) across the processes of the group, each holding the
    whole image and coding its contiguous run of bands on `device` (by
    default card rank % cards). Every process returns the same result,
    byte-identical to pipeline.encode_array's; one process alone codes
    every band. The fallbacks of parallel/tiled.encode_tiled (quirk
    geometries, a restart interval with no band split) encode the image
    whole in every process, with no collective."""
    rank, world = _rank_world()
    share = devices_lib.Share(devices_lib.resolve_device(
        _own_card(rank) if device is None else device))
    bands = world if bands is None else bands
    geom, band_rows = tiled.prepare(rgb, config, bands)
    if band_rows is None:
        return pipeline.encode_array(rgb, config, device=share.device)
    restart = config.restart_interval
    runs = tiled.BandRun.split(geom, band_rows, bands, world)
    run = runs[rank] if rank < len(runs) and runs[rank].live_entries else None
    init = luts = specs = None
    pieces = []
    with share.on():
        if run is not None:
            z, lasts = run.front(rgb, config, share.device)
        if restart is None:
            # The ppermute: every run's last final DCs, to every process.
            last = (torch.zeros(3, dtype=torch.int32) if run is None
                    else lasts[-1].to(torch.int32).cpu())
            every = _all_gather(last, world)
            if run is not None:
                init = tiled.chained(
                    lasts, every[rank - 1].to(share.device) if rank else None)
        if config.optimize_huffman:
            # The psum: one table set from every band's statistics.
            hist = (torch.zeros((4, 256), dtype=torch.int64) if run is None
                    else run.histogram(z, init, restart).cpu())
            if world > 1:
                dist.all_reduce(hist)
            specs, host_luts = pipeline.optimal_specs_and_luts(hist.numpy(),
                                                               "cpu")
            luts = tuple(t.to(share.device) for t in host_luts)
        if run is not None:
            pieces = run.collect(
                z, *batch.fetch_chunk(*run.encode(z, init, luts, config)),
                init, luts, config)
    bound = runs[0].count * (1 if restart is None else
                             -(-band_rows * geom.mcu_cols // restart))
    return tiled.assemble(geom, config, _replicate(pieces, bound, world),
                          specs)


def _all_gather(tensor: torch.Tensor, world: int) -> torch.Tensor:
    """Every process's host `tensor` (one shape in all), stacked in rank
    order."""
    if world == 1:
        return tensor[None]
    every = [torch.empty_like(tensor) for _ in range(world)]
    dist.all_gather(every, tensor)
    return torch.stack(every)


def _replicate(pieces: list, bound: int, world: int) -> list:
    """Every process's [(payload, bits)] joined in rank order (the JAX
    package's replicate_out): one all_gather of the bit lengths (at most
    `bound` pieces a process), one of the payload bytes."""
    bits = torch.full((1 + bound,), -1, dtype=torch.int64)
    bits[0] = len(pieces)
    bits[1 : 1 + len(pieces)] = torch.tensor([b for _, b in pieces],
                                             dtype=torch.int64)
    every_bits = _all_gather(bits, world)
    mine = np.concatenate([np.zeros(0, np.uint8)] + [
        np.asarray(p[: (b + 7) // 8], dtype=np.uint8) for p, b in pieces])
    counts = [every_bits[r, 1 : 1 + int(every_bits[r, 0])].tolist()
              for r in range(world)]
    longest = max(sum((b + 7) // 8 for b in c) for c in counts)
    buffer = torch.zeros(max(1, longest), dtype=torch.uint8)
    buffer[: mine.size] = torch.from_numpy(mine)
    every_bytes = _all_gather(buffer, world).numpy()
    joined = []
    for r, rank_bits in enumerate(counts):
        at = 0
        for b in rank_bits:
            size = (b + 7) // 8
            joined.append((every_bytes[r, at : at + size], b))
            at += size
    return joined
