"""Dataset encoding across processes: a file list in strided shares.

Port of jpeg_encoder_tpu/parallel/multihost.py on torch.distributed:

* initialize() joins a gloo process group when the process was launched
  as one of several (an explicit coordinator address, or torchrun's
  environment), with a timeout, so that a missing peer fails instead of
  hanging;
* each process takes a strided share of the file list (whole images are
  independent: no coordination) and pushes it through the stream engine
  (parallel/stream.py) on its own card, cuda:(rank % cards) by default;
* every process writes its outputs and a JSON manifest of the files it
  finished, persisted every 32 files and at the end; a rerun skips the
  files its manifest records (and whose outputs exist), so a failed
  process can simply be started again;
* the only traffic between processes is the final summary, three integers
  gathered from every process (global_summary).

One process encodes everything itself with the same code.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time

import torch
import torch.distributed as dist

from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.parallel import stream

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


@dataclasses.dataclass
class DatasetResult:
    encoded: int
    skipped: int
    output_bytes: int
    manifest_path: str
    pixels: int = 0            # pixels encoded this run (not skipped ones)
    seconds: float = 0.0       # file-to-file wall clock of the encode loop
    decode_seconds: float = 0.0  # loader-thread busy time (overlapped)
    write_seconds: float = 0.0   # writer-thread busy time (overlapped)


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
    resume: bool = True,
) -> DatasetResult:
    """Encode this process's share of `paths` into out_dir.

    Files are assigned round-robin by rank (strided) and encoded through
    stream.encode_paths on `device`: by default card rank % cards, so the
    processes of one machine spread over its cards ("cpu" runs the plain
    versions). A manifest records every finished file with its output
    size; with `resume`, files already in the manifest (and present on
    disk) are skipped.
    """
    os.makedirs(out_dir, exist_ok=True)
    rank, world = _rank_world()
    mine = [str(p) for p in paths][rank::world]
    if device is None:
        device = torch.device("cuda", rank % max(1, torch.cuda.device_count()))

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
        stats = stream.encode_paths(todo, config, emit, device=device)
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
