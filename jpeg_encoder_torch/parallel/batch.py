"""Batch encode: many same-sized images, one launch per kernel per share.

Port of jpeg_encoder_tpu/parallel/batch.py. The JAX package vmaps its
single-image program over the batch and shards the batch over a mesh;
here the batch dimension is written out (pipeline.scan_entries on (B, H,
W, 3), or on (B, H, stride) stored rows), and `devices` takes the mesh's
place:

* the front (colour, pad, subsample; the F1 kernel) runs on the whole
  chunk in one launch;
* the B padded planes of each component are stacked into one plane, so K1,
  K2 or K3 codes the whole chunk in one launch without a change;
* K4 codes every image, or every restart interval of every image, into its
  own row in one launch (kernels/entropy.py with entries_per_interval: an
  image's unbroken scan is one interval of its entries), with one table
  pair for all or, for optimized Huffman, one per image.

encode_batch cuts the batch into chunks (chunk_size_images): an input-byte
budget and an image cap a share (K4's 64-bit bit offsets are relative to a
row, an image or a restart interval, so they bound neither). With
`devices` (a count or a list, parallel/devices.py) a chunk is split into
contiguous shares, one an entry, as P(DATA_AXIS) splits the JAX batch:
each share is uploaded and enqueued on its own card and stream before any
share is fetched, and the files come back in input order. Each share is
dispatch_chunk (on a card the share goes up through the calling thread's
pinned upload ring, pipeline.upload, piece after piece, each piece's copy
to the card overlapping the host's filling of the next; device work on
the current stream, enqueued, nothing synchronised; parallel/stream.py
uploads the files' stored rows on its own and calls dispatch_uploaded
with them, as bmp.Rows: the front kernel reads them as stored,
kernels/front.py), fetch_chunk (one copy of the bit counts,
then one copy of every row up to the longest payload) and assemble_chunk
(JFIF files on the host; a member whose payload overflowed the chunk's
shared capacity is re-encoded alone through pipeline.encode_array from
the next capacity rung). Optimized Huffman runs the two passes over each share: statistics
(one histogram), tables on the host, then the encode of the same scan
entries with per-image tables.

The device work of a chunk is one program (two with optimized Huffman),
run through graphs.run under program_keys, as the JAX package runs its
compiled_batch_encoder, compiled_batch_stats_encoder and
compiled_batch_custom_encoder: on a card the first call of a key runs
eagerly, the second captures a CUDA graph, later calls copy their inputs
into its buffers and replay it (graphs.disabled() keeps it eager). The key
holds the exact image count (no power-of-two ladder: a short last chunk is
a key of its own). A replay overwrites its key's outputs: encode_batch
fetches a chunk before its next call of the key, each share under an
owner of its own (graphs.run's owner; on a card each share has its own
stream as well).

Files are byte-identical to pipeline.encode_array's for every config. Like
the JAX package's batch, this path does not check config.validate (only
its single-image retries do) and has no packer option: K5 stays a tier of
encode_array. Entry points run on "cuda" unless the caller asks for the
CPU, where the kernels' plain versions run.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from jpeg_encoder_torch import graphs, pipeline, trace
from jpeg_encoder_torch.config import EncoderConfig, FrameGeometry
from jpeg_encoder_torch.io import bmp, jfif
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops
from jpeg_encoder_torch.parallel import devices as devices_lib

# Input-byte budget of one share of a chunk (the decoded uint8 images;
# coefficients and buffers scale with it), and a cap on a share's images
# for tiny images. Tests monkeypatch both.
CHUNK_INPUT_BUDGET = 128 * 1024 * 1024
MAX_IMAGES_PER_CHUNK = 64


def chunk_size_images(geom: FrameGeometry, n_dev: int = 1) -> int:
    """Images per dispatch for this geometry over n_dev shares (the JAX
    package's chunk_size_images): at most CHUNK_INPUT_BUDGET bytes of
    input and MAX_IMAGES_PER_CHUNK images a share, at least one."""
    per_image = geom.height * geom.width * 3
    per_dev = max(1, min(MAX_IMAGES_PER_CHUNK,
                         CHUNK_INPUT_BUDGET // per_image))
    return per_dev * n_dev


@trace.entry("encode_batch")
def encode_batch(
    images: np.ndarray,
    config: EncoderConfig = EncoderConfig(),
    *,
    device: str | torch.device = "cuda",
    devices=None,
) -> list[bytes]:
    """Encode (B, H, W, 3) uint8 images -> list of B JFIF files, on
    `device` (the card by default), or over `devices` (a count of cards
    or a list of devices, which may repeat one: each entry takes a
    contiguous share of every chunk); batches beyond the geometry's chunk
    size run as several bounded dispatches. Its steps are spans
    (trace.py): batch.dispatch (the upload's spans beneath it),
    batch.fetch and batch.assemble a share of each chunk."""
    pipeline.check_config(config)
    if images.ndim != 4 or images.shape[3] != 3:
        raise ValueError("expected (B, H, W, 3) uint8 batch")
    batch, height, width = images.shape[:3]
    geom = config.geometry(width, height)
    if config.restart_interval is not None:
        pipeline.check_restart_geometry(geom)
    shares = devices_lib.shares(device, devices)
    chunk = chunk_size_images(geom, len(shares))
    encode_one_chunk = (
        _encode_chunk_optimized if config.optimize_huffman else _encode_chunk
    )
    files: list[bytes] = []
    for start in range(0, batch, chunk):
        files.extend(encode_one_chunk(
            images[start : start + chunk], config, geom, shares
        ))
    return files


def _shares_of(images, shares):
    """[(share, its contiguous images)] of one chunk."""
    return [(share, images[lo:hi]) for share, (lo, hi) in
            zip(shares, devices_lib.split(len(images), len(shares)))]


def chunk_capacity_bytes(config: EncoderConfig, geom: FrameGeometry) -> int:
    """The batch dispatch's shared initial capacity for this config (per
    restart interval with restart markers)."""
    if config.restart_interval is not None:
        return pipeline.restart_default_capacity_bytes(
            geom, config.restart_interval, config.capacity_bytes_per_pixel
        )
    return pipeline.default_capacity_bytes(
        geom, config.capacity_bytes_per_pixel
    )


def program_keys(geom: FrameGeometry, config: EncoderConfig, capacity: int,
                 images: int, source: str = "rgb") -> dict[str, tuple]:
    """The keys (graphs.run) of the device programs of a chunk of `images`
    images of geom (the exact count) at the chunk's shared capacity:
    "batch" (the chunk -> payloads and bits: dispatch_uploaded) and, for
    optimized Huffman, "batch_stats" (the chunk -> entries and symbol
    counts: optimized_stats_uploaded) then "batch_custom" (entries and each
    image's tables, program inputs -> payloads and bits:
    dispatch_optimized_encode). Each holds what changes its program, as the
    JAX package's compiled_batch_* keys do (the mesh aside: a share is the
    caller's stream and owner); the batch neither validates nor takes a
    packer. The two that take the chunk end with its form, source: "rgb"
    ((B, H, W, 3) images) or "bmp-rows" (the files' stored rows, bmp.Rows),
    as pipeline.program_keys does; "batch_custom" takes the entries, the
    same in either form."""
    front = (geom, *pipeline.dct_key(config), config.restart_interval,
             images)
    return {"batch": ("batch", *front, capacity, source),
            "batch_stats": ("batch_stats", *front, source),
            "batch_custom": ("batch_custom", geom, config.restart_interval,
                             capacity, images)}


def front_entries(rgb: torch.Tensor | bmp.Rows, config, geom) -> torch.Tensor:
    """The front half over an uploaded (B, H, W, 3) uint8 chunk, or bmp.Rows
    of (B, H, stride) stored rows: its (B * E, 64) scan entries, on the
    chunk's device."""
    z, _ = pipeline.scan_entries(
        rgb, geom, config.dct_algorithm, config.quality,
        fast_dct=config.fast_dct, bin_dct_descale=config.bin_dct_descale,
    )
    return z


def _encode_entries(z, config, geom, capacity, luts=None):
    """K4 over a chunk's entries: (payloads (B, capacity) or (B, n_int,
    capacity) uint8, bits (B,) or (B, n_int) int64), on z's device."""
    restart = config.restart_interval
    epi = (geom.num_scan_entries if restart is None
           else entropy_ops.entries_per_interval(geom, restart))
    data, bits = entropy_kernel.encode_entries(
        z, geom, capacity, luts=luts, entries_per_interval=epi
    )
    batch = z.shape[0] // geom.num_scan_entries
    if restart is None:
        return data, bits
    return data.reshape(batch, -1, capacity), bits.reshape(batch, -1)


def _form(images):
    """A chunk as a program takes it, (B, H, W, 3) RGB or bmp.Rows of (B,
    H, stride) stored rows: (its source form, the program's inputs, a
    function that makes a program of an image take its input tensor). The
    front kernel reads the rows as stored (kernels/front.py)."""
    if isinstance(images, bmp.Rows):
        width, height = images.width, images.height
        return ("bmp-rows", {"rows": images.rows},
                lambda program: lambda rows: program(
                    bmp.Rows(rows, width, height)))
    return "rgb", {"rgb": images}, lambda program: program


def _tensor(images) -> torch.Tensor:
    """A chunk's tensor in either form: its images or its stored rows."""
    return images.rows if isinstance(images, bmp.Rows) else images


def _batch(images, config, geom, capacity, device, owner):
    """The "batch" program of a chunk (on the host or on device, either
    form) on device."""

    def program(rgb):
        return _encode_entries(front_entries(rgb, config, geom), config,
                               geom, capacity)

    source, inputs, taking = _form(images)
    count = _tensor(images).shape[0]
    key = program_keys(geom, config, capacity, count, source)["batch"]
    return graphs.run(key, taking(program), inputs, device, owner=owner)


def _stats(images, config, geom, device, owner):
    """The "batch_stats" program of a chunk (on the host or on device,
    either form) on device."""

    def program(rgb):
        z = front_entries(rgb, config, geom)
        hists = entropy_ops.symbol_histograms(z, geom,
                                              config.restart_interval)
        return z, hists.reshape(-1, 4, 256)

    source, inputs, taking = _form(images)
    count = _tensor(images).shape[0]
    key = program_keys(geom, config, 0, count, source)["batch_stats"]
    return graphs.run(key, taking(program), inputs, device, owner=owner)


def dispatch_chunk(
    images: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    capacity: int,
    device: str | torch.device = "cuda",
    owner=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the encode of one (B, H, W, 3) uint8 host chunk on `device`:
    the chunk goes up through the calling thread's pinned upload ring
    (pipeline.upload; on the CPU it is used as it is), then
    dispatch_uploaded's program runs on it. owner: graphs.run's."""
    device = devices_lib.resolve_device(device)
    with trace.span("batch.dispatch"):
        return _batch(pipeline.upload(images, device), config, geom,
                      capacity, device, owner)


def dispatch_uploaded(
    images: torch.Tensor | bmp.Rows,
    config: EncoderConfig,
    geom: FrameGeometry,
    capacity: int,
    owner=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the encode of one uploaded chunk, (B, H, W, 3) uint8 images
    or the files' stored rows (bmp.Rows of (B, H, stride) uint8, as the
    stream engine uploads them), on its device (on the current stream):
    (payloads, bit lengths) as device tensors, (B, capacity) and (B,), or
    (B, n_int, capacity) and (B, n_int) with restart markers. Nothing is
    synchronised, so the caller can overlap other work and fetch later
    (fetch_chunk). One program (the "batch" key of the chunk's form,
    graphs.run with `owner`): a replay first copies the chunk into the
    program's buffer, a device-to-device copy, and its outputs are
    overwritten by the key's next replay."""
    return _batch(images, config, geom, capacity, _tensor(images).device,
                  owner)


def fetch_chunk(
    payloads: torch.Tensor, bit_lengths: torch.Tensor
) -> tuple[np.ndarray, np.ndarray]:
    """Device results -> host arrays: the bit counts, then every row sliced
    on the device to the longest payload's bytes (rows are capacity-sized,
    several times the real payloads) and copied once."""
    with trace.span("batch.fetch"):
        bits = bit_lengths.cpu().numpy()
        max_bytes = (int(bits.max()) + 7) // 8
        return payloads[..., :max_bytes].cpu().numpy(), bits


def assemble_chunk(
    images: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    capacity: int,
    payloads: np.ndarray,
    bit_lengths: np.ndarray,
    device: str | torch.device = "cuda",
    specs_list: list | None = None,
) -> list[bytes]:
    """Host-side file assembly for one chunk's fetched results, with each
    member's optimal tables (DHT) if specs_list is given. images are the
    chunk's (B, H, W, 3) uint8 images, on the host or as the uploaded
    tensor, or its files' stored rows (bmp.Rows): they are read only to
    retry a member.

    A member whose payload (or any interval's) overflowed `capacity` is
    re-encoded alone through pipeline.encode_array, from the next rung of
    the capacity ladder: the same program (and the same optimal tables),
    so the same bytes, and one pathological image does not grow every
    member's buffer.
    """
    restart = config.restart_interval
    files = []
    with trace.span("batch.assemble"):
        for i in range(len(bit_lengths)):
            bits = bit_lengths[i]
            specs = None if specs_list is None else specs_list[i]
            if int(np.max(bits)) > 8 * capacity:
                files.append(_retry(_member(images, i), config, geom,
                                    capacity, device))
            elif restart is not None:
                files.append(jfif.assemble_restart(
                    geom, list(payloads[i]), [int(b) for b in bits],
                    restart, quality=config.quality, dht_specs=specs,
                ))
            else:
                files.append(jfif.assemble(
                    geom, payloads[i, : (int(bits) + 7) // 8],
                    quality=config.quality, dht_specs=specs,
                ))
    return files


def _member(images, i: int):
    """Member i of a chunk, in the chunk's form."""
    if isinstance(images, bmp.Rows):
        return bmp.Rows(images.rows[i], images.width, images.height)
    return images[i]


def _retry(image, config, geom, capacity, device) -> bytes:
    """One member (an (H, W, 3) image or its file's bmp.Rows, on the host
    or on a device) through encode_array from the rung above capacity; the
    same program, so the same bytes, in either form."""
    trace.count("batch.retry")
    if isinstance(image, bmp.Rows):
        image = bmp.Rows(image.rows.cpu(), image.width, image.height)
    else:
        if isinstance(image, torch.Tensor):
            image = image.cpu().numpy()
        image = np.asarray(image)
    restart = config.restart_interval
    if restart is None:
        rung = pipeline.next_capacity_bytes(geom, capacity)
    else:
        rung = pipeline.restart_next_capacity_bytes(geom, restart, capacity)
    return pipeline.encode_array(
        image, config, device=device, _initial_capacity_bytes=rung
    ).file_bytes


def _encode_chunk(images, config, geom, shares) -> list[bytes]:
    """One bounded dispatch: every share dispatched on its own stream, then
    each fetched and assembled in turn (a member that overflowed is
    retried on its share's card)."""
    capacity = chunk_capacity_bytes(config, geom)
    parts = _shares_of(images, shares)
    thread = threading.get_ident()
    enqueued = []
    for k, (share, part) in enumerate(parts):
        with share.on():
            enqueued.append(dispatch_chunk(part, config, geom, capacity,
                                           share.device, (thread, k)))
    files = []
    for (share, part), (payloads, bits) in zip(parts, enqueued):
        with share.on():
            payloads_np, bits_np = fetch_chunk(payloads, bits)
            files.extend(assemble_chunk(part, config, geom, capacity,
                                        payloads_np, bits_np, share.device))
    return files


def _encode_chunk_optimized(images, config, geom, shares) -> list[bytes]:
    """One bounded optimized-Huffman dispatch: the statistics pass of every
    share, then for each share its members' optimal tables on the host and
    one encode of the same scan entries with them, then every share's
    fetch and assembly."""
    capacity = chunk_capacity_bytes(config, geom)
    parts = _shares_of(images, shares)
    thread = threading.get_ident()
    stats = []
    for k, (share, part) in enumerate(parts):
        with share.on():
            stats.append(dispatch_optimized_stats(part, config, geom,
                                                  share.device, (thread, k)))
    enqueued = []
    for k, ((share, _), (z, hists)) in enumerate(zip(parts, stats)):
        with share.on():
            specs_list, dc_luts, ac_luts = build_chunk_luts(
                hists.cpu().numpy())
            enqueued.append((specs_list, *dispatch_optimized_encode(
                z, dc_luts, ac_luts, config, geom, capacity, (thread, k))))
    files = []
    for (share, part), (specs_list, payloads, bits) in zip(parts, enqueued):
        with share.on():
            payloads_np, bits_np = fetch_chunk(payloads, bits)
            files.extend(assemble_chunk_optimized(
                part, config, geom, capacity, payloads_np, bits_np,
                specs_list, share.device))
    return files


def dispatch_optimized_stats(
    images: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    device: str | torch.device = "cuda",
    owner=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the statistics pass of one optimize host chunk on `device`:
    optimized_stats_uploaded's program on the chunk, uploaded as
    dispatch_chunk uploads it."""
    device = devices_lib.resolve_device(device)
    return _stats(pipeline.upload(images, device), config, geom, device,
                  owner)


def optimized_stats_uploaded(
    images: torch.Tensor | bmp.Rows, config: EncoderConfig,
    geom: FrameGeometry, owner=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the statistics pass of one uploaded optimize chunk (either
    form, as dispatch_uploaded takes it): (the chunk's (B * E, 64) scan
    entries, which the encode pass reuses, and (B, 4, 256) symbol counts),
    both on its device, unsynchronised. The framing is the encode pass's
    (restart_interval). One program (the "batch_stats" key of the chunk's
    form, graphs.run with `owner`), its outputs overwritten by the key's
    next replay."""
    return _stats(images, config, geom, _tensor(images).device, owner)


def build_chunk_luts(
    hists: np.ndarray,
) -> tuple[list, np.ndarray, np.ndarray]:
    """(B, 4, 256) symbol counts -> (the four optimal HuffmanSpecs of each
    member, (B, 2, 256) packed DC tables, (B, 2, 256) packed AC tables)."""
    specs_list, dc_luts, ac_luts = [], [], []
    for hist in hists:
        specs, (dc, ac) = pipeline.optimal_specs_and_luts(hist, "cpu")
        specs_list.append(specs)
        dc_luts.append(dc.numpy())
        ac_luts.append(ac.numpy())
    return specs_list, np.stack(dc_luts), np.stack(ac_luts)


def dispatch_optimized_encode(
    z: torch.Tensor,
    dc_luts: np.ndarray,
    ac_luts: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    capacity: int,
    owner=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the encode pass of an optimize chunk: its entries (on their
    device) with one (dc, ac) table pair per image, as dispatch_chunk's
    result. One program (the "batch_custom" key, graphs.run with `owner`):
    a replay copies the entries and the (B, 2, 256) host tables (pinned
    on a card) into its buffers."""

    def program(z, dc_luts, ac_luts):
        return _encode_entries(z, config, geom, capacity, (dc_luts, ac_luts))

    images = z.shape[0] // geom.num_scan_entries
    key = program_keys(geom, config, capacity, images)["batch_custom"]
    inputs = {"z": z,
              "dc_luts": pipeline.pinned(torch.from_numpy(dc_luts), z.device),
              "ac_luts": pipeline.pinned(torch.from_numpy(ac_luts), z.device)}
    return graphs.run(key, program, inputs, z.device, owner=owner)


def assemble_chunk_optimized(
    images: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    capacity: int,
    payloads: np.ndarray,
    bit_lengths: np.ndarray,
    specs_list: list,
    device: str | torch.device = "cuda",
) -> list[bytes]:
    """Host assembly for one optimized chunk: assemble_chunk with each
    member's own tables."""
    return assemble_chunk(images, config, geom, capacity, payloads,
                          bit_lengths, device, specs_list)
