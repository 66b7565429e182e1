"""Batch encode: many same-sized images, one launch per kernel per chunk.

Port of jpeg_encoder_tpu/parallel/batch.py to one device. The JAX package
vmaps its single-image program over the batch; here the batch dimension is
written out (pipeline.scan_entries on (B, H, W, 3)):

* the front (colour, pad, subsample) runs on (B, H, W, 3) at once;
* the B padded planes of each component are stacked into one plane, so K1,
  K2 or K3 codes the whole chunk in one launch without a change;
* K4 codes every image, or every restart interval of every image, into its
  own row in one launch (kernels/entropy.py with entries_per_interval: an
  image's unbroken scan is one interval of its entries), with one table
  pair for all or, for optimized Huffman, one per image.

encode_batch cuts the batch into chunks (chunk_size_images): an input-byte
budget and an image cap (K4's 64-bit bit offsets are relative to a row, an
image or a restart interval, so they bound neither). Each chunk is
dispatch_chunk (upload_chunk, a synchronous pageable copy, then
dispatch_uploaded: device work on the current stream, enqueued, nothing
synchronised; parallel/stream.py uploads on its own and calls
dispatch_uploaded), fetch_chunk (one copy of the bit
counts, then one copy of every row up to the longest payload) and
assemble_chunk (JFIF files on the host; a member whose payload overflowed
the chunk's shared capacity is re-encoded alone through
pipeline.encode_array from the next capacity rung). Optimized Huffman runs
the two passes over the chunk: statistics (one bincount), tables on the
host, then the encode of the same scan entries with per-image tables.

Files are byte-identical to pipeline.encode_array's for every config. Like
the JAX package's batch, this path does not check config.validate (only
its single-image retries do) and has no packer option: K5 stays a tier of
encode_array. Entry points run on "cuda" unless the caller asks for the
CPU, where the kernels' plain versions run.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.config import EncoderConfig, FrameGeometry
from jpeg_encoder_torch.io import jfif
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops

# Input-byte budget of one chunk (the decoded uint8 images; coefficients
# and buffers scale with it), and a cap on images per chunk for tiny
# images. Tests monkeypatch both.
CHUNK_INPUT_BUDGET = 128 * 1024 * 1024
MAX_IMAGES_PER_CHUNK = 64


def chunk_size_images(geom: FrameGeometry) -> int:
    """Images per dispatch for this geometry: at most CHUNK_INPUT_BUDGET
    bytes of input and MAX_IMAGES_PER_CHUNK images; always at least one."""
    per_image = geom.height * geom.width * 3
    return max(1, min(MAX_IMAGES_PER_CHUNK, CHUNK_INPUT_BUDGET // per_image))


def encode_batch(
    images: np.ndarray,
    config: EncoderConfig = EncoderConfig(),
    *,
    device: str | torch.device = "cuda",
) -> list[bytes]:
    """Encode (B, H, W, 3) uint8 images -> list of B JFIF files, on
    `device` (the card by default); batches beyond the geometry's chunk
    size run as several bounded dispatches."""
    pipeline.check_config(config)
    if images.ndim != 4 or images.shape[3] != 3:
        raise ValueError("expected (B, H, W, 3) uint8 batch")
    batch, height, width = images.shape[:3]
    geom = config.geometry(width, height)
    if config.restart_interval is not None:
        pipeline.check_restart_geometry(geom)
    chunk = chunk_size_images(geom)
    encode_one_chunk = (
        _encode_chunk_optimized if config.optimize_huffman else _encode_chunk
    )
    files: list[bytes] = []
    for start in range(0, batch, chunk):
        files.extend(encode_one_chunk(
            images[start : start + chunk], config, geom, device
        ))
    return files


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


def upload_chunk(images: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """(B, H, W, 3) uint8 host images -> the same on `device`, copied
    synchronously from pageable memory (parallel/stream.py stages its
    uploads in pinned memory on a copy stream instead)."""
    return torch.as_tensor(np.ascontiguousarray(images, dtype=np.uint8),
                           device=device)


def front_entries(rgb: torch.Tensor, config, geom) -> torch.Tensor:
    """The front half over an uploaded (B, H, W, 3) uint8 chunk: its
    (B * E, 64) scan entries, on rgb's device."""
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


def dispatch_chunk(
    images: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    capacity: int,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Upload one chunk and enqueue its encode: dispatch_uploaded over
    upload_chunk's copy."""
    return dispatch_uploaded(upload_chunk(images, device), config, geom,
                             capacity)


def dispatch_uploaded(
    rgb: torch.Tensor,
    config: EncoderConfig,
    geom: FrameGeometry,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the encode of one uploaded (B, H, W, 3) uint8 chunk on rgb's
    device (on the current stream): (payloads, bit lengths) as device
    tensors, (B, capacity) and (B,), or (B, n_int, capacity) and (B,
    n_int) with restart markers. Nothing is synchronised, so the caller can
    overlap other work and fetch later (fetch_chunk)."""
    return _encode_entries(front_entries(rgb, config, geom), config, geom,
                           capacity)


def fetch_chunk(
    payloads: torch.Tensor, bit_lengths: torch.Tensor
) -> tuple[np.ndarray, np.ndarray]:
    """Device results -> host arrays: the bit counts, then every row sliced
    on the device to the longest payload's bytes (rows are capacity-sized,
    several times the real payloads) and copied once."""
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
    tensor: they are read only to retry a member.

    A member whose payload (or any interval's) overflowed `capacity` is
    re-encoded alone through pipeline.encode_array, from the next rung of
    the capacity ladder: the same program (and the same optimal tables),
    so the same bytes, and one pathological image does not grow every
    member's buffer.
    """
    restart = config.restart_interval
    files = []
    for i in range(images.shape[0]):
        bits = bit_lengths[i]
        specs = None if specs_list is None else specs_list[i]
        if int(np.max(bits)) > 8 * capacity:
            files.append(_retry(images[i], config, geom, capacity, device))
        elif restart is not None:
            files.append(jfif.assemble_restart(
                geom, list(payloads[i]), [int(b) for b in bits], restart,
                quality=config.quality, dht_specs=specs,
            ))
        else:
            files.append(jfif.assemble(
                geom, payloads[i, : (int(bits) + 7) // 8],
                quality=config.quality, dht_specs=specs,
            ))
    return files


def _retry(rgb, config, geom, capacity, device) -> bytes:
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.cpu().numpy()
    restart = config.restart_interval
    if restart is None:
        rung = pipeline.next_capacity_bytes(geom, capacity)
    else:
        rung = pipeline.restart_next_capacity_bytes(geom, restart, capacity)
    return pipeline.encode_array(
        np.asarray(rgb), config, device=device, _initial_capacity_bytes=rung
    ).file_bytes


def _encode_chunk(images, config, geom, device) -> list[bytes]:
    """One bounded dispatch, synchronously: dispatch -> fetch -> assemble."""
    capacity = chunk_capacity_bytes(config, geom)
    payloads, bits = dispatch_chunk(images, config, geom, capacity, device)
    payloads_np, bits_np = fetch_chunk(payloads, bits)
    return assemble_chunk(images, config, geom, capacity, payloads_np,
                          bits_np, device)


def _encode_chunk_optimized(images, config, geom, device) -> list[bytes]:
    """One bounded optimized-Huffman dispatch: the statistics pass over the
    chunk, each member's optimal tables on the host, then one encode of the
    same scan entries with the per-image tables."""
    capacity = chunk_capacity_bytes(config, geom)
    z, hists = dispatch_optimized_stats(images, config, geom, device)
    specs_list, dc_luts, ac_luts = build_chunk_luts(hists.cpu().numpy())
    payloads, bits = dispatch_optimized_encode(
        z, dc_luts, ac_luts, config, geom, capacity
    )
    payloads_np, bits_np = fetch_chunk(payloads, bits)
    return assemble_chunk_optimized(
        images, config, geom, capacity, payloads_np, bits_np, specs_list,
        device,
    )


def dispatch_optimized_stats(
    images: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Upload one optimize chunk and enqueue its statistics pass:
    optimized_stats_uploaded over upload_chunk's copy."""
    return optimized_stats_uploaded(upload_chunk(images, device), config,
                                    geom)


def optimized_stats_uploaded(
    rgb: torch.Tensor, config: EncoderConfig, geom: FrameGeometry
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the statistics pass of one uploaded optimize chunk: (the
    chunk's (B * E, 64) scan entries, which the encode pass reuses, and
    (B, 4, 256) symbol counts), both on rgb's device, unsynchronised. The
    framing is the encode pass's (restart_interval)."""
    z = front_entries(rgb, config, geom)
    hists = entropy_ops.symbol_histograms(z, geom, config.restart_interval)
    return z, hists.reshape(-1, 4, 256)


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the encode pass of an optimize chunk: its entries (on their
    device) with one (dc, ac) table pair per image, as dispatch_chunk's
    result."""
    luts = tuple(torch.from_numpy(t).to(z.device) for t in (dc_luts, ac_luts))
    return _encode_entries(z, config, geom, capacity, luts)


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
