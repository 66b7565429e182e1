"""End-to-end encode: the device path on one device + host assembly.

Port of jpeg_encoder_tpu/pipeline.py: encode_array with every DCT variant
(RealDCT, --fast-dct, binDCT with and without the descale fix), every
subsampling ratio and quality, restart markers and two-pass optimized
Huffman tables (stats_core, then custom_core), alone and combined.
The front (colour, padding, subsampling: kernels/front.py), the DCT and
the scan encoder are kernels (kernels/dct.py, kernels/entropy.py,
kernels/pack.py through scan.py), which run their CUDA code on CUDA
tensors and their plain PyTorch versions on CPU tensors. The exact DCTs
store their rows in scan order themselves (kernels/dct.scan_entries); the
scan marshal (plain PyTorch ops) remains for --fast-dct and for the
callers that keep the per-plane coefficients.
The host builds optimal tables, stuffs 0xFF bytes and writes the JFIF
container (the port's tables.py and io/).

encode_file does not decode the BMP on the host: it reads the file's pixel
rows as stored (io/bmp.read(path, out=..., ranges=...), several ranges at
once on the native read pool) into a host buffer of its thread's
(Staging: pinned on a card, one a device and geometry, a few a thread),
uploads them as they are, and the front kernel reads them as stored
(bottom row first, BGR, padded rows). encode_array takes either form,
an RGB array or bmp.Rows; the form is part of the program's key. The
in-memory entries (encode_array of an array, parallel/batch's chunks,
parallel/tiled's band rows) go up through upload: on a card the calling
thread's ring of pinned pieces (UploadRing), so that nothing goes up
from pageable memory.

encode_array runs its device programs through graphs.run: on a card, one
CUDA graph a configuration (program_keys), replayed from the second call
of a key on (the counterpart of the JAX package's compiled_encoder,
compiled_restart_encoder, compiled_stats_encoder and
compiled_custom_encoder). encode_array and encode_file run on "cuda"
unless the caller passes another device ("cpu" runs the plain versions);
without a card they raise, they do not fall back. The front half
(scan_entries) also takes a batch of images, (B, H, W, 3), which
parallel/batch.py codes in one launch per kernel.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading

import numpy as np
import torch

from jpeg_encoder_torch import graphs, scan, tables, trace
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig, FrameGeometry
from jpeg_encoder_torch.io import bmp, jfif
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.kernels import front as front_kernel
from jpeg_encoder_torch.ops import entropy as entropy_ops
from jpeg_encoder_torch.ops.entropy import worst_case_capacity_bytes
from jpeg_encoder_torch.parallel.devices import resolve_device


def default_capacity_bytes(
    geom: FrameGeometry, bytes_per_pixel: float = 0.5
) -> int:
    """Initial output-buffer size: a content estimate, not the worst case.

    The worst case (~27 bytes per 8x8 block) is ~100x a real image's
    payload, so start from `bytes_per_pixel` (EncoderConfig's
    capacity_bytes_per_pixel), rounded up to a power of two, and let the
    caller retry with next_capacity_bytes on the detectable, rare overflow.
    """
    worst = worst_case_capacity_bytes(geom)
    est = max(int(geom.width * geom.height * bytes_per_pixel), 16384)
    cap = 1 << (est - 1).bit_length()
    return min(cap, worst)


def next_capacity_bytes(geom: FrameGeometry, capacity_bytes: int) -> int:
    """The retry ladder: 8x the buffer, capped at the true worst case."""
    return min(capacity_bytes * 8, worst_case_capacity_bytes(geom))


def restart_worst_case_capacity_bytes(
    geom: FrameGeometry, restart_mcus: int
) -> int:
    """Worst case for ONE restart interval (its entries only)."""
    entries = entropy_ops.entries_per_interval(geom, restart_mcus)
    bits = entries * entropy_ops.WORST_CASE_BITS_PER_ENTRY
    return (bits // 8 + 4) // 4 * 4


def restart_default_capacity_bytes(
    geom: FrameGeometry, restart_mcus: int, bytes_per_pixel: float = 0.5
) -> int:
    """Initial per-interval buffer: the whole-image estimate split evenly,
    rounded up to a power of two and floored at 4 KiB (so that tiny
    intervals do not walk the ladder on content spikes), capped at the
    interval's worst case."""
    worst = restart_worst_case_capacity_bytes(geom, restart_mcus)
    n_int = -(-geom.num_mcus // restart_mcus)
    est = max(
        int(geom.width * geom.height * bytes_per_pixel) // n_int, 4096
    )
    cap = 1 << (est - 1).bit_length()
    return min(cap, worst)


def initial_capacity_bytes(geom: FrameGeometry, config: EncoderConfig) -> int:
    """The capacity ladder's first rung for config at geom: the whole
    scan's buffer, or one restart interval's."""
    if config.restart_interval is None:
        return default_capacity_bytes(geom, config.capacity_bytes_per_pixel)
    return restart_default_capacity_bytes(
        geom, config.restart_interval, config.capacity_bytes_per_pixel)


def restart_next_capacity_bytes(
    geom: FrameGeometry, restart_mcus: int, capacity_bytes: int
) -> int:
    """The restart-mode retry ladder (per-interval buffers): 8x, capped."""
    return min(
        capacity_bytes * 8,
        restart_worst_case_capacity_bytes(geom, restart_mcus),
    )


def dct_planes_zigzag(
    y_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    algorithm: DctAlgorithm,
    quality: int | None = None,
    *,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded planes -> (N_i, 64) int16 zigzag quantized coefficients.

    Routes as jpeg_encoder_tpu.pipeline.dct_planes_zigzag does: fast_dct
    only selects the RealDCT flavour, bin_dct_descale only the binDCT
    quantization; each is ignored by the other algorithm.
    """
    if algorithm == DctAlgorithm.REAL_DCT:
        dct = (dct_kernel.real_dct_fast_planes_zigzag if fast_dct
               else dct_kernel.real_dct_quant_planes_zigzag)
        return dct(y_plane, cb_plane, cr_plane, quality)
    return dct_kernel.bin_dct_quant_planes_zigzag(
        y_plane, cb_plane, cr_plane, quality, bin_dct_descale
    )


@graphs.operand_cache(maxsize=8)
def _inverse_zigzag(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tables.ZIGZAG_INVERSE.astype(np.int64)).to(device)


def natural_order(
    coeffs: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zigzag-ordered (N_i, 64) coefficients -> natural order."""
    inv_zz = _inverse_zigzag(coeffs[0].device)
    return tuple(c[:, inv_zz] for c in coeffs)


def scan_entries(
    image: torch.Tensor | bmp.Rows,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    quality: int | None = None,
    *,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    live_rows: int | None = None,
    with_coeffs: bool = False,
) -> tuple[torch.Tensor,
           tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None]:
    """(H, W, 3) uint8 RGB on a device, or a BMP file's stored rows there
    (bmp.Rows) -> ((E, 64) int16 scan entries, with with_coeffs the (N_i,
    64) zigzag coefficients [Y, Cb, Cr], else None): the front half every
    core shares (the front: colour, pad, subsample; the DCT into scan
    order).

    A batch (B, H, W, 3), or rows of (B, H, stride), gives the B images'
    entries one after another, (B * E, 64): the B padded planes of each
    component are stacked into one (B * Hp, Wp) plane (Hp is a multiple
    of 8, so image b's blocks are rows b * ny ... (b + 1) * ny - 1 of the
    DCT's raster order), and the DCT kernel runs once on the three
    stacked planes.

    RealDCT and binDCT write each block's row straight to its scan entry
    (kernels/dct.scan_entries). --fast-dct, and every call with
    with_coeffs, runs the plane kernel in raster order and the scan
    marshal (ops/entropy.marshal_scan_inputs) gathers each image's entries
    from [all Y | all Cb | all Cr]; the bytes are the same.

    The front is the F1 kernel (kernels/front.py; its plain version on the
    CPU). live_rows zeroes the Y, Cb and Cr rows at or past it, counted
    over the B * H rows of the stack (ops/front.planes).
    """
    y, cb, cr = front_kernel.planes(image, geom, live_rows)
    if not with_coeffs and not (fast_dct
                                and algorithm == DctAlgorithm.REAL_DCT):
        return dct_kernel.scan_entries(
            y, cb, cr, geom, algorithm, quality,
            bin_dct_descale=bin_dct_descale), None
    coeffs = dct_planes_zigzag(
        y, cb, cr, algorithm, quality,
        fast_dct=fast_dct, bin_dct_descale=bin_dct_descale,
    )
    return (entropy_ops.marshal_scan_inputs(*coeffs, geom),
            coeffs if with_coeffs else None)


def custom_core(
    z: torch.Tensor,
    geom: FrameGeometry,
    capacity_bytes: int,
    luts: tuple[torch.Tensor, torch.Tensor] | None = None,
    restart_mcus: int | None = None,
    validate: bool = False,
    packer: str = "fused",
) -> dict[str, torch.Tensor]:
    """Scan entries -> packed payload, with the given Huffman tables (luts,
    (dc, ac) (2, 256) packed; Annex K if None) and, with restart_mcus, one
    stream per restart interval; packer is scan.encode_entries'.

    The scan stage of jpeg_encoder_tpu.pipeline.custom_core, which every
    core here and encode_array share. It takes the entries, not the image:
    encode_array runs colour and the DCT once and codes the same entries
    for every rung of the capacity ladder (and the optimized encode the
    statistics pass's entries; the bytes are the same). Returns
    {"payload", "total_bits"}, or {"payloads", "bits"} per interval; with
    validate also the scan's coefficient ranges (over the unbroken
    predictor chains, as the JAX package checks them).
    """
    data, bits = scan.encode_entries(
        z, geom, capacity_bytes, restart_mcus=restart_mcus, luts=luts,
        packer=packer,
    )
    if restart_mcus is None:
        result = {"payload": data, "total_bits": bits}
    else:
        result = {"payloads": data, "bits": bits}
    if validate:
        result["max_dc_diff"], result["max_ac"] = (
            entropy_ops.coefficient_ranges(z, geom)
        )
    return result


def encode_core(
    rgb: torch.Tensor,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity_bytes: int,
    validate: bool = False,
    with_coeffs: bool = True,
    quality: int | None = None,
    *,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
) -> dict[str, torch.Tensor]:
    """(H, W, 3) uint8 on a device -> packed payload (+ coefficients).

    The DCT emits zigzag-ordered coefficients (the permutation is folded
    into its constants); returned coefficients are put back in natural
    order. All outputs stay on rgb's device.
    """
    z, coeffs = scan_entries(
        rgb, geom, algorithm, quality,
        fast_dct=fast_dct, bin_dct_descale=bin_dct_descale,
        with_coeffs=with_coeffs,
    )
    result = custom_core(z, geom, capacity_bytes, validate=validate)
    if with_coeffs:
        result.update(zip(("y_coeffs", "cb_coeffs", "cr_coeffs"),
                          natural_order(coeffs)))
    return result


def encode_core_restart(
    rgb: torch.Tensor,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity_bytes: int,
    restart_mcus: int,
    validate: bool = False,
    quality: int | None = None,
    *,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
) -> dict[str, torch.Tensor]:
    """encode_core for restart markers: {"payloads" (n_int,
    capacity_bytes) uint8, "bits" (n_int,)}, capacity_bytes per interval.

    Each run of restart_mcus MCUs is an independent scan segment with
    reset DC predictors. Restart markers are absent from the reference
    (file.rs:77-90); they make the files parallel-decodable.
    """
    z, _ = scan_entries(
        rgb, geom, algorithm, quality,
        fast_dct=fast_dct, bin_dct_descale=bin_dct_descale,
    )
    return custom_core(z, geom, capacity_bytes, None, restart_mcus, validate)


def stats_core(
    rgb: torch.Tensor,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    quality: int | None = None,
    *,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    restart_mcus: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The statistics pass: rgb -> ((4, 256) Huffman symbol counts, the
    (E, 64) scan entries the encode pass reuses). restart_mcus must match
    the encode pass's framing (interval DC resets change the DC
    categories the tables must cover)."""
    z, _ = scan_entries(
        rgb, geom, algorithm, quality,
        fast_dct=fast_dct, bin_dct_descale=bin_dct_descale,
    )
    return entropy_ops.symbol_histograms(z, geom, restart_mcus), z


def optimal_specs_and_luts(hist: np.ndarray, device: str | torch.device):
    """(4, 256) symbol counts -> (the four optimal canonical HuffmanSpecs,
    (dc, ac) (2, 256) packed LUTs on device).

    Keeps the JAX package's refusal of AC histograms that count a symbol
    (bl+1)<<4 (a zero run with size 0, r = 1..12), which the fused TPU
    kernel's DC stuffing slots collide with. symbol_histograms never
    counts them (only EOB 0x00 and ZRL 0xF0 have size 0), so this trips
    only on hand-made histograms.
    """
    specs = tuple(tables.optimal_spec(hist[i]) for i in range(4))
    for ac_spec in (specs[2], specs[3]):
        for bl in range(12):
            if ac_spec.length_lut[(bl + 1) << 4] != 0:
                raise ValueError(
                    "AC histogram counts symbol "
                    f"0x{(bl + 1) << 4:02x} (zero-run with size 0), which "
                    "no baseline JPEG scan emits: refusing to build "
                    "tables that collide with the kernel's DC stuffing "
                    "slots"
                )
    luts = tuple(
        torch.from_numpy(np.stack(
            [entropy_ops.pack_lut(specs[i]), entropy_ops.pack_lut(specs[i + 1])]
        )).to(device)
        for i in (0, 2)
    )
    return specs, luts


def validate_scan_ranges(max_dc_diff: int, max_ac: int) -> None:
    """Raise like the reference panics (entropy_coding.rs:153-155,188-191)."""
    if max_dc_diff.bit_length() > 11:
        raise ValueError("DC coefficient bit length greater than 11!")
    if max_ac.bit_length() > 10:
        raise ValueError("AC coefficient bit length greater than 10!")


@dataclasses.dataclass
class EncodeResult:
    file_bytes: bytes
    entropy_payload: bytes  # unstuffed scan payload
    bit_length: int
    geom: FrameGeometry


class Staging:
    """A host buffer for one device and geometry's stored BMP rows, pinned
    on a card (a card without pinned memory raises: nothing goes up from
    pageable memory). wait() returns once the copy out of it that
    release() marked has completed, as parallel/stream.py's pinned ring
    waits before it hands a slot out again."""

    def __init__(self, device: torch.device, nbytes: int):
        self.device = device
        pin = device.type == "cuda"
        self.buffer = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
        if pin and not self.buffer.is_pinned():
            raise RuntimeError(f"could not pin a {nbytes}-byte staging buffer")
        self.copied = torch.cuda.Event() if pin else None

    def release(self) -> None:
        """Mark the end of the work enqueued so far on the device's current
        stream (the copy out of the buffer among it)."""
        if self.copied is not None:
            self.copied.record(torch.cuda.current_stream(self.device))

    def wait(self) -> "Staging":
        if self.copied is not None:
            self.copied.synchronize()
        return self


class StagingBuffers:
    """Each thread's Staging buffers, one a device and geometry, the
    `slots` most recently used kept (pinned memory stays bounded, and no
    two threads share a buffer)."""

    def __init__(self, slots: int = 4):
        self.slots = slots
        self._local = threading.local()

    def take(self, device: torch.device, width: int, height: int) -> Staging:
        """This thread's buffer for device and a width x height file, once
        the copy out of it has completed."""
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = collections.OrderedDict()
        key = (device, width, height)
        if key in held:
            held.move_to_end(key)
        else:
            held[key] = Staging(device, height * bmp.row_stride(width))
            if len(held) > self.slots:
                held.popitem(last=False)
        with trace.span("staging.wait"):
            return held[key].wait()


STAGING = StagingBuffers()

# The upload ring of each thread and device (UploadRing): pieces of
# PIECE_BYTES, RING_DEPTH of them, so a thread pins PIECE_BYTES *
# RING_DEPTH bytes a card, whatever the size of the arrays it uploads.
PIECE_BYTES = 4 << 20
RING_DEPTH = 4


class UploadRing:
    """Host pieces (pinned on a card; not pinned raises) that upload a host
    tensor's bytes to a device one piece after another: each piece is
    filled on the host (torch's copy, on its intra-op threads), then
    copied to its offset of the destination without the host waiting, and
    an event is recorded after that copy. A piece is filled again only
    after its event, as parallel/stream.py's pinned ring waits, so the
    host fills piece k + 1 while piece k goes up."""

    def __init__(self, device: torch.device, piece_bytes: int = PIECE_BYTES,
                 depth: int = RING_DEPTH):
        self.device = device
        pin = device.type == "cuda"
        self.pieces = []
        for _ in range(depth):
            piece = torch.empty(piece_bytes, dtype=torch.uint8,
                                pin_memory=pin)
            if pin and not piece.is_pinned():
                raise RuntimeError(
                    f"could not pin a {piece_bytes}-byte upload piece")
            self.pieces.append(piece)
        self.copied = [torch.cuda.Event() if pin else None
                       for _ in range(depth)]
        self.turn = 0

    def take(self) -> int:
        """The next piece's index, once the copy out of it has completed."""
        i = self.turn % len(self.pieces)
        self.turn += 1
        if self.copied[i] is not None:
            with trace.span("upload.ring_wait"):
                self.copied[i].synchronize()
        return i

    def release(self, i: int) -> None:
        """Mark the copy out of piece i, enqueued on the device's current
        stream."""
        if self.copied[i] is not None:
            self.copied[i].record(torch.cuda.current_stream(self.device))

    def staged(self, host: torch.Tensor) -> torch.Tensor:
        """A new tensor on the ring's device holding host's bytes (a host
        tensor), enqueued on the current stream."""
        host = host.contiguous()
        out = torch.empty(host.shape, dtype=host.dtype, device=self.device)
        self.upload(host.view(-1).view(torch.uint8),
                    out.view(-1).view(torch.uint8))
        return out

    def upload(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """src's bytes (a flat uint8 host tensor) into dst (flat uint8 on
        the ring's device), enqueued on the current stream."""
        piece_bytes = self.pieces[0].numel()
        for start in range(0, src.numel(), piece_bytes):
            stop = min(start + piece_bytes, src.numel())
            i = self.take()
            piece = self.pieces[i][: stop - start]
            self.fill(piece, src[start:stop])
            dst[start:stop].copy_(piece, non_blocking=True)
            self.release(i)

    def fill(self, piece: torch.Tensor, src: torch.Tensor) -> None:
        """The host's copy of src into piece."""
        trace.count("upload.pieces")
        with trace.span("upload.fill") as s:
            if s:
                s.attrs["bytes"] = src.numel()
            piece.copy_(src)


class UploadRings:
    """Each thread's UploadRing, one a device (no two threads share a
    piece)."""

    def __init__(self):
        self._local = threading.local()

    def ring(self, device: torch.device) -> UploadRing:
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = {}
        if device not in held:
            held[device] = UploadRing(device)
        return held[device]


UPLOADS = UploadRings()


def upload(host: np.ndarray | torch.Tensor,
           device: torch.device) -> torch.Tensor:
    """A host image or batch as a program input on device: an array is
    taken as np.ascontiguousarray(host, dtype=np.uint8) (no copy where it
    is contiguous uint8), a tensor as it is. On a card the bytes of one
    in pageable memory go up through the calling thread's UploadRing into
    a new device tensor of the same shape (enqueued on the current stream;
    the caller may reuse its array as soon as this returns); a pinned host
    tensor or a device tensor is returned as it is (graphs.run copies a
    pinned one without waiting). On the CPU -> the CPU tensor."""
    if not isinstance(host, torch.Tensor):
        host = torch.from_numpy(np.ascontiguousarray(host, dtype=np.uint8))
    if (device.type != "cuda" or host.device.type != "cpu"
            or host.is_pinned()):
        return host
    return UPLOADS.ring(device).staged(host)


def pinned(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A small host tensor (a table) as a program input on device: a
    pinned copy on a card, where graphs.run refuses pageable memory."""
    return host.pin_memory() if device.type == "cuda" else host


def check_restart_geometry(geom: FrameGeometry) -> None:
    """Refuse restart markers on the quirk geometries.

    There the reference emits fewer MCUs than the SOF dimensions imply
    (config.FrameGeometry.mcu_grid_aligned). An unbroken scan hides that,
    but a restart marker resyncs the decoder to the absolute MCU position
    k * N of its own grid, so a framed file would decode shifted.
    """
    if not geom.mcu_grid_aligned:
        raise ValueError(
            f"restart markers are unsupported for {geom.width}x"
            f"{geom.height} at {geom.h_factor}:{geom.v_factor} "
            "subsampling: the reference-parity scan omits trailing MCU "
            "columns/rows on this dim % (8*factor) == 1 quirk geometry, "
            "which is incompatible with the absolute MCU positions "
            "restart markers give the decoder; encode without "
            "--restart-interval"
        )


def restart_result(
    geom: FrameGeometry,
    segments: list[np.ndarray],
    bits_list: list[int],
    restart_mcus: int,
    quality: int | None,
    dht_specs: tuple | None = None,
) -> EncodeResult:
    """EncodeResult of a restart-framed encode from its interval streams.

    file_bytes from jfif.assemble_restart; entropy_payload is the
    byte-aligned (1-padded), unstuffed segments joined without the RSTn
    markers; bit_length sums the segments' true bit counts. The device
    zero-fills each segment's final partial byte; the host 1-fills it
    (T.81 B.1.1.5, PARITY quirk 7).
    """
    padded_segs = [
        jfif.pad_final_byte(
            np.ascontiguousarray(p[: (b + 7) // 8], dtype=np.uint8), b
        )
        for p, b in zip(segments, bits_list)
    ]
    return EncodeResult(
        file_bytes=jfif.assemble_restart(
            geom, segments, bits_list, restart_mcus, quality=quality,
            dht_specs=dht_specs,
        ),
        entropy_payload=b"".join(s.tobytes() for s in padded_segs),
        bit_length=int(sum(bits_list)),
        geom=geom,
    )


def _climb_capacity_ladder(encode, geom, capacity, restart_mcus, validate):
    """Run encode(capacity) up the capacity ladder until the payload (every
    interval's, with restart markers) fits; -> the fitting output.

    The packers drop the excess of an overflowing buffer but report the
    true length. Past the worst case, the bits-per-entry bound was
    violated: raise rather than retry the same capacity forever.
    """
    while True:
        out = encode(capacity)
        if validate:
            validate_scan_ranges(int(out["max_dc_diff"]), int(out["max_ac"]))
        if restart_mcus is None:
            bits = int(out["total_bits"])
            worst = worst_case_capacity_bytes(geom)
        else:
            bits = int(out["bits"].max())
            worst = restart_worst_case_capacity_bytes(geom, restart_mcus)
        if bits <= 8 * capacity:
            return out
        trace.count("ladder.climb")
        if capacity >= worst:
            raise AssertionError(
                f"packed bit length {bits} exceeds the worst-case "
                f"capacity {capacity} B — entropy packer invariant violated"
            )
        if restart_mcus is None:
            capacity = next_capacity_bytes(geom, capacity)
        else:
            capacity = restart_next_capacity_bytes(geom, restart_mcus,
                                                   capacity)


def dct_key(config: EncoderConfig) -> tuple:
    """The DCT a config runs (dct_planes_zigzag): fast_dct picks the
    RealDCT kernel and bin_dct_descale the binDCT quantization, each
    ignored by the other algorithm."""
    if config.dct_algorithm == DctAlgorithm.REAL_DCT:
        return config.dct_algorithm, config.fast_dct, config.quality
    return config.dct_algorithm, config.bin_dct_descale, config.quality


def program_keys(
    geom: FrameGeometry,
    config: EncoderConfig,
    capacity_bytes: int,
    with_coeffs: bool = False,
    packer: str = "fused",
    source: str = "rgb",
) -> dict[str, tuple]:
    """The keys (graphs.run) of encode_array's device programs for config
    at geom, the ladder's first rung capacity_bytes: {"scan": image -> the
    scan (with its entries, its ranges under validate, the coefficients
    with with_coeffs)}, or with optimize_huffman {"stats": image -> symbol
    counts and entries, "custom": entries and tables -> the scan}. Each
    holds what the JAX package's compiled_* cache keys hold; the programs
    that take the image end with its form, source: "rgb" (an (H, W, 3)
    array) or "bmp-rows" (a BMP file's stored rows, bmp.Rows)."""
    front = (geom, *dct_key(config), config.restart_interval)
    if config.optimize_huffman:
        return {"stats": ("stats", *front, source),
                "custom": ("custom", *front, capacity_bytes, config.validate,
                           packer)}
    return {"scan": ("scan", *front, capacity_bytes, config.validate,
                     with_coeffs, packer, source)}


def scan_program(
    geom: FrameGeometry,
    config: EncoderConfig,
    capacity_bytes: int,
    with_coeffs: bool = False,
    packer: str = "fused",
):
    """encode_array's device program without optimize_huffman (the JAX
    package's compiled_encoder and compiled_restart_encoder): fn(rgb) ->
    custom_core's result with the scan entries under "z" and, with
    with_coeffs, the natural-order coefficients under "coeffs"."""

    def program(rgb):
        z, coeffs = scan_entries(
            rgb, geom, config.dct_algorithm, config.quality,
            fast_dct=config.fast_dct, bin_dct_descale=config.bin_dct_descale,
            with_coeffs=with_coeffs)
        result = custom_core(z, geom, capacity_bytes, None,
                             config.restart_interval, config.validate, packer)
        result["z"] = z
        if with_coeffs:
            result["coeffs"] = natural_order(coeffs)
        return result

    return program


def check_config(config) -> None:
    """Refuse a config that is not this package's own EncoderConfig.

    DctAlgorithm is an Enum, compared by identity: a jpeg_encoder_tpu
    config's REAL_DCT is not this package's, and would route to binDCT.
    """
    if not isinstance(config, EncoderConfig):
        raise TypeError(
            "config must be a jpeg_encoder_torch.config.EncoderConfig, got "
            f"{type(config).__module__}.{type(config).__qualname__}"
        )


@trace.entry("encode_array")
def encode_array(
    rgb: np.ndarray | bmp.Rows,
    config: EncoderConfig = EncoderConfig(),
    *,
    device: str | torch.device = "cuda",
    return_coeffs: bool = False,
    packer: str = "fused",
    _initial_capacity_bytes: int | None = None,
):
    """Encode an (H, W, 3) uint8 RGB array into JFIF bytes on `device`
    (the card by default; "cpu" runs the plain versions).

    rgb may also be a BMP file's stored rows (bmp.Rows, from bmp.read(path,
    out=...)): they are uploaded as they are (from pinned memory without
    waiting, when they lie there: their owner keeps them until the copy
    has completed) and read as stored by the program's front kernel
    (kernels/front.py); the bytes are the same. On a card an input in
    pageable host memory, an array among them, goes up through the
    calling thread's pinned upload ring (upload).

    Every EncoderConfig option runs: restart_interval frames the scan
    into independently coded intervals (DRI/RSTn); optimize_huffman
    histograms the scan's symbols on the device, builds the four optimal
    tables on the host and encodes the same coefficients with them.
    packer picks the scan encoder (scan.PACKERS: K4, or the assemble tier
    through K5; the bytes are the same).
    _initial_capacity_bytes starts the capacity ladder at a known rung
    (per interval with restart markers). With return_coeffs (the unbroken
    Annex-K scan only), also returns the (N_i, 64) int16 natural-order
    quantized coefficients (y, cb, cr) as NumPy arrays.

    The device work is one program (two with optimize_huffman), run through
    graphs.run under program_keys: on a card the first call of a key runs
    it eagerly, the second captures it into a CUDA graph, later calls
    replay it (graphs.disabled() keeps it eager).

    Its steps are spans (trace.py): encode_array.upload, .launch (each
    program; graphs.run notes how it ran), .tables (optimize), .fetch_wait
    (the host blocked on the card from the ladder's first read through
    the payload's copy) and .jfif.
    """
    check_config(config)
    if isinstance(rgb, bmp.Rows):
        height, width = rgb.height, rgb.width
        source, name, host = "bmp-rows", "rows", rgb.rows
    else:
        if rgb.ndim != 3 or rgb.shape[2] != 3:
            raise ValueError("expected (H, W, 3) RGB input")
        height, width = rgb.shape[:2]
        source, name, host = "rgb", "rgb", rgb
    geom = config.geometry(width, height)
    restart = config.restart_interval
    if return_coeffs and config.optimize_huffman:
        raise ValueError(
            "return_coeffs is not supported with optimized Huffman"
        )
    if return_coeffs and restart is not None:
        raise ValueError("return_coeffs is not supported with restart markers")
    if restart is not None:
        check_restart_geometry(geom)
    device = resolve_device(device)
    with trace.span("encode_array.upload"):
        image = {name: upload(host, device)}
    capacity = _initial_capacity_bytes or initial_capacity_bytes(geom, config)
    keys = program_keys(geom, config, capacity, return_coeffs, packer,
                        source)

    def front_program(program):
        """program(image) as it takes this call's input tensor: the stored
        rows go to the front kernel as bmp.Rows."""
        if source == "rgb":
            return program
        return lambda rows: program(bmp.Rows(rows, width, height))
    front = dict(fast_dct=config.fast_dct,
                 bin_dct_descale=config.bin_dct_descale)
    specs = host_luts = None
    if config.optimize_huffman:
        # Two programs, as the JAX package's stats and custom encoders: the
        # host builds the tables between them.
        def stats_program(rgb):
            return stats_core(rgb, geom, config.dct_algorithm, config.quality,
                              restart_mcus=restart, **front)

        def custom_program(z, dc_lut, ac_lut):
            return custom_core(z, geom, capacity, (dc_lut, ac_lut), restart,
                               config.validate, packer)

        with trace.span("encode_array.launch"):
            hist, z = graphs.run(keys["stats"],
                                 front_program(stats_program), image, device)
        with trace.span("encode_array.tables"):
            specs, host_luts = optimal_specs_and_luts(hist.cpu().numpy(),
                                                      "cpu")
        with trace.span("encode_array.launch"):
            first = graphs.run(
                keys["custom"], custom_program,
                {"z": z, "dc_lut": pinned(host_luts[0], device),
                 "ac_lut": pinned(host_luts[1], device)}, device)
    else:
        with trace.span("encode_array.launch"):
            first = graphs.run(
                keys["scan"],
                front_program(scan_program(geom, config, capacity,
                                           return_coeffs, packer)),
                image, device)
        z = first["z"]

    # The program codes the first rung; a rung above it (rare) codes the
    # program's entries again, eagerly: the front half runs once.
    def encode(rung):
        if rung == capacity:
            return first
        luts = (None if host_luts is None
                else tuple(t.to(device) for t in host_luts))
        return custom_core(z, geom, rung, luts, restart, config.validate,
                           packer)

    with trace.span("encode_array.fetch_wait"):
        out = _climb_capacity_ladder(encode, geom, capacity, restart,
                                     config.validate)
        if restart is not None:
            bits = out["bits"].cpu().numpy()
            # Fetch only the longest interval's byte prefix of every row.
            max_bytes = (int(bits.max()) + 7) // 8
            payloads = out["payloads"][:, :max_bytes].cpu().numpy()
        else:
            bit_length = int(out["total_bits"])
            payload = out["payload"][: (bit_length + 7) // 8].cpu().numpy(
                ).tobytes()
    if restart is not None:
        with trace.span("encode_array.jfif"):
            return restart_result(
                geom, list(payloads), [int(b) for b in bits], restart,
                config.quality, dht_specs=specs,
            )
    with trace.span("encode_array.jfif"):
        file_bytes = jfif.assemble(geom, payload, quality=config.quality,
                                   dht_specs=specs)
    result = EncodeResult(
        file_bytes=file_bytes,
        entropy_payload=payload,
        bit_length=bit_length,
        geom=geom,
    )
    if return_coeffs:
        return result, tuple(c.cpu().numpy() for c in first["coeffs"])
    return result


@trace.entry("encode_file")
def encode_file(
    bmp_path: str | os.PathLike,
    output_path: str | os.PathLike,
    config: EncoderConfig = EncoderConfig(),
    *,
    device: str | torch.device = "cuda",
) -> EncodeResult:
    """BMP file -> JFIF file, encoded on `device` (the card by default).

    The file's pixel rows go from the page cache into the calling thread's
    staging buffer for the device and geometry (STAGING; pinned on a card),
    read as bmp.file_ranges(width, height) ranges at once on the native
    read pool, and
    from there to the card as they are stored; the program reorders them
    (encode_array of bmp.Rows). Its steps are spans (trace.py):
    encode_file.read (staging.wait beneath it), encode_array and
    encode_file.write."""
    check_config(config)
    device = resolve_device(device)
    taken = []

    def buffer(width: int, height: int) -> torch.Tensor:
        taken.append(STAGING.take(device, width, height))
        return taken[-1].buffer

    try:
        with trace.span("encode_file.read"):
            rows = bmp.read(bmp_path, out=buffer, ranges=bmp.file_ranges)
        result = encode_array(rows, config, device=device)
    finally:
        for staging in taken:
            staging.release()
    with trace.span("encode_file.write"), open(output_path, "wb") as f:
        f.write(result.file_bytes)
    return result
