"""End-to-end encode: the device path on one explicit device + host assembly.

Port of jpeg_encoder_tpu/pipeline.py: encode_array with every DCT variant
(RealDCT, --fast-dct, binDCT with and without the descale fix), every
subsampling ratio and quality, restart markers and two-pass optimized
Huffman tables (stats_core, then custom_core), alone and combined.
Colour, padding, subsampling and the scan marshal are plain PyTorch
ops; the DCT and the scan encoder are kernels (kernels/dct.py,
kernels/entropy.py, kernels/pack.py through scan.py), which run their
CUDA code on CUDA tensors and their plain PyTorch versions on CPU tensors.
The host decodes the BMP, builds optimal tables, stuffs 0xFF bytes and
writes the JFIF container (jpeg_encoder_tpu.tables and .io, shared).

Every entry point takes its device explicitly; nothing here picks one.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from jpeg_encoder_tpu import tables
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig, FrameGeometry
from jpeg_encoder_tpu.io import bmp, jfif
from jpeg_encoder_torch import scan
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.ops import color, sample
from jpeg_encoder_torch.ops import entropy as entropy_ops
from jpeg_encoder_torch.ops.entropy import worst_case_capacity_bytes


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


@functools.lru_cache(maxsize=8)
def _inverse_zigzag(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tables.ZIGZAG_INVERSE.astype(np.int64)).to(device)


def natural_order(
    coeffs: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zigzag-ordered (N_i, 64) coefficients -> natural order."""
    inv_zz = _inverse_zigzag(coeffs[0].device)
    return tuple(c[:, inv_zz] for c in coeffs)


def scan_entries(
    rgb: torch.Tensor,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    quality: int | None = None,
    *,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(H, W, 3) uint8 on a device -> ((E, 64) int16 scan entries, the
    (N_i, 64) zigzag coefficients [Y, Cb, Cr]): the front half every core
    shares (colour, pad, subsample, DCT, scan marshal)."""
    y, cb, cr = color.rgb_to_ycbcr(rgb)
    y = sample.pad_plane(y, geom)
    cb = sample.subsample_plane(sample.pad_plane(cb, geom), geom)
    cr = sample.subsample_plane(sample.pad_plane(cr, geom), geom)
    coeffs = dct_planes_zigzag(
        y, cb, cr, algorithm, quality,
        fast_dct=fast_dct, bin_dct_descale=bin_dct_descale,
    )
    return entropy_ops.marshal_scan_inputs(*coeffs, geom), coeffs


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


def encode_array(
    rgb: np.ndarray,
    config: EncoderConfig = EncoderConfig(),
    *,
    device: str | torch.device,
    return_coeffs: bool = False,
    packer: str = "fused",
    _initial_capacity_bytes: int | None = None,
):
    """Encode an (H, W, 3) uint8 RGB array into JFIF bytes on `device`.

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
    """
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("expected (H, W, 3) RGB input")
    height, width = rgb.shape[:2]
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
    device_rgb = torch.tensor(np.asarray(rgb, dtype=np.uint8), device=device)
    front = dict(fast_dct=config.fast_dct,
                 bin_dct_descale=config.bin_dct_descale)
    # The front half runs once; the capacity ladder retries the scan only.
    specs = luts = None
    if config.optimize_huffman:
        hist, z = stats_core(device_rgb, geom, config.dct_algorithm,
                             config.quality, restart_mcus=restart, **front)
        specs, luts = optimal_specs_and_luts(hist.cpu().numpy(), device)
    else:
        z, coeffs = scan_entries(device_rgb, geom, config.dct_algorithm,
                                 config.quality, **front)

    def encode(capacity):
        return custom_core(z, geom, capacity, luts, restart, config.validate,
                           packer)

    if restart is None:
        capacity = default_capacity_bytes(
            geom, config.capacity_bytes_per_pixel
        )
    else:
        capacity = restart_default_capacity_bytes(
            geom, restart, config.capacity_bytes_per_pixel
        )
    out = _climb_capacity_ladder(
        encode, geom, _initial_capacity_bytes or capacity, restart,
        config.validate,
    )
    if restart is not None:
        bits = out["bits"].cpu().numpy()
        # Fetch only the longest interval's byte prefix of every row.
        max_bytes = (int(bits.max()) + 7) // 8
        payloads = out["payloads"][:, :max_bytes].cpu().numpy()
        return restart_result(
            geom, list(payloads), [int(b) for b in bits], restart,
            config.quality, dht_specs=specs,
        )
    bit_length = int(out["total_bits"])
    payload = out["payload"][: (bit_length + 7) // 8].cpu().numpy().tobytes()
    result = EncodeResult(
        file_bytes=jfif.assemble(geom, payload, quality=config.quality,
                                 dht_specs=specs),
        entropy_payload=payload,
        bit_length=bit_length,
        geom=geom,
    )
    if return_coeffs:
        return result, tuple(c.cpu().numpy() for c in natural_order(coeffs))
    return result


def encode_file(
    bmp_path: str | os.PathLike,
    output_path: str | os.PathLike,
    config: EncoderConfig = EncoderConfig(),
    *,
    device: str | torch.device,
) -> EncodeResult:
    """BMP file -> JFIF file, encoded on `device`."""
    rgb = bmp.read(bmp_path)
    result = encode_array(rgb, config, device=device)
    with open(output_path, "wb") as f:
        f.write(result.file_bytes)
    return result
