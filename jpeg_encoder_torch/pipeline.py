"""End-to-end encode: the device path on one explicit device + host assembly.

Port of jpeg_encoder_tpu/pipeline.py: encode_array -> encode_core with
every DCT variant (RealDCT, --fast-dct, binDCT with and without the
descale fix), the Annex-K tables, no restart markers and no optimized
Huffman, at every subsampling ratio and quality. Colour, padding,
subsampling and the scan marshal are plain PyTorch ops; the DCT and the
entropy coder are kernels (kernels/dct.py and kernels/entropy.py), which
run their CUDA code on CUDA tensors and their plain PyTorch versions on
CPU tensors. The host decodes the BMP, stuffs 0xFF bytes and writes the
JFIF container (jpeg_encoder_tpu.io, shared).

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
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
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
    y, cb, cr = color.rgb_to_ycbcr(rgb)
    y = sample.pad_plane(y, geom)
    cb = sample.subsample_plane(sample.pad_plane(cb, geom), geom)
    cr = sample.subsample_plane(sample.pad_plane(cr, geom), geom)
    y_z, cb_z, cr_z = dct_planes_zigzag(
        y, cb, cr, algorithm, quality,
        fast_dct=fast_dct, bin_dct_descale=bin_dct_descale,
    )
    z = entropy_ops.marshal_scan_inputs(y_z, cb_z, cr_z, geom)
    payload, total_bits = entropy_kernel.encode_entries(
        z, geom, capacity_bytes
    )
    result = {"payload": payload, "total_bits": total_bits}
    if with_coeffs:
        inv_zz = _inverse_zigzag(rgb.device)
        result["y_coeffs"] = y_z[:, inv_zz]
        result["cb_coeffs"] = cb_z[:, inv_zz]
        result["cr_coeffs"] = cr_z[:, inv_zz]
    if validate:
        result["max_dc_diff"], result["max_ac"] = (
            entropy_ops.coefficient_ranges(z, geom)
        )
    return result


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


def _check_supported(config: EncoderConfig) -> None:
    """Refuse the options whose port is still to come (ROADMAP.md)."""
    unported = {
        "restart_interval": config.restart_interval is not None,
        "optimize_huffman": config.optimize_huffman,
    }
    for name, requested in unported.items():
        if requested:
            raise NotImplementedError(
                f"{name} is not ported to jpeg_encoder_torch yet"
            )


def encode_array(
    rgb: np.ndarray,
    config: EncoderConfig = EncoderConfig(),
    *,
    device: str | torch.device,
    return_coeffs: bool = False,
    _initial_capacity_bytes: int | None = None,
):
    """Encode an (H, W, 3) uint8 RGB array into JFIF bytes on `device`.

    _initial_capacity_bytes starts the capacity ladder at a known rung.
    With return_coeffs, also returns the (N_i, 64) int16 natural-order
    quantized coefficients (y, cb, cr) as NumPy arrays.
    """
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("expected (H, W, 3) RGB input")
    _check_supported(config)
    height, width = rgb.shape[:2]
    geom = config.geometry(width, height)
    capacity = _initial_capacity_bytes or default_capacity_bytes(
        geom, config.capacity_bytes_per_pixel
    )
    device_rgb = torch.tensor(np.asarray(rgb, dtype=np.uint8), device=device)
    while True:
        out = encode_core(
            device_rgb, geom, config.dct_algorithm, capacity,
            config.validate, return_coeffs, config.quality,
            fast_dct=config.fast_dct, bin_dct_descale=config.bin_dct_descale,
        )
        if config.validate:
            validate_scan_ranges(
                int(out["max_dc_diff"]), int(out["max_ac"])
            )
        bit_length = int(out["total_bits"])
        if bit_length <= 8 * capacity:
            break
        # The payload overflowed the estimate (the packer drops the excess
        # but reports the true length): re-encode with a bigger buffer.
        # Past the worst case, the bits-per-entry bound was violated.
        if capacity >= worst_case_capacity_bytes(geom):
            raise AssertionError(
                f"packed bit length {bit_length} exceeds the worst-case "
                f"capacity {capacity} B — entropy packer invariant violated"
            )
        capacity = next_capacity_bytes(geom, capacity)
    num_bytes = (bit_length + 7) // 8
    payload = out["payload"][:num_bytes].cpu().numpy().tobytes()
    result = EncodeResult(
        file_bytes=jfif.assemble(geom, payload, quality=config.quality),
        entropy_payload=payload,
        bit_length=bit_length,
        geom=geom,
    )
    if return_coeffs:
        coeffs = tuple(
            out[k].cpu().numpy()
            for k in ("y_coeffs", "cb_coeffs", "cr_coeffs")
        )
        return result, coeffs
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
