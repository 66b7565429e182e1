"""Every kernel, and each stage of encode_core, by CUDA-graph replay:
tools/time_kernel_only.py and tools/profile_stages.py for the port.

    python -m jpeg_encoder_torch.bench.kernels [--device cuda|cpu]
        [--height 1080 --width 1920] [--calls 10] [--launches JSON]

Operands: one corpus frame (landscape) at 1920x1080 4:2:0, through the
front (F1), K1 and the scan marshal, as chip_smoke.py's timing phase
builds them. Each kernel is timed alone on them by graph_ms
(bench/timing.py): F1 front on the frame; K1 realdct and K3 bindct on the
three planes into the scan entries (dct.scan_entries, as the main path
runs them), K2 fastdct on the three planes (raster order: the marshal
follows it); K4 entropy on the unbroken scan; K5 pack on the
assemble tier's rows at restart 120; K6a/b realdct_blocks and K6c
bindct_blocks on the Y blocks; and torch.matmul, K2's product alone, as
its yardstick. Beside each: its bound (the larger of its bytes once over
the card's memory rate and its operations over their peak; kernel_bounds)
and, with --launches (a JSON object of kernel name -> launches on the main
paths, as chip_smoke.py counts them), launches x (graph ms - bound), by
which the table is ranked. Then the stage map: the plain front (its torch
ops, ops/front.py) and F1, K1 in raster order, the marshal, K1 into the
entries, K4 and encode_core as a whole, each by graph_ms (encode_core, not the capacity ladder, which
reads the card); beside them encode_array's
device program (pipeline.scan_program through graphs.run, on the resident
frame) by the window timer on the card's events, replayed and eager
(graphs.disabled()): the host's launches against one graph launch. With
--device cpu every time is the host clock's. Two markdown tables, then one
JSON line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import sys

import numpy as np
import torch

from jpeg_encoder_torch import graphs, pipeline, scan
from jpeg_encoder_torch.bench import timing
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig, FrameGeometry
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.kernels import entropy as entropy_kernel
from jpeg_encoder_torch.kernels import front as front_kernel
from jpeg_encoder_torch.kernels import pack as pack_kernel
from jpeg_encoder_torch.ops import front as front_ops
from jpeg_encoder_torch.ops import sample
from jpeg_encoder_torch.ops import dct as dct_ops
from jpeg_encoder_torch.ops import entropy as entropy_ops
from jpeg_encoder_torch.parallel.devices import resolve_device
from jpeg_encoder_torch.utils import corpus

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes
# a second, float32 FLOP a second outside the tensor cores (a fused
# multiply-add counts 2), dense bf16 FLOP a second on the tensor cores.
# Without FMAs the FP32 pipes issue half that many operations; INT32 has
# half the FP32 lanes, so a quarter of the FLOP rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
FP32_ISSUE_OPS = FP32_FLOPS / 2
INT32_OPS = FP32_FLOPS / 4
# Operations per 8x8 block: RealDCT, the least work its function needs, 8
# first products px[k] * B[u][x_k] a step (one per u, shared by the 8
# coefficients of that u: the same operands give the same rounded product),
# 64 second products and 64 adds a step, over 64 steps, then a scale
# multiply and a divide a coefficient; binDCT, 16 8-point lifts of 43
# integer operations, 64 level shifts, and 64 divides by invariant integers
# of MAGIC_DIVIDE_OPS each ((x + mulhi(m, x)) >> s) - (x >> 31)); --fast-dct,
# the three bf16 split products of 64 x 64 multiply-adds (FAST_BLOCK_FLOPS,
# at BF16_TENSOR_FLOPS).
REALDCT_BLOCK_OPS = 8 * 64 + 64 * 64 * 2 + 2 * 64
MAGIC_DIVIDE_OPS = 5
BINDCT_BLOCK_OPS = 16 * 43 + 64 + 64 * MAGIC_DIVIDE_OPS
FAST_BLOCK_FLOPS = 3 * 2 * 64 * 64
# Operations per pixel of the front (F1): 9 products, 2 offsets and 4 sums
# of the three colour chains, a truncation and two clamps a channel.
FRONT_PIXEL_OPS = 9 + 2 + 4 + 3 * 3
PACK_RESTART = 120  # K5's operands: the assemble tier's rows at this interval


def bound(num_bytes: int, ops: int = 0, rate: float = 1.0) -> tuple:
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the operations over their peak."""
    t_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def front_bound(geom, images: int = 1, rows: bool = False) -> tuple:
    """F1's bound for `images` images of geom: each image's RGB bytes (or
    stored rows, with their padding) read once, the three padded planes
    written once; FRONT_PIXEL_OPS a pixel at the FP32 issue rate."""
    from jpeg_encoder_torch.io import bmp

    read = geom.height * (bmp.row_stride(geom.width) if rows
                          else 3 * geom.width)
    written = (geom.padded_height * geom.padded_width
               + 2 * geom.chroma_height * geom.chroma_width)
    return bound(images * (read + written),
                 images * geom.width * geom.height * FRONT_PIXEL_OPS,
                 FP32_ISSUE_OPS)


def kernel_bounds(geom, planes, z, cap, y_blocks) -> dict[str, tuple]:
    """Each kernel's bound on the operands it is timed on (every input
    byte read once, every output byte written once). K1 and K3 into the
    entries read the planes and a 4-byte entry index a block and write
    the (E, 64) int16 entries; K2 writes every block's row."""
    n = sum(p.numel() for p in planes) // 64
    plane_bytes = sum(p.numel() for p in planes) + n * 64 * 2
    entry_bytes = sum(p.numel() for p in planes) + n * 4 + z.numel() * 2
    n_y = y_blocks.shape[0]
    epi = entropy_ops.entries_per_interval(geom, PACK_RESTART)
    rows = -(-geom.num_scan_entries // epi)
    cap120 = pipeline.restart_default_capacity_bytes(geom, PACK_RESTART)
    slot_bits, slot_lens = entropy_ops.symbolize(
        z, geom.h_factor * geom.v_factor, entries_per_interval=epi)
    pack_row_bits = scan.assemble_operands(slot_bits, slot_lens, epi)[2]
    return {
        "front": front_bound(geom),
        "realdct": bound(entry_bytes, n * REALDCT_BLOCK_OPS, FP32_ISSUE_OPS),
        "fastdct": bound(plane_bytes, n * FAST_BLOCK_FLOPS,
                         BF16_TENSOR_FLOPS),
        "bindct": bound(entry_bytes, n * BINDCT_BLOCK_OPS, INT32_OPS),
        # z in, the two (2, 256) tables, one row of cap bytes and its count.
        "entropy": bound(z.numel() * 2 + 4096 + cap + 4),
        # K5 at restart 120: 8 bytes of offset an entry and the live words
        # in (a row's bit count over 32, rounded up: the words past an
        # entry's bits are zero and need not be read), one row of cap120
        # bytes per interval out.
        "pack": bound(rows * epi * 8 + int(((pack_row_bits + 31) // 32).sum())
                      * 4 + rows * cap120),
        "realdct_blocks": bound(n_y * 64 * 5, n_y * REALDCT_BLOCK_OPS,
                                FP32_ISSUE_OPS),
        "bindct_blocks": bound(n_y * 64 * 5, n_y * BINDCT_BLOCK_OPS,
                               INT32_OPS),
    }


@dataclasses.dataclass
class Operands:
    """One 4:2:0 frame's operands of every kernel, on one device."""

    geom: FrameGeometry
    rgb: torch.Tensor     # (H, W, 3) uint8
    planes: tuple         # padded Y, Cb, Cr (uint8)
    coeffs: tuple         # K1's (N_i, 64) int16 zigzag coefficients
    z: torch.Tensor       # (E, 64) int16 scan entries
    cap: int              # the unbroken scan's capacity
    y_blocks: torch.Tensor  # (N_y, 64) uint8
    pack: tuple           # K5's (words, offsets, capacity) at PACK_RESTART

    @classmethod
    def build(cls, rgb: np.ndarray, device: torch.device) -> Operands:
        geom = EncoderConfig().geometry(rgb.shape[1], rgb.shape[0])
        rgb_dev = timing.resident(rgb, device)
        planes = front_kernel.planes(rgb_dev, geom)
        coeffs = dct_kernel.real_dct_quant_planes_zigzag(*planes)
        z = entropy_ops.marshal_scan_inputs(*coeffs, geom)
        epi = entropy_ops.entries_per_interval(geom, PACK_RESTART)
        slot_bits, slot_lens = entropy_ops.symbolize(
            z, geom.h_factor * geom.v_factor, entries_per_interval=epi)
        words, offsets, _ = scan.assemble_operands(slot_bits, slot_lens, epi)
        return cls(geom, rgb_dev, planes, coeffs, z,
                   pipeline.default_capacity_bytes(geom),
                   sample.blockify(planes[0]).contiguous(),
                   (words, offsets, pipeline.restart_default_capacity_bytes(
                       geom, PACK_RESTART)))


def kernel_calls(ops: Operands) -> list[tuple]:
    """(name, kernel call, its plain version) of every kernel on ops."""
    p, blocks = ops.planes, ops.y_blocks
    words, offsets, cap120 = ops.pack
    part = functools.partial
    real, binary = DctAlgorithm.REAL_DCT, DctAlgorithm.BIN_DCT
    return [
        ("front", part(front_kernel.planes, ops.rgb, ops.geom),
         part(front_ops.planes, ops.rgb, ops.geom)),
        ("realdct", part(dct_kernel.scan_entries, *p, ops.geom, real),
         part(dct_kernel.plain_scan_entries, *p, ops.geom, real)),
        ("fastdct", part(dct_kernel.real_dct_fast_planes_zigzag, *p),
         part(dct_ops.real_dct_fast_planes_zigzag, *p)),
        ("bindct", part(dct_kernel.scan_entries, *p, ops.geom, binary),
         part(dct_kernel.plain_scan_entries, *p, ops.geom, binary)),
        ("entropy", part(entropy_kernel.encode_entries, ops.z, ops.geom,
                         ops.cap),
         part(entropy_ops.encode_entries, ops.z, ops.geom, ops.cap)),
        ("pack", part(pack_kernel.assemble_bitstream, words, offsets, cap120),
         part(entropy_ops.assemble_bitstream, words, offsets, cap120)),
        ("realdct_blocks", part(dct_kernel.real_dct_quant_zigzag, blocks,
                                True),
         part(dct_ops.real_dct_quant_zigzag, blocks, True)),
        ("bindct_blocks", part(dct_kernel.bin_dct_quant_zigzag, blocks, True),
         part(dct_ops.bin_dct_quant_zigzag, blocks, True)),
    ]


def matmul_call(ops: Operands):
    """K2's product alone as one torch.matmul, f32 with TF32 off: the
    (N, 64) level-shifted blocks of the three planes x K_zz^T (64, 64)."""
    shifted = (torch.cat([sample.blockify(p) for p in ops.planes])
               .to(torch.int16) - 128).to(torch.float32)
    kzz = dct_ops.fast_device_constant(shifted.device)
    return functools.partial(torch.matmul, shifted, kzz.T), shifted.shape


def stage_calls(ops: Operands) -> dict:
    """encode_core's stages on ops, and encode_core as a whole."""
    geom, planes = ops.geom, ops.planes
    return {
        "colour+pad+subsample": functools.partial(front_ops.planes, ops.rgb,
                                                  geom),
        "front kernel": functools.partial(front_kernel.planes, ops.rgb, geom),
        "realdct kernel": functools.partial(
            dct_kernel.real_dct_quant_planes_zigzag, *planes),
        "scan marshal": functools.partial(entropy_ops.marshal_scan_inputs,
                                          *ops.coeffs, geom),
        "realdct into entries": functools.partial(
            dct_kernel.scan_entries, *planes, geom, DctAlgorithm.REAL_DCT),
        "entropy kernel": functools.partial(entropy_kernel.encode_entries,
                                            ops.z, geom, ops.cap),
        "encode_core": lambda: pipeline.encode_core(
            ops.rgb, geom, EncoderConfig().dct_algorithm, ops.cap,
            with_coeffs=False),
    }


def program_call(ops: Operands):
    """fn() -> encode_array's device program on ops' resident frame, through
    graphs.run (its rgb copied into the program's buffer each replay)."""
    config = EncoderConfig()
    key = pipeline.program_keys(ops.geom, config, ops.cap)["scan"]
    program = pipeline.scan_program(ops.geom, config, ops.cap)
    return lambda: graphs.run(key, program, {"rgb": ops.rgb}, ops.rgb.device)


def main(argv: list[str] | None = None) -> int:
    ap = timing.parser(__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--calls", type=int, default=10,
                    help="calls captured into one graph")
    ap.add_argument("--launches", type=json.loads, default=None,
                    help="JSON object: kernel name -> main-path launches")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = timing.card_line(device)
    clock = "graph" if device.type == "cuda" else "host"
    ops = Operands.build(corpus.landscape(args.height, args.width), device)
    bounds = kernel_bounds(ops.geom, ops.planes, ops.z, ops.cap, ops.y_blocks)
    matmul, shape = matmul_call(ops)
    library = {"fastdct": timing.graph_ms(matmul, device, args.calls)}
    rows = []
    for name, kernel, _ in kernel_calls(ops):
        ms = timing.graph_ms(kernel, device, args.calls)
        bound_ms, bound_by = bounds[name]
        launches = (args.launches or {}).get(name)
        rows.append({
            "name": name, "ms": ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library.get(name),
            "launches": launches,
            "excess_ms": (None if launches is None
                          else launches * (ms - bound_ms)),
        })
    stages = {name: timing.graph_ms(fn, device, args.calls)
              for name, fn in stage_calls(ops).items()}
    program_clock = timing.clock_for(device)
    program = {"replayed": timing.window(program_call(ops), args.min_seconds,
                                         program_clock).per_call_ms()}
    with graphs.disabled():
        program["eager"] = timing.window(program_call(ops), args.min_seconds,
                                         program_clock).per_call_ms()
    rows.sort(key=lambda r: -(r["excess_ms"] if r["excess_ms"] is not None
                              else r["ms"] - r["bound_ms"]))
    label = f"{args.width}x{args.height} 4:2:0 corpus landscape"
    print(f"| kernel ({label}) | {clock} ms | bound ms (by) | library ms | "
          "launches | launches x (ms - bound) |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        lib = "" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        excess = ("" if r["excess_ms"] is None
                  else f"{r['excess_ms']:.4f}")
        print(f"| {r['name']} | {r['ms']:.4f} | {r['bound_ms']:.5f} "
              f"({r['bound_by']}) | {lib} | {r['launches'] or ''} | "
              f"{excess} |")
    print(f"torch.matmul {tuple(shape)} x (64, 64) f32, TF32 off: "
          f"{library['fastdct']:.4f} ms ({card})")
    print(f"\n| stage ({label}) | {clock} ms |")
    print("|---|---|")
    for name, ms in stages.items():
        print(f"| {name} | {ms:.4f} |", flush=True)
    for name, window in program.items():
        print(f"| encode_array's program, {name} ({program_clock.name}) | "
              f"{window['ms']:.4f} |", flush=True)
    timing.emit({"metric": "kernel_times", "clock": clock, "calls":
                 args.calls, "geometry": f"{args.width}x{args.height}",
                 "kernels": rows, "matmul_ms": library["fastdct"],
                 "stages": stages, "program": program, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
