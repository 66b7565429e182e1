"""Worker process of the port's two-process band test.

    python tests/torch_band_worker.py <coordinator> <process_id> \
        <num_processes> <out_dir>

Launched as a pair of processes by
tests/test_torch_multicard.py::test_two_process_bands_over_gloo. Each joins
the gloo group (parallel/multihost.initialize), then encodes the bands of
one image across the processes with parallel/multihost.encode_tiled on the
CPU, as tests/multihost_worker.py phases 2-4 do for the JAX package:
unbroken (the final DCs cross processes), restart framed (the intervals
are gathered, no DC exchange) and optimized Huffman (the statistics are
summed). It writes each file to <out_dir>/<mode>-<process_id>.jpeg.

Not a pytest module (no test_ prefix).
"""

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

# 288 rows are 18 MCU rows at 4:2:0: 4 bands of 5 MCU rows, the last with
# 3 (an uneven split); each band of a 32-pixel width holds 10 MCUs, two
# whole intervals of 5.
HEIGHT, WIDTH, SEED, BANDS = 288, 32, 123, 4


def configs():
    from jpeg_encoder_torch.config import EncoderConfig

    return {
        "unbroken": EncoderConfig(),
        "restart": EncoderConfig(restart_interval=5),
        "optimize": EncoderConfig(optimize_huffman=True),
    }


def image():
    import numpy as np

    return np.random.default_rng(SEED).integers(
        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)


def main() -> int:
    coordinator, pid, nproc, out_dir = sys.argv[1:5]

    import torch.distributed as dist

    from jpeg_encoder_torch.parallel import multihost

    rank, _ = multihost.initialize(coordinator, int(nproc), int(pid))
    try:
        rgb = image()
        for mode, config in configs().items():
            result = multihost.encode_tiled(rgb, config, BANDS, device="cpu")
            with open(os.path.join(out_dir, f"{mode}-{rank}.jpeg"), "wb") as f:
                f.write(result.file_bytes)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
