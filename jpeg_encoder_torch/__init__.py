"""jpeg_encoder_torch: the baseline JPEG encoder on PyTorch and CUDA.

The same encoder as jpeg_encoder_tpu, rebuilt for an NVIDIA Hopper card:
hand-written CUDA kernels for the front (colour, pad, subsample:
kernels/front.py) and for the two heavy stages (the DCT variants,
kernels/dct.py: exact RealDCT, --fast-dct and binDCT, on three planes,
the exact ones straight into scan order, or on (N, 64) blocks; and the
scan encoder, scan.py over
kernels/entropy.py and kernels/pack.py, for the unbroken scan or restart
intervals, with Annex-K or per-image optimal Huffman tables). Entry
points (pipeline.encode_array, encode_file, parallel.batch.encode_batch)
run on "cuda" unless the caller asks for the CPU, where the kernels'
plain PyTorch versions run instead; nothing falls back to the CPU.

The host side (config, tables, io.bmp, io.jfif, native, utils.corpus and
the NumPy oracle) is this package's own copy of jpeg_encoder_tpu's
JAX-free modules: the port imports nothing of jpeg_encoder_tpu.
"""

from jpeg_encoder_torch.config import (  # noqa: F401
    DctAlgorithm,
    EncoderConfig,
    FrameGeometry,
)
