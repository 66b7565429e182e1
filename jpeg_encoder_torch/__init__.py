"""jpeg_encoder_torch: the baseline JPEG encoder on PyTorch and CUDA.

The same encoder as jpeg_encoder_tpu, rebuilt for an NVIDIA Hopper card:
plain PyTorch ops for the planar stages (colour, pad, subsample, scan
marshal) and hand-written CUDA kernels for the two heavy stages (the DCT
variants, kernels/dct.py: exact RealDCT, --fast-dct and binDCT; and the
scan encoder, scan.py over kernels/entropy.py and kernels/pack.py, for
the unbroken scan or restart intervals, with Annex-K or per-image optimal
Huffman tables). Every function takes its tensors on an explicit device;
on CPU tensors the kernels' plain PyTorch versions run instead.

The host side (BMP decode, JFIF container, byte stuffing, Huffman tables,
the NumPy oracle) is shared with jpeg_encoder_tpu and imported, not copied;
none of those modules imports JAX, and neither does this package.
"""

from jpeg_encoder_tpu.config import (  # noqa: F401
    DctAlgorithm,
    EncoderConfig,
    FrameGeometry,
)
