"""The port imports no JAX: the machine with the card has none installed."""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import sys
import numpy as np
import jpeg_encoder_torch
from jpeg_encoder_torch import constants, pipeline
from jpeg_encoder_torch.kernels import _build, dct, entropy
from jpeg_encoder_torch.ops import color, sample
from jpeg_encoder_torch.ops import dct as dct_ops
from jpeg_encoder_torch.ops import entropy as entropy_ops

rgb = np.random.default_rng(0).integers(0, 256, (24, 40, 3), dtype=np.uint8)
result = pipeline.encode_array(rgb, jpeg_encoder_torch.EncoderConfig(), device="cpu")
assert result.file_bytes[:2] == b"\\xff\\xd8" and result.bit_length > 0
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", leaked)
"""


def test_port_imports_and_encodes_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=_REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout
