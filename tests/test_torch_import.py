"""The port imports no JAX and nothing of jpeg_encoder_tpu: the machine with
the card has no JAX installed, and the port keeps its own copies of the
host modules it needs."""

import ast
import glob
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT_FILES = sorted(
    glob.glob(os.path.join(_REPO, "jpeg_encoder_torch", "**", "*.py"),
              recursive=True)
) + [os.path.join(_REPO, "chip_smoke.py")]
_FORBIDDEN = ("jax", "jaxlib", "jpeg_encoder_tpu")

_SCRIPT = """
import sys
import numpy as np
import jpeg_encoder_torch
from jpeg_encoder_torch import config, constants, native, oracle, pipeline, scan, tables
from jpeg_encoder_torch.io import bmp, jfif
from jpeg_encoder_torch.kernels import _build, dct, entropy, pack
from jpeg_encoder_torch.ops import color, sample
from jpeg_encoder_torch.ops import dct as dct_ops
from jpeg_encoder_torch.ops import entropy as entropy_ops
from jpeg_encoder_torch.parallel import batch, stream
from jpeg_encoder_torch.utils import corpus

rgb = np.random.default_rng(0).integers(0, 256, (24, 40, 3), dtype=np.uint8)
result = pipeline.encode_array(rgb, jpeg_encoder_torch.EncoderConfig(), device="cpu")
assert result.file_bytes[:2] == b"\\xff\\xd8" and result.bit_length > 0
files = batch.encode_batch(np.stack([rgb, rgb[::-1]]), device="cpu")
assert files[0] == result.file_bytes and len(files) == 2
import os, tempfile
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "in.bmp")
    bmp.write(path, rgb)
    got = {}
    stream.encode_paths([path], jpeg_encoder_torch.EncoderConfig(),
                        got.__setitem__, device="cpu")
assert got[path] == result.file_bytes
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jpeg_encoder_tpu"))
print("FORBIDDEN_MODULES", leaked)
"""


def test_port_imports_and_encodes_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=_REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN_MODULES []" in proc.stdout, proc.stdout


def _imported(path: str) -> list[str]:
    """Every module an import statement of the file names, at any depth
    (function-local imports included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path", _PORT_FILES, ids=[os.path.relpath(p, _REPO) for p in _PORT_FILES]
)
def test_no_port_file_imports_the_jax_package(path):
    bad = [n for n in _imported(path) if n.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, _REPO)} imports {bad}"
