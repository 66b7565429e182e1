"""Datasets across processes in the port: parallel/multihost.py on gloo.

One process: outputs, manifest bookkeeping and resume (the JAX package's
tests/test_parallel.py::test_encode_dataset_manifest_and_resume). Two
processes: two CLI subprocesses with --device cpu join one gloo group
through a localhost rendezvous, split the files by rank, and gather the
summary; every wait has a timeout, so a hung rendezvous fails the test
instead of stalling the suite (the port's workers import no JAX, so this
runs in the default tier). A missing peer makes initialize raise after its
timeout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.parallel import multihost

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_images(src, rng, count, shape=(16, 24, 3)):
    src.mkdir()
    images = {}
    for i in range(count):
        rgb = rng.integers(0, 256, size=shape, dtype=np.uint8)
        bmp.write(src / f"img{i}.bmp", rgb)
        images[f"img{i}"] = rgb
    return images


def test_encode_dataset_manifest_and_resume(tmp_path, rng):
    src, out = tmp_path / "src", tmp_path / "out"
    images = _write_images(src, rng, 5)
    # One differently-sized image exercises the dimension grouping.
    bmp.write(src / "odd.bmp", rng.integers(0, 256, (8, 8, 3), np.uint8))
    paths = sorted(src.iterdir())
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))

    res = multihost.encode_dataset(paths, str(out), config, device="cpu")
    assert res.encoded == 6 and res.skipped == 0
    assert res.pixels == 5 * 16 * 24 + 64 and res.seconds > 0
    for p in paths:
        assert (out / (p.stem + ".jpeg")).exists()
    manifest = json.loads((out / "manifest-00000.json").read_text())
    assert sorted(manifest["files"]) == sorted(p.stem + ".jpeg" for p in paths)
    assert manifest["files"]["img0.jpeg"]["source"] == str(src / "img0.bmp")
    assert "updated" in manifest
    summary = multihost.global_summary(res)
    assert summary == {"processes": 1, "encoded": 6, "skipped": 0,
                       "output_bytes": res.output_bytes}

    # Resume: everything already recorded -> all skipped.
    res2 = multihost.encode_dataset(paths, str(out), config, device="cpu")
    assert res2.encoded == 0 and res2.skipped == 6

    # Deleting one output forces just that file to re-encode.
    (out / "img3.jpeg").unlink()
    res3 = multihost.encode_dataset(paths, str(out), config, device="cpu")
    assert res3.encoded == 1 and res3.skipped == 5
    res4 = multihost.encode_dataset(paths, str(out), config, device="cpu",
                                    resume=False)
    assert res4.encoded == 6 and res4.skipped == 0

    for name, rgb in images.items():
        want = pipeline.encode_array(rgb, config, device="cpu").file_bytes
        assert (out / f"{name}.jpeg").read_bytes() == want, name


def test_manifest_persists_every_32_files(tmp_path, rng, monkeypatch):
    """A crash after the k-th file loses at most PERSIST_EVERY records."""
    monkeypatch.setattr(multihost, "PERSIST_EVERY", 2)
    src, out = tmp_path / "src", tmp_path / "out"
    _write_images(src, rng, 5, shape=(8, 8, 3))
    writes = []
    real_dump = multihost.json.dump

    def counting_dump(obj, f, **kw):
        writes.append(len(obj["files"]))
        return real_dump(obj, f, **kw)

    monkeypatch.setattr(multihost.json, "dump", counting_dump)
    multihost.encode_dataset(sorted(src.iterdir()), str(out), device="cpu")
    assert writes == [2, 4, 5]


def test_initialize_single_process_and_refusals():
    assert not dist.is_initialized()
    assert multihost.initialize() == (0, 1)
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize(coordinator_address="localhost:1")
    assert not dist.is_initialized()


def test_initialize_times_out_without_its_peer():
    """Rank 0 of two, alone: the rendezvous raises after its timeout."""
    with pytest.raises(RuntimeError):
        multihost.initialize(f"localhost:{_free_port()}", 2, 0, timeout=2)
    assert not dist.is_initialized()


def test_two_process_dataset_over_gloo(tmp_path, rng):
    src, out = tmp_path / "src", tmp_path / "out"
    images = _write_images(src, rng, 6)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    coordinator = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "jpeg_encoder_torch.cli", "--dataset",
             str(src), "-o", str(out), "--device", "cpu", "--coordinator",
             coordinator, "--num-processes", "2", "--process-id", str(i)],
            cwd=_REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    lines = []
    for i, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{stdout}\n{stderr}"
        lines.append(json.loads(stdout.strip().splitlines()[-1]))
    for i, line in enumerate(lines):
        assert line["process_index"] == i and line["process_count"] == 2
        assert line["encoded"] == 3 and line["skipped"] == 0
        assert line["summary"]["processes"] == 2
        assert line["summary"]["encoded"] == 6
        assert line["summary"]["output_bytes"] == sum(
            l["output_bytes"] for l in lines)
    manifests = [json.loads((out / f"manifest-{i:05d}.json").read_text())
                 ["files"] for i in range(2)]
    assert sorted(manifests[0]) == ["img0.jpeg", "img2.jpeg", "img4.jpeg"]
    assert sorted(manifests[1]) == ["img1.jpeg", "img3.jpeg", "img5.jpeg"]
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    for name, rgb in images.items():
        want = pipeline.encode_array(rgb, config, device="cpu").file_bytes
        assert (out / f"{name}.jpeg").read_bytes() == want, name
