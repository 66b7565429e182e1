"""The port's multi-device paths on the CPU: devices=["cpu"] * k.

parallel/devices.py resolves every entry point's devices; these tests hold
it to its contract (indexed devices, a count above the cards present
raises, a list keeps its repeats), then drive each multi-device path with
k CPU shares, where the kernels' plain versions run, and hold every file to
pipeline.encode_array(device="cpu") byte for byte:

* encode_batch over 2 and 3 shares: an uneven last share, several chunks,
  restart markers every 2 MCUs, optimized tables; one case against the JAX
  package's encode_batch on its 2-device virtual mesh;
* stream.encode_paths over 2 shares and two dimension groups, chunk k on
  share k mod 2;
* encode_tiled at 4 bands over 2 shares and 8 over 3: the DC hop across a
  share boundary, uneven splits, runs of dead bands, restart-aligned bands,
  optimized tables, a one-band retry on the last share; one case against
  the JAX package's encode_tiled on its 8-device virtual mesh;
* multihost.encode_tiled in two gloo processes (tests/torch_band_worker.py,
  --device cpu), unbroken, restart and optimized, as the JAX package's
  tests/multihost_worker.py phases 2-4;
* the CLI's --devices: the keywords each input mode hands its entry point.

The case marked `cuda` runs the three paths with the card named two and
four times against the one-card files and skips elsewhere; the JAX package
is imported inside the tests that use it, so that the card machine, which
has no JAX, collects this file (python -m pytest
tests/test_torch_multicard.py -m cuda --noconftest).
"""

import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import cli, pipeline
from jpeg_encoder_torch.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.parallel import batch, devices, multihost, stream
from jpeg_encoder_torch.parallel import tiled
from jpeg_encoder_torch.utils import corpus

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpus(k):
    return ["cpu"] * k


def _singles(images, config):
    return [pipeline.encode_array(rgb, config, device="cpu").file_bytes
            for rgb in images]


def _images(count, height, width, seed=0):
    """Corpus content and noise in turn."""
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(0, 256, (height, width, 3), np.uint8) if i % 2
        else corpus.landscape(height, width, seed=seed + i)
        for i in range(count)])


# -- the device resolver -----------------------------------------------------

@pytest.fixture
def two_cards(monkeypatch):
    """torch.cuda as on a machine with two cards, card 1 current (only
    the resolver's queries; nothing runs on them)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)


def test_resolver_indexes_counts_and_keeps_repeats(two_cards):
    cuda = lambda i: torch.device("cuda", i)
    assert devices.resolve_device("cuda") == cuda(1)
    assert devices.resolve_device(torch.device("cuda")) == cuda(1)
    assert devices.resolve_device("cuda:0") == cuda(0)
    assert devices.resolve_device("cpu") == torch.device("cpu")
    assert devices.resolve(2) == (cuda(0), cuda(1))
    assert devices.resolve(1) == (cuda(0),)
    assert devices.resolve("cuda") == (cuda(1),)
    assert devices.resolve(["cuda:0", "cuda", "cuda:0"]) == (
        cuda(0), cuda(1), cuda(0))
    assert devices.resolve(_cpus(3)) == (torch.device("cpu"),) * 3
    for count in (0, 3):
        with pytest.raises(ValueError, match="have 2"):
            devices.resolve(count)
    with pytest.raises(ValueError, match="only 2"):
        devices.resolve_device("cuda:2")
    with pytest.raises(ValueError, match="more than one kind"):
        devices.resolve(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="empty"):
        devices.resolve([])
    with pytest.raises(ValueError, match="unsupported"):
        devices.resolve_device("meta")


def test_resolver_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devices.resolve_device("cuda")
    with pytest.raises(ValueError, match="have 0"):
        devices.resolve(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.encode_array(np.zeros((8, 8, 3), np.uint8))


@pytest.mark.parametrize("count, parts, runs", [
    (8, 3, [(0, 3), (3, 6), (6, 8)]),
    (4, 2, [(0, 2), (2, 4)]),
    (5, 2, [(0, 3), (3, 5)]),
    (2, 4, [(0, 1), (1, 2)]),
    (7, 1, [(0, 7)]),
])
def test_split_is_contiguous_and_skips_empty_runs(count, parts, runs):
    assert devices.split(count, parts) == runs


# -- batch over shares -------------------------------------------------------

@pytest.mark.parametrize("k, config, count", [
    (2, EncoderConfig(), 5),
    (3, EncoderConfig(), 7),
    (3, EncoderConfig(subsampling_ratio=(4, 4, 4), restart_interval=2), 4),
    (2, EncoderConfig(optimize_huffman=True), 3),
    (3, EncoderConfig(optimize_huffman=True, restart_interval=2), 5),
    (2, EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT), 3),
], ids=["2-uneven", "3-uneven", "3-restart2-444", "2-optimize",
        "3-optimize-restart2", "2-bindct"])
def test_batch_over_shares_matches_single_images(k, config, count,
                                                 monkeypatch):
    """Each chunk splits into contiguous shares, the last one shorter;
    the files come back in input order."""
    images = _images(count, 24, 40, seed=count)
    sizes = []
    dispatch = (batch.dispatch_optimized_stats if config.optimize_huffman
                else batch.dispatch_chunk)

    def spy(part, *args):
        sizes.append(len(part))
        return dispatch(part, *args)

    monkeypatch.setattr(batch, dispatch.__name__, spy)
    got = batch.encode_batch(images, config, devices=_cpus(k))
    assert sizes == [hi - lo for lo, hi in devices.split(count, k)]
    assert sizes[-1] < sizes[0]
    assert got == _singles(images, config)


@pytest.mark.parametrize("optimize", [False, True])
def test_batch_chunks_count_their_budget_a_share(optimize, monkeypatch):
    """A chunk is the per-share budget times the shares (the JAX package's
    chunk_size_images(geom, n_dev)): 2 images a share over 2 shares cut 7
    images into chunks of 4 and 3."""
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 2 * 24 * 40 * 3)
    config = EncoderConfig(optimize_huffman=optimize)
    assert batch.chunk_size_images(config.geometry(40, 24), 2) == 4
    images = _images(7, 24, 40, seed=3)
    sizes = []
    real = batch._shares_of

    def spy(chunk, shares):
        sizes.append(len(chunk))
        return real(chunk, shares)

    monkeypatch.setattr(batch, "_shares_of", spy)
    assert batch.encode_batch(images, config, devices=_cpus(2)) == (
        _singles(images, config))
    assert sizes == [4, 3]


def test_batch_overflow_is_retried_on_its_share(monkeypatch):
    """Random noise at quality 100 overflows the chunk's shared 16 KiB
    capacity; the member, in the last of 2 shares, is re-encoded alone on
    that share's device."""
    config = EncoderConfig(subsampling_ratio=(4, 4, 4), quality=100)
    images = np.stack([corpus.portrait(128, 128, seed=s) for s in range(3)]
                      + [np.random.default_rng(2).integers(
                          0, 256, (128, 128, 3), np.uint8)])
    retried = []
    real = batch._retry

    def spy(rgb, config, geom, capacity, device):
        retried.append((rgb, device))
        return real(rgb, config, geom, capacity, device)

    monkeypatch.setattr(batch, "_retry", spy)
    got = batch.encode_batch(images, config, devices=_cpus(2))
    assert len(retried) == 1 and np.array_equal(retried[0][0], images[3])
    assert retried[0][1] == torch.device("cpu")
    assert got == _singles(images, config)


def test_batch_over_shares_matches_jax_batch():
    """Three shares against the JAX package's batch on its 2-device mesh."""
    from jpeg_encoder_tpu.parallel import batch as jax_batch
    from jpeg_encoder_tpu.parallel import mesh as jax_mesh
    from test_torch_host import jax_config

    config = EncoderConfig(optimize_huffman=True)
    images = np.stack([corpus.landscape(48, 64, seed=s) for s in range(4)])
    want = jax_batch.encode_batch(images, jax_config(config),
                                  jax_mesh.data_mesh(2))
    assert batch.encode_batch(images, config, devices=_cpus(3)) == want


# -- the stream over shares --------------------------------------------------

class _TaggedShare(devices.Share):
    """A CPU share that records which share and leg entered it."""

    def __init__(self, tag, log):
        super().__init__(torch.device("cpu"))
        object.__setattr__(self, "tag", tag)
        object.__setattr__(self, "log", log)

    def on(self):
        self.log.append(self.tag)
        return super().on()


def test_stream_over_two_shares_and_two_groups(tmp_path, monkeypatch):
    """Chunk k runs its compute leg on share k mod 2; emit keeps path
    order within each dimension group; every file == encode_array."""
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 2 * 24 * 32 * 3)
    rng = np.random.default_rng(4)
    shapes = [(24, 32) if i % 3 else (16, 24) for i in range(10)]
    paths, images = [], {}
    for i, (height, width) in enumerate(shapes):
        rgb = (corpus.landscape(height, width, seed=i) if i % 2
               else rng.integers(0, 256, (height, width, 3), np.uint8))
        paths.append(str(tmp_path / f"f{i:02d}.bmp"))
        bmp.write(paths[-1], rgb)
        images[paths[-1]] = rgb
    log, made = [], []

    def legs(device, k):
        assert k == len(made)  # the k-th share of the CPU
        share = len(made)
        made.append(device)
        return tuple(_TaggedShare((share, leg), log) for leg in range(4))

    monkeypatch.setattr(stream, "_legs", legs)
    got, order = {}, []

    def emit(path, data):
        got[path] = data
        order.append(path)

    config = EncoderConfig(restart_interval=2)
    stats = stream.encode_paths(paths, config, emit, devices=_cpus(2))
    assert made == [torch.device("cpu")] * 2
    # One chunk of the (16, 24) group's 4 files (4 fit the budget), then 3
    # of the (24, 32) group's 6.
    computes = [share for share, leg in log if leg == 2]
    assert computes == [0, 1, 0, 1]
    first = [p for p in paths if images[p].shape == images[paths[0]].shape]
    assert order == first + [p for p in paths if p not in first]
    assert stats.encoded == len(paths)
    for path in paths:
        assert got[path] == pipeline.encode_array(images[path], config,
                                                  device="cpu").file_bytes


def test_stream_over_shares_optimized(tmp_path, monkeypatch):
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET", 2 * 32 * 48 * 3)
    config = EncoderConfig(optimize_huffman=True)
    images = _images(5, 32, 48, seed=6)
    paths = []
    for i, rgb in enumerate(images):
        paths.append(str(tmp_path / f"o{i}.bmp"))
        bmp.write(paths[-1], rgb)
    got = {}
    stream.encode_paths(paths, config, lambda p, d: got.__setitem__(p, d),
                        devices=_cpus(3))
    assert [got[p] for p in paths] == _singles(images, config)


# -- bands over shares -------------------------------------------------------

def _runs_of(monkeypatch):
    """Spy on BandRun.front: the (first, count) of every run that ran."""
    runs = []
    real = tiled.BandRun.front

    def spy(self, *args):
        runs.append((self.first, self.count))
        return real(self, *args)

    monkeypatch.setattr(tiled.BandRun, "front", spy)
    return runs


@pytest.mark.parametrize("height, width, config, bands, k, runs", [
    # 128 rows at 4:2:0: 8 MCU rows, 2 a band; the DC hop between bands 1-2.
    (128, 48, EncoderConfig(), 4, 2, [(0, 2), (2, 2)]),
    # 8 bands over 3 shares: 3, 3 and 2 bands, two hops.
    (128, 48, EncoderConfig(), 8, 3, [(0, 3), (3, 3), (6, 2)]),
    # 121 rows: the last band's rows masked; 4:2:2.
    (121, 32, EncoderConfig(subsampling_ratio=(4, 2, 2)), 8, 3,
     [(0, 3), (3, 3), (6, 2)]),
    # 4:4:4, 9 MCU rows in 4 bands of 3: band 3 is dead, its run skipped.
    (72, 40, EncoderConfig(subsampling_ratio=(4, 4, 4)), 4, 3,
     [(0, 2), (2, 1)]),
    # 3 MCU rows over 8 bands: the second and third runs are dead bands.
    (48, 32, EncoderConfig(), 8, 3, [(0, 3)]),
    # 5 MCU rows over 4 bands of 2: band 3 dead, in the second run.
    (80, 32, EncoderConfig(), 4, 2, [(0, 2), (2, 2)]),
    (128, 48, EncoderConfig(quality=90, fast_dct=True), 4, 2,
     [(0, 2), (2, 2)]),
    (128, 48, EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT,
                            bin_dct_descale=True), 8, 3,
     [(0, 3), (3, 3), (6, 2)]),
], ids=["4-over-2", "8-over-3", "121-rows-422", "444-4-over-3",
        "dead-runs", "dead-band", "fast-dct-q90", "bindct-descale"])
def test_bands_over_shares_match_encode_array(height, width, config, bands,
                                              k, runs, monkeypatch):
    rgb = corpus.foliage(height, width)
    ran = _runs_of(monkeypatch)
    got = tiled.encode_tiled(rgb, config, bands, devices=_cpus(k))
    assert ran == runs
    want = pipeline.encode_array(rgb, config, device="cpu")
    assert got.file_bytes == want.file_bytes
    assert got.bit_length == want.bit_length


@pytest.mark.parametrize("config, bands, k", [
    (EncoderConfig(restart_interval=4), 2, 2),
    (EncoderConfig(restart_interval=5), 2, 2),    # 5-row bands, re-aligned
    (EncoderConfig(restart_interval=2), 8, 3),    # 6 MCU rows: dead bands
    (EncoderConfig(optimize_huffman=True), 4, 2),
    (EncoderConfig(optimize_huffman=True), 8, 3),
    (EncoderConfig(optimize_huffman=True, restart_interval=4), 4, 3),
], ids=["restart4-2-over-2", "restart5-2-over-2", "restart2-8-over-3",
        "optimize-4-over-2", "optimize-8-over-3",
        "optimize-restart4-4-over-3"])
def test_bands_over_shares_restart_and_optimize(config, bands, k):
    rgb = corpus.portrait(96, 64)  # 4:2:0: 6 MCU rows x 4 MCU columns
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback to one encode
        got = tiled.encode_tiled(rgb, config, bands, devices=_cpus(k))
    want = pipeline.encode_array(rgb, config, device="cpu")
    assert got.file_bytes == want.file_bytes
    assert got.bit_length == want.bit_length


@pytest.mark.parametrize("restart", [None, 160])
def test_band_retry_on_the_last_share(restart, monkeypatch):
    """8 bands over 2 shares of a gradient with noise in band 6: only band
    6, in the second share's run, is re-coded, from that run's entries."""
    height, width = 256, 2560
    x = np.linspace(0, 255, width)[None, :, None]
    rgb = np.broadcast_to(x, (height, width, 3)).astype(np.uint8).copy()
    rgb[192:224] = np.random.default_rng(2).integers(0, 256, (32, width, 3),
                                                     np.uint8)
    config = EncoderConfig(capacity_bytes_per_pixel=0.04,
                           restart_interval=restart)
    name = "_retry_band" if restart is None else "_retry_band_restart"
    retried = []
    real = getattr(tiled, name)

    def spy(z, geom, band_rows, idx, *args):
        retried.append((idx, args[-1], z.shape[0]))
        return real(z, geom, band_rows, idx, *args)

    monkeypatch.setattr(tiled, name, spy)
    got = tiled.encode_tiled(rgb, config, 8, devices=_cpus(2))
    monkeypatch.undo()
    band_entries = 2 * (width // 16) * 6  # 2 MCU rows of 160 MCUs
    assert retried == [(6, 4, 4 * band_entries)]
    assert got.file_bytes == pipeline.encode_array(rgb, config,
                                                   device="cpu").file_bytes


def test_bands_over_shares_match_jax_tiled(rng):
    """8 bands over 3 shares against the JAX package's band encode on its
    8-device virtual mesh (a device a band)."""
    from jpeg_encoder_tpu.parallel import mesh as jax_mesh
    from jpeg_encoder_tpu.parallel import tiled as jax_tiled
    from test_torch_host import jax_config

    rgb = rng.integers(0, 256, size=(128, 48, 3), dtype=np.uint8)
    config = EncoderConfig()
    want = jax_tiled.encode_tiled(rgb, jax_config(config),
                                  jax_mesh.data_mesh(8))
    got = tiled.encode_tiled(rgb, config, 8, devices=_cpus(3))
    assert got.file_bytes == want.file_bytes
    assert got.bit_length == want.bit_length


# -- bands over processes ----------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_bands_over_one_process_match_encode_array():
    """Without a process group, multihost.encode_tiled codes every band in
    its one process, with the same gathers over a world of one."""
    import torch_band_worker as worker

    rgb = worker.image()
    for config in worker.configs().values():
        got = multihost.encode_tiled(rgb, config, 3, device="cpu")
        assert got.file_bytes == pipeline.encode_array(
            rgb, config, device="cpu").file_bytes


def test_two_process_bands_over_gloo(tmp_path):
    """One image's 4 bands over two gloo processes (2 bands each), the
    unbroken, restart and optimized encodes; every process's file ==
    encode_array's."""
    import torch_band_worker as worker

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    coordinator = f"localhost:{_free_port()}"
    script = os.path.join(_REPO, "tests", "torch_band_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, script, coordinator, str(i), "2",
             str(tmp_path)],
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
    for i, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{stdout}\n{stderr}"
    rgb = worker.image()
    for mode, config in worker.configs().items():
        want = pipeline.encode_array(rgb, config, device="cpu").file_bytes
        for i in range(2):
            got = (tmp_path / f"{mode}-{i}.jpeg").read_bytes()
            assert got == want, (mode, i)


# -- the CLI's --devices -----------------------------------------------------

@pytest.mark.parametrize("extra, mode, want", [
    ([], "batch", {"devices": 2}),
    (["--devices", "1"], "batch", {"devices": 1}),
    (["--device", "cuda:1"], "batch", {"device": torch.device("cuda", 1)}),
    ([], "dataset", {"devices": None}),
    (["--devices", "2"], "dataset", {"devices": 2}),
    (["--device", "cuda:0"], "dataset", {"device": torch.device("cuda", 0)}),
    (["--tile-bands", "--devices", "4"], "bands", {"bands": 4, "devices": 2}),
    (["--tile-bands", "--devices", "1"], "bands", {"bands": 1, "devices": 1}),
    (["--tile-bands"], "bands", {"bands": 2, "devices": 2}),
    (["--tile-bands", "--device", "cuda:1"], "bands",
     {"bands": 2, "device": torch.device("cuda", 1)}),
], ids=["batch-default", "batch-1", "batch-pinned", "dataset-default",
        "dataset-2", "dataset-pinned", "bands-4", "bands-1",
        "bands-default", "bands-pinned"])
def test_cli_devices_reach_the_entry_points(extra, mode, want, tmp_path,
                                            two_cards, monkeypatch):
    """On a machine of two cards: batch and dataset input shard over the
    first --devices cards (default every card: the dataset's own default,
    which is every card in one process), --tile-bands spreads its bands
    over the cards present, --device cuda:K pins everything to card K.
    The entry points are stubbed: only their keywords are checked."""
    from jpeg_encoder_torch.parallel import multihost as multihost_lib

    seen = {}

    class Stats:
        encoded = 0
        seconds = 1.0
        pixels = 0
        decode_seconds = write_seconds = 0.0

    def paths_stub(paths, config, emit, **kw):
        seen.update(kw)
        return Stats()

    def dataset_stub(paths, out_dir, config, resume, **kw):
        seen.update(kw)
        return multihost_lib.DatasetResult(0, 0, 0, "m.json")

    def tiled_stub(rgb, config, bands, **kw):
        seen.update(kw, bands=bands)
        return pipeline.encode_array(rgb, config, device="cpu")

    monkeypatch.setattr(stream, "encode_paths", paths_stub)
    monkeypatch.setattr(multihost_lib, "encode_dataset", dataset_stub)
    monkeypatch.setattr(tiled, "encode_tiled", tiled_stub)
    for i in range(2):
        bmp.write(tmp_path / f"c{i}.bmp", np.zeros((8, 8, 3), np.uint8))
    args = {"batch": ["-i", str(tmp_path / "c*.bmp")],
            "dataset": ["--dataset", str(tmp_path)],
            "bands": ["-i", str(tmp_path / "c0.bmp")]}[mode]
    out = tmp_path / ("out.jpeg" if mode == "bands" else "out")
    assert cli.main([*args, "-o", str(out), *extra]) == 0
    assert seen == want


def test_cli_devices_above_the_cards_present_exit_2(tmp_path, two_cards,
                                                    capsys):
    for i in range(2):
        bmp.write(tmp_path / f"c{i}.bmp", np.zeros((8, 8, 3), np.uint8))
    for args in (["-i", str(tmp_path / "c*.bmp")],
                 ["--dataset", str(tmp_path)]):
        assert cli.main([*args, "-o", str(tmp_path), "--devices", "3"]) == 2
        assert "--devices 3: only 2 cuda device(s)" in capsys.readouterr().err


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_shares_on_the_card_match_one_share(cuda, k, tmp_path):
    """The card named k times: every batch, stream and band file == the
    one-share file on the card."""
    shares = [cuda] * k
    images = _images(7, 72, 104, seed=k)
    for config in (EncoderConfig(), EncoderConfig(restart_interval=7),
                   EncoderConfig(optimize_huffman=True)):
        assert batch.encode_batch(images, config, devices=shares) == (
            batch.encode_batch(images, config, device=cuda))
    paths = []
    for i, rgb in enumerate(images):
        paths.append(str(tmp_path / f"s{i}.bmp"))
        bmp.write(paths[-1], rgb)
    got = {}
    stream.encode_paths(paths, EncoderConfig(), got.__setitem__,
                        devices=shares)
    assert [got[p] for p in paths] == batch.encode_batch(
        images, EncoderConfig(), device=cuda)
    rgb = corpus.landscape(333, 517)  # 21 x 33 MCUs: 8 bands of 3 rows
    for config in (EncoderConfig(), EncoderConfig(restart_interval=11),
                   EncoderConfig(optimize_huffman=True)):
        got = tiled.encode_tiled(rgb, config, 8, devices=shares)
        assert got.file_bytes == pipeline.encode_array(
            rgb, config, device=cuda).file_bytes
