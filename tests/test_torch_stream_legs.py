"""The stream engine's four legs and its rows-form ring, on the CPU.

parallel/stream.encode_paths reads each file's stored pixel rows straight
into the loader's ring (io/bmp.read(path, out=...)), hands the chunk to
the batch program as bmp.Rows (the "bmp-rows" keys: the program reorders
the rows first, bmp.rows_to_rgb over a batch), and splits the old writer
into an assembler (fetch and JFIF assembly) and an emitter (emit() of each
file, in order). Held here: the stream's files against encode_batch's and
the JAX package's NumPy oracle for every option (the oracle's helpers come
from tests/test_torch_bmp_rows.py; --fast-dct and binDCT's descale against
encode_batch alone); two dimension groups interleaved; one emitting
thread, in path order within each group, groups in first-seen order; an
emit and an assembly that raise, each surfacing with no thread left and
the earlier files standing; chunk k's emits overlapping chunk k+1's
assembly; a forced capacity retry from the rows form; the two forms'
batch keys; the legs' seconds. The card case (pinned slots) is marked
`cuda` and skips elsewhere.
"""

import os
import threading

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import graphs, pipeline
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.parallel import batch, stream
from jpeg_encoder_torch.utils import corpus
from test_torch_bmp_rows import FILE_CASES, _oracle
from test_torch_graphs import graphed_cpu  # noqa: F401 (a fixture)

CPU = torch.device("cpu")
TIMEOUT_S = 120  # a hang fails the test instead of stalling the suite
WAIT_S = 30


def _images(seed, count, height, width):
    """Corpus content and noise in turn."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (height, width, 3), np.uint8) if i % 2
            else corpus.landscape(height, width, seed=seed + i)
            for i in range(count)]


def _write(tmp_path, images, prefix="img"):
    paths = []
    for i, rgb in enumerate(images):
        paths.append(str(tmp_path / f"{prefix}{i:02d}.bmp"))
        bmp.write(paths[-1], rgb)
    return paths


def _chunks_of(monkeypatch, images, height, width):
    """Cut the stream's groups into chunks of `images` height x width
    images (the budget counts H * W * 3 bytes an image)."""
    monkeypatch.setattr(batch, "CHUNK_INPUT_BUDGET",
                        images * height * width * 3)


def _legs_alive():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("jpeg-torch-")]


def _bounded(fn):
    """fn() in a thread joined with TIMEOUT_S: {"value": ...} or
    {"error": ...}."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the test
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(TIMEOUT_S)
    assert not t.is_alive(), f"encode_paths still running after {TIMEOUT_S} s"
    return out


# --------------------------------------------------------------------------
# The reorder over a batch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 5, 17, 40])
def test_rows_to_rgb_takes_a_batch(tmp_path, width):
    """A (B, H, stride) stack reorders to the (B, H, W, 3) stack of each
    file's decode, at widths with and without row padding."""
    images = _images(width, 3, 7, width)
    paths = _write(tmp_path, images)
    stride = bmp.row_stride(width)
    stack = torch.empty((3, 7 * stride), dtype=torch.uint8)
    for j, path in enumerate(paths):
        bmp.read(path, out=stack[j])
    got = bmp.rows_to_rgb(stack.view(3, 7, stride), width)
    assert got.shape == (3, 7, width, 3)
    assert np.array_equal(got.numpy(), np.stack(images))


# --------------------------------------------------------------------------
# The stream's files
# --------------------------------------------------------------------------

@pytest.mark.parametrize("label,config,shape", FILE_CASES,
                         ids=[c[0] for c in FILE_CASES])
def test_stream_equals_encode_batch_and_oracle(tmp_path, monkeypatch, label,
                                               config, shape):
    """Three files in chunks of 2 (a full chunk and a short one), for each
    option: the stream's files == encode_batch's (RGB form) and the
    oracle's where it has the option; 33 x 17 and 18-wide rows are
    padded, 33 x 17 is a quirk geometry."""
    height, width = shape
    _chunks_of(monkeypatch, 2, height, width)
    images = _images(len(label), 3, height, width)
    paths = _write(tmp_path, images)
    got = {}
    stats = stream.encode_paths(paths, config, got.__setitem__, device="cpu")
    want = batch.encode_batch(np.stack(images), config, device="cpu")
    assert [got[p] for p in paths] == want, label
    assert stats.encoded == 3 and stats.pixels == 3 * height * width
    for path, rgb in zip(paths, images):
        oracle = _oracle(rgb, config)
        assert oracle is None or got[path] == oracle, label


def test_two_groups_interleaved_on_one_emitting_thread(tmp_path,
                                                       monkeypatch):
    """Files of two geometries alternate in the folder (one row-padded):
    every emit runs on one thread, not the caller's, one call at a time,
    in path order within each group, the first-seen group first; each
    group's files == encode_batch's."""
    _chunks_of(monkeypatch, 2, 16, 24)
    shapes = [(16, 24) if i % 2 else (13, 19) for i in range(9)]
    images = [_images(i, 1, h, w)[0] for i, (h, w) in enumerate(shapes)]
    paths = _write(tmp_path, images)
    got, threads, inside = {}, [], []

    def emit(path, data):
        inside.append(path)
        assert len(inside) == 1, "two emits at once"
        threads.append(threading.current_thread())
        got[path] = data
        inside.pop()

    out = _bounded(lambda: stream.encode_paths(
        paths, EncoderConfig(), emit, device="cpu"))
    assert "error" not in out, out
    first = [p for p, s in zip(paths, shapes) if s == shapes[0]]
    second = [p for p in paths if p not in first]
    assert list(got) == first + second
    assert len(set(threads)) == 1
    assert threads[0].name == "jpeg-torch-emitter"
    assert threads[0] is not threading.current_thread()
    for group in (first, second):
        want = batch.encode_batch(
            np.stack([images[paths.index(p)] for p in group]),
            EncoderConfig(), device="cpu")
        assert [got[p] for p in group] == want
    assert not _legs_alive()


def test_emits_overlap_the_next_chunks_assembly(tmp_path, monkeypatch):
    """The first emit waits until the assembler has assembled the second
    chunk: chunk k's emits no longer hold chunk k+1's fetch and assembly.
    The files are the one-thread stream's all the same."""
    _chunks_of(monkeypatch, 1, 8, 16)
    paths = _write(tmp_path, _images(3, 4, 8, 16))
    want = {}
    stream.encode_paths(paths, EncoderConfig(), want.__setitem__,
                        device="cpu")
    cond = threading.Condition()
    assembled, held = [], []
    real = batch.assemble_chunk

    def assemble(*args):
        files = real(*args)
        with cond:
            assembled.append(len(files))
            cond.notify_all()
        return files

    monkeypatch.setattr(batch, "assemble_chunk", assemble)
    got = {}

    def emit(path, data):
        if not got:
            with cond:
                held.append(cond.wait_for(lambda: len(assembled) >= 2,
                                          WAIT_S))
        got[path] = data

    out = _bounded(lambda: stream.encode_paths(
        paths, EncoderConfig(), emit, device="cpu"))
    assert "error" not in out, out
    assert held == [True]
    assert got == want and list(got) == paths


# --------------------------------------------------------------------------
# Errors
# --------------------------------------------------------------------------

def _writing(out_dir, emitted, fail_at=None):
    def emit(path, data):
        if path == fail_at:
            raise OSError("disk full (simulated)")
        with open(os.path.join(out_dir, os.path.basename(path)), "wb") as f:
            f.write(data)
        emitted.append(path)
    return emit


def test_emit_raising_in_the_second_chunk_surfaces(tmp_path, monkeypatch):
    """emit() raises on the second chunk's first file: the caller gets the
    OSError, no leg or decoder thread is left, the first chunk's files
    stand and nothing is emitted after the failure."""
    _chunks_of(monkeypatch, 2, 16, 16)
    paths = _write(tmp_path, _images(5, 8, 16, 16))
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    emitted = []
    out = _bounded(lambda: stream.encode_paths(
        paths, EncoderConfig(), _writing(out_dir, emitted, paths[2]),
        device="cpu"))
    assert isinstance(out.get("error"), OSError), out
    assert emitted == paths[:2]
    assert sorted(os.listdir(out_dir)) == [os.path.basename(p)
                                           for p in paths[:2]]
    assert not _legs_alive()


def test_assembly_raising_surfaces(tmp_path, monkeypatch):
    """The second chunk's assembly raises: the caller gets its error, the
    first chunk's files are still emitted and stand, nothing after them,
    and no thread is left."""
    _chunks_of(monkeypatch, 2, 16, 16)
    paths = _write(tmp_path, _images(6, 8, 16, 16))
    real = batch.assemble_chunk
    calls = []

    def assemble(*args):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("assembly failed (simulated)")
        return real(*args)

    monkeypatch.setattr(batch, "assemble_chunk", assemble)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    emitted = []
    out = _bounded(lambda: stream.encode_paths(
        paths, EncoderConfig(), _writing(out_dir, emitted), device="cpu"))
    assert isinstance(out.get("error"), RuntimeError), out
    assert "assembly failed" in str(out["error"])
    assert emitted == paths[:2]
    assert len(os.listdir(out_dir)) == 2
    assert not _legs_alive()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_a_file_that_changed_after_its_probe_is_refused(tmp_path,
                                                        monkeypatch, native):
    """The loader reads into a slot of its group's geometry: a file whose
    header no longer gives it raises, one too large for the slot too."""
    if not native:
        monkeypatch.setattr(bmp.native, "load", lambda: None)
    path = _write(tmp_path, _images(7, 1, 8, 16))[0]
    out = torch.zeros(8 * bmp.row_stride(16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="its group is 17x6"):
        stream._read_rows(path, out, (17, 6))
    with pytest.raises(ValueError, match="out must be"):
        stream._read_rows(path, out[:-1], (16, 8))
    stream._read_rows(path, out, (16, 8))
    assert out.any()


def _read_outcome(path, out):
    """bmp.read(path, out=out()): the rows' geometry and bytes, or the
    error's type and text."""
    try:
        rows = bmp.read(path, out=out())
    except (OSError, ValueError) as error:
        return type(error), str(error)
    return rows.width, rows.height, rows.rows.clone()


@pytest.mark.parametrize("width", [1, 5, 17, 40])
def test_native_read_equals_the_python_read(tmp_path, monkeypatch, width):
    """bmp.read(path, out=...) reads natively, into a buffer (the loader)
    and into a buffer function's (encode_file): the same rows as the
    Python read, and the same errors: a missing file's OSError, a short
    buffer's ValueError, a truncated file's."""
    assert bmp.native.load() is not None
    path = _write(tmp_path, _images(width, 1, 9, width))[0]
    nbytes = 9 * bmp.row_stride(width)

    def buffer(n):
        return torch.zeros(n, dtype=torch.uint8)

    outs = {"buffer": lambda: buffer(nbytes + 7),
            "function": lambda: lambda w, h: buffer(h * bmp.row_stride(w)),
            "short buffer": lambda: buffer(nbytes - 1),
            "short function": lambda: lambda w, h: buffer(nbytes - 1)}
    with open(path, "rb") as f:
        data = f.read()
    truncated = str(tmp_path / "truncated.bmp")
    with open(truncated, "wb") as f:
        f.write(data[:-1])
    missing = str(tmp_path / "missing.bmp")
    native = {(p, o): _read_outcome(p, out) for p in (path, truncated, missing)
              for o, out in outs.items()}
    with monkeypatch.context() as m:
        m.setattr(bmp.native, "load", lambda: None)
        python = {(p, o): _read_outcome(p, out)
                  for p in (path, truncated, missing)
                  for o, out in outs.items()}
    for key, got in native.items():
        want = python[key]
        assert len(got) == len(want), key
        if len(got) == 3:
            assert got[:2] == want[:2] == (width, 9)
            assert torch.equal(got[2], want[2])
        else:
            assert got == want, key
    for o in outs:
        assert native[missing, o][0] is FileNotFoundError
        assert "truncated" in native[truncated, o][1]
    assert "out must be" in native[path, "short buffer"][1]
    assert "out must be" in native[path, "short function"][1]


def test_an_unpinned_ring_slot_raises(monkeypatch):
    """No fallback: a slot that pin_memory=True does not pin raises."""
    empty = torch.empty

    def unpinned(*args, pin_memory=False, **kwargs):
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", unpinned)
    with pytest.raises(RuntimeError, match="could not pin"):
        stream._PinnedRing(3, (2, 8 * bmp.row_stride(16)))


# --------------------------------------------------------------------------
# The rows form in the batch programs
# --------------------------------------------------------------------------

def test_forced_capacity_retry_from_the_rows_form(tmp_path, monkeypatch):
    """A capacity of 0.05 bytes a pixel (the 16 KiB floor) overflows the
    noise members at quality 100 (130-pixel rows, padded): the assembler
    retries each alone through encode_array from its stored rows
    (bmp.Rows), with the bytes of encode_batch's retry from RGB."""
    config = EncoderConfig(subsampling_ratio=(4, 4, 4), quality=100,
                           capacity_bytes_per_pixel=0.05)
    _chunks_of(monkeypatch, 3, 128, 130)
    images = _images(8, 4, 128, 130)
    paths = _write(tmp_path, images)
    retried = []
    real = batch._retry

    def retry(image, *args):
        retried.append(type(image))
        return real(image, *args)

    monkeypatch.setattr(batch, "_retry", retry)
    got = {}
    stream.encode_paths(paths, config, got.__setitem__, device="cpu")
    assert retried and set(retried) == {bmp.Rows}
    count = len(retried)
    want = batch.encode_batch(np.stack(images), config, device="cpu")
    assert len(retried) == 2 * count and set(retried[count:]) == {np.ndarray}
    assert [got[p] for p in paths] == want
    for path, rgb in zip(paths, images):
        assert got[path] == pipeline.encode_array(rgb, config,
                                                  device="cpu").file_bytes


@pytest.mark.parametrize("config", [EncoderConfig(),
                                    EncoderConfig(optimize_huffman=True)],
                         ids=["default", "optimize"])
def test_rows_and_rgb_batch_keys_differ(config):
    """The programs that take the chunk end with its form; the custom
    encode takes entries, the same in either form."""
    geom = config.geometry(1920, 1080)
    capacity = batch.chunk_capacity_bytes(config, geom)
    rgb = batch.program_keys(geom, config, capacity, 21)
    rows = batch.program_keys(geom, config, capacity, 21, "bmp-rows")
    for name in ("batch", "batch_stats"):
        assert rgb[name][-1] == "rgb" and rows[name][-1] == "bmp-rows"
        assert rgb[name][:-1] == rows[name][:-1]
    assert rgb["batch_custom"] == rows["batch_custom"]


@pytest.mark.parametrize("config", [EncoderConfig(),
                                    EncoderConfig(optimize_huffman=True)],
                         ids=["default", "optimize"])
def test_stream_programs_take_the_rows(graphed_cpu, tmp_path,  # noqa: F811
                                       monkeypatch, config):
    """Through a cache of stand-in programs, three one-key chunks (eager,
    captured, replayed): the stream's front program is keyed "bmp-rows"
    and takes (B, H, stride) rows, encode_batch's is keyed "rgb"; every
    file equals the eager path's."""
    height, width = 16, 22
    _chunks_of(monkeypatch, 2, height, width)
    images = _images(9, 6, height, width)
    paths = _write(tmp_path, images)
    got = {}
    stream.encode_paths(paths, config, got.__setitem__, device="cpu")
    with graphs.disabled():
        want = batch.encode_batch(np.stack(images), config, device="cpu")
    assert [got[p] for p in paths] == want
    front = "batch_stats" if config.optimize_huffman else "batch"
    programs = {key[2:]: p for key, p in graphed_cpu.programs(CPU)}
    geom = config.geometry(width, height)
    capacity = batch.chunk_capacity_bytes(config, geom)
    key = batch.program_keys(geom, config, capacity, 2, "bmp-rows")[front]
    assert programs[key].replays == 2
    assert set(programs[key].inputs) == {"rows"}
    assert programs[key].inputs["rows"].shape == (
        2, height, bmp.row_stride(width))
    batch.encode_batch(np.stack(images), config, device="cpu")
    forms = {k[-1] for k in (key[2:] for key, _ in graphed_cpu.programs(CPU))
             if k[0] == front}
    assert forms == {"rgb", "bmp-rows"}


# --------------------------------------------------------------------------
# The legs' seconds
# --------------------------------------------------------------------------

def test_leg_seconds(tmp_path, monkeypatch):
    _chunks_of(monkeypatch, 2, 16, 16)
    paths = _write(tmp_path, _images(10, 5, 16, 16))
    stats = stream.encode_paths(paths, EncoderConfig(), lambda p, d: None,
                                device="cpu")
    assert stats.decode_seconds > 0
    assert stats.assemble_seconds > 0 and stats.emit_seconds > 0
    assert stats.write_seconds == stats.assemble_seconds + stats.emit_seconds
    assert stats.seconds >= stats.decode_seconds


def test_host_io_bench_on_cpu(tmp_path, capsys):
    """bench/host_io, the legs' host I/O by the host clock: exit 0 and a
    last JSON line with each measurement."""
    import json

    from jpeg_encoder_torch.bench import host_io

    assert host_io.main(["--images", "3", "--width", "24", "--height", "16",
                         "--threads", "2", "--reps", "1", "--dir",
                         str(tmp_path), "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = {"probe_serial", "probe_pool", "read_native_1", "read_native_pool",
            "read_python_1", "read_python_pool", "emit_alone",
            "emit_under_1_readers", "emit_under_2_readers"}
    assert keys <= set(line) and all(line[k] > 0 for k in keys)
    assert line["card"] == "cpu" and line["pinned"] is False


def test_folder_legs_bench_on_cpu(tmp_path, capsys):
    """bench/folder_legs, a folder's untraced passes leg by leg: exit 0 and
    a last JSON line with each quantity for every pass, under the switch
    interval asked for; the interpreter's own is restored after."""
    import json
    import sys

    from jpeg_encoder_torch.bench import folder_legs

    interval = sys.getswitchinterval()
    try:
        assert folder_legs.main(["--files", "3", "--width", "24",
                                 "--height", "16", "--warm", "1",
                                 "--passes", "2", "--switch-interval",
                                 "0.001", "--dir", str(tmp_path),
                                 "--device", "cpu"]) == 0
    finally:
        sys.setswitchinterval(interval)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    legs = {f"{leg}_cpu_s" for leg in ("compute_leg", "loader", "assembler",
                                       "emitter", "decoders", "other")}
    keys = {"wall_s", "decode_s", "assemble_s", "emit_s", "cpu_s",
            "voluntary_switches", "involuntary_switches"} | legs
    assert set(line["passes"]) == keys == set(line["median"])
    assert all(len(v) == 2 for v in line["passes"].values())
    assert all(w > 0 for w in line["passes"]["wall_s"])
    # Each leg's threads timed themselves; the parts add up to the whole.
    for i in range(2):
        assert all(line["passes"][k][i] >= 0 for k in legs - {"other_cpu_s"})
        assert line["passes"]["loader_cpu_s"][i] > 0
        assert line["passes"]["decoders_cpu_s"][i] > 0
        assert sum(line["passes"][k][i] for k in legs) == pytest.approx(
            line["passes"]["cpu_s"][i])
    assert threading.Thread is folder_legs._Timed.__bases__[0]  # restored
    assert line["switch_interval"] == 0.001 and line["mpix_per_s"] > 0
    assert line["card"] == "cpu"
    assert len(list((tmp_path / "bmp_24x16").iterdir())) == 3
    # --compare pairs runs' lines: a run against itself is lower in none.
    run = tmp_path / "run.json"
    run.write_text(json.dumps(line) + "\n")
    assert folder_legs.main(["--compare", str(run), "--against",
                             str(run)]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 1 + len(keys)
    assert all("(+0.00%), lower in 0 of 1 pairs" in r for r in rows
               if not r.startswith(("voluntary", "involuntary")))


# --------------------------------------------------------------------------
# The card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned ring and the CUDA "
                    "kernels")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_card_stream_reads_rows_into_pinned_slots(cuda, tmp_path,
                                                  monkeypatch):
    """On the card, a row-padded geometry in chunks of 3, 3 and 1: every
    ring slot is pinned, one thread emits, and the files == encode_batch's
    on the card."""
    rings = []

    class Ring(stream._PinnedRing):
        def __init__(self, *args):
            super().__init__(*args)
            rings.append(self)

    monkeypatch.setattr(stream, "_PinnedRing", Ring)
    _chunks_of(monkeypatch, 3, 333, 517)
    images = _images(11, 7, 333, 517)
    paths = _write(tmp_path, images)
    got, threads = {}, set()

    def emit(path, data):
        threads.add(threading.get_ident())
        got[path] = data

    stream.encode_paths(paths, EncoderConfig(), emit, device=cuda)
    assert rings and all(s.is_pinned() for r in rings for s in r.slots)
    assert rings[0].slots[0].shape == (3, 333 * bmp.row_stride(517))
    assert len(threads) == 1
    want = batch.encode_batch(np.stack(images), EncoderConfig(), device=cuda)
    assert [got[p] for p in paths] == want
