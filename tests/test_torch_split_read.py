"""The single-file entry's split read, on CPU, with the g++-built runtime.

pipeline.encode_file reads a BMP file's stored rows with
bmp.read(path, out=..., ranges=bmp.file_ranges): one native open and
header check (jt_bmp_open_rows), then the rows as contiguous range preads
whose inner ends lie on 4 KiB file pages, the first on the calling thread
and the others on the runtime's read pool, whose threads start once a
process (jt_read_ranges). Held here: the rows against the Python read and
one pread at widths 1-64, at heights whose rows no range count divides,
at 1, 2, 3, 4 and 8 ranges; the ranges used against a model of the cut;
the reorder against the port's and the JAX package's decode; the errors
(a truncated file, a missing one, a short buffer; a short range and a
failed pread at the native call); four threads reading at once; a
forked child's split read on a pool of its own, and a fork while a
thread holds the pool's lock; the
trace's range counter for encode_file and for the stream's loader, which
reads one range; encode_file's bytes against the JAX package's oracle;
bench.host_io --split on the CPU.
"""

import ctypes
import errno
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import native, pipeline, trace
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.parallel import stream

PAGE = 4096
RANGE_COUNTS = [1, 2, 3, 4, 8]
# Rows that no range count divides (odd, not a multiple of 3), each file
# spanning more 4 KiB pages than the most ranges asked for.
HEIGHT_KINDS = {"short": 0, "long": 2}


def _lib():
    lib = native.load()
    assert lib is not None, "the g++-built runtime does not load"
    return lib


def _height(width: int, kind: str) -> int:
    """An odd height, not a multiple of 3, whose rows span >= 40 KB."""
    height = 40_000 // bmp.row_stride(width) + HEIGHT_KINDS[kind] * 97
    while height % 2 == 0 or height % 3 == 0:
        height += 1
    return height


def _rgb(seed, height, width):
    return np.random.default_rng(seed).integers(
        0, 256, (height, width, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(width, kind): path} of a BMP file for each width 1-64 and kind."""
    root = tmp_path_factory.mktemp("split")
    paths = {}
    for width in range(1, 65):
        for kind in HEIGHT_KINDS:
            path = str(root / f"{width}_{kind}.bmp")
            bmp.write(path, _rgb(width * 10 + len(kind), _height(width, kind),
                                 width))
            paths[width, kind] = path
    return paths


def _model_ranges(offset: int, nbytes: int, ranges: int) -> int:
    """The ranges jt_read_ranges reads: inner ends rounded down to 4 KiB
    file pages, empty ranges dropped, at most 64."""
    ranges = min(ranges, 64)
    end, lo, used = offset + nbytes, offset, 0
    for i in range(1, ranges + 1):
        hi = end if i == ranges else (offset + nbytes * i // ranges) // PAGE * PAGE
        if hi <= lo or (i < ranges and hi >= end):
            continue
        used, lo = used + 1, hi
    return used


def _recorded_ranges(fn) -> int:
    with trace.recording() as recorder:
        fn()
    return recorder.counters.get("read.ranges", 0)


# --------------------------------------------------------------------------
# The rows
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(HEIGHT_KINDS))
@pytest.mark.parametrize("ranges", RANGE_COUNTS)
def test_split_rows_equal_the_python_read_and_one_pread(files, kind, ranges):
    """At every width 1-64 (padded rows or not) the split read's rows are
    byte-equal to the Python read's and to one pread's, and to the file's
    pixel block; it reads the ranges the 4 KiB cut gives."""
    _lib()
    for width in range(1, 65):
        path = files[width, kind]
        height = _height(width, kind)
        nbytes = height * bmp.row_stride(width)
        assert height % 2 and height % 3 and nbytes > 8 * PAGE
        split = torch.full((nbytes + 5,), 0xAB, dtype=torch.uint8)
        one = torch.zeros(nbytes, dtype=torch.uint8)
        python = torch.zeros(nbytes, dtype=torch.uint8)
        used = _recorded_ranges(
            lambda: bmp.read(path, out=split, ranges=ranges))
        assert used == _model_ranges(54, nbytes, ranges) == ranges, width
        got = bmp.read(path, out=split, ranges=ranges)
        assert (got.width, got.height) == (width, height)
        assert got.rows.data_ptr() == split.data_ptr()
        assert split[nbytes:].eq(0xAB).all()
        bmp.read(path, out=one)
        bmp._read_python(path, python)
        with open(path, "rb") as f:
            stored = torch.frombuffer(bytearray(f.read()[54:]),
                                      dtype=torch.uint8)
        assert torch.equal(got.rows.reshape(-1), one)
        assert torch.equal(one, python)
        assert torch.equal(one, stored)


@pytest.mark.parametrize("ranges", [5, 64, 100])
def test_more_ranges_than_pages_or_the_cap(tmp_path, ranges):
    """A block of few pages is read as the ranges its pages give; the cut
    never passes 64 ranges; the rows are the same."""
    _lib()
    for height, width in ((3, 5), (40, 100), (700, 333)):
        path = str(tmp_path / f"{width}.bmp")
        bmp.write(path, _rgb(height, height, width))
        nbytes = height * bmp.row_stride(width)
        out = torch.zeros(nbytes, dtype=torch.uint8)
        used = _recorded_ranges(lambda: bmp.read(path, out=out,
                                                 ranges=ranges))
        assert used == _model_ranges(54, nbytes, ranges) <= 64
        if nbytes > 64 * PAGE:
            assert used == min(ranges, 64)
        else:
            assert used < ranges
        assert torch.equal(out, bmp._read_python(
            path, torch.zeros(nbytes, dtype=torch.uint8)).rows.view(-1))


@pytest.mark.parametrize("width", [1, 3, 17, 64])
def test_split_rows_reorder_to_the_decode(files, width):
    """rows_to_rgb of the split rows equals bmp.decode of the file, and
    the JAX package's decode."""
    from jpeg_encoder_tpu.io import bmp as jax_bmp

    path = files[width, "long"]
    rows = bmp.read(path, out=lambda w, h: torch.empty(
        h * bmp.row_stride(w), dtype=torch.uint8), ranges=8)
    got = bmp.rows_to_rgb(rows.rows, rows.width).numpy()
    with open(path, "rb") as f:
        np.testing.assert_array_equal(got, bmp.decode(f.read()))
    np.testing.assert_array_equal(got, jax_bmp.read(path))


def test_ranges_below_one_raise(files):
    with pytest.raises(ValueError, match="ranges must be at least 1"):
        bmp.read(files[1, "short"], out=torch.empty(1 << 20,
                                                    dtype=torch.uint8),
                 ranges=0)


# --------------------------------------------------------------------------
# Errors
# --------------------------------------------------------------------------

def _outcome(path, out, ranges):
    try:
        rows = bmp.read(path, out=out(), ranges=ranges)
    except (OSError, ValueError) as error:
        return type(error), str(error)
    return rows.width, rows.height, rows.rows.clone()


@pytest.mark.parametrize("ranges", [1, 8])
def test_errors_are_the_python_reads(tmp_path, monkeypatch, ranges):
    """A truncated file, a missing one, a short buffer and a short buffer
    function: the split read raises what the Python read raises, type and
    text; a good file gives its rows."""
    _lib()
    rgb = _rgb(7, 301, 77)
    good = str(tmp_path / "good.bmp")
    bmp.write(good, rgb)
    with open(good, "rb") as f:
        data = f.read()
    truncated = str(tmp_path / "truncated.bmp")
    with open(truncated, "wb") as f:
        f.write(data[:-PAGE - 1])
    missing = str(tmp_path / "missing.bmp")
    nbytes = 301 * bmp.row_stride(77)
    outs = {
        "buffer": lambda: torch.zeros(nbytes, dtype=torch.uint8),
        "function": lambda: lambda w, h: torch.zeros(
            h * bmp.row_stride(w), dtype=torch.uint8),
        "short buffer": lambda: torch.zeros(nbytes - 1, dtype=torch.uint8),
        "short function": lambda: lambda w, h: torch.zeros(
            nbytes - 1, dtype=torch.uint8),
    }
    cases = [(p, o) for p in (good, truncated, missing) for o in outs]
    split = {c: _outcome(c[0], outs[c[1]], ranges) for c in cases}
    with monkeypatch.context() as m:
        m.setattr(bmp.native, "load", lambda: None)
        python = {c: _outcome(c[0], outs[c[1]], ranges) for c in cases}
    for case in cases:
        got, want = split[case], python[case]
        assert len(got) == len(want), case
        if len(got) == 3:
            assert got[:2] == want[:2] == (77, 301)
            assert torch.equal(got[2], want[2])
        else:
            assert got == want, case
    assert split[truncated, "buffer"] == (ValueError, "BMP file truncated")
    assert split[missing, "buffer"][0] is FileNotFoundError
    assert "out must be" in split[good, "short buffer"][1]


def _read_ranges(fd, out, nbytes, offset, ranges):
    used, error = ctypes.c_int32(), ctypes.c_int32()
    rc = _lib().jt_read_ranges(
        fd, ctypes.cast(out.data_ptr(), ctypes.POINTER(ctypes.c_uint8)),
        nbytes, offset, ranges, ctypes.byref(used), ctypes.byref(error))
    return rc, error.value, used.value


@pytest.mark.parametrize("short_at", ["first", "middle", "last"])
@pytest.mark.parametrize("ranges", [2, 4, 8])
def test_a_short_range_is_truncated(tmp_path, short_at, ranges):
    """jt_read_ranges of more bytes than the file holds: JT_ERR_TRUNCATED
    (-4) wherever the file ends, first, middle or last range; the bytes
    the file has are read."""
    size = 16 * PAGE
    data = np.random.default_rng(ranges).integers(0, 256, size, np.uint8)
    path = tmp_path / "data"
    path.write_bytes(data.tobytes())
    ask = {"first": size * ranges, "middle": size * 2, "last": size + 1}
    nbytes = ask[short_at]
    out = torch.zeros(nbytes, dtype=torch.uint8)
    fd = os.open(path, os.O_RDONLY)
    try:
        rc, error, used = _read_ranges(fd, out, nbytes, 0, ranges)
    finally:
        os.close(fd)
    assert (rc, error, used) == (-4, 0, _model_ranges(0, nbytes, ranges))
    assert torch.equal(out[:size], torch.from_numpy(data))
    assert not out[size:].any()


@pytest.mark.parametrize("ranges", [1, 4])
def test_a_failed_pread_is_io_with_its_errno(tmp_path, ranges):
    """A pread that fails (a directory's descriptor: EISDIR; a closed
    one: EBADF) is JT_ERR_IO (-6) with that call's errno, and bmp turns it
    into the OSError of that errno."""
    out = torch.zeros(16 * PAGE, dtype=torch.uint8)
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        rc, error, _ = _read_ranges(fd, out, out.numel(), 0, ranges)
    finally:
        os.close(fd)
    assert (rc, error) == (-6, errno.EISDIR)
    assert _read_ranges(fd, out, out.numel(), 0, ranges)[:2] == (
        -6, errno.EBADF)
    raised = bmp._native_error(rc, error, "x.bmp")
    assert isinstance(raised, IsADirectoryError)
    assert str(raised) == str(IsADirectoryError(
        errno.EISDIR, os.strerror(errno.EISDIR), "x.bmp"))
    pool = bmp._native_error(-7, errno.EAGAIN, "x.bmp")
    assert isinstance(pool, RuntimeError)
    assert "read pool could not start" in str(pool)


# --------------------------------------------------------------------------
# The pool
# --------------------------------------------------------------------------

def test_four_threads_read_different_files_at_once(tmp_path):
    """4 Python threads x 20 split reads of different files, all at once
    on the one pool (its threads and the callers outnumber the CPUs; a 1
    us switch interval): each file's rows are its own; the pool has a
    thread for each CPU this process may use, started once."""
    lib = _lib()
    paths, want = [], []
    for k in range(80):
        height, width = 101 + 2 * (k % 5), 120 + k
        rgb = _rgb(k, height, width)
        paths.append(str(tmp_path / f"{k}.bmp"))
        bmp.write(paths[-1], rgb)
        want.append(rgb)
    failures = []
    start = threading.Barrier(4)

    def reader(j):
        buffer = torch.empty(1 << 17, dtype=torch.uint8)
        start.wait()
        for k in range(j, 80, 4):
            rows = bmp.read(paths[k], out=buffer, ranges=8)
            got = bmp.rows_to_rgb(rows.rows, rows.width).numpy()
            if not np.array_equal(got, want[k]):
                failures.append(k)

    threads = [threading.Thread(target=reader, args=(j,)) for j in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert failures == []
    cpus = len(os.sched_getaffinity(0))
    assert lib.jt_read_pool_threads() == cpus
    assert lib.jt_read_pool_threads() == cpus


def _native_rows(lib, path: str, ranges: int) -> np.ndarray:
    """The file's stored rows by the native calls alone (no torch, so a
    forked child may run it): jt_bmp_open_rows, then jt_read_ranges into
    a NumPy buffer."""
    fd, width, height = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    offset, err, used = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    assert lib.jt_bmp_open_rows(
        os.fsencode(path), ctypes.byref(fd), ctypes.byref(width),
        ctypes.byref(height), ctypes.byref(offset), ctypes.byref(err)) == 0
    rows = np.empty(height.value * bmp.row_stride(width.value), np.uint8)
    try:
        rc = lib.jt_read_ranges(
            fd.value, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            rows.size, offset.value, ranges, ctypes.byref(used),
            ctypes.byref(err))
    finally:
        os.close(fd.value)
    assert rc == 0 and used.value == ranges, (rc, used.value)
    return rows


def _forked(child, timeout: float = 60.0) -> int:
    """Fork; the child runs child() -> its exit code (1 on an exception)
    and leaves by os._exit. -> the child's exit status; the child is
    killed, and the test fails, if it has not exited within timeout."""
    import time

    pid = os.fork()
    if pid == 0:
        code = 1
        try:
            code = child()
        finally:
            os._exit(code)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            return os.waitstatus_to_exitcode(status)
        time.sleep(0.01)
    os.kill(pid, 9)
    os.waitpid(pid, 0)
    pytest.fail(f"the forked child did not exit within {timeout} s")


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_a_forked_child_splits_on_a_pool_of_its_own(files):
    """A split read starts the pool; a forked child, which has none of its
    threads, reads the same file in 8 ranges on a pool of its own: its
    rows equal the parent's, it starts a thread a CPU, and it exits 0."""
    lib = _lib()
    path = files[17, "long"]
    parent = _native_rows(lib, path, 8)
    assert lib.jt_read_pool_threads() == len(os.sched_getaffinity(0))

    def child():
        got = _native_rows(lib, path, 8)
        return 0 if (np.array_equal(got, parent)
                     and lib.jt_read_pool_threads()
                     == len(os.sched_getaffinity(0))) else 3

    assert _forked(child) == 0
    assert np.array_equal(_native_rows(lib, path, 8), parent)


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_a_fork_while_a_thread_holds_the_pool_lock(files):
    """A second thread holds the read pool's lock (jt_read_pool_hold, as a
    thread starting the pool does) when the main thread forks: fork()
    waits for it (pthread_atfork), so the child, which has no such thread,
    splits 8 ranges on a pool of its own and exits 0 within 5 s. Without
    the handlers the child inherits the lock held and never splits."""
    import time

    lib = _lib()
    path = files[33, "long"]
    want = _native_rows(lib, path, 8)
    held = ctypes.c_int32(0)
    holder = threading.Thread(target=lib.jt_read_pool_hold,
                              args=(300, ctypes.byref(held)))
    holder.start()
    try:
        while not held.value:
            time.sleep(0.001)
        code = _forked(lambda: 0 if np.array_equal(
            _native_rows(lib, path, 8), want) else 3, timeout=5)
    finally:
        holder.join()
    assert code == 0


# --------------------------------------------------------------------------
# Who splits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width,height", [(640, 480), (1366, 768),
                                          (1920, 1080), (3840, 2160)])
def test_file_ranges_is_the_constant_capped_by_the_cpus(monkeypatch, width,
                                                        height):
    """READ_RANGES, at most one a usable CPU, for rows of SPLIT_MIN_BYTES
    or more; one pread below."""
    big = height * bmp.row_stride(width) >= bmp.SPLIT_MIN_BYTES
    cpus = len(os.sched_getaffinity(0))
    assert bmp.file_ranges(width, height) == (
        min(bmp.READ_RANGES, cpus) if big else 1)
    assert big == (width > 640)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1})
    assert bmp.file_ranges(width, height) == (min(2, bmp.READ_RANGES)
                                              if big else 1)


@pytest.mark.parametrize("split_min", [0, 1 << 30])
def test_encode_file_splits_and_equals_the_oracle(tmp_path, monkeypatch,
                                                  split_min):
    """encode_file reads a file of many pages as bmp.file_ranges ranges
    (the trace's read.ranges; one below SPLIT_MIN_BYTES) and writes the
    JAX package's oracle's bytes, as encode_array of the decoded array
    does."""
    from jpeg_encoder_tpu import oracle
    from jpeg_encoder_tpu.io import jfif
    from test_torch_host import jax_config

    monkeypatch.setattr(bmp, "SPLIT_MIN_BYTES", split_min)
    rgb = _rgb(11, 203, 257)
    path = str(tmp_path / "in.bmp")
    bmp.write(path, rgb)
    out = str(tmp_path / "out.jpg")
    used = _recorded_ranges(
        lambda: pipeline.encode_file(path, out, device="cpu"))
    nbytes = 203 * bmp.row_stride(257)
    ranges = bmp.file_ranges(257, 203)
    assert ranges == (1 if split_min else min(bmp.READ_RANGES,
                                             len(os.sched_getaffinity(0))))
    assert used == _model_ranges(54, nbytes, ranges) == ranges
    with open(out, "rb") as f:
        got = f.read()
    assert got == pipeline.encode_array(rgb, device="cpu").file_bytes
    golden = oracle.encode_oracle(rgb, jax_config(EncoderConfig()))
    assert got == jfif.assemble(golden.geom, golden.entropy_bytes,
                                quality=EncoderConfig().quality)


def test_the_streams_loader_reads_one_range(tmp_path, monkeypatch):
    """The stream's _read_rows reads each file as one pread, whatever
    file_ranges gives, and so does encode_paths's loader."""
    monkeypatch.setattr(bmp, "SPLIT_MIN_BYTES", 0)
    assert bmp.file_ranges(257, 203) > 1
    paths = []
    for k in range(3):
        paths.append(str(tmp_path / f"{k}.bmp"))
        bmp.write(paths[-1], _rgb(k, 203, 257))
    nbytes = 203 * bmp.row_stride(257)
    out = torch.empty(nbytes, dtype=torch.uint8)
    assert _recorded_ranges(
        lambda: stream._read_rows(paths[0], out, (257, 203))) == 1
    emitted = {}
    assert _recorded_ranges(lambda: stream.encode_paths(
        paths, EncoderConfig(), emitted.__setitem__, device="cpu")) == 3
    assert sorted(emitted) == sorted(paths)
    for path in paths:
        assert emitted[path] == pipeline.encode_array(
            bmp.read(path), device="cpu").file_bytes


def test_python_read_is_one_range(files, monkeypatch):
    """Without the native runtime the read is one readinto, whatever
    ranges asks for."""
    monkeypatch.setattr(bmp.native, "load", lambda: None)
    out = torch.empty(1 << 20, dtype=torch.uint8)
    assert _recorded_ranges(
        lambda: bmp.read(files[9, "long"], out=out, ranges=8)) == 1


# --------------------------------------------------------------------------
# The instrument
# --------------------------------------------------------------------------

def test_host_io_split_mode_on_cpu(capsys):
    """bench/host_io --split: exit 0 and a last JSON line with every
    candidate's ms and GB/s at each geometry, every candidate's rows equal
    to one pread's."""
    from jpeg_encoder_torch.bench import host_io

    assert host_io.main(["--split", "--geometries", "24x16,300x200",
                         "--reps", "1", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    names = set(host_io.split_candidates())
    assert {"one_pread", "mmap_copy", "chosen", "pool_2", "pool_4",
            "pool_8", "threads_2", "threads_4", "threads_8"} <= names
    assert line["exact"] is True and line["card"] == "cpu"
    assert line["pool_threads"] == len(os.sched_getaffinity(0))
    assert set(line["geometries"]) == {"24x16", "300x200"}
    for key, geometry in line["geometries"].items():
        assert geometry["chosen_ranges"] == bmp.file_ranges(
            *map(int, key.split("x")))
        assert set(geometry["ms"]) == set(geometry["gb_per_s"]) == names
        assert all(geometry["exact"][name] for name in names)
        assert all(geometry["ms"][name] > 0 for name in names)
    assert line["geometries"]["300x200"]["mb"] == 200 * 900 / 1e6
