"""The staged upload of in-memory arrays (pipeline.upload, UploadRing), on
CPU.

On a card, encode_array of an array, encode_batch's chunks and the band
front's live rows go up through the calling thread's ring of pinned
pieces, and graphs.run refuses a program input in pageable host memory.
Held here: the ring's piece schedule with unpinned pieces and a CPU
destination (pieces smaller than an image, not dividing the chunk and
larger than it, rings of depth 1 and 2): the bytes come back exact and a
piece is filled again only after the wait on its copy; the input
semantics (views, other dtypes) against np.ascontiguousarray; the files
of encode_batch, encode_array and encode_tiled on such inputs, with the
ring forced into the CPU path, against the JAX package's and its
oracle's; the refusal of pageable inputs through a stand-in card. The
JAX package is imported where a test compares with it, so that the card
tests run where JAX is absent.
"""

import threading

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import graphs, pipeline
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.parallel import batch, tiled

CPU = torch.device("cpu")


def _images(seed, count, height, width):
    return np.random.default_rng(seed).integers(
        0, 256, (count, height, width, 3), dtype=np.uint8)


class _Event:
    """A stand-in CUDA event: what the ring recorded and waited on."""

    def __init__(self, log, i):
        self.log, self.i = log, i

    def record(self, stream):
        self.log.append(("record", self.i))

    def synchronize(self):
        self.log.append(("wait", self.i))


class _LoggedRing(pipeline.UploadRing):
    """An UploadRing on the CPU whose pieces' events are stand-ins, and
    whose fills are logged with the piece they fill."""

    def __init__(self, piece_bytes, depth, log):
        super().__init__(CPU, piece_bytes=piece_bytes, depth=depth)
        self.log = log
        self.copied = [_Event(log, i) for i in range(depth)]

    def release(self, i):
        self.copied[i].record(None)

    def fill(self, piece, src):
        index = next(i for i, p in enumerate(self.pieces)
                     if p.data_ptr() == piece.data_ptr())
        self.log.append(("fill", index))
        super().fill(piece, src)


# --------------------------------------------------------------------------
# The piece schedule
# --------------------------------------------------------------------------

# An image of 12 x 20 x 3 = 720 bytes, a chunk of 5 images, 3,600 bytes.
@pytest.mark.parametrize("piece_bytes", [256, 1000, 720, 3600, 5000],
                         ids=["below-an-image", "not-dividing", "an-image",
                              "the-chunk", "above-the-chunk"])
@pytest.mark.parametrize("depth", [1, 2])
def test_ring_uploads_exact_bytes(piece_bytes, depth):
    chunk = _images(piece_bytes + depth, 5, 12, 20)
    ring = pipeline.UploadRing(CPU, piece_bytes=piece_bytes, depth=depth)
    assert all(not p.is_pinned() and p.numel() == piece_bytes
               for p in ring.pieces)
    assert ring.copied == [None] * depth
    for _ in range(2):  # the ring is used again from where it stopped
        out = ring.staged(torch.from_numpy(chunk))
        assert out.shape == chunk.shape and out.dtype == torch.uint8
        assert np.array_equal(out.numpy(), chunk)
        assert out.data_ptr() not in [p.data_ptr() for p in ring.pieces]
    assert ring.turn == 2 * -(-chunk.nbytes // piece_bytes)


@pytest.mark.parametrize("piece_bytes, depth", [(256, 1), (1000, 2),
                                                (5000, 2)])
def test_ring_fills_a_piece_only_after_its_copy(piece_bytes, depth):
    """Piece after piece in turn: each one waited on, filled, then its
    copy's event recorded; the wait before a fill is on that piece."""
    log = []
    ring = _LoggedRing(piece_bytes, depth, log)
    chunk = _images(7, 5, 12, 20)
    assert np.array_equal(ring.staged(torch.from_numpy(chunk)).numpy(),
                          chunk)
    pieces = -(-chunk.nbytes // piece_bytes)
    want = []
    for k in range(pieces):
        i = k % depth
        want += [("wait", i), ("fill", i), ("record", i)]
    assert log == want


def test_ring_of_an_empty_upload():
    ring = pipeline.UploadRing(CPU, piece_bytes=64, depth=2)
    out = ring.staged(torch.zeros((0, 7, 3), dtype=torch.uint8))
    assert out.shape == (0, 7, 3) and ring.turn == 0


def test_unpinnable_piece_raises(monkeypatch):
    """No quiet fallback to pageable memory: where pin_memory does not give
    pinned pieces, the card's ring refuses to start."""
    empty = torch.empty

    def unpinned(*args, pin_memory=False, **kwargs):
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", unpinned)
    with pytest.raises(RuntimeError, match="could not pin"):
        pipeline.UploadRing(torch.device("cuda", 0), piece_bytes=64)


def test_rings_are_one_a_thread_and_device(monkeypatch):
    made = []

    class Ring:
        def __init__(self, device):
            made.append(device)

    monkeypatch.setattr(pipeline, "UploadRing", Ring)
    rings = pipeline.UploadRings()
    first = rings.ring(torch.device("cuda", 0))
    assert rings.ring(torch.device("cuda", 0)) is first
    assert rings.ring(torch.device("cuda", 1)) is not first
    other = []
    thread = threading.Thread(
        target=lambda: other.append(rings.ring(torch.device("cuda", 0))))
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive() and other[0] is not first
    assert len(made) == 3


# --------------------------------------------------------------------------
# The input semantics
# --------------------------------------------------------------------------

def _views():
    """(name, an input) whose bytes are np.ascontiguousarray(x, uint8)."""
    base = _images(3, 2, 9, 13)
    wide = np.random.default_rng(4).integers(0, 256, (2, 9, 13, 5),
                                             dtype=np.uint8)
    return [
        ("contiguous", base),
        ("negative-stride rows", base[:, ::-1]),
        ("negative-stride channels", base[..., ::-1]),
        ("channel slice", wide[..., 1:4]),
        ("column slice", base[:, :, 2:11]),
        ("int64", base.astype(np.int64)),
        ("float32", base.astype(np.float32)),
    ]


@pytest.mark.parametrize("name, x", _views(), ids=[v[0] for v in _views()])
def test_upload_takes_todays_bytes(name, x):
    want = np.ascontiguousarray(x, dtype=np.uint8)
    on_cpu = pipeline.upload(x, CPU)
    assert on_cpu.dtype == torch.uint8 and np.array_equal(on_cpu.numpy(), want)
    staged = pipeline.UploadRing(CPU, piece_bytes=100, depth=2).staged(
        on_cpu)
    assert np.array_equal(staged.numpy(), want)
    for member in range(len(x)):  # an image of it, as encode_array takes it
        assert np.array_equal(pipeline.upload(x[member], CPU).numpy(),
                              want[member])


def test_upload_copies_no_contiguous_uint8_array_on_the_cpu():
    x = _images(5, 2, 9, 13)
    assert np.shares_memory(pipeline.upload(x, CPU).numpy(), x)
    t = torch.from_numpy(x)
    assert pipeline.upload(t, CPU) is t


# --------------------------------------------------------------------------
# The files, with the ring in the CPU path
# --------------------------------------------------------------------------

@pytest.fixture
def ring_on_cpu(monkeypatch):
    """pipeline.upload with every input staged through a CPU ring of
    small pieces (what a card does, in the CPU path); -> the count of
    uploads."""
    calls = []

    def staged(host, device):
        calls.append(device)
        if not isinstance(host, torch.Tensor):
            host = torch.from_numpy(np.ascontiguousarray(host,
                                                         dtype=np.uint8))
        return pipeline.UploadRing(device, piece_bytes=1000,
                                   depth=2).staged(host)

    monkeypatch.setattr(pipeline, "upload", staged)
    return calls


# (width, height, bands): 4:2:0 MCU rows of 16 lines. 64x48 has three, so
# three bands of one; 49x33 is a quirk geometry (dim % 16 == 1), where the
# band path falls back to one encode_array.
GEOMETRIES = [(64, 48, 3), (49, 33, 2)]


@pytest.mark.parametrize("width, height, bands", GEOMETRIES,
                         ids=["64x48", "49x33-quirk"])
def test_files_on_views_match_jax_and_oracle(width, height, bands,
                                             ring_on_cpu):
    """Three images as a negative-stride view, a channel-sliced view and
    an int64 array: encode_batch's, encode_array's and encode_tiled's
    files equal the JAX package's and its oracle's for the image
    np.ascontiguousarray(x, dtype=np.uint8)."""
    from jpeg_encoder_tpu import oracle
    from jpeg_encoder_tpu import pipeline as jax_pipeline
    from jpeg_encoder_tpu.io import jfif as jax_jfif
    from test_torch_host import jax_config

    config = EncoderConfig()
    base = _images(width + height, 3, height, width)
    padded = np.concatenate([base, base[..., :1]], axis=-1)
    inputs = {"negative-stride": base[:, ::-1],
              "channel-sliced": padded[..., ::-1][..., 1:],
              "int64": base.astype(np.int64)}
    for name, images in inputs.items():
        want = []
        for rgb in np.ascontiguousarray(images, dtype=np.uint8):
            golden = oracle.encode_oracle(rgb, jax_config(config))
            want.append(jax_jfif.assemble(golden.geom, golden.entropy_bytes,
                                          quality=config.quality))
            assert want[-1] == jax_pipeline.encode_array(
                rgb, jax_config(config)).file_bytes, name
        before = len(ring_on_cpu)
        assert batch.encode_batch(images, config, device="cpu") == want, name
        assert len(ring_on_cpu) == before + 1
        assert [pipeline.encode_array(rgb, config, device="cpu").file_bytes
                for rgb in images] == want, name
        if (width, height) == (49, 33):
            with pytest.warns(RuntimeWarning):
                got = tiled.encode_tiled(images[0], config, bands,
                                         device="cpu")
        else:
            got = tiled.encode_tiled(images[0], config, bands, device="cpu")
        assert got.file_bytes == want[0], name
    assert set(ring_on_cpu) == {CPU}


def test_optimize_batch_and_bands_through_the_ring(ring_on_cpu):
    """The statistics pass takes the staged chunk too; the band front
    uploads only its run's live rows (three runs of a 64x40 image: 16, 16
    and 8 rows)."""
    config = EncoderConfig(optimize_huffman=True)
    images = _images(11, 3, 40, 64)[..., ::-1]
    want = [pipeline.encode_array(np.ascontiguousarray(rgb), config,
                                  device="cpu").file_bytes for rgb in images]
    assert batch.encode_batch(images, config, device="cpu") == want
    shapes = []
    upload = pipeline.upload

    def spy(host, device):
        out = upload(host, device)
        shapes.append(tuple(out.shape))
        return out

    pipeline.upload = spy
    try:
        got = tiled.encode_tiled(images[1], EncoderConfig(), 3,
                                 device="cpu", devices=[CPU] * 3)
    finally:
        pipeline.upload = upload
    assert shapes == [(16, 64, 3), (16, 64, 3), (8, 64, 3)]
    assert got.file_bytes == pipeline.encode_array(
        np.ascontiguousarray(images[1]), EncoderConfig(),
        device="cpu").file_bytes


# --------------------------------------------------------------------------
# No pageable input on a card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pinned", [False, True])
def test_graphs_refuse_pageable_inputs_on_a_card(pinned, monkeypatch):
    card = torch.device("cuda", 0)
    host = torch.arange(6, dtype=torch.uint8)
    monkeypatch.setattr(torch.Tensor, "is_pinned",
                        lambda self, *a: pinned)
    if not pinned:
        with pytest.raises(ValueError, match="'x' lies in pageable"):
            graphs.check_inputs({"x": host}, card)
        with pytest.raises(ValueError, match="'x' lies in pageable"):
            graphs.eager(lambda x: x, {"x": host}, card)
        program = graphs.Program(None, {"x": _OnCard()}, None, {})
        with pytest.raises(ValueError, match="'x' lies in pageable"):
            program.replay({"x": host})
    else:
        graphs.check_inputs({"x": host}, card)
    graphs.check_inputs({"x": host}, CPU)  # the CPU path takes any


class _OnCard:
    """A static buffer that says it lies on a card."""

    device = torch.device("cuda", 0)


def test_capture_refuses_pageable_inputs(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a: False)
    with pytest.raises(ValueError, match="'rgb' lies in pageable"):
        graphs.capture(lambda rgb: rgb, {"rgb": torch.zeros(3)},
                       torch.device("cuda", 0))


def test_pinned_tables_only_on_a_card():
    t = torch.arange(4)
    assert pipeline.pinned(t, CPU) is t


def test_host_io_upload_mode_on_cpu(capsys):
    """bench/host_io --upload: exit 0 and a last JSON line with every
    candidate's GB/s and the ring's bytes exact."""
    import json

    from jpeg_encoder_torch.bench import host_io

    assert host_io.main(["--upload", "--images", "2", "--width", "24",
                         "--height", "16", "--reps", "1", "--device",
                         "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = {"pageable", "pinned_dma", "fill_torch", "ring_torch",
            "ring_torch_1", "ring_torch_16"}
    keys |= {f"{kind}_native_{t}" for kind in ("fill", "ring")
             for t in (1, 2, 4, 8)}
    assert keys <= set(line) and all(line[k] > 0 for k in keys)
    assert line["exact"] is True and line["card"] == "cpu"
    assert line["array_mb"] == 2 * 16 * 24 * 3 / 1e6


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pinned pieces and the card path")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_card_upload_exact_and_pinned(cuda):
    for name, x in _views():
        got = pipeline.upload(x, cuda)
        assert got.device == cuda, name
        assert np.array_equal(got.cpu().numpy(),
                              np.ascontiguousarray(x, dtype=np.uint8)), name
    big = _images(9, 3, 1081, 1923)[:, ::-1]
    assert np.array_equal(pipeline.upload(big, cuda).cpu().numpy(),
                          np.ascontiguousarray(big))
    ring = pipeline.UPLOADS.ring(cuda)
    assert all(p.is_pinned() for p in ring.pieces)
    with pytest.raises(ValueError, match="pageable"):
        graphs.run(("staging-test",), lambda x: x + 1,
                   {"x": torch.zeros(4)}, cuda)


@pytest.mark.cuda
def test_card_files_equal_cpu(cuda):
    config = EncoderConfig()
    images = _images(12, 3, 120, 200)[:, ::-1]
    want = [pipeline.encode_array(rgb, config, device="cpu").file_bytes
            for rgb in images]
    for _ in range(3):  # eager, capture, replay
        assert batch.encode_batch(images, config, device=cuda) == want
        assert [pipeline.encode_array(rgb, config, device=cuda).file_bytes
                for rgb in images] == want
        assert tiled.encode_tiled(images[0], config, 4,
                                  device=cuda).file_bytes == want[0]
    optimize = EncoderConfig(optimize_huffman=True)
    assert batch.encode_batch(images, optimize, device=cuda) == [
        pipeline.encode_array(rgb, optimize, device="cpu").file_bytes
        for rgb in images]
