"""The program's front, on CPU: an image in, the three padded planes out.

pipeline.scan_entries turns an image into the padded Y, Cb and Cr planes
with kernels/front.planes: on the card the F1 kernel (csrc/front.cu), on
the CPU its plain version, ops/front.planes. Held here, exactly: the plain
version against the JAX package's colour, pad and subsample stages
composed as its pipeline composes them, and against its NumPy oracle, at
4:4:4, 4:2:2 and 4:2:0 on the quirk geometries (dim % (8 * factor) == 1)
and at widths 1-20 (every BMP row padding), for both input forms (an RGB
array, and a BMP file's stored rows read with bmp.read(out=)), a batch of
three images and live_rows; the wrapper's checks; the bit identities
F1's conversions rest on, over all 2^24 RGB triples; encode_array,
encode_file and encode_batch bytes against the JAX package's and the
oracle's. The cuda-marked tests hold F1 to the plain version and all 2^24
RGB triples to the oracle on the card, and skip here. JAX is imported inside the fixtures that need it, so the
card tests run where JAX is absent.
"""

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import pipeline
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.io import bmp
from jpeg_encoder_torch.kernels import front as front_kernel
from jpeg_encoder_torch.ops import front as front_ops
from jpeg_encoder_torch.parallel import batch

RATIOS = {"444": (4, 4, 4), "422": (4, 2, 2), "420": (4, 2, 0)}
QUIRKS = [(17, 17), (33, 17), (49, 33)]  # (width, height)


def _geom(width, height, ratio):
    return EncoderConfig(subsampling_ratio=RATIOS[ratio]).geometry(
        width, height)


def _images(seed, count, height, width):
    return np.random.default_rng(seed).integers(
        0, 256, (count, height, width, 3), dtype=np.uint8)


def _stored(tmp_path, images):
    """Each image written as a BMP file and read back as stored rows
    (bmp.read(out=)), stacked: (B, H, stride) uint8."""
    height, width = images.shape[1:3]
    stride = bmp.row_stride(width)
    stack = torch.empty((len(images), height * stride), dtype=torch.uint8)
    for i, rgb in enumerate(images):
        path = str(tmp_path / f"{i}.bmp")
        bmp.write(path, rgb)
        rows = bmp.read(path, out=stack[i])
        assert (rows.width, rows.height) == (width, height)
    return stack.view(len(images), height, stride)


def _oracle_planes(images, geom, live_rows=None):
    """The JAX package's oracle, image by image: colour, the live rows
    zeroed, pad, subsample; stacked as scan_entries stacks them."""
    from jpeg_encoder_tpu import oracle

    height = images.shape[1]
    out = [[], [], []]
    for i, rgb in enumerate(images):
        planes = list(oracle.rgb_to_ycbcr_exact(rgb))
        if live_rows is not None:
            dead = max(0, min(height, live_rows - i * height))
            for p in planes:
                p[dead:] = 0
        for k, p in enumerate(planes):
            padded = np.zeros((geom.padded_height, geom.padded_width),
                              np.uint8)
            padded[: geom.height, : geom.width] = p
            out[k].append(padded if k == 0 else oracle.subsample_plane(
                padded, _jax_geom(geom)))
    return tuple(np.concatenate(p) for p in out)


def _jax_geom(geom):
    from jpeg_encoder_tpu.config import FrameGeometry

    return FrameGeometry(geom.width, geom.height, geom.h_factor,
                         geom.v_factor)


@pytest.fixture(scope="module")
def jax_front():
    """fn(images, geom, live_rows=None) -> the JAX package's planes of each
    image, composed as jpeg_encoder_tpu/pipeline.py:251-254 composes them
    (with live rows, as its band front does, parallel/tiled.py:110-118),
    stacked; one eager run a geometry, content and live_rows, shared by
    every case of it."""
    import jax
    import jax.numpy as jnp

    from jpeg_encoder_tpu.ops import color, sample

    done = {}

    def front(images, geom, live_rows=None):
        key = (images.tobytes(), images.shape, geom, live_rows)
        if key not in done:
            jgeom = _jax_geom(geom)
            height = images.shape[1]
            out = [[], [], []]
            with jax.default_device(jax.devices("cpu")[0]):
                for i, rgb in enumerate(images):
                    planes = color.rgb_to_ycbcr(rgb)
                    if live_rows is not None:
                        live = (jnp.arange(height)
                                < live_rows - i * height)[:, None]
                        planes = [jnp.where(live, p, 0) for p in planes]
                    y, cb, cr = planes
                    out[0].append(np.asarray(sample.pad_plane(y, jgeom)))
                    for k, c in ((1, cb), (2, cr)):
                        out[k].append(np.asarray(sample.subsample_plane(
                            sample.pad_plane(c, jgeom), jgeom)))
            done[key] = tuple(np.concatenate(p) for p in out)
        return done[key]

    return front


def _assert_planes(got, want):
    assert len(got) == 3
    for name, g, w in zip("y cb cr".split(), got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# --------------------------------------------------------------------------
# The plain version against the JAX package and the oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", list(RATIOS))
@pytest.mark.parametrize("width,height", QUIRKS)
@pytest.mark.parametrize("form", ["rgb", "rows"])
def test_front_equals_jax_and_oracle(tmp_path, jax_front, form, width,
                                     height, ratio):
    geom = _geom(width, height, ratio)
    images = _images(width * 100 + height, 1, height, width)
    image = (torch.from_numpy(images[0]) if form == "rgb"
             else bmp.Rows(_stored(tmp_path, images)[0], width, height))
    got = front_ops.planes(image, geom)
    _assert_planes(got, jax_front(images, geom))
    _assert_planes(got, _oracle_planes(images, geom))
    _assert_planes(front_kernel.planes(image, geom), jax_front(images, geom))


@pytest.mark.parametrize("ratio", list(RATIOS))
@pytest.mark.parametrize("width", range(1, 21))
def test_stored_rows_at_every_row_padding(tmp_path, width, ratio):
    height = 3 + width % 5
    geom = _geom(width, height, ratio)
    images = _images(width, 1, height, width)
    rows = bmp.Rows(_stored(tmp_path, images)[0], width, height)
    want = _oracle_planes(images, geom)
    _assert_planes(front_ops.planes(rows, geom), want)
    _assert_planes(front_ops.planes(torch.from_numpy(images[0]), geom), want)


@pytest.mark.parametrize("ratio", list(RATIOS))
@pytest.mark.parametrize("form", ["rgb", "rows"])
def test_a_batch_of_three_quirk_images(tmp_path, jax_front, form, ratio):
    width, height = 33, 17
    geom = _geom(width, height, ratio)
    images = _images(7, 3, height, width)
    image = (torch.from_numpy(images) if form == "rgb"
             else bmp.Rows(_stored(tmp_path, images), width, height))
    got = front_ops.planes(image, geom)
    _assert_planes(got, jax_front(images, geom))
    _assert_planes(got, _oracle_planes(images, geom))


@pytest.mark.parametrize("ratio", list(RATIOS))
@pytest.mark.parametrize("live_rows", [0, 9, 17, 30, 51])
def test_live_rows_zero_the_stack_past_them(jax_front, live_rows, ratio):
    """Three 33x17 images stacked (the band path's form): the rows at or
    past live_rows, over the 51 stacked rows, are 0 in all three planes."""
    width, height = 33, 17
    geom = _geom(width, height, ratio)
    images = _images(11, 3, height, width)
    got = front_ops.planes(torch.from_numpy(images), geom, live_rows)
    _assert_planes(got, jax_front(images, geom, live_rows))
    _assert_planes(got, _oracle_planes(images, geom, live_rows))


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows_width", "order",
                                 "live_rows"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    geom = _geom(33, 17, "420")
    rgb = torch.zeros((17, 33, 3), dtype=torch.uint8)
    image, live = rgb, None
    if bad == "dtype":
        image = rgb.to(torch.int16)
    elif bad == "shape":
        image = torch.zeros((17, 32, 3), dtype=torch.uint8)
    elif bad == "rows_width":
        image = bmp.Rows(torch.zeros((17, bmp.row_stride(33)),
                                     dtype=torch.uint8), 32, 17)
    elif bad == "order":
        image = torch.zeros((33, 17, 3), dtype=torch.uint8).transpose(0, 1)
    else:
        live = -1
    with pytest.raises(ValueError):
        front_kernel.planes(image, geom, live)


# --------------------------------------------------------------------------
# The bit identities F1's conversions rest on (csrc/front.cu)
# --------------------------------------------------------------------------

TWO23 = 2.0 ** 23


def test_a_byte_under_the_exponent_of_2_to_the_23_is_its_value():
    """The bits 0x4B000000 | c are the float 2^23 + c: minus 2^23, c."""
    c = np.arange(256, dtype=np.uint32)
    value = (np.uint32(0x4B000000) | c).view(np.float32) - np.float32(TWO23)
    np.testing.assert_array_equal(value, c.astype(np.float32))


@pytest.mark.parametrize("channel", range(3), ids=["y", "cb", "cr"])
def test_clamping_then_adding_2_to_the_23_toward_zero_gives_the_byte(
        channel):
    """For all 2^24 RGB triples through ops/color's per-operation-rounded
    chains, clamp(x, 0, 255) + 2^23 rounded toward zero is a float whose
    low byte is ops/color._to_u8(x) (the sum is exact in float64, where
    toward zero is floor), and whose bits above the byte are 0x4B000000."""
    from jpeg_encoder_torch.ops import color

    luts = color._channel_luts_np()
    first, second, third = luts[3 * channel: 3 * channel + 3]
    values = np.arange(256)
    g, b = (a.ravel() for a in np.meshgrid(values, values, indexing="ij"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for r in range(256):
            x = (first[r] + second[g] if channel == 0
                 else first[r] - second[g])
            x = x - third[b] if channel == 2 else x + third[b]
            bits = (np.floor(np.clip(x, 0, 255).astype(np.float64) + TWO23)
                    .astype(np.float32).view(np.uint32))
            want = color._to_u8(torch.from_numpy(x)).numpy()
            assert x.dtype == np.float32
            np.testing.assert_array_equal(bits & 0xFF, want)
            np.testing.assert_array_equal(bits >> 8, 0x4B0000)
    finally:
        torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# The entry points' bytes
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def references():
    """Three 33x17 images and, for each, the JAX package's encode_array
    file and its oracle's file (EncoderConfig(); one JAX compilation)."""
    from jpeg_encoder_tpu import oracle
    from jpeg_encoder_tpu import pipeline as jax_pipeline
    from jpeg_encoder_tpu.io import jfif
    from test_torch_host import jax_config

    images = _images(3, 3, 17, 33)
    config = jax_config(EncoderConfig())
    jax_files = [jax_pipeline.encode_array(rgb, config).file_bytes
                 for rgb in images]
    oracle_files = []
    for rgb in images:
        golden = oracle.encode_oracle(rgb, config)
        oracle_files.append(jfif.assemble(golden.geom, golden.entropy_bytes,
                                          quality=config.quality))
    return images, jax_files, oracle_files


@pytest.mark.parametrize("entry", ["encode_array", "encode_file",
                                   "encode_batch", "encode_array_rows"])
def test_entry_bytes_equal_jax_and_oracle(tmp_path, references, entry):
    images, jax_files, oracle_files = references
    assert jax_files == oracle_files
    if entry == "encode_array":
        got = [pipeline.encode_array(rgb, device="cpu").file_bytes
               for rgb in images]
    elif entry == "encode_batch":
        got = batch.encode_batch(images, device="cpu")
    elif entry == "encode_array_rows":
        stack = _stored(tmp_path, images)
        got = [pipeline.encode_array(bmp.Rows(rows, 33, 17),
                                     device="cpu").file_bytes
               for rows in stack]
    else:
        got = []
        for i, rgb in enumerate(images):
            path = str(tmp_path / f"in{i}.bmp")
            bmp.write(path, rgb)
            got.append(pipeline.encode_file(
                path, str(tmp_path / f"out{i}.jpg"), device="cpu").file_bytes)
    assert got == jax_files


# --------------------------------------------------------------------------
# F1 on the card (skipped without one)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the F1 kernel")
    return torch.device("cuda", torch.cuda.current_device())


def _card_case(cuda, images, geom, form, live_rows=None):
    """F1 on the card against the plain version on the CPU, exactly."""
    height, width = images.shape[1:3]
    host = torch.from_numpy(images)
    if form == "rows":
        stride = bmp.row_stride(width)
        rows = torch.zeros((len(images), height, stride), dtype=torch.uint8)
        rows[..., : 3 * width] = host.flip(1).flip(-1).reshape(
            len(images), height, 3 * width)
        host_image = bmp.Rows(rows, width, height)
        card_image = bmp.Rows(rows.to(cuda), width, height)
    else:
        host_image, card_image = host, host.to(cuda)
    got = front_kernel.planes(card_image, geom, live_rows)
    want = front_ops.planes(host_image, geom, live_rows)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.data_ptr() % 8 == 0
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", list(RATIOS))
@pytest.mark.parametrize("form", ["rgb", "rows"])
def test_card_front_equals_plain(cuda, form, ratio):
    for width, height in QUIRKS + [(w, 3 + w % 5) for w in range(1, 21)]:
        geom = _geom(width, height, ratio)
        _card_case(cuda, _images(width, 3, height, width), geom, form)
    for live_rows in (0, 9, 17, 30, 51):
        _card_case(cuda, _images(11, 3, 17, 33), _geom(33, 17, ratio), form,
                   live_rows)


@pytest.mark.cuda
def test_card_front_converts_every_rgb_triple_as_the_oracle(cuda):
    from jpeg_encoder_torch.bench import parity

    assert parity.color_mismatches(parity.color_grid(1), cuda) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", list(RATIOS))
@pytest.mark.parametrize("size", [(1920, 1080, 8), (3840, 2160, 1),
                                  (1921, 1089, 2)])
def test_card_front_at_full_size(cuda, size, ratio):
    width, height, count = size
    geom = _geom(width, height, ratio)
    for form in ("rgb", "rows"):
        _card_case(cuda, _images(count, count, height, width), geom, form)
