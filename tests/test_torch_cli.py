"""The port's CLI: every case of tests/test_cli.py, in-process with
--device cpu (flags, defaults, stage banners, exit codes), plus what is
new: --tile-bands refused on batch and dataset input, --devices refused
above the devices present for batch and dataset input, no fallback to the
CPU without a card, a torch.profiler trace, and the same file as the JAX
package's CLI."""

import json

import numpy as np
import pytest
import torch

from jpeg_encoder_tpu import cli as jax_cli
from jpeg_encoder_torch import cli, pipeline
from jpeg_encoder_torch.config import EncoderConfig
from jpeg_encoder_torch.io import bmp

CPU = ["--device", "cpu"]


def test_default_output_path():
    assert cli.default_output_path("photo.bmp") == "photo.jpeg"
    assert cli.default_output_path("/a/b/c.bmp") == "/a/b/c.jpeg"


def test_rejects_non_bmp_input(capsys):
    assert cli.main(["-i", "photo.png", *CPU]) == 2
    assert "must be a .bmp" in capsys.readouterr().err


def test_rejects_bad_ratio(tmp_path, capsys, rng):
    path = tmp_path / "x.bmp"
    bmp.write(path, rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8))
    assert cli.main(["-i", str(path), "-s", "4:1:1", *CPU]) == 2
    assert "ratio" in capsys.readouterr().err
    assert cli.main(["-i", str(path), "-s", "nonsense", *CPU]) == 2


def test_rejects_bad_algorithm(tmp_path, rng):
    path = tmp_path / "x.bmp"
    bmp.write(path, rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8))
    with pytest.raises(SystemExit):
        cli.main(["-i", str(path), "-d", "quantum-dct", *CPU])


def test_single_image_encode(tmp_path, rng, capsys):
    rgb = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    path = tmp_path / "img.bmp"
    bmp.write(path, rgb)
    assert cli.main(["-i", str(path), "-s", "4:2:0", "--timing", *CPU]) == 0
    out = tmp_path / "img.jpeg"
    data = out.read_bytes()
    assert data == pipeline.encode_array(rgb, device="cpu").file_bytes
    stdout = capsys.readouterr().out
    assert "megapixels_per_second" in stdout
    # Reference-parity stage banners, in order (main.rs:16-67).
    banners = [
        "Loading bmp...",
        "Loaded!",
        "Chrominance downsampling...",
        "Done!",
        "Performing Discrete Cosine Transform + Quantization...",
        "Done!",
        "Entropy encoding...",
        "Done!",
        "Creating file",
        "Done!",
    ]
    pos = 0
    for banner in banners:
        found = stdout.find(banner, pos)
        assert found >= 0, f"missing banner {banner!r} after offset {pos}"
        pos = found + len(banner)


def test_single_image_matches_the_jax_cli(tmp_path, rng, capsys):
    """The same flags give the same file and the same banners as the JAX
    package's CLI."""
    rgb = rng.integers(0, 256, size=(24, 40, 3), dtype=np.uint8)
    path = tmp_path / "img.bmp"
    bmp.write(path, rgb)
    flags = ["-i", str(path), "-s", "4:2:2", "-d", "bin-dct", "-q", "80"]
    assert jax_cli.main([*flags, "-o", str(tmp_path / "jax.jpeg")]) == 0
    jax_out = capsys.readouterr().out.replace("jax.jpeg", "out.jpeg")
    assert cli.main([*flags, "-o", str(tmp_path / "out.jpeg"), *CPU]) == 0
    assert capsys.readouterr().out == jax_out
    assert (tmp_path / "out.jpeg").read_bytes() == (
        tmp_path / "jax.jpeg").read_bytes()


def test_batch_glob_encode(tmp_path, rng):
    images = {}
    for i in range(3):
        images[i] = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
        bmp.write(tmp_path / f"img{i}.bmp", images[i])
    out_dir = tmp_path / "out"
    assert cli.main(
        ["-i", str(tmp_path / "*.bmp"), "-o", str(out_dir), *CPU]
    ) == 0
    for i in range(3):
        want = pipeline.encode_array(images[i], device="cpu").file_bytes
        assert (out_dir / f"img{i}.jpeg").read_bytes() == want


def test_tile_bands_matches_single_device(tmp_path, rng):
    """--tile-bands --devices N encodes N MCU-row bands, byte-identical to
    the one-piece encode."""
    rgb = rng.integers(0, 256, size=(64, 48, 3), dtype=np.uint8)
    path = tmp_path / "big.bmp"
    bmp.write(path, rgb)
    plain = tmp_path / "plain.jpeg"
    tiled = tmp_path / "tiled.jpeg"
    assert cli.main(["-i", str(path), "-o", str(plain), *CPU]) == 0
    for bands in ("2", "3"):
        assert cli.main(
            ["-i", str(path), "-o", str(tiled), "--tile-bands", "--devices",
             bands, *CPU]
        ) == 0
        assert tiled.read_bytes() == plain.read_bytes()


def test_dataset_mode_single_process(tmp_path, rng, capsys):
    """--dataset DIR is the CLI surface of parallel/multihost: one process
    encodes everything, writes a manifest, prints a summary JSON line, and
    resumes (skips) on a rerun."""
    src = tmp_path / "src"
    src.mkdir()
    images = {}
    for i in range(3):
        rgb = rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8)
        bmp.write(src / f"img{i}.bmp", rgb)
        images[f"img{i}"] = rgb
    out = tmp_path / "out"
    assert cli.main(
        ["--dataset", str(src), "-o", str(out), "-s", "4:2:0", "--timing",
         *CPU]
    ) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["process_count"] == 1
    assert line["encoded"] == 3 and line["skipped"] == 0
    assert line["summary"]["encoded"] == 3
    assert "seconds" in line and "megapixels_per_second" in line
    assert (out / "manifest-00000.json").exists()
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    for name, rgb in images.items():
        got = (out / f"{name}.jpeg").read_bytes()
        want = pipeline.encode_array(rgb, config, device="cpu").file_bytes
        assert got == want, name

    # Rerun: the manifest marks everything done -> all skipped.
    assert cli.main(["--dataset", str(src), "-o", str(out), *CPU]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["encoded"] == 0 and line["skipped"] == 3

    # --no-resume forces re-encoding.
    assert cli.main(
        ["--dataset", str(src), "-o", str(out), "--no-resume", *CPU]
    ) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["encoded"] == 3 and line["skipped"] == 0


def test_dataset_mode_empty_dir(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["--dataset", str(empty), "-o", str(tmp_path), *CPU]) == 1
    assert "no .bmp files" in capsys.readouterr().err


def test_requires_image_or_dataset(capsys):
    assert cli.main([]) == 2
    assert "--image or --dataset" in capsys.readouterr().err


def test_batch_devices_flag(tmp_path, rng, capsys):
    """Batch input runs on one device a process: --devices up to the
    devices present is taken (1 on the CPU), more exits 2."""
    for i in range(4):
        bmp.write(
            tmp_path / f"d{i}.bmp",
            rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8),
        )
    out_dir = tmp_path / "out"
    glob = str(tmp_path / "d*.bmp")
    assert cli.main(["-i", glob, "-o", str(out_dir), "--devices", "1",
                     *CPU]) == 0
    for i in range(4):
        assert (out_dir / f"d{i}.jpeg").exists()
    assert cli.main(["-i", glob, "-o", str(out_dir), "--devices", "2",
                     *CPU]) == 2
    assert "--devices 2" in capsys.readouterr().err
    assert cli.main(["--dataset", str(tmp_path), "-o", str(out_dir),
                     "--devices", "2", *CPU]) == 2


def test_restart_interval_flag(tmp_path, rng):
    from PIL import Image

    rgb = rng.integers(0, 256, size=(24, 40, 3), dtype=np.uint8)
    path = tmp_path / "img.bmp"
    bmp.write(path, rgb)
    plain = tmp_path / "plain.jpeg"
    marked = tmp_path / "marked.jpeg"
    assert cli.main(["-i", str(path), "-o", str(plain), *CPU]) == 0
    assert cli.main(
        ["-i", str(path), "-o", str(marked), "--restart-interval", "1", *CPU]
    ) == 0
    data = marked.read_bytes()
    assert b"\xff\xdd\x00\x04\x00\x01" in data  # DRI, interval 1
    assert b"\xff\xd0" in data  # at least one RST0
    a = np.asarray(Image.open(plain).convert("RGB"))
    b = np.asarray(Image.open(marked).convert("RGB"))
    assert np.array_equal(a, b)


def test_restart_interval_with_tile_bands(tmp_path, rng):
    """Band-tiled restart framing equals the one-piece restart file."""
    rgb = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
    path = tmp_path / "img.bmp"
    bmp.write(path, rgb)
    single = tmp_path / "single.jpeg"
    tiled = tmp_path / "tiled.jpeg"
    assert cli.main(
        ["-i", str(path), "-o", str(single), "--restart-interval", "2", *CPU]
    ) == 0
    for extra in ([], ["--devices", "2"]):
        assert cli.main(
            ["-i", str(path), "-o", str(tiled), "--tile-bands",
             "--restart-interval", "2", *extra, *CPU]
        ) == 0
        assert tiled.read_bytes() == single.read_bytes()


def test_dataset_mode_with_restart_interval(tmp_path, rng):
    """--dataset composes with --restart-interval (rides the stream
    engine)."""
    src = tmp_path / "src"
    src.mkdir()
    rgb = rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8)
    bmp.write(src / "img.bmp", rgb)
    out = tmp_path / "out"
    assert cli.main(
        ["--dataset", str(src), "-o", str(out), "--restart-interval", "1",
         *CPU]
    ) == 0
    got = (out / "img.jpeg").read_bytes()
    cfg = EncoderConfig(restart_interval=1)
    assert got == pipeline.encode_array(rgb, cfg, device="cpu").file_bytes
    assert b"\xff\xdd" in got


@pytest.mark.parametrize("where", ["glob", "dataset"])
def test_tile_bands_refused_on_batch_and_dataset_input(tmp_path, rng, capsys,
                                                       where):
    for i in range(2):
        bmp.write(tmp_path / f"t{i}.bmp",
                  rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8))
    source = (["-i", str(tmp_path / "t*.bmp")] if where == "glob"
              else ["--dataset", str(tmp_path)])
    out = tmp_path / "out"
    assert cli.main([*source, "-o", str(out), "--tile-bands", *CPU]) == 2
    assert "--tile-bands" in capsys.readouterr().err
    assert not out.exists()


def test_default_device_is_the_card(tmp_path, rng, capsys):
    """Without --device the encode runs on "cuda": with no card it exits
    1 with a message, and writes nothing; it never falls back."""
    path = tmp_path / "img.bmp"
    bmp.write(path, rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default encodes there")
    assert cli.main(["-i", str(path)]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "img.jpeg").exists()
    assert cli.main(["-i", str(path), "--device", "tpu"]) == 2


def test_trace_writes_a_profiler_trace(tmp_path, rng):
    path = tmp_path / "img.bmp"
    bmp.write(path, rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8))
    trace = tmp_path / "trace"
    assert cli.main(["-i", str(path), "--trace", str(trace), *CPU]) == 0
    (written,) = list(trace.iterdir())
    assert written.name.endswith(".pt.trace.json")
    events = json.loads(written.read_text())["traceEvents"]
    assert any("rgb_to_ycbcr" in e.get("name", "") or
               e.get("cat") == "cpu_op" for e in events)
