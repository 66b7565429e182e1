"""The port's measurement tools (jpeg_encoder_torch/bench) on the CPU.

Every module's main() at a tiny size with --device cpu: exit 0 and a last
line of JSON with its keys; the window timer's iteration clamp on a fake
clock; the parity sweep's 24 cases byte-equal to the NumPy oracle, six of
them (one a ratio x algorithm, every content kind) also to the JAX
package's encode_array; the colour check on a grid against the oracle and
the JAX package's colour stage; no module falls back to the CPU when asked
for a card that is not there. The tests marked `cuda` run every module and
graph_ms on the card and skip elsewhere (the JAX package is imported only
by the tests that compare with it: the card's machine has no JAX):

    python -m pytest tests/test_torch_bench.py -m cuda --noconftest -q
"""

import json

import numpy as np
import pytest
import torch

from jpeg_encoder_torch import oracle, pipeline
from jpeg_encoder_torch.bench import (dataset, kernels, matrix, parity,
                                      scaling, tiled, timing)
from jpeg_encoder_torch.bench import __main__ as bench_main
from jpeg_encoder_torch.config import DctAlgorithm
from jpeg_encoder_torch.ops import color

TINY = ["--height", "32", "--width", "48", "--min-seconds", "0.01"]

# (module, argv at a tiny size, keys its JSON line must have)
RUNS = {
    "bench": (bench_main, TINY + ["--batch", "2"],
              ("metric", "value", "unit", "vs_baseline", "value_min",
               "value_max", "iters", "windows", "clock", "card")),
    "matrix": (matrix, TINY + ["--batch", "2"], ("metric", "rows", "card")),
    "matrix cell fast": (matrix, TINY + ["--batch", "2", "--cell", "4:4:4",
                                         "fast"], ("value", "fast", "ms")),
    "matrix cell optimize": (
        matrix, TINY + ["--batch", "2", "--cell", "4:2:0", "bin",
                        "restart=2", "optimize"],
        ("value", "two_pass", "two_pass_ms", "restart", "optimize")),
    "tiled": (tiled, TINY + ["--bands", "2", "4"],
              ("rows", "encode_core", "encode_array", "geometry")),
    "scaling batch curve": (scaling, TINY + ["--batch-curve"],
                            ("mode", "rows")),
    "scaling cards": (scaling, TINY + ["--per-device-batch", "2"],
                      ("mode", "rows")),
    "scaling shares": (scaling, TINY + ["--per-device-batch", "1",
                                        "--shares", "2"], ("mode", "rows")),
    "kernels": (kernels, ["--height", "32", "--width", "48", "--calls", "2",
                          "--launches", '{"realdct": 3, "entropy": 2}'],
                ("kernels", "stages", "matmul_ms", "clock")),
    "parity geometry": (parity, [], ("cases", "identical", "mismatched")),
    "parity color": (parity, ["--color", "--step", "15"],
                     ("triples", "mismatched")),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's intra-op threads at one for the module's cases: beside the
    suite's other workers, its default threads make these small cases wait
    for each other's turns (tests/test_torch_benchmark.py has the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("run", sorted(RUNS))
def test_module_main_on_cpu(run, capsys):
    module, argv, keys = RUNS[run]
    assert module.main([*argv, "--device", "cpu"]) == 0
    line = last_json(capsys)
    assert all(key in line for key in keys), line
    assert line["card"] == "cpu"
    if "clock" in line:
        assert line["clock"] == "host"


def test_bench_line_is_bench_py_line(capsys):
    """bench.py's metric name and unit; vs_baseline null (no TPU figure)."""
    module, argv, _ = RUNS["bench"]
    assert module.main([*argv, "--device", "cpu"]) == 0
    line = last_json(capsys)
    assert line["metric"] == "single_chip_encode_throughput_1080p_420_realdct"
    assert line["unit"] == "Mpixel/s" and line["vs_baseline"] is None
    assert line["value_min"] <= line["value"] <= line["value_max"]
    assert line["windows"] == timing.WINDOWS


def test_matrix_has_six_rows(capsys):
    module, argv, _ = RUNS["matrix"]
    assert module.main([*argv, "--device", "cpu"]) == 0
    rows = last_json(capsys)["rows"]
    assert [(r["ratio"], r["algorithm"]) for r in rows] == [
        (ratio, algorithm) for ratio in ("4:2:0", "4:2:2", "4:4:4")
        for algorithm in ("real-dct", "bin-dct")]


@pytest.mark.parametrize("optimize", [False, True])
def test_dataset_main_on_cpu(optimize, tmp_path, capsys):
    argv = ["--images", "5", "--height", "32", "--width", "48", "--dir",
            str(tmp_path), "--verify", "2", "--device", "cpu"]
    if optimize:
        argv += ["--optimize", "--chunk-budget", str(2 * 32 * 48 * 3)]
    assert dataset.main(argv) == 0
    line = last_json(capsys)
    expected = {"metric", "value", "unit", "images", "optimize", "geometry",
                "chunk_images", "wall_seconds", "encode_seconds",
                "decode_seconds", "write_seconds", "output_mb",
                "host_rss_peak_mb", "host_rss_before_mb",
                "device_hbm_peak_mb", "verified_byte_identical"}
    assert expected <= set(line), line
    assert line["images"] == 5 and line["optimize"] is optimize
    assert line["verified_byte_identical"] == 2
    assert line["device_hbm_peak_mb"] is None  # not a device number
    assert len(list((tmp_path / "out").glob("*.jpeg"))) == 5


def test_dataset_chunk_budget_is_restored(tmp_path, capsys):
    from jpeg_encoder_torch.parallel import batch

    budget = batch.CHUNK_INPUT_BUDGET
    assert dataset.main(["--images", "2", "--height", "16", "--width", "16",
                         "--dir", str(tmp_path), "--chunk-budget", "768",
                         "--verify", "1", "--device", "cpu"]) == 0
    assert batch.CHUNK_INPUT_BUDGET == budget
    assert last_json(capsys)["chunk_images"] == 1


class FakeClock:
    """Every call of fn advances it by per_call seconds."""

    name = "fake"

    def __init__(self, per_call: float):
        self.per_call, self.now = per_call, 0.0

    def tick(self):
        self.now += self.per_call

    def start(self):
        self.t0 = self.now

    def stop(self) -> float:
        return self.now - self.t0


@pytest.mark.parametrize("per_call, min_seconds, iters", [
    (1.0, 0.01, 8),          # slow calls: at least 8 a window
    (1e-9, 3.0, 2048),       # fast calls: at most 2048
    (2.0 ** -10, 0.125, 128),  # in between: min_seconds / estimate
    (0.0, 3.0, 2048),        # a clock that does not move
])
def test_window_clamps_iterations(per_call, min_seconds, iters):
    clock = FakeClock(per_call)
    calls = []

    def fn():
        calls.append(1)
        clock.tick()

    win = timing.window(fn, min_seconds, clock)
    assert win.iters == iters
    assert win.windows == timing.WINDOWS and win.clock == "fake"
    assert len(calls) == (timing.WARM_CALLS + timing.ESTIMATE_CALLS
                          + timing.WINDOWS * iters)
    assert win.median == pytest.approx(per_call)
    assert win.min <= win.median <= win.max


CASES = list(parity.geometry_cases())
# One case a ratio x algorithm (every fourth case starts one), cycling the
# content kind so that each kind meets the JAX package.
JAX_CASES = [0, 5, 10, 15, 16, 21]


def test_parity_cases_are_the_tools():
    """24 cases, the tool's dims on its diagonal stride."""
    assert len(CASES) == 24
    dims = [tuple(int(d) for d in label.split()[-1].split("x"))[::-1]
            for label, _, _ in CASES]
    assert dims == [parity.DIMS[(i + i // 4) % 4] for i in range(24)]
    assert [rgb.shape[:2] for _, _, rgb in CASES] == dims


@pytest.mark.parametrize("index", range(24))
def test_parity_case_matches_oracle(index):
    label, config, rgb = CASES[index]
    got = pipeline.encode_array(rgb, config, device="cpu").file_bytes
    assert got == parity.oracle_file(rgb, config), label
    if index in JAX_CASES:
        from jpeg_encoder_tpu import pipeline as jax_pipeline
        from test_torch_host import jax_config

        want = jax_pipeline.encode_array(rgb, jax_config(config)).file_bytes
        # Where the JAX package's jitted program hits its FMA fault (ROADMAP
        # section 3, item 2) it differs from the oracle, which holds.
        if want == parity.oracle_file(rgb, config):
            assert got == want, label


def test_color_grid_matches_oracle_and_jax():
    import jax.numpy as jnp
    from jpeg_encoder_tpu.ops import color as jax_color

    rgb = parity.color_grid(5)
    assert rgb.shape == (52, 52 * 52, 3)
    got = [p.numpy() for p in color.rgb_to_ycbcr(torch.from_numpy(rgb))]
    want = oracle.rgb_to_ycbcr_exact(rgb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert parity.color_mismatches(rgb, torch.device("cpu")) == 0
    jax_planes = [np.asarray(p) for p in jax_color.rgb_to_ycbcr(
        jnp.asarray(rgb))]
    for g, j, w in zip(got, jax_planes, want):
        exact = j == w
        np.testing.assert_array_equal(g[exact], j[exact])


def test_full_color_grid_is_every_triple():
    rgb = parity.color_grid(1)
    assert rgb.shape == (4096, 4096, 3)
    flat = rgb.reshape(-1, 3).astype(np.int64)
    codes = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    assert np.array_equal(codes, np.arange(1 << 24))


@pytest.mark.parametrize("run", sorted(RUNS) + ["dataset"])
def test_cuda_without_a_card_raises(run, monkeypatch, tmp_path):
    """--device cuda never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv, _ = RUNS.get(run, (dataset, ["--dir", str(tmp_path)], ()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([*argv, "--device", "cuda"])


def test_cold_graph_ms_on_cpu_takes_each_input_in_turn():
    seen = []
    ms = timing.cold_graph_ms(seen.append, [1, 2, 3], torch.device("cpu"),
                              reps=4)
    assert ms >= 0
    assert seen == [1, 2, 3, 1, 2]  # one warm call, then one a repetition


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_graph_ms_on_card(cuda):
    """graph_ms times K1 and K4 on the card; a captured call counts its
    launch once, at capture."""
    ops = kernels.Operands.build(np.zeros((64, 96, 3), np.uint8), cuda)
    calls = dict((name, call) for name, call, _ in kernels.kernel_calls(ops))
    from jpeg_encoder_torch.kernels import entropy as entropy_kernel

    entropy_kernel.ENTROPY.launches = 0
    ms = timing.graph_ms(calls["entropy"], cuda, calls=4, reps=3)
    assert ms > 0
    assert entropy_kernel.ENTROPY.launches == 1 + 4  # warm call + capture
    assert timing.graph_ms(calls["realdct"], cuda, calls=2, reps=3) > 0
    assert timing.graph_ms(lambda: pipeline.encode_core(
        ops.rgb, ops.geom, DctAlgorithm.REAL_DCT, ops.cap,
        with_coeffs=False), cuda, calls=2, reps=3) > 0


@pytest.mark.cuda
def test_cold_graph_ms_on_card(cuda):
    """cold_graph_ms refuses inputs that fit in twice the L2 cache, and
    times past_l2's copies, each call on another."""
    rows = torch.zeros(1 << 22, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="L2"):
        timing.cold_graph_ms(torch.neg, [rows, rows.clone()], cuda)
    copies = timing.past_l2(rows)
    assert len(copies) * rows.numel() > 2 * timing.l2_bytes(cuda)
    assert len({c.data_ptr() for c in copies}) == len(copies)
    assert timing.cold_graph_ms(torch.neg, copies, cuda, reps=3) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("run", sorted(RUNS))
def test_module_main_on_card(run, cuda, capsys):
    module, argv, keys = RUNS[run]
    assert module.main([*argv, "--device", str(cuda)]) == 0
    line = last_json(capsys)
    assert all(key in line for key in keys), line
    assert line["card"] != "cpu"


# --------------------------------------------------------------------------
# The card line: the card torch was given, found by its UUID
# --------------------------------------------------------------------------

SMI = ("GPU-11111111-2222-3333-4444-555555555555, NVIDIA H100 80GB HBM3, "
       "700.00 W\n"
       "GPU-aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee, NVIDIA H100 80GB HBM3, "
       "450.00 W\n")


class _Uuid:
    """torch's UUID object: its bytes."""

    def __init__(self, text):
        self.bytes = bytes.fromhex(text.replace("-", ""))


def _fake_card(monkeypatch, uuid):
    """nvidia-smi lists two cards in PCI order; torch's cuda:0 is the one
    of `uuid` (as under CUDA_VISIBLE_DEVICES=1). -> the argv nvidia-smi
    was run with."""
    import subprocess
    from types import SimpleNamespace

    calls = []

    def run(argv, **kwargs):
        calls.append(argv)
        return subprocess.CompletedProcess(argv, 0, stdout=SMI, stderr="")

    monkeypatch.setattr(timing.subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(uuid=uuid))
    return calls


@pytest.mark.parametrize("uuid", [
    _Uuid("aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee"),
    "aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee",
    "GPU-AAAAAAAA-BBBB-CCCC-DDDD-EEEEEEEEEEEE",
], ids=["bytes", "text", "nvidia-smi text"])
def test_card_line_names_the_card_by_uuid(monkeypatch, uuid):
    calls = _fake_card(monkeypatch, uuid)
    line = timing.card_line(torch.device("cuda", 0))
    assert line == "NVIDIA H100 80GB HBM3, 450.00 W"
    assert not any(arg.startswith("--id") for arg in calls[0])
    assert "--query-gpu=uuid,name,power.limit" in calls[0]


def test_card_line_raises_without_its_card(monkeypatch):
    _fake_card(monkeypatch, _Uuid("99999999-2222-3333-4444-555555555555"))
    with pytest.raises(RuntimeError, match="no card"):
        timing.card_line(torch.device("cuda", 0))
    assert timing.card_line(torch.device("cpu")) == "cpu"
