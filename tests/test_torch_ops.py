"""Port ops vs the JAX package and the oracle: colour, sampling, the DCTs.

Inputs are made from seeds with NumPy and handed to both packages; every
comparison is exact (byte identity is the contract, so no tolerance),
except --fast-dct, whose contract is a tolerance: max |diff| 1 at a
mismatch rate below 1e-3 against the JAX package's fast path and its TPU
kernel, and at most 5e-4 against the exact RealDCT of the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_encoder_tpu import oracle, tables
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_tpu.kernels import dct_pallas
from jpeg_encoder_tpu.ops import color as jax_color
from jpeg_encoder_tpu.ops import dct as jax_dct
from jpeg_encoder_tpu.ops import sample as jax_sample
from jpeg_encoder_torch import constants
from jpeg_encoder_torch.kernels import dct as dct_kernel
from jpeg_encoder_torch.ops import color, dct, sample
from test_torch_kernels import (EXTREMES, assert_fast_tolerance,
                                extreme_planes)

RATIOS = [(4, 4, 4), (4, 2, 2), (4, 2, 0)]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def test_color_exhaustive_vs_oracle():
    """All 2^24 RGB triples, one blue value at a time (tie triples
    included): the gather-and-add form is exact, with no sampling."""
    c = np.arange(256, dtype=np.uint8)
    r, g = np.meshgrid(c, c, indexing="ij")
    for b in range(256):
        rgb = np.stack([r, g, np.full_like(r, b)], axis=-1)
        got = color.rgb_to_ycbcr(_t(rgb))
        want = oracle.rgb_to_ycbcr_exact(rgb)
        for a, e in zip(got, want):
            assert a.dtype == torch.uint8
            assert np.array_equal(a.numpy(), e)


def test_color_matches_jax(rng):
    rgb = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    got = color.rgb_to_ycbcr(_t(rgb))
    want = jax_color.rgb_to_ycbcr(jnp.asarray(rgb))
    for a, e in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(e))


# Each size hits dim % (8 * factor) == 1 for some ratio (the push-order
# quirk geometries) or is aligned, odd or tiny.
SIZES = [(16, 16), (17, 16), (33, 17), (24, 40), (20, 12), (49, 33), (9, 25)]


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("size", SIZES)
def test_pad_and_subsample_match_oracle_and_jax(ratio, size, rng):
    width, height = size
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(width, height)
    plane = rng.integers(0, 256, size=(height, width), dtype=np.uint8)
    padded = sample.pad_plane(_t(plane), geom)
    want_padded = np.zeros((geom.padded_height, geom.padded_width), np.uint8)
    want_padded[:height, :width] = plane
    assert np.array_equal(padded.numpy(), want_padded)
    got = sample.subsample_plane(padded, geom)
    assert got.shape == (geom.chroma_height, geom.chroma_width)
    assert np.array_equal(got.numpy(), oracle.subsample_plane(want_padded, geom))
    jax_got = jax_sample.subsample_plane(jnp.asarray(want_padded), geom)
    assert np.array_equal(got.numpy(), np.asarray(jax_got))


def test_blockify_matches_oracle(rng):
    plane = rng.integers(0, 256, size=(24, 40), dtype=np.uint8)
    got = sample.blockify(_t(plane))
    assert np.array_equal(got.numpy(), oracle.blockify(plane).reshape(-1, 64))


@pytest.mark.parametrize("quality", [None, 90])
@pytest.mark.parametrize("ratio", RATIOS)
def test_plain_dct_matches_jax_and_oracle(ratio, quality, rng):
    """The plain chain equals the JAX package's XLA ordered chain and the
    oracle's scalar-order RealDCT on random planes (the worst case for
    rounding ties: every pixel value occurs)."""
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(40, 24)
    yp = rng.integers(0, 256, (geom.padded_height, geom.padded_width), np.uint8)
    cp = [
        rng.integers(0, 256, (geom.chroma_height, geom.chroma_width), np.uint8)
        for _ in range(2)
    ]
    got = dct.real_dct_quant_planes_zigzag(_t(yp), _t(cp[0]), _t(cp[1]), quality)
    want = jax_dct.dct_quantize_planes(
        *(jax_sample.blockify(jnp.asarray(p)) for p in (yp, *cp)),
        DctAlgorithm.REAL_DCT, zigzag_out=True, quality=quality,
    )
    q_luma, q_chroma = tables.scaled_quant_tables(quality)
    for g, w, p, q in zip(got, want, (yp, *cp), (q_luma, q_chroma, q_chroma)):
        assert g.dtype == torch.int16
        assert np.array_equal(g.numpy(), np.asarray(w))
        exact = oracle.real_dct_quant_exact(oracle.blockify(p), q)
        assert np.array_equal(
            g.numpy(), exact.reshape(-1, 64)[:, tables.ZIGZAG_ORDER]
        )


def test_dct_wrapper_matches_pallas_kernel_interpret(rng):
    """The RealDCT kernel's wrapper, on CPU tensors, equals the TPU kernel
    it replaces (run in interpret mode, at one small geometry)."""
    yp = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    cbp = rng.integers(0, 256, (8, 16), dtype=np.uint8)
    crp = rng.integers(0, 256, (8, 16), dtype=np.uint8)
    before = dct_kernel.REALDCT.launches
    got = dct_kernel.real_dct_quant_planes_zigzag(_t(yp), _t(cbp), _t(crp))
    assert dct_kernel.REALDCT.launches == before  # the CPU path launches nothing
    want = dct_pallas.real_dct_quant_planes_zigzag_pallas_t(
        jnp.asarray(yp), jnp.asarray(cbp), jnp.asarray(crp), interpret=True
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


WRAPPERS = [
    dct_kernel.real_dct_quant_planes_zigzag,
    dct_kernel.real_dct_fast_planes_zigzag,
    dct_kernel.bin_dct_quant_planes_zigzag,
]


@pytest.mark.parametrize("wrapper", WRAPPERS, ids=lambda f: f.__name__)
@pytest.mark.parametrize(
    "bad",
    [
        lambda y, c: (y.to(torch.int16), c, c),          # dtype
        lambda y, c: (y[:, :12], c, c),                   # not padded to 8
        lambda y, c: (y.t(), c, c),                       # not contiguous
        lambda y, c: (y, c, c[:8, :8].contiguous()),      # cb/cr mismatch
    ],
)
def test_dct_wrapper_rejects_bad_planes(bad, wrapper):
    y = torch.zeros((16, 16), dtype=torch.uint8)
    c = torch.zeros((8, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        wrapper(*bad(y, c))


def _planes(rng, y_shape, c_shape):
    return [rng.integers(0, 256, y_shape, dtype=np.uint8)] + [
        rng.integers(0, 256, c_shape, dtype=np.uint8) for _ in range(2)
    ]


def _jax_planes(algorithm, planes, **kwargs):
    """The JAX package's XLA path over the same planes (zigzag out)."""
    return jax_dct.dct_quantize_planes(
        *(jax_sample.blockify(jnp.asarray(p)) for p in planes),
        algorithm, zigzag_out=True, **kwargs,
    )


def _oracle_zigzag(exact_fn, planes, quality):
    q_luma, q_chroma = tables.scaled_quant_tables(quality)
    return [
        exact_fn(oracle.blockify(p), q).reshape(-1, 64)[:, tables.ZIGZAG_ORDER]
        for p, q in zip(planes, (q_luma, q_chroma, q_chroma))
    ]


# The TPU kernels' own test geometries (tests/test_kernels.py): 4:2:0-like
# planes and equal 4:4:4 planes.
KERNEL_SHAPES = [((240, 160), (120, 80), None), ((80, 80), (80, 80), 90)]


@pytest.mark.parametrize("descale", [False, True])
@pytest.mark.parametrize("y_shape, c_shape, quality", KERNEL_SHAPES)
def test_plain_bindct_matches_jax(y_shape, c_shape, quality, descale, rng):
    """Exact against the JAX package's XLA binDCT (dct_quantize_planes) and
    the TPU kernel it ports (interpret mode), in both quantization modes."""
    planes = _planes(rng, y_shape, c_shape)
    got = dct.bin_dct_quant_planes_zigzag(
        *(_t(p) for p in planes), quality, descale
    )
    want = _jax_planes(DctAlgorithm.BIN_DCT, planes,
                       bin_dct_descale=descale, quality=quality)
    kernel = dct_pallas.bin_dct_quant_planes_zigzag_pallas_t(
        *(jnp.asarray(p) for p in planes), interpret=True, quality=quality,
        descale=descale,
    )
    for g, w, k in zip(got, want, kernel):
        assert g.dtype == torch.int16
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), np.asarray(k))


@pytest.mark.parametrize("quality", [None, 90, 100])
def test_plain_bindct_matches_oracle(quality, rng):
    """Bug-parity mode against the oracle's integer binDCT, per plane;
    quality 100 divides by 1, so the raw lifting outputs are compared."""
    planes = _planes(rng, (48, 40), (24, 40))
    got = dct.bin_dct_quant_planes_zigzag(*(_t(p) for p in planes), quality)
    for g, w in zip(got, _oracle_zigzag(oracle.bin_dct_quant_exact, planes,
                                        quality)):
        assert np.array_equal(g.numpy(), w)


def test_bindct_lifting_negative_shifts_match_oracle(rng):
    """The lifting pass on int32 values of both signs far outside the
    pixel range: torch's >> must floor like the oracle's (and Rust's)."""
    x = rng.integers(-(1 << 20), 1 << 20, size=(8, 4096), dtype=np.int32)
    got = constants.bindct_lift8([_t(r) for r in x], dct._shr)
    want = oracle._bindct_lifting_1d(list(x))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_bindct_extreme_blocks_match_oracle():
    """Blocks of 0s and 255s (every level-shifted input at -128 or 127, the
    most negative intermediates) through the whole transform at q = 1."""
    rng = np.random.default_rng(17)
    blocks = (rng.integers(0, 2, size=(512, 8, 8)) * 255).astype(np.uint8)
    blocks[0], blocks[1] = 0, 255
    blocks[2] = (np.add.outer(np.arange(8), np.arange(8)) % 2) * 255
    got = dct.bin_dct_transform(_t(blocks.reshape(-1, 64)))
    want = oracle.bin_dct_quant_exact(blocks, np.ones((8, 8), np.int32))
    assert np.array_equal(got.numpy(), want.reshape(-1, 64).astype(np.int32))


def _within(got, want, rate: float) -> None:
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= rate, f"mismatch rate {(d > 0).mean()}"


@pytest.mark.parametrize("y_shape, c_shape, quality", KERNEL_SHAPES)
def test_plain_fast_dct_matches_jax_and_oracle(y_shape, c_shape, quality, rng):
    """trunc((block @ K_zz^T) / q): within the --fast-dct tolerance of the
    JAX package's fast path (another f32 summation order) and of the
    oracle's exact RealDCT."""
    planes = _planes(rng, y_shape, c_shape)
    got = torch.cat(dct.real_dct_fast_planes_zigzag(
        *(_t(p) for p in planes), quality
    )).numpy()
    assert got.dtype == np.int16
    want = _jax_planes(DctAlgorithm.REAL_DCT, planes, fast_dct=True,
                       quality=quality)
    _within(got, np.concatenate([np.asarray(w) for w in want]), 1e-3)
    exact = _oracle_zigzag(oracle.real_dct_quant_exact, planes, quality)
    _within(got, np.concatenate(exact), 5e-4)


def test_plain_fast_dct_refuses_tf32():
    planes = [torch.zeros((8, 8), dtype=torch.uint8)] * 3
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full float32"):
            dct.real_dct_fast_planes_zigzag(*planes)
    finally:
        torch.set_float32_matmul_precision("highest")
    dct.real_dct_fast_planes_zigzag(*planes)


@pytest.mark.parametrize("variant", ["bindct", "bindct-descale", "fastdct"])
def test_dct_wrappers_match_pallas_kernels_interpret(variant, rng):
    """K2's and K3's wrappers, on CPU tensors, against the TPU kernels they
    replace (interpret mode, one small geometry): K3 exactly, K2 within
    the --fast-dct tolerance. The CPU path launches nothing."""
    planes = _planes(rng, (16, 32), (8, 16))
    jplanes = [jnp.asarray(p) for p in planes]
    kernel = dct_kernel.FASTDCT if variant == "fastdct" else dct_kernel.BINDCT
    before = kernel.launches
    if variant == "fastdct":
        got = dct_kernel.real_dct_fast_planes_zigzag(*(_t(p) for p in planes))
        want = dct_pallas.real_dct_quant_planes_zigzag_pallas_t(
            *jplanes, interpret=True, fast=True
        )
    else:
        descale = variant == "bindct-descale"
        got = dct_kernel.bin_dct_quant_planes_zigzag(
            *(_t(p) for p in planes), None, descale
        )
        want = dct_pallas.bin_dct_quant_planes_zigzag_pallas_t(
            *jplanes, interpret=True, descale=descale
        )
    assert kernel.launches == before
    for g, w in zip(got, want):
        if variant == "fastdct":
            _within(g.numpy(), np.asarray(w), 1e-3)
        else:
            assert np.array_equal(g.numpy(), np.asarray(w))


# The per-block tier: K6a/b and K6c's wrappers on CPU tensors (their plain
# versions) against the Pallas kernels they replace, in interpret mode, on
# the blocks and planes of tests/test_kernels.py.
@pytest.mark.parametrize("quality", [None, 35])
@pytest.mark.parametrize("is_luma", [True, False])
def test_realdct_blocks_match_pallas_interpret(is_luma, quality, rng):
    blocks = rng.integers(0, 256, size=(70, 64), dtype=np.uint8)
    before = dct_kernel.REALDCT_BLOCKS.launches
    got = dct_kernel.real_dct_quant_zigzag(_t(blocks), is_luma, quality)
    assert dct_kernel.REALDCT_BLOCKS.launches == before
    assert got.dtype == torch.int32 and got.shape == (70, 64)
    want = dct_pallas.real_dct_quant_zigzag_pallas(
        blocks, is_luma, interpret=True, quality=quality
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("transposed", ["kernel", "xla"])
def test_realdct_blocks_match_transposed_pallas_interpret(transposed, rng):
    """K6b: both TPU layouts compute K6a's function, so the one CUDA entry
    (and its plain version) stands for both."""
    blocks = rng.integers(0, 256, (700, 64), dtype=np.uint8)
    for is_luma in (True, False):
        got = dct_kernel.real_dct_quant_zigzag(_t(blocks), is_luma)
        want = dct_pallas.real_dct_quant_zigzag_pallas_t(
            jnp.asarray(blocks), is_luma, interpret=True,
            transposed=transposed,
        )
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quality", [None, 35])
@pytest.mark.parametrize("is_luma", [True, False])
def test_bindct_blocks_match_pallas_interpret(is_luma, quality, rng):
    blocks = rng.integers(0, 256, size=(70, 64), dtype=np.uint8)
    before = dct_kernel.BINDCT_BLOCKS.launches
    got = dct_kernel.bin_dct_quant_zigzag(_t(blocks), is_luma, quality)
    assert dct_kernel.BINDCT_BLOCKS.launches == before
    assert got.dtype == torch.int32 and got.shape == (70, 64)
    want = dct_pallas.bin_dct_quant_zigzag_pallas(
        blocks, is_luma, interpret=True, quality=quality
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("algorithm", ["real-dct", "bin-dct"])
def test_block_tier_matches_oracle_and_plane_kernels(algorithm, rng):
    """The per-block tier on each plane of an image equals the oracle's
    coefficients and the 3-plane kernels' (K1, K3) plain versions on the
    same planes: the check tests/test_kernels.py makes of the TPU tier."""
    rgb = rng.integers(0, 256, size=(24, 40, 3), dtype=np.uint8)
    config = EncoderConfig(dct_algorithm=DctAlgorithm(algorithm))
    geom = config.geometry(40, 24)
    golden = oracle.encode_oracle(rgb, config)
    y, cb, cr = oracle.build_padded_planes(rgb, geom)
    planes = [y, oracle.subsample_plane(cb, geom),
              oracle.subsample_plane(cr, geom)]
    if algorithm == "real-dct":
        blocks_fn = dct_kernel.real_dct_quant_zigzag
        planes_fn = dct_kernel.real_dct_quant_planes_zigzag
    else:
        blocks_fn = dct_kernel.bin_dct_quant_zigzag
        planes_fn = dct_kernel.bin_dct_quant_planes_zigzag
    three = planes_fn(*(_t(p) for p in planes))
    golden_coeffs = (golden.y_coeffs, golden.cb_coeffs, golden.cr_coeffs)
    for i, (plane, want, gold) in enumerate(zip(planes, three, golden_coeffs)):
        got = blocks_fn(sample.blockify(_t(plane)), i == 0)
        assert torch.equal(got, want.to(torch.int32))
        natural = got.numpy()[:, tables.ZIGZAG_INVERSE]
        assert np.array_equal(natural, gold.reshape(-1, 64))


def test_block_wrappers_reject_bad_operands():
    blocks = torch.zeros((4, 64), dtype=torch.uint8)
    for fn in (dct_kernel.real_dct_quant_zigzag,
               dct_kernel.bin_dct_quant_zigzag):
        with pytest.raises(ValueError, match="uint8"):
            fn(blocks.to(torch.int16), True)
        with pytest.raises(ValueError, match="uint8"):
            fn(blocks[:, :32], True)
        with pytest.raises(ValueError, match="contiguous"):
            fn(blocks.T.contiguous().T, True)


# K1's design premise, held here where there is no card: its compact
# operands are realdct_constants bit for bit, and its arithmetic order (the
# first product px[k] * basis[u, x_k] once per u, then 8 chains over v) is
# the plain chain's.
@pytest.mark.parametrize("quality", [None, 1, 50, 90, 100])
def test_realdct_kernel_operands_expand_to_steps(quality):
    ops = constants.realdct_kernel_operands(quality)
    want = constants.realdct_constants(quality)
    zz = tables.ZIGZAG_ORDER  # zigzag position j -> natural u * 8 + v
    u_of, v_of = zz // 8, zz % 8
    x_of, y_of = np.arange(64) // 8, np.arange(64) % 8
    a_steps = ops.basis[u_of[None, :], x_of[:, None]]
    b_steps = ops.basis[v_of[None, :], y_of[:, None]]
    for got, ref in ((a_steps, want.a_steps), (b_steps, want.b_steps),
                     (ops.scale[zz], want.scale[0]),
                     (ops.q_luma[zz], want.q_luma[0]),
                     (ops.q_chroma[zz], want.q_chroma[0])):
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert ops.zigzag.dtype == np.int32
    assert np.array_equal(ops.zigzag[zz], np.arange(64))
    for arr in ops:  # the wrapper hands the kernel their raw addresses
        assert arr.flags.c_contiguous


def _u_chains_model(planes, quality):
    """float32 model of K1's order: per block and u, t1 = px[k] *
    basis[u, x_k] once, then acc[v] = acc[v] + t1 * basis[v, y_k] for the
    8 v, k = x_k * 8 + y_k in order; quantized with the compact rows and
    placed at each coefficient's zigzag position. NumPy rounds every f32
    operation on its own, as the kernel does."""
    ops = constants.realdct_kernel_operands(quality)
    out = []
    for i, plane in enumerate(planes):
        px = sample.blockify(_t(plane)).numpy().astype(np.float32) - np.float32(128)
        acc = np.zeros((px.shape[0], 8, 8), np.float32)  # (block, u, v)
        for k in range(64):
            x, y = divmod(k, 8)
            t1 = px[:, k, None] * ops.basis[:, x]  # (block, u)
            acc = acc + t1[:, :, None] * ops.basis[:, y][None, None, :]
        q = ops.q_luma if i == 0 else ops.q_chroma
        coeffs = np.trunc((ops.scale * acc.reshape(-1, 64)) / q)
        zigzag = np.empty_like(coeffs)
        zigzag[:, ops.zigzag] = coeffs
        out.append(zigzag.astype(np.int32).astype(np.int16))
    return out


@pytest.mark.parametrize("quality", [None, 90, 100])
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("content", ("random",) + EXTREMES)
def test_realdct_u_chains_model_matches_plain(content, ratio, quality):
    planes = extreme_planes(content, ratio, seed=3)
    got = _u_chains_model(planes, quality)
    want = dct.real_dct_quant_planes_zigzag(*(_t(p) for p in planes), quality)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


# K2's design premise, held here where there is no card: the TPU kernel's
# 3-term bf16 split, its products accumulated in float32 from the smallest
# term to the largest, stays within the --fast-dct tolerance. The model adds
# each m16n8k16 step's 16 products (exact: a bf16 term times an integer
# pixel in [-128, 127] has at most 16 significant bits) to a float32
# accumulator, rounding once a step: m3's four k-steps, then m2's, then m1's.
def _fast_split_model(planes, quality):
    terms = [constants.bf16_to_f32(t).astype(np.float64)
             for t in constants.fast_kron_split()]
    *_, q_luma, q_chroma = dct.device_constants(quality, torch.device("cpu"))
    out = []
    for i, plane in enumerate(planes):
        px = sample.blockify(_t(plane)).numpy().astype(np.float64) - 128
        acc = np.zeros((px.shape[0], 64), np.float32)
        for term in (terms[2], terms[1], terms[0]):
            for k0 in range(0, 64, 16):
                step = px[:, k0:k0 + 16] @ term[:, k0:k0 + 16].T
                acc = (acc.astype(np.float64) + step).astype(np.float32)
        q = (q_luma if i == 0 else q_chroma).numpy()
        out.append(np.trunc(acc / q).astype(np.int16))
    return np.concatenate(out)


@pytest.mark.parametrize("quality", [None, 90, 100])
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("content", ("random",) + EXTREMES)
def test_fast_split_model_matches_plain(content, ratio, quality):
    """The model against the plain version (the full float32 matmul) on
    random and extreme planes: within max |diff| 1, every mismatch a tie."""
    planes = extreme_planes(content, ratio, seed=4)
    got = _fast_split_model(planes, quality)
    want = torch.cat(dct.real_dct_fast_planes_zigzag(
        *(_t(p) for p in planes), quality)).numpy()
    assert_fast_tolerance(got, want, planes, quality)


@pytest.mark.parametrize("quality", [None, 90, 100])
def test_fast_split_model_within_tolerance(quality):
    """The model against the plain version (rate < 1e-3) and the exact
    RealDCT (rate <= 5e-4) at quality None and 90, on 3,072 random blocks.
    At quality 100 (q = 1) the plain version itself misses the second rate
    against the exact RealDCT (about 1.5e-3: coefficients whose exact value
    is an integer, the DC of every block whose pixel sum is a multiple of 8
    among them, fall on either side by a float32 rounding), so there the
    model is held to max |diff| 1 and ties alone, as is the plain version
    against the exact RealDCT."""
    rng = np.random.default_rng(21)
    planes = _planes(rng, (256, 512), (128, 256))
    got = _fast_split_model(planes, quality)
    tplanes = [_t(p) for p in planes]
    plain = torch.cat(dct.real_dct_fast_planes_zigzag(*tplanes, quality)).numpy()
    exact = torch.cat(dct.real_dct_quant_planes_zigzag(*tplanes, quality)).numpy()
    hold = quality != 100
    assert_fast_tolerance(got, plain, planes, quality, 1e-3 if hold else None)
    assert_fast_tolerance(got, exact, planes, quality, 5e-4 if hold else None)
    assert_fast_tolerance(plain, exact, planes, quality,
                           5e-4 if hold else None)


@pytest.mark.parametrize("quality", [None, 90, 100])
def test_fast_split_model_matches_pallas_interpret(quality):
    """The model against the TPU kernel it ports, in interpret mode (the
    same split, another float32 order): within max |diff| 1, ties alone."""
    rng = np.random.default_rng(22)
    planes = _planes(rng, (32, 64), (16, 32))
    got = _fast_split_model(planes, quality)
    want = dct_pallas.real_dct_quant_planes_zigzag_pallas_t(
        *(jnp.asarray(p) for p in planes), interpret=True, quality=quality,
        fast=True,
    )
    want = np.concatenate([np.asarray(w) for w in want])
    assert_fast_tolerance(got, want, planes, quality,
                           1e-3 if quality != 100 else None)


def _k2_trunc_quotient(acc: np.ndarray, q: np.float32) -> np.ndarray:
    """fastdct.cu's trunc_quotient in float32, each operation rounded to
    nearest as on the card: x = acc * (1 / q); the true divide only where
    |x| >= 0.5 and x lies within 2^-20 |x| of an integer."""
    f32 = np.float32
    x = acc * (f32(1) / q)
    ax = np.abs(x)
    near = (ax >= f32(0.5)) & (np.abs(x - np.rint(x)) <= ax * f32(2.0**-20))
    return np.trunc(np.where(near, acc / q, x))


@pytest.mark.parametrize("q_range", [(1, 64), (64, 160), (160, 256)])
def test_k2_divide_rule_is_true_division(q_range):
    """K2's epilogue: trunc of acc * (1 / q), with the true divide near a
    truncation boundary, is trunc(acc / q) (IEEE, rounded to nearest) for
    every q in 1..255, on float32 values within 16 ulps of every boundary
    k * q (|k| <= 2048) and on random values across the coefficients'
    range."""
    rng = np.random.default_rng(q_range[0])
    ulps = np.arange(-16, 17, dtype=np.int64)
    for qi in range(*q_range):
        q = np.float32(qi)
        base = (np.arange(-2048, 2049) * qi).astype(np.float32)
        bits = base.view(np.int32).astype(np.int64)[:, None] + ulps
        acc = bits.astype(np.int32).view(np.float32).reshape(-1)
        acc = np.concatenate([
            acc[np.isfinite(acc)],
            rng.uniform(-2048.0 * qi, 2048.0 * qi, 4096).astype(np.float32),
        ])
        want = np.trunc(acc / q)
        assert want.dtype == np.float32
        assert np.array_equal(_k2_trunc_quotient(acc, q), want), qi
