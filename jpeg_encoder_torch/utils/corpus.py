"""Photographic-like test corpus, generated deterministically.

The container has no network egress and no vendored photos, so corpus
evidence (decoded PSNR, compression ratio — the BASELINE "PSNR >= Rust
reference on Kodak" analog) is gathered on procedurally generated content
with natural-image statistics instead of synthetic gradients/noise:

* natural images have ~1/f amplitude spectra — `_spectral_noise` shapes
  white noise in the Fourier domain to that power law, which is what makes
  these images behave like photographs under a DCT codec (energy
  concentrated in low frequencies, heavy-tailed AC coefficients);
* channels are correlated (luma dominates, chroma varies slowly), matching
  the statistics 4:2:0 subsampling is designed around;
* each class adds photographic structure: horizon + texture (landscape),
  smooth in-focus blobs over bokeh (portrait), band-pass high-detail
  texture (foliage), straight edges + flat faces (architecture).

Used by tests/test_corpus.py (quality bounds), tools/corpus_report.py
(the BASELINE.md table), and tools/hw_parity_sweep.py --corpus
(on-hardware byte-exactness on this content).
"""

from __future__ import annotations

import numpy as np


def _spectral_noise(
    rng: np.random.Generator, h: int, w: int, alpha: float
) -> np.ndarray:
    """Real-valued noise field with a 1/f**alpha amplitude spectrum in [0, 1]."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    f = np.hypot(fy, fx)
    f[0, 0] = 1.0  # leave DC finite; normalized away below
    spectrum = np.fft.fft2(rng.standard_normal((h, w))) / f**alpha
    field = np.fft.ifft2(spectrum).real
    field -= field.min()
    peak = field.max()
    return field / peak if peak else field


def _to_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def landscape(h: int = 512, w: int = 768, seed: int = 101) -> np.ndarray:
    """Sky gradient over 1/f terrain with correlated green/brown texture."""
    rng = np.random.default_rng(seed)
    terrain = _spectral_noise(rng, h, w, 1.8)
    detail = _spectral_noise(rng, h, w, 1.1)
    horizon = 0.38 + 0.05 * _spectral_noise(rng, 1, w, 1.5)[0]
    rows = np.arange(h)[:, None] / h
    ground = rows > horizon[None, :]
    sky_t = rows / np.maximum(horizon[None, :], 1e-3)
    r = np.where(ground, 90 + 90 * terrain + 25 * detail, 120 + 60 * sky_t)
    g = np.where(ground, 110 + 80 * terrain + 30 * detail, 150 + 50 * sky_t)
    b = np.where(ground, 70 + 50 * terrain + 15 * detail, 235 - 40 * sky_t)
    return _to_u8(np.stack([r, g, b], axis=-1))


def portrait(h: int = 512, w: int = 768, seed: int = 202) -> np.ndarray:
    """Skin-toned smooth subject over a blurred (bokeh-like) background."""
    rng = np.random.default_rng(seed)
    bg = _spectral_noise(rng, h, w, 2.4)  # very smooth: out-of-focus field
    skin = _spectral_noise(rng, h, w, 1.6)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h * 0.52, w * 0.5
    d = np.hypot((yy - cy) / (h * 0.42), (xx - cx) / (w * 0.26))
    subject = np.clip(1.2 - d, 0, 1) ** 0.7  # soft-edged oval mask
    r = subject * (205 + 30 * skin) + (1 - subject) * (60 + 70 * bg)
    g = subject * (160 + 25 * skin) + (1 - subject) * (55 + 60 * bg)
    b = subject * (135 + 20 * skin) + (1 - subject) * (70 + 80 * bg)
    return _to_u8(np.stack([r, g, b], axis=-1))


def foliage(h: int = 512, w: int = 768, seed: int = 303) -> np.ndarray:
    """Dense high-frequency leaf texture: the hard (high-entropy) case."""
    rng = np.random.default_rng(seed)
    coarse = _spectral_noise(rng, h, w, 1.5)
    fine = _spectral_noise(rng, h, w, 0.7)  # nearly white: leaf speckle
    light = _spectral_noise(rng, h, w, 2.0)
    g = 70 + 110 * coarse + 55 * fine + 20 * light
    r = 30 + 70 * coarse + 40 * fine
    b = 25 + 45 * coarse + 25 * fine
    return _to_u8(np.stack([r, g, b], axis=-1))


def architecture(h: int = 512, w: int = 768, seed: int = 404) -> np.ndarray:
    """Flat facades, straight edges, window grid — sharp-edge content."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3))
    img[:] = (170 + 50 * _spectral_noise(rng, h, w, 2.2))[..., None]  # sky
    x = 0
    while x < w:  # buildings of random width/height/shade
        bw = int(rng.integers(w // 12, w // 5))
        top = int(rng.integers(h // 8, h // 2))
        shade = rng.uniform(60, 150, 3)
        img[top:, x : x + bw] = shade
        # window grid: bright/dark cells on a regular pitch
        for wy in range(top + 8, h - 8, 22):
            for wx in range(x + 6, min(x + bw, w) - 6, 16):
                lit = rng.random() < 0.35
                img[wy : wy + 10, wx : wx + 8] = 225 if lit else 35
        x += bw
    img += rng.normal(0, 2.0, img.shape)  # sensor noise
    return _to_u8(img)


CORPUS = {
    "landscape": landscape,
    "portrait": portrait,
    "foliage": foliage,
    "architecture": architecture,
}


def images(h: int = 512, w: int = 768) -> dict[str, np.ndarray]:
    """The full corpus at the given size (default 512x768, Kodak-shaped)."""
    return {name: fn(h, w) for name, fn in CORPUS.items()}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(255.0**2 / mse))
