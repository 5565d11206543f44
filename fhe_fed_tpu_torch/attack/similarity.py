"""Image-similarity metrics for attack evaluation: SSIM/MS-SSIM, UQI,
VIFp, a copy of fhe_fed_tpu.attack.similarity (reference
attack/similarity.py:24-42 uses the `sewar` package, so the metrics are
implemented directly in numpy; host-side). The port keeps its own copy so
that it imports nothing of the JAX package; both give the same floats bit
for bit.

All take (H, W) or (H, W, C) float arrays; channels are averaged.
"""

from __future__ import annotations

import numpy as np


def _to_gray2d(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 3:
        return x.mean(axis=-1)
    return x


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'valid' 2-D correlation via stride tricks (no scipy dependency)."""
    kh, kw = kernel.shape
    h, w = img.shape
    if h < kh or w < kw:
        return img.mean(keepdims=True).reshape(1, 1)
    shape = (h - kh + 1, w - kw + 1, kh, kw)
    strides = img.strides * 2
    windows = np.lib.stride_tricks.as_strided(img, shape, strides)
    return np.einsum("ijkl,kl->ij", windows, kernel)


def _ssim_maps(a: np.ndarray, b: np.ndarray, data_range: float,
               k1: float = 0.01, k2: float = 0.03):
    kern = _gaussian_kernel()
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    mu_a, mu_b = _filter2(a, kern), _filter2(b, kern)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2(a * a, kern) - mu_aa
    s_bb = _filter2(b * b, kern) - mu_bb
    s_ab = _filter2(a * b, kern) - mu_ab
    luminance = (2 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    cs = (2 * s_ab + c2) / (s_aa + s_bb + c2)
    return luminance * cs, cs


def mssim(a: np.ndarray, b: np.ndarray,
          data_range: float | None = None) -> float:
    """Mean SSIM."""
    a, b = _to_gray2d(a), _to_gray2d(b)
    if data_range is None:
        data_range = max(a.max() - a.min(), b.max() - b.min(), 1e-9)
    ssim_map, _ = _ssim_maps(a, b, data_range)
    return float(ssim_map.mean())


def msssim(a: np.ndarray, b: np.ndarray, data_range: float | None = None,
           weights=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)) -> float:
    """Multi-scale SSIM (Wang et al. 2003); scales limited by image size."""
    a, b = _to_gray2d(a), _to_gray2d(b)
    if data_range is None:
        data_range = max(a.max() - a.min(), b.max() - b.min(), 1e-9)
    levels = len(weights)
    vals = []
    for i in range(levels):
        ssim_map, cs_map = _ssim_maps(a, b, data_range)
        vals.append(ssim_map.mean() if i == levels - 1 else cs_map.mean())
        if min(a.shape) < 22 or i == levels - 1:
            # image too small for another dyadic scale: renormalize
            w = np.asarray(weights[:i + 1])
            w = w / w.sum()
            vals[-1] = ssim_map.mean()
            return float(np.prod(np.maximum(vals, 1e-6) ** w))
        a = (a[::2, ::2] + a[1::2, ::2] + a[::2, 1::2] + a[1::2, 1::2]) / 4
        b = (b[::2, ::2] + b[1::2, ::2] + b[::2, 1::2] + b[1::2, 1::2]) / 4
    w = np.asarray(weights)
    return float(np.prod(np.maximum(vals, 1e-6) ** w))


def uqi(a: np.ndarray, b: np.ndarray, block: int = 8) -> float:
    """Universal Quality Index (Wang & Bovik 2002): sliding-window
    correlation * luminance * contrast product."""
    a, b = _to_gray2d(a), _to_gray2d(b)
    kern = np.ones((block, block)) / (block * block)
    mu_a, mu_b = _filter2(a, kern), _filter2(b, kern)
    s_aa = _filter2(a * a, kern) - mu_a ** 2
    s_bb = _filter2(b * b, kern) - mu_b ** 2
    s_ab = _filter2(a * b, kern) - mu_a * mu_b
    num = 4 * s_ab * mu_a * mu_b
    den = (s_aa + s_bb) * (mu_a ** 2 + mu_b ** 2)
    q = np.where(den > 1e-12, num / np.maximum(den, 1e-12), 1.0)
    return float(q.mean())


def vifp(ref: np.ndarray, dist: np.ndarray,
         sigma_nsq: float = 2.0) -> float:
    """Pixel-domain Visual Information Fidelity (Sheikh & Bovik 2006),
    4-scale gaussian pyramid."""
    ref, dist = _to_gray2d(ref), _to_gray2d(dist)
    num = den = 0.0
    for scale in range(1, 5):
        size = 2 ** (4 - scale + 1) + 1
        kern = _gaussian_kernel(size, size / 5.0)
        if scale > 1:
            ref = _filter2(ref, kern)[::2, ::2]
            dist = _filter2(dist, kern)[::2, ::2]
            if min(ref.shape) < size:
                break
        mu1, mu2 = _filter2(ref, kern), _filter2(dist, kern)
        s11 = np.maximum(_filter2(ref * ref, kern) - mu1 ** 2, 0)
        s22 = np.maximum(_filter2(dist * dist, kern) - mu2 ** 2, 0)
        s12 = _filter2(ref * dist, kern) - mu1 * mu2
        g = s12 / np.maximum(s11, 1e-10)
        sv = s22 - g * s12
        g = np.where(s11 < 1e-10, 0.0, g)
        sv = np.where(s11 < 1e-10, s22, sv)
        sv = np.where(s22 < 1e-10, 0.0, np.maximum(sv, 1e-10))
        g = np.where(s22 < 1e-10, 0.0, g)
        num += np.sum(np.log10(1 + g * g * s11 / (sv + sigma_nsq)))
        den += np.sum(np.log10(1 + s11 / sigma_nsq))
    return float(num / max(den, 1e-10))
