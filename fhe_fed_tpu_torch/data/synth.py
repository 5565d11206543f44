"""Deterministic synthetic image-classification data, a copy of
fhe_fed_tpu.data.synth (numpy only; the port imports nothing of the JAX
package), bit for bit the same samples.

The reference's accuracy-delta criterion evaluates FashionMNIST accuracy
after FHE vs plaintext aggregation (reference benchmark_crypto.py:21-49,
246-250: deltas 0.0 at >=33 scale bits, >0 at 14 bits). This environment
has no dataset access, so this module supplies an embeddable stand-in with
the same shape (28x28 grayscale, 10 classes) and — importantly — the same
failure mode: class prototypes are smooth low-frequency patterns and
samples carry enough additive noise that some test points sit near the
decision boundary, where low-scale-bit CKKS quantization of the averaged
weights flips predictions.

Fully deterministic given (n, seed): no files, no downloads.
"""

from __future__ import annotations

import numpy as np


class SynthSpec:
    n_classes = 10
    hw = 28
    # Class separation is deliberately small relative to the pixel noise:
    # nearest-prototype accuracy ~0.92 at signal=0.12 (unit noise), so a
    # fraction of test points sit near the decision boundary — the regime
    # where low-scale-bit CKKS weight quantization visibly moves accuracy
    # (reference params_results.csv: delta > 0 at 14 bits, 0.0 at >= 33).
    signal = 0.12
    noise = 1.0
    prototype_seed = 1234


def _prototypes(spec=SynthSpec) -> np.ndarray:
    """(n_classes, hw, hw) smooth unit-RMS class prototypes from a shared
    low-frequency cosine basis with class-specific coefficients."""
    rng = np.random.default_rng(spec.prototype_seed)
    hw, k = spec.hw, 4                     # 4x4 lowest frequencies
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64) / hw
    basis = np.stack([np.cos(np.pi * (fy * yy + 0.5) * 2)
                      * np.cos(np.pi * (fx * xx + 0.5) * 2)
                      for fy in range(k) for fx in range(k)])  # (k*k, hw, hw)
    coef = rng.standard_normal((spec.n_classes, k * k))
    protos = np.einsum("cb,bij->cij", coef, basis)
    protos /= np.sqrt((protos ** 2).mean(axis=(1, 2), keepdims=True))
    return (spec.signal * protos).astype(np.float32)


def make_synth_images(n: int, seed: int = 0, spec=SynthSpec):
    """n samples -> (x (n, hw, hw) float32, y (n,) int32). Bayes-optimal
    accuracy is high but < 1 (noise floor), so trained-model accuracy is a
    meaningful, quantization-sensitive metric."""
    protos = _prototypes(spec)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    x = protos[y] + spec.noise * rng.standard_normal(
        (n, spec.hw, spec.hw)).astype(np.float32)
    return x.astype(np.float32), y
