"""Two-float (f32 hi, lo) arithmetic used by the exact-CRT decode tail.

Branch-free Knuth / Dekker algorithms without FMA, operation for operation
as in fhe_fed_tpu.utils.dfloat, on float32 tensors. Only the operations
the decode needs are ported.
"""

from __future__ import annotations

import numpy as np

_SPLITTER = 4097.0  # 2**12 + 1, Veltkamp split for f32


def two_sum(a, b):
    """Exact sum: a + b = s + e with s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Exact sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Exact product: a * b = p + e (Dekker, no FMA)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add_f32(x_hi, x_lo, y):
    s, e = two_sum(x_hi, y)
    e = e + x_lo
    return fast_two_sum(s, e)


def df_mul(x_hi, x_lo, y_hi, y_lo):
    p, e = two_prod(x_hi, y_hi)
    e = e + (x_hi * y_lo + x_lo * y_hi)
    return fast_two_sum(p, e)


def df_from_f64(v) -> tuple[float, float]:
    """Host side: split a float64 into an f32 (hi, lo) pair."""
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return float(hi), float(lo)
