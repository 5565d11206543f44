"""Modular arithmetic on residue tensors.

Dtypes, fixed for the whole port:

  * residues are non-negative ``torch.int32`` at rest (every q < 2**31), so
    their little-endian bytes are the JAX package's ``<u4`` bytes;
  * Shoup companion words w_shoup = floor(w * 2**32 / q) reach 2**32 - 1 and
    do NOT fit int32: they are stored as ``torch.int64`` values everywhere
    (keys, tables, weights), and the CUDA kernels read them as int64 and
    truncate to their low 32 bits.

The functions below compute in int64 (their inputs are promoted): for
a, w < q < 2**31, a*w < 2**62 and a*w_shoup < 2**63 both fit, so every
result is the exact canonical residue that the JAX package's u32 code
computes. torch.uint32 is not used: on the CPU it is a storage-only dtype.
"""

from __future__ import annotations

import numpy as np
import torch

_I64 = torch.int64


def add_mod(a, b, q):
    """(a + b) mod q for a, b in [0, q)."""
    s = a.to(_I64) + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    """(a - b) mod q for a, b in [0, q)."""
    d = a.to(_I64) - b
    return torch.where(d < 0, d + q, d)


def neg_mod(a, q):
    a = a.to(_I64)
    return torch.where(a == 0, a, q - a)


def reduce_u32(x, q):
    """x mod q for 0 <= x < 2**32 and q > 2**30 (at most three
    subtractions)."""
    x = x.to(_I64)
    x = torch.where(x >= 2 * q, x - 2 * q, x)
    x = torch.where(x >= q, x - q, x)
    return torch.where(x >= q, x - q, x)


def shoup_precompute(w, q) -> np.ndarray:
    """Host side: floor(w * 2**32 / q) for constants w < q, as numpy int64
    (values in [0, 2**32))."""
    w = np.asarray(w, dtype=np.uint64)
    q = np.asarray(q, dtype=np.uint64)
    return ((w << np.uint64(32)) // q).astype(np.int64)


def shoup_tensor(w: torch.Tensor, q) -> torch.Tensor:
    """Device side: floor(w * 2**32 / q) for residues w < q < 2**31, as
    int64 (w * 2**32 < 2**63 is exact). Equals shoup_precompute."""
    return torch.div(w.to(_I64) << 32, q, rounding_mode="floor")


def mul_mod_shoup(x, w, w_shoup, q):
    """x * w mod q for x in [0, q) and a constant w with its Shoup word.

    qhat = floor(x * w_shoup / 2**32); r = x*w - qhat*q lies in [0, 2q);
    one conditional subtraction. Same arithmetic as the JAX package's u32
    version, done exactly in int64."""
    x = x.to(_I64)
    qhat = (x * w_shoup) >> 32
    r = x * w - qhat * q
    return torch.where(r >= q, r - q, r)


def mul_mod(x, y, q):
    """Generic x * y mod q for x, y in [0, q), q < 2**31: x*y < 2**62 is
    exact in int64, so torch.remainder gives the canonical residue, the same
    value as the JAX package's Barrett mul_mod. No Barrett constant mu is
    needed, so the port keeps none."""
    return torch.remainder(x.to(_I64) * y, q)
