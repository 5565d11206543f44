"""Carry state from the JAX package into the port.

Each helper takes the JAX package's arrays as numpy (u32 residues, u32
Shoup words, int8 matrices) and returns the port's objects with its dtype
rules: residues int32, Shoup words int64, int8 unchanged. Nothing here
imports jax: callers pass `np.asarray(jax_array)`.
"""

from __future__ import annotations

import numpy as np
import torch

from .ckks.keys import SecretKey, PublicKey
from .ckks.ops import Ciphertext
from .ckks.keyswitch import KSwitchKey


def _tensor(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.int8:
        return torch.as_tensor(a, device=device)
    if name.endswith("shoup"):
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype.kind in "ui" and a.size and int(a.max()) >= 2 ** 31:
        raise ValueError(f"{name}: residues must be < 2**31")
    return torch.as_tensor(a.astype(np.int32) if a.dtype.kind in "ui" else a,
                           device=device)


def context_arrays_from_numpy(arrays: dict, device="cpu") -> dict:
    """{name: numpy array} -> {name: tensor}; names ending in 'shoup' are
    Shoup words (int64), other integer arrays residues (int32)."""
    return {k: _tensor(k, v, device) for k, v in arrays.items()}


def keys_from_numpy(sk_arrays, pk_arrays, device="cpu"):
    """(s, s_shoup) and (p0, p0_shoup, p1, p1_shoup) -> (SecretKey,
    PublicKey); either tuple may be None."""
    sk = pk = None
    if sk_arrays is not None:
        sk = SecretKey(**context_arrays_from_numpy(
            dict(zip(("s", "s_shoup"), sk_arrays)), device))
    if pk_arrays is not None:
        pk = PublicKey(**context_arrays_from_numpy(
            dict(zip(("p0", "p0_shoup", "p1", "p1_shoup"), pk_arrays)),
            device))
    return sk, pk


def ciphertext_from_numpy(data, scale: float, level: int,
                          device="cpu") -> Ciphertext:
    """u32 ciphertext data (..., chunks, 2, live, N) -> Ciphertext."""
    return Ciphertext(data=_tensor("data", data, device), scale=float(scale),
                      level=int(level))


def kswitch_key_from_numpy(b, b_shoup, a, a_shoup,
                           device="cpu") -> KSwitchKey:
    """A relinearisation or Galois key's (dnum, L, N) rows -> KSwitchKey."""
    return KSwitchKey(**context_arrays_from_numpy(
        dict(b=b, b_shoup=b_shoup, a=a, a_shoup=a_shoup), device))
