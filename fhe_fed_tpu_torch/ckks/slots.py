"""Canonical-embedding ("slot") packing for ct x ct and rotation workloads.

Slot j holds m(zeta**e_j) with zeta = exp(i*pi/N), e_j = 5**j mod 2N,
j = 0 .. N/2-1; the conjugate slots at -e_j carry conj(z_j), so the
polynomial is real. Rotation by r (Galois element 5**r) maps slot j to
z_{j+r}.

Encode and decode run on the host in numpy float64, with the same numpy
operations as fhe_fed_tpu.ckks.slots (and the decode's exact CRT in numpy
object ints), so both packages give identical residues and identical
slots. Only the residues move to and from the device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .params import CkksContext

__all__ = ["num_slots", "encode_slots", "decode_slots", "slot_rotation_map"]


def num_slots(ctx: CkksContext) -> int:
    return ctx.ring_dim // 2


@functools.lru_cache(maxsize=None)
def _slot_exponents(n: int) -> np.ndarray:
    """e_j = 5**j mod 2N for j = 0 .. N/2-1."""
    two_n = 2 * n
    e = np.empty(n // 2, dtype=np.int64)
    cur = 1
    for j in range(n // 2):
        e[j] = cur
        cur = cur * 5 % two_n
    return e


def _embed_inverse(z: np.ndarray, n: int) -> np.ndarray:
    """Complex slots (..., N/2) -> real coefficients (..., N), f64."""
    two_n = 2 * n
    e = _slot_exponents(n)
    V = np.zeros(z.shape[:-1] + (two_n,), dtype=np.complex128)
    V[..., e] = z
    V[..., (two_n - e) % two_n] = np.conj(z)
    c_pad = np.fft.fft(V, axis=-1) / two_n
    # Odd-frequency support gives c_pad[k + N] == -c_pad[k]: fold exactly.
    return 2.0 * np.real(c_pad[..., :n])


def _embed_forward(c: np.ndarray, n: int) -> np.ndarray:
    """Real coefficients (..., N) -> complex slots (..., N/2), f64."""
    two_n = 2 * n
    e = _slot_exponents(n)
    c_pad = np.zeros(c.shape[:-1] + (two_n,), dtype=np.float64)
    c_pad[..., :n] = c
    spec = np.fft.ifft(c_pad, axis=-1) * two_n
    return spec[..., e]


def encode_slots(ctx: CkksContext, z, scale: float | None = None
                 ) -> torch.Tensor:
    """Slots (..., N/2), real or complex -> int32 residues (..., chain, N)
    in coefficient order on ctx.device (ready for ops.encrypt_encoded)."""
    n = ctx.ring_dim
    scale = float(ctx.params.scale if scale is None else scale)
    z = np.asarray(z)
    if z.shape[-1] != n // 2:
        raise ValueError(f"expected (..., {n // 2}) slots, got {z.shape}")
    c = _embed_inverse(z.astype(np.complex128), n)
    c_int = np.rint(c * scale).astype(np.int64)
    chain = ctx.params.chain_len
    qs = np.array(ctx.params.moduli[:chain], dtype=np.int64)
    res = c_int[..., None, :] % qs[:, None]                # negatives wrap
    return torch.as_tensor(res.astype(np.int32), device=ctx.device)


def decode_slots(ctx: CkksContext, residues, scale: float) -> np.ndarray:
    """Residues (..., live, N) in coefficient order (a tensor on any
    device, or numpy) -> complex slots (..., N/2) f64. Exact CRT on host
    ints, then the forward embedding."""
    n = ctx.ring_dim
    if torch.is_tensor(residues):
        residues = residues.cpu().numpy()
    x = np.asarray(residues).astype(np.uint64)
    live = x.shape[-2]
    qs = ctx.params.moduli[:live]
    Q = math.prod(qs)
    half = Q // 2
    v = np.zeros(x.shape[:-2] + (n,), dtype=object)
    for l, q in enumerate(qs):
        M = Q // q
        inv = pow(M % q, q - 2, q)
        y = (x[..., l, :] * np.uint64(inv)) % np.uint64(q)  # < 2**62, exact
        v = v + y.astype(object) * M
    v %= Q
    v = np.where(v > half, v - Q, v)
    c = (v / np.float64(scale)).astype(np.float64)
    return _embed_forward(c, n)


def slot_rotation_map(n: int, r: int) -> np.ndarray:
    """After rotate(ct, r), slot j holds old slot (j + r) mod N/2."""
    half = n // 2
    return (np.arange(half) + r) % half
