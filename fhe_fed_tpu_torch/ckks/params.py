"""CKKS parameters and the per-device context.

Same parameter selection as fhe_fed_tpu.ckks.params (31-bit primes; base
primes covering scale + headroom, one rescale prime per level, trailing
key-switch primes), so both packages pick identical moduli. The context
holds the four-step NTT tables (ntt/mxu.py) on an explicit device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..rns import primes as primes_mod
from ..rns import modops
from ..ntt import mxu as mxu_mod

_HEADROOM_BITS = 34

ENCODE_DIGITS = 6          # 6 x 16-bit digits = 96 bits of |round(m * Delta)|
DIGIT_BITS = 16
_DIGIT_MASK = (1 << DIGIT_BITS) - 1


@dataclasses.dataclass(frozen=True)
class CkksParams:
    """Static CKKS parameters (hashable)."""
    ring_dim: int
    batch: int
    scale_bits: int
    mult_depth: int
    moduli: tuple[int, ...]   # base primes | rescale primes | special primes
    num_base: int
    num_special: int = 0

    @property
    def num_limbs(self) -> int:
        return len(self.moduli)

    @property
    def chain_len(self) -> int:
        """Limbs available to ciphertexts (excludes special primes)."""
        return len(self.moduli) - self.num_special

    @property
    def scale(self) -> float:
        return float(2.0 ** self.scale_bits)


def make_params(batch: int = 4096, scale_bits: int = 52,
                mult_depth: int = 1, ring_dim: int | None = None,
                num_special: int = 1) -> CkksParams:
    """genCryptoContextCKKS(multDepth, scaleFactorBits, batchSize) for
    31-bit RNS limbs; identical to the JAX package's make_params."""
    num_base = max(2, math.ceil((scale_bits + _HEADROOM_BITS) / 31))
    total = num_base + mult_depth + num_special
    n = max(2 * batch, primes_mod.min_ring_dim_128(31 * total))
    if ring_dim is not None:
        if ring_dim < 2 * batch:
            raise ValueError(f"ring_dim {ring_dim} < 2 * batch {batch}")
        n = ring_dim
    return CkksParams(
        ring_dim=n, batch=batch, scale_bits=scale_bits,
        mult_depth=mult_depth, moduli=primes_mod.ntt_primes(n, total),
        num_base=num_base, num_special=num_special)


@dataclasses.dataclass(frozen=True)
class DecodeConsts:
    """Exact-CRT decode constants for `live` limbs, host numpy (the decode
    kernel takes them as launch arguments; the plain decode moves the few it
    broadcasts to the data's device)."""
    live: int
    ndig: int                      # 16-bit digit planes
    punc_inv: np.ndarray           # (live,)   (Q/q_l)^-1 mod q_l, int64
    punc_inv_shoup: np.ndarray     # (live,)   int64
    m_digits: np.ndarray           # (live, ndig) 16-bit digits of Q/q_l
    q_digits: np.ndarray           # (ndig,) digits of Q
    inv_q_f32: np.ndarray          # (live,) f32(1/q_l)


def _make_decode_consts(moduli: tuple[int, ...], live: int) -> DecodeConsts:
    qs = moduli[:live]
    Q = math.prod(qs)
    # Two extra planes absorb the live-fold accumulation overflow and the
    # k*Q subtraction slack.
    ndig = (Q.bit_length() + DIGIT_BITS - 1) // DIGIT_BITS + 2

    def digits(v: int) -> np.ndarray:
        return np.array([(v >> (DIGIT_BITS * d)) & _DIGIT_MASK
                         for d in range(ndig)], dtype=np.int64)

    punc_inv = np.array([pow(Q // q % q, q - 2, q) for q in qs],
                        dtype=np.int64)
    return DecodeConsts(
        live=live, ndig=ndig,
        punc_inv=punc_inv,
        punc_inv_shoup=modops.shoup_precompute(punc_inv, np.array(qs)),
        m_digits=np.stack([digits(Q // q) for q in qs]),
        q_digits=digits(Q),
        inv_q_f32=np.array([1.0 / q for q in qs], dtype=np.float32))


@dataclasses.dataclass(frozen=True)
class CkksContext:
    """Precomputed context on one device."""
    params: CkksParams
    device: torch.device
    q: torch.Tensor                # (L,) int64
    pow32: torch.Tensor            # (L,) 2**32 mod q, int64
    pow32_shoup: torch.Tensor
    enc_pow: torch.Tensor          # (ENCODE_DIGITS, L) 2**(16j) mod q, int64
    enc_pow_shoup: torch.Tensor
    dec_consts: tuple              # tuple[DecodeConsts], index = live - 1
    mxu: mxu_mod.MxuNttTables | None   # None where mxu_viable is false

    @property
    def ring_dim(self) -> int:
        return self.params.ring_dim


def make_context(params: CkksParams,
                 device: torch.device | str = "cpu") -> CkksContext:
    device = torch.device(device)
    n = params.ring_dim
    moduli = params.moduli
    qs = np.array(moduli, dtype=np.int64)
    pow32 = np.array([(1 << 32) % q for q in moduli], dtype=np.int64)
    enc_pow = np.array([[pow(2, DIGIT_BITS * j, q) for q in moduli]
                        for j in range(ENCODE_DIGITS)], dtype=np.int64)

    def t(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return CkksContext(
        params=params, device=device,
        q=t(qs),
        pow32=t(pow32), pow32_shoup=t(modops.shoup_precompute(pow32, qs)),
        enc_pow=t(enc_pow),
        enc_pow_shoup=t(modops.shoup_precompute(enc_pow, qs[None, :])),
        dec_consts=tuple(_make_decode_consts(moduli, live)
                         for live in range(1, params.chain_len + 1)),
        mxu=(mxu_mod.make_mxu_tables(n, moduli, device=device)
             if mxu_mod.mxu_viable(n) else None))
