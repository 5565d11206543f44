"""CKKS parameters and the per-device context.

Same parameter selection as fhe_fed_tpu.ckks.params (31-bit primes; base
primes covering scale + headroom, one rescale prime per level, trailing
key-switch primes), so both packages pick identical moduli. The context
holds the NTT tables (ntt/tables.py, with the four-step tables of ntt/mxu.py
where the ring has a split) on an explicit device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import cuda_lib
from ..rns import primes as primes_mod
from ..rns import modops
from ..ntt import tables as ntt_tables

_HEADROOM_BITS = 34

ENCODE_DIGITS = 6          # 6 x 16-bit digits = 96 bits of |round(m * Delta)|
DIGIT_BITS = 16
_DIGIT_MASK = (1 << DIGIT_BITS) - 1
# An integer-valued float32 is m * 2**k with m < 2**24 and k <= 127 - 23:
# the encode pass (csrc/rlwe_passes.cu) reads 2**k mod q for k < 105.
ENCODE_EXPS = 105


def encode_table(moduli) -> np.ndarray:
    """The encode pass's table: (L, ENCODE_EXPS, 2) uint32 pairs of
    2**k mod q_l and its Shoup word floor((2**k mod q_l) * 2**32 / q_l)."""
    qs = np.asarray(moduli, dtype=np.uint64)[:, None]
    p = np.array([[pow(2, k, int(q)) for k in range(ENCODE_EXPS)]
                  for q in moduli], dtype=np.uint64)
    return np.stack([p, (p << np.uint64(32)) // qs], axis=-1).astype(
        np.uint32)


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
    def special_prime(self) -> int:
        if self.num_special != 1:
            raise ValueError("key switching needs exactly one special prime")
        return self.moduli[-1]

    @property
    def scale(self) -> float:
        return float(2.0 ** self.scale_bits)

    @property
    def rescale_primes(self) -> tuple[int, ...]:
        return self.moduli[self.num_base:]

    @property
    def log_q(self) -> float:
        return sum(math.log2(q) for q in self.moduli)

    def limbs_at_level(self, level: int) -> int:
        """Live limbs of a ciphertext at `level` (0 = fresh)."""
        if not 0 <= level <= self.mult_depth:
            raise ValueError(f"level {level} outside [0, {self.mult_depth}]")
        return self.chain_len - level


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
    kernel builds its device block from them, pallas_decode.kernel_consts;
    the plain decode moves the few it broadcasts to the data's device)."""
    live: int
    ndig: int                      # 16-bit digit planes
    punc_inv: np.ndarray           # (live,)   (Q/q_l)^-1 mod q_l, int64
    punc_inv_shoup: np.ndarray     # (live,)   int64
    m_digits: np.ndarray           # (live, ndig) 16-bit digits of Q/q_l
    q_digits: np.ndarray           # (ndig,) digits of Q
    inv_q_f32: np.ndarray          # (live,) f32(1/q_l)
    # (live*4, 2*ndig) uint8: row (l, i), column d8 = byte (d8 - i) of
    # Q/q_l, so bytes(y) @ m_bytes is sum_l y_l * Q/q_l in base-256 planes
    # (the decode kernel's tensor-core product).
    m_bytes: np.ndarray


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
    m_bytes = np.zeros((live * 4, 2 * ndig), dtype=np.uint8)
    for l, q in enumerate(qs):
        mb = np.frombuffer((Q // q).to_bytes(2 * ndig, "little"),
                           dtype=np.uint8)
        for i in range(4):
            m_bytes[4 * l + i, i:] = mb[:2 * ndig - i]
    return DecodeConsts(
        live=live, ndig=ndig,
        punc_inv=punc_inv,
        punc_inv_shoup=modops.shoup_precompute(punc_inv, np.array(qs)),
        m_digits=np.stack([digits(Q // q) for q in qs]),
        q_digits=digits(Q),
        inv_q_f32=np.array([1.0 / q for q in qs], dtype=np.float32),
        m_bytes=m_bytes)


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
    enc_table: torch.Tensor        # encode_table(moduli) as int32 bits
    dec_consts: tuple              # tuple[DecodeConsts], index = live - 1
    tables: ntt_tables.NttTables   # all L limbs, special prime included
    rescale_inv: tuple             # per level: (q_top^-1 mod q_j, Shoup), int64
    # Device blocks the decode kernel builds once per (live, scale, device)
    # from dec_consts (ckks/pallas_decode.py).
    decode_blocks: dict = dataclasses.field(default_factory=dict,
                                            compare=False, repr=False)

    @property
    def ring_dim(self) -> int:
        return self.params.ring_dim

    @property
    def num_limbs(self) -> int:
        return self.params.num_limbs


def make_context(params: CkksParams,
                 device: torch.device | str = "cuda") -> CkksContext:
    device = cuda_lib.device(device)
    n = params.ring_dim
    moduli = params.moduli
    qs = np.array(moduli, dtype=np.int64)
    pow32 = np.array([(1 << 32) % q for q in moduli], dtype=np.int64)
    enc_pow = np.array([[pow(2, DIGIT_BITS * j, q) for q in moduli]
                        for j in range(ENCODE_DIGITS)], dtype=np.int64)

    def t(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    rescale = []
    for level in range(params.mult_depth):
        top = params.chain_len - 1 - level        # index of the limb dropped
        inv = np.array([pow(moduli[top] % q, q - 2, q) for q in moduli[:top]],
                       dtype=np.int64)
        rescale.append((t(inv), t(modops.shoup_precompute(inv, qs[:top]))))

    return CkksContext(
        params=params, device=device,
        q=t(qs),
        pow32=t(pow32), pow32_shoup=t(modops.shoup_precompute(pow32, qs)),
        enc_pow=t(enc_pow),
        enc_pow_shoup=t(modops.shoup_precompute(enc_pow, qs[None, :])),
        enc_table=torch.from_numpy(encode_table(moduli).view(np.int32)).to(
            device),
        dec_consts=tuple(_make_decode_consts(moduli, live)
                         for live in range(1, params.chain_len + 1)),
        tables=ntt_tables.make_tables(n, moduli, device=device),
        rescale_inv=tuple(rescale))
