"""Key containers, samplers and key generation.

Keys live in the NTT (evaluation) domain with their Shoup companion words:
residues int32, companions int64 (rns/modops.py). Two families of samplers,
with the same distributions:

  * `uniform_mod_q`, `ternary_coeffs`, `cbd_coeffs` draw from an explicit
    torch.Generator, on the generator's device (the port's own streams,
    for `keygen(ctx, generator)`);
  * the `*_key` forms draw under a key of either implementation
    (utils/prng.py) and follow fhe_fed_tpu.ckks.keys line for line, so
    they give the JAX package's samples bit for bit: the same functions of
    the words (`uniform_from_words`, `ternary_from_words`,
    `cbd_from_words`) over threefry's words (the `*_tf` forms,
    utils/threefry.py) or rbg's (XLA's Philox). Under an rbg key on the
    card the words and the sampler run as one kernel
    (utils/philox_rbg.py); on the CPU through `prng.bits`. A key batch
    (..., W) draws each key's stream, or with `vmap=True` as a `jax.vmap`
    of the JAX sampler draws (prng.batch_rule): the caller says which, as
    the JAX function it mirrors does. `uniform_mod_q_xor2` is threefry
    only (the wire seed's a-stream).

`keygen` is a sampling step followed by the deterministic `keygen_core`,
which takes the samples as arguments. Given an int seed it splits
threefry key(seed) as the JAX package's keygen does and reproduces its
keys byte for byte. Keys can also be loaded (ckks/serial.py) or carried
over from the JAX package (interop.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..rns import modops
from ..ntt import ntt as ntt_mod
from ..utils import philox_rbg, prng, threefry
from .params import CkksContext

_CBD_BITS = 20  # centered binomial with variance _CBD_BITS / 2


@dataclasses.dataclass(frozen=True)
class SecretKey:
    s: torch.Tensor          # (L, N) int32, eval domain
    s_shoup: torch.Tensor    # (L, N) int64


@dataclasses.dataclass(frozen=True)
class PublicKey:
    p0: torch.Tensor         # (L, N) eval domain: -a*s + e
    p0_shoup: torch.Tensor
    p1: torch.Tensor         # (L, N) eval domain: a
    p1_shoup: torch.Tensor


def uniform_mod_q(gen: torch.Generator, shape, moduli) -> torch.Tensor:
    """Uniform residues in [0, q_l) of shape (..., L, n), int32; limb l is
    drawn directly in [0, moduli[l]) (exactly uniform)."""
    *lead, L, n = shape
    return torch.stack(
        [torch.randint(0, int(q), (*lead, n), generator=gen,
                       device=gen.device, dtype=torch.int32)
         for q in moduli[:L]], dim=-2)


def ternary_coeffs(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform ternary {-1, 0, 1} int32 coefficients."""
    return torch.randint(-1, 2, tuple(shape), generator=gen,
                         device=gen.device, dtype=torch.int32)


def _popcount20(x: torch.Tensor) -> torch.Tensor:
    """Bit count of 20-bit values by SWAR shifts and masks (int64)."""
    x = x - ((x >> 1) & 0x55555)
    x = (x & 0x33333) + ((x >> 2) & 0x33333)
    x = (x + (x >> 4)) & 0x0F0F0F
    return (x + (x >> 8) + (x >> 16)) & 0x1F


def cbd_coeffs(gen: torch.Generator, shape) -> torch.Tensor:
    """Centered binomial error popcount(a) - popcount(b) over two uniform
    20-bit masks, int32. torch has no popcount: it is built from SWAR
    shifts and masks in int64."""
    shape = tuple(shape)
    a = torch.randint(0, 1 << _CBD_BITS, shape, generator=gen,
                      device=gen.device)
    b = torch.randint(0, 1 << _CBD_BITS, shape, generator=gen,
                      device=gen.device)
    return cbd_from_words(a, b)


def uniform_from_words(hi: torch.Tensor, lo: torch.Tensor,
                       moduli) -> torch.Tensor:
    """(hi * 2**32 + lo) mod q_l for uniform 32-bit words (..., L, n) held
    in int64, int32; bias < 2**-33 (the JAX package's _reduce_bits_mod_q).
    Both words are first brought below q (at most three subtractions each,
    every q > 2**30): mul_mod_shoup is exact in int64 only for x < 2**31,
    and [hi]_q * 2**32 mod q is the canonical residue the JAX package's u32
    Shoup multiply gives for the full word."""
    L = hi.shape[-2]
    qs = np.asarray(moduli[:L], dtype=np.int64)
    p32 = (1 << 32) % qs

    def col(a):
        return torch.as_tensor(a, device=hi.device)[:, None]

    q = col(qs)
    hi_red = modops.mul_mod_shoup(
        modops.reduce_u32(hi, q), col(p32),
        col(modops.shoup_precompute(p32, qs)), q)
    return modops.add_mod(hi_red, modops.reduce_u32(lo, q), q).to(
        torch.int32)


def ternary_from_words(w: torch.Tensor) -> torch.Tensor:
    """bits % 3 - 1, int32: ternary {-1, 0, 1}."""
    return (w % 3 - 1).to(torch.int32)


def cbd_from_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """popcount(a) - popcount(b) over the low 20 bits of two words, int32."""
    mask = (1 << _CBD_BITS) - 1
    return (_popcount20(a & mask) - _popcount20(b & mask)).to(torch.int32)


def uniform_mod_q_tf(key: torch.Tensor, shape, moduli) -> torch.Tensor:
    """Threefry form of uniform_mod_q: residues (*key batch, *shape) in
    [0, q_l), int32, for shape (..., L, n); 64 bits per element,
    r = (hi * 2**32 + lo) mod q, hi and lo under split(key)."""
    k1, k2 = threefry.split(key).unbind(-2)
    return uniform_from_words(threefry.bits(k1, shape),
                              threefry.bits(k2, shape), moduli)


def uniform_mod_q_xor2(key_a: torch.Tensor, key_b: torch.Tensor, shape,
                       moduli) -> torch.Tensor:
    """uniform_mod_q_tf from the XOR of two independently keyed threefry
    streams: a key pair collides only when both keys do (a 128-bit seed
    space). The a-stream of the seed-compressed ciphertext (ckks/ops.py)."""
    k1a, k2a = threefry.split(key_a).unbind(-2)
    k1b, k2b = threefry.split(key_b).unbind(-2)
    hi = threefry.bits(k1a, shape).bitwise_xor_(threefry.bits(k1b, shape))
    lo = threefry.bits(k2a, shape).bitwise_xor_(threefry.bits(k2b, shape))
    return uniform_from_words(hi, lo, moduli)


def ternary_coeffs_tf(key: torch.Tensor, shape) -> torch.Tensor:
    """Threefry form of ternary_coeffs: bits % 3 - 1, int32."""
    return ternary_from_words(threefry.bits(key, shape))


def cbd_coeffs_tf(key: torch.Tensor, shape) -> torch.Tensor:
    """Threefry form of cbd_coeffs: popcount(a) - popcount(b) over the low
    20 bits of two words drawn from split(key)."""
    k1, k2 = threefry.split(key).unbind(-2)
    return cbd_from_words(threefry.bits(k1, shape), threefry.bits(k2, shape))


def _rbg_pair(key: torch.Tensor, shape, vmap: bool):
    """An rbg draw's (key, shape) under the batch rule, and its split."""
    key, shape = prng.batch_rule(key, shape, vmap)
    k1, k2 = prng.split(key).unbind(-2)
    return key, shape, k1.contiguous(), k2.contiguous()


def uniform_mod_q_key(key: torch.Tensor, shape, moduli, *,
                      vmap: bool) -> torch.Tensor:
    """fhe_fed_tpu.ckks.keys.uniform_mod_q under a key of either
    implementation: residues (*key batch, *shape) in [0, q_l), int32.
    `vmap`: the key batch stands for a jax.vmap (prng.batch_rule)."""
    if prng.impl_of(key) == "threefry":
        return uniform_mod_q_tf(key, shape, moduli)
    key, shape, k1, k2 = _rbg_pair(key, shape, vmap)
    if key.is_cuda:
        return philox_rbg.uniform_mod_q(k1, k2, shape, moduli)
    return uniform_from_words(prng.bits(k1, shape), prng.bits(k2, shape),
                              moduli)


def ternary_coeffs_key(key: torch.Tensor, shape, *,
                       vmap: bool) -> torch.Tensor:
    """fhe_fed_tpu.ckks.keys.ternary_coeffs under a key of either
    implementation; `vmap` as uniform_mod_q_key."""
    if prng.impl_of(key) == "threefry":
        return ternary_coeffs_tf(key, shape)
    key, shape = prng.batch_rule(key, shape, vmap)
    if key.is_cuda:
        return philox_rbg.ternary(key.contiguous(), shape)
    return ternary_from_words(prng.bits(key, shape))


def cbd_coeffs_key(key: torch.Tensor, shape, *, vmap: bool) -> torch.Tensor:
    """fhe_fed_tpu.ckks.keys.cbd_coeffs under a key of either
    implementation; `vmap` as uniform_mod_q_key."""
    if prng.impl_of(key) == "threefry":
        return cbd_coeffs_tf(key, shape)
    key, shape, k1, k2 = _rbg_pair(key, shape, vmap)
    if key.is_cuda:
        return philox_rbg.cbd(k1, k2, shape)
    return cbd_from_words(prng.bits(k1, shape), prng.bits(k2, shape))


def lift_signed(coeffs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Small signed coefficients (..., N) -> int32 residues (..., L, N)."""
    c = coeffs.to(torch.int64)[..., None, :]
    return torch.where(c < 0, c + q[:, None], c).to(torch.int32)


def keygen_core(ctx: CkksContext, s_coeffs: torch.Tensor, a: torch.Tensor,
                e_coeffs: torch.Tensor) -> tuple[SecretKey, PublicKey]:
    """(sk, pk) from a ternary secret `s_coeffs` (N,), a uniform `a`
    (L, N) in the evaluation domain and a small error `e_coeffs` (N,), over
    all L limbs (special prime included): s = NTT(s), p1 = a,
    p0 = -a*s + NTT(e). The two transforms run as one NTT batch."""
    qb = ctx.q[:, None]
    s_hat, e_hat = ntt_mod.ntt(
        lift_signed(torch.stack([s_coeffs, e_coeffs]), ctx.q), ctx.tables)
    p0 = modops.add_mod(modops.neg_mod(modops.mul_mod(a, s_hat, qb), qb),
                        e_hat, qb).to(torch.int32)
    a = a.to(torch.int32)
    sk = SecretKey(s=s_hat, s_shoup=modops.shoup_tensor(s_hat, qb))
    pk = PublicKey(p0=p0, p0_shoup=modops.shoup_tensor(p0, qb),
                   p1=a, p1_shoup=modops.shoup_tensor(a, qb))
    return sk, pk


def keygen(ctx: CkksContext, rng: torch.Generator | int
           ) -> tuple[SecretKey, PublicKey]:
    """Generate (sk, pk) (cc->KeyGen()). `rng` is a torch.Generator (keys
    on its device) or an int seed: threefry key(seed) on ctx.device, split
    into (s, a, e) keys as fhe_fed_tpu.ckks.keys.keygen does, so the keys
    equal the JAX package's keygen(ctx, seed) byte for byte."""
    n, L = ctx.ring_dim, ctx.num_limbs
    if isinstance(rng, torch.Generator):
        s = ternary_coeffs(rng, (n,))
        a = uniform_mod_q(rng, (L, n), ctx.params.moduli)
        e = cbd_coeffs(rng, (n,))
    else:
        k_s, k_a, k_e = threefry.split(
            threefry.key(rng, ctx.device), 3).unbind(-2)
        s = ternary_coeffs_tf(k_s, (n,))
        a = uniform_mod_q_tf(k_a, (L, n), ctx.params.moduli)
        e = cbd_coeffs_tf(k_e, (n,))
    return keygen_core(ctx, s, a, e)
