"""CKKS operations of the encrypted FedAvg round, batched over chunks.

A ciphertext is int32 residues (..., chunks, 2, live, N) in the evaluation
domain (bit-reversed order), as in fhe_fed_tpu.ckks.ops. Each encrypt is a
sampling step followed by a deterministic core that takes the samples as
arguments. The step draws from `rng`, which is either

  * a torch.Generator: the port's own streams, or
  * a key (utils/prng.py), split as the JAX function of the same name
    splits it, line for line, so a threefry key (2,) and an rbg key (4,)
    both give the JAX package's ciphertext bit for bit (keys.*_key; under
    rbg on the card the Philox kernel draws). A stacked encrypt gives
    client i the key split(key, K)[i] and draws as JAX's `jax.vmap` over
    the clients draws: under rbg every client's samples come from the
    first client's key, at shape (K, ...) (prng.batch_rule).

Kernels on the path: the NTT (K1 or K2, via ntt/ntt.py) in encrypt,
decrypt and rescale, the weighted sum (K3, ckks/pallas_agg.py), the
decode (K4, via encoding.decode_coeff), and around the NTT the secret-key
encrypt's encode and encrypt passes and the decrypt's phase pass
(csrc/rlwe_passes.cu, ckks/rlwe_passes.py). The rest of the glue between
them is plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..rns import modops
from ..ntt import ntt as ntt_mod
from ..utils import prng
from ..utils.spans import traced
from . import encoding, pallas_agg, rlwe_passes
from .params import CkksContext
from .keys import (SecretKey, PublicKey, uniform_mod_q, ternary_coeffs,
                   cbd_coeffs, lift_signed, uniform_mod_q_key,
                   ternary_coeffs_key, cbd_coeffs_key, uniform_mod_q_xor2)


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    """RLWE ciphertext batch in the evaluation domain."""
    data: torch.Tensor        # (chunks, 2, live, N) or (K, chunks, 2, live, N)
    scale: float
    level: int

    @property
    def num_chunks(self) -> int:
        return int(self.data.shape[-4])

    @property
    def live_limbs(self) -> int:
        return int(self.data.shape[-2])


@dataclasses.dataclass(frozen=True)
class SeededCiphertext:
    """A fresh secret-key ciphertext with c1 elided: c1 = -a, where `a` is
    expanded from the 128-bit seed carried beside c0 (the XOR of two
    threefry streams keyed by its two halves, keys.uniform_mod_q_xor2).
    Half the upload of a full ciphertext; the server expands on arrival
    (expand_seeded). As fhe_fed_tpu.ckks.ops.SeededCiphertext."""
    c0: torch.Tensor          # (chunks, live, N) int32
    seed: torch.Tensor        # (4,) uint32 words, int64
    scale: float
    level: int


def _scale(ctx: CkksContext, scale: float | None) -> float:
    return float(ctx.params.scale if scale is None else scale)


def _tables(ctx: CkksContext, live: int):
    return ctx.tables.slice_limbs(0, live)


def _per_key_shape(key: torch.Tensor, shape) -> tuple:
    """The shape each key of a batch (..., W) draws: `shape` without the
    leading dimensions that the key batch covers."""
    b = key.dim() - 1
    if tuple(key.shape[:-1]) != tuple(shape[:b]):
        raise ValueError(f"keys {tuple(key.shape)} do not match the leading "
                         f"dimensions of {tuple(shape)}")
    return tuple(shape[b:])


@traced("fhe.sample")
def _sym_samples(ctx: CkksContext, rng, shape):
    """(a_hat (..., L, N), e (..., N)) for a secret-key encrypt of values
    `shape` (..., N): k_a, k_e = split(key), as _encrypt_sym_impl; a key
    batch is the stacked encrypt's jax.vmap over the clients."""
    L = ctx.params.chain_len
    moduli = ctx.params.moduli
    if isinstance(rng, torch.Generator):
        *lead, n = shape
        return (uniform_mod_q(rng, (*lead, L, n), moduli),
                cbd_coeffs(rng, tuple(shape)))
    *lead, n = _per_key_shape(rng, shape)
    k_a, k_e = prng.split(rng).unbind(-2)
    return (uniform_mod_q_key(k_a, (*lead, L, n), moduli, vmap=True),
            cbd_coeffs_key(k_e, (*lead, n), vmap=True))


@traced("fhe.sample")
def _pk_samples(rng, shape):
    """(u, e0, e1), each (..., N), for a public-key encrypt of polynomials
    `shape` (..., N): k_u, k_e0, k_e1 = split(key, 3), as _encrypt_pt_impl;
    a key batch is the stacked encrypt's jax.vmap over the clients."""
    if isinstance(rng, torch.Generator):
        return (ternary_coeffs(rng, shape), cbd_coeffs(rng, shape),
                cbd_coeffs(rng, shape))
    per = _per_key_shape(rng, shape)
    k_u, k_e0, k_e1 = prng.split(rng, 3).unbind(-2)
    return (ternary_coeffs_key(k_u, per, vmap=True),
            cbd_coeffs_key(k_e0, per, vmap=True),
            cbd_coeffs_key(k_e1, per, vmap=True))


def _split_clients(rng, k: int):
    """A stacked encrypt gives client i the key split(key, K)[i] (drawn
    as JAX's vmap over the clients draws, _sym_samples)."""
    return rng if isinstance(rng, torch.Generator) else prng.split(rng, k)


def _encrypt_plain(ctx: CkksContext, sk: SecretKey, a_hat: torch.Tensor,
                   w_hat: torch.Tensor, c1: bool = True) -> torch.Tensor:
    """c0 = a_hat*s + w_hat mod q in int64 and, with `c1`, c1 = -a_hat,
    stacked as (..., 2, L, N) int32; the plain version of the encrypt
    pass."""
    L = a_hat.shape[-2]
    qb = ctx.q[:L, None]
    c0 = modops.add_mod(
        modops.mul_mod_shoup(a_hat, sk.s[:L], sk.s_shoup[:L], qb), w_hat, qb)
    if not c1:
        return c0.to(torch.int32)
    return torch.stack([c0, modops.neg_mod(a_hat, qb)],
                       dim=-3).to(torch.int32)


def encrypt_symmetric_core(ctx: CkksContext, sk: SecretKey,
                           values: torch.Tensor, a_hat: torch.Tensor,
                           e: torch.Tensor, scale: float,
                           c1: bool = True) -> torch.Tensor:
    """Secret-key RLWE: ct = (a*s + NTT(m + e), -a), with `a_hat` (..., L, N)
    uniform in the evaluation domain and `e` (..., N) small signed error.
    values (..., N) f32 -> data (..., 2, L, N) int32, or c0 alone (..., L,
    N) without `c1`. One NTT batch; around it on the card the encode and
    encrypt passes of csrc/rlwe_passes.cu, on the CPU encoding.encode_plain
    and _encrypt_plain."""
    L = ctx.params.chain_len
    w = encoding.encode_coeff(ctx, values, scale, error=e)
    w_hat = ntt_mod.ntt(w, _tables(ctx, L))
    if w_hat.is_cuda:
        return rlwe_passes.encrypt(ctx, sk, a_hat, w_hat, c1)
    return _encrypt_plain(ctx, sk, a_hat, w_hat, c1)


def encrypt_symmetric(ctx: CkksContext, sk: SecretKey, values: torch.Tensor,
                      rng, scale: float | None = None) -> Ciphertext:
    """Secret-key encrypt of (chunks, N) f32 values."""
    scale = _scale(ctx, scale)
    a_hat, e = _sym_samples(ctx, rng, values.shape)
    return Ciphertext(encrypt_symmetric_core(ctx, sk, values, a_hat, e, scale),
                      scale, 0)


def encrypt_symmetric_stacked(ctx: CkksContext, sk: SecretKey,
                              values: torch.Tensor, rng,
                              scale: float | None = None) -> Ciphertext:
    """Encrypt a whole cohort: values (K, chunks, N) -> data
    (K, chunks, 2, L, N), one NTT batch for all K clients."""
    if values.dim() != 3:
        raise ValueError(f"expected (K, chunks, N) values, got "
                         f"{tuple(values.shape)}")
    return encrypt_symmetric(ctx, sk, values,
                             _split_clients(rng, values.shape[0]), scale)


def encrypt_symmetric_seeded(ctx: CkksContext, sk: SecretKey,
                             values: torch.Tensor, rng_key: torch.Tensor,
                             scale: float | None = None) -> SeededCiphertext:
    """Secret-key encrypt of (chunks, N) f32 with c1 elided. The wire seed
    is bits(key, (4,)), the error key fold_in(key, 0x5eed), under the key's
    implementation (JAX's seed under either); `a` is expanded from the seed
    as expand_seeded does, from the threefry pair of its halves whatever
    the key, so any server expands it alike."""
    scale = _scale(ctx, scale)
    seed = prng.bits(rng_key, (4,))
    e = cbd_coeffs_key(prng.fold_in(rng_key, 0x5eed), values.shape,
                       vmap=False)
    chunks, n = values.shape
    a_hat = uniform_mod_q_xor2(seed[:2], seed[2:],
                               (chunks, ctx.params.chain_len, n),
                               ctx.params.moduli)
    c0 = encrypt_symmetric_core(ctx, sk, values, a_hat, e, scale, c1=False)
    return SeededCiphertext(c0=c0, seed=seed, scale=scale, level=0)


def expand_seeded(ctx: CkksContext, sct: SeededCiphertext) -> Ciphertext:
    """Server side: rebuild the full (c0, c1) ciphertext from (c0, seed)."""
    chunks, L, n = sct.c0.shape
    seed = sct.seed.to(sct.c0.device)
    a_hat = uniform_mod_q_xor2(seed[:2], seed[2:], (chunks, L, n),
                               ctx.params.moduli)
    c1 = modops.neg_mod(a_hat, ctx.q[:L, None]).to(torch.int32)
    return Ciphertext(torch.stack([sct.c0, c1], dim=1), sct.scale, sct.level)


def encrypt_encoded_core(ctx: CkksContext, pk: PublicKey, pt: torch.Tensor,
                         u: torch.Tensor, e0: torch.Tensor,
                         e1: torch.Tensor) -> torch.Tensor:
    """Public-key RLWE on encoded residues: pt (..., chain, N) int32 in
    coefficient order -> (b*u + e0 + m, a*u + e1) (..., 2, chain, N) in the
    evaluation domain, for ternary `u` and errors `e0`, `e1` of shape
    (..., N). The four transforms (m, u, e0, e1) run as ONE NTT batch."""
    L = ctx.params.chain_len
    q = ctx.q[:L]
    qb = q[:, None]
    polys = torch.stack([pt, lift_signed(u, q), lift_signed(e0, q),
                         lift_signed(e1, q)])
    m_hat, u_hat, e0_hat, e1_hat = ntt_mod.ntt(polys, _tables(ctx, L))
    c0 = modops.add_mod(
        modops.add_mod(
            modops.mul_mod_shoup(u_hat, pk.p0[:L], pk.p0_shoup[:L], qb),
            e0_hat, qb),
        m_hat, qb)
    c1 = modops.add_mod(
        modops.mul_mod_shoup(u_hat, pk.p1[:L], pk.p1_shoup[:L], qb),
        e1_hat, qb)
    return torch.stack([c0, c1], dim=-3).to(torch.int32)


def encrypt_core(ctx: CkksContext, pk: PublicKey, values: torch.Tensor,
                 u: torch.Tensor, e0: torch.Tensor, e1: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Public-key RLWE of f32 values (..., N): encode_coeff, then
    encrypt_encoded_core."""
    return encrypt_encoded_core(ctx, pk,
                                encoding.encode_coeff(ctx, values, scale),
                                u, e0, e1)


def encrypt_encoded(ctx: CkksContext, pk: PublicKey, pt: torch.Tensor,
                    rng, scale: float) -> Ciphertext:
    """Public-key encrypt of already-encoded residues (chunks, chain, N),
    e.g. slot-packed plaintexts from slots.encode_slots."""
    u, e0, e1 = _pk_samples(rng, pt.shape[:-2] + pt.shape[-1:])
    return Ciphertext(encrypt_encoded_core(ctx, pk, pt, u, e0, e1),
                      float(scale), 0)


def encrypt(ctx: CkksContext, pk: PublicKey, values: torch.Tensor,
            rng, scale: float | None = None) -> Ciphertext:
    """Public-key encrypt of (chunks, N) f32 values."""
    scale = _scale(ctx, scale)
    u, e0, e1 = _pk_samples(rng, values.shape)
    return Ciphertext(encrypt_core(ctx, pk, values, u, e0, e1, scale),
                      scale, 0)


def encrypt_stacked(ctx: CkksContext, pk: PublicKey, values: torch.Tensor,
                    rng, scale: float | None = None) -> Ciphertext:
    """Public-key analogue of encrypt_symmetric_stacked."""
    if values.dim() != 3:
        raise ValueError(f"expected (K, chunks, N) values, got "
                         f"{tuple(values.shape)}")
    return encrypt(ctx, pk, values, _split_clients(rng, values.shape[0]),
                   scale)


def decrypt_residues(ctx: CkksContext, sk: SecretKey,
                     ct: Ciphertext) -> torch.Tensor:
    """Decrypt to coefficient-order residues (chunks, live, N) int32: the
    phase c0 + c1*s (on the card the decrypt pass of csrc/rlwe_passes.cu,
    on the CPU _phase_plain), then one inverse NTT batch."""
    if ct.data.is_cuda:
        phase = rlwe_passes.decrypt(ctx, sk, ct.data)
    else:
        phase = _phase_plain(ctx, sk, ct.data)
    return ntt_mod.intt(phase, _tables(ctx, ct.live_limbs))


def _phase_plain(ctx: CkksContext, sk: SecretKey,
                 data: torch.Tensor) -> torch.Tensor:
    """c0 + c1*s mod q of data (..., 2, live, N) in int64, as (..., live,
    N) int32; the plain version of the decrypt pass."""
    live = data.shape[-2]
    qb = ctx.q[:live, None]
    c0, c1 = data.unbind(dim=-3)
    return modops.add_mod(
        c0, modops.mul_mod_shoup(c1, sk.s[:live], sk.s_shoup[:live], qb),
        qb).to(torch.int32)


def decrypt(ctx: CkksContext, sk: SecretKey, ct: Ciphertext) -> torch.Tensor:
    """Decrypt to (chunks, N) f32."""
    return encoding.decode_coeff(ctx, decrypt_residues(ctx, sk, ct), ct.scale)


def log2_precision(actual, expected) -> float:
    """Bits of precision of a decrypted result: -log2(max |actual -
    expected|), in f64 (PALISADE's GetLogPrecision)."""
    def f64(x):
        return np.asarray(x.cpu() if torch.is_tensor(x) else x,
                          dtype=np.float64)
    err = float(np.max(np.abs(f64(actual) - f64(expected))))
    return float("inf") if err == 0.0 else -float(np.log2(err))


def add(ctx: CkksContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """EvalAdd: two ciphertexts at the same scale and level."""
    if a.scale != b.scale or a.level != b.level:
        raise ValueError("add: ciphertexts differ in scale or level")
    qb = ctx.q[:a.live_limbs, None]
    return Ciphertext(modops.add_mod(a.data, b.data, qb).to(torch.int32),
                      a.scale, a.level)


def mul_scalar(ctx: CkksContext, ct: Ciphertext, w: float) -> Ciphertext:
    """EvalMult(ct, double): the scale grows by the top prime."""
    live = ct.live_limbs
    ds = _scalar_scale(ctx, ct.level)
    res, shoup = encoding.encode_scalar(ctx.params.moduli[:live], w, ds)
    qb = ctx.q[:live, None]
    dev = ct.data.device
    data = modops.mul_mod_shoup(
        ct.data, torch.as_tensor(res, device=dev)[:, None],
        torch.as_tensor(shoup, device=dev)[:, None], qb)
    return Ciphertext(data.to(torch.int32), ct.scale * ds, ct.level)


def rescale(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    """Drop the top limb and divide the scale by its prime (RNS rescale):
    (c - [c]_{q_t}) * q_t^-1 mod q_j on the remaining limbs."""
    if ct.level >= ctx.params.mult_depth:
        raise ValueError("rescale: no levels left")
    live = ct.live_limbs
    t = live - 1
    lvl = ctx.params.chain_len - live     # level before the rescale
    data = ct.data
    top = ntt_mod.intt(data[..., t:t + 1, :].contiguous(),
                       ctx.tables.slice_limbs(t, t + 1))    # (..., 2, 1, N)
    # The top limb's coefficients are < q_t < 2 q_j: one subtraction.
    qj = ctx.q[:t, None]
    top = top.to(torch.int64)
    delta = torch.where(top >= qj, top - qj, top).to(torch.int32)
    delta_hat = ntt_mod.ntt(delta, ctx.tables.slice_limbs(0, t))
    inv, inv_shoup = ctx.rescale_inv[lvl]
    num = modops.sub_mod(data[..., :t, :], delta_hat, qj)
    out = modops.mul_mod_shoup(num, inv[:, None], inv_shoup[:, None], qj)
    return Ciphertext(out.to(torch.int32), ct.scale / ctx.params.moduli[t],
                      ct.level + 1)


def _scalar_scale(ctx: CkksContext, level: int) -> float:
    """Scalars are encoded at the current top rescale prime."""
    return float(ctx.params.moduli[ctx.params.chain_len - 1 - level])


def modsum_clients(terms: torch.Tensor, qb: torch.Tensor,
                   pow32b: torch.Tensor, pow32b_shoup: torch.Tensor):
    """Modular sum over axis 0 (clients) by 16-bit split accumulation:
    value = lo + hi * 2**16, hi = a * 2**16 + b, so
    value mod q = [lo]_q + [b << 16]_q + a * [2**32]_q."""
    if terms.shape[0] > 65536:
        raise ValueError("modsum_clients takes at most 65536 clients")
    lo = torch.sum(terms & 0xFFFF, dim=0)
    hi = torch.sum(terms >> 16, dim=0)
    a = hi >> 16
    b = hi & 0xFFFF
    r = modops.reduce_u32(lo, qb)
    r = modops.add_mod(r, modops.reduce_u32(b << 16, qb), qb)
    a32 = modops.mul_mod_shoup(a, pow32b, pow32b_shoup, qb)
    return modops.add_mod(r, a32, qb)


def _weighted_sum_impl(ctx: CkksContext, stacked: torch.Tensor,
                       w_res: torch.Tensor, w_shoup: torch.Tensor):
    """stacked: (K, chunks, 2, live, N); w_*: (K, live) int64 tensors.
    The plain version of kernel K3, in both of the JAX package's lowerings:
    an unrolled chain for K <= 8, modsum_clients above."""
    K = stacked.shape[0]
    live = stacked.shape[3]
    qb = ctx.q[:live, None]
    if K <= 8:
        acc = None
        for i in range(K):
            t = modops.mul_mod_shoup(stacked[i], w_res[i, :, None],
                                     w_shoup[i, :, None], qb)
            acc = t if acc is None else modops.add_mod(acc, t, qb)
        return acc.to(torch.int32)
    terms = modops.mul_mod_shoup(stacked, w_res[:, None, None, :, None],
                                 w_shoup[:, None, None, :, None], qb)
    return modsum_clients(terms, qb, ctx.pow32[:live, None],
                          ctx.pow32_shoup[:live, None]).to(torch.int32)


def _encode_weights(ctx: CkksContext, weights, live: int, level: int):
    ds = _scalar_scale(ctx, level)
    res, shoup = zip(*(encoding.encode_scalar(ctx.params.moduli[:live],
                                              float(w), ds) for w in weights))
    return np.stack(res), np.stack(shoup), ds


def _aggregate(ctx: CkksContext, stacked: torch.Tensor, w_res: np.ndarray,
               w_shoup: np.ndarray) -> torch.Tensor:
    live = stacked.shape[3]
    if stacked.is_cuda:
        return pallas_agg.weighted_sum_fused(stacked, pallas_agg.weight_block(
            w_res, w_shoup, ctx.params.moduli[:live]))
    if stacked.device.type != "cpu":
        raise ValueError(f"no weighted-sum backend for {stacked.device}")
    return _weighted_sum_impl(ctx, stacked, torch.as_tensor(w_res),
                              torch.as_tensor(w_shoup))


def weighted_sum(ctx: CkksContext, cts, weights) -> Ciphertext:
    """computeWeightedAverage core: sum_k w_k * ct_k, the scale multiplied
    by the top prime. `cts` is a list of (chunks, 2, live, N) Ciphertexts
    or ONE stacked Ciphertext with data (K, chunks, 2, live, N)."""
    if isinstance(cts, Ciphertext):
        if cts.data.dim() != 5 or cts.data.shape[0] != len(weights):
            raise ValueError("stacked ciphertext must be (K, chunks, 2, live,"
                             " N) with one weight per client")
        scale0, level0, stacked = cts.scale, cts.level, cts.data
    else:
        if len(cts) != len(weights):
            raise ValueError("one weight per ciphertext")
        scale0, level0 = cts[0].scale, cts[0].level
        stacked = torch.stack([c.data for c in cts])
    w_res, w_shoup, ds = _encode_weights(ctx, weights, stacked.shape[3],
                                         level0)
    return Ciphertext(_aggregate(ctx, stacked, w_res, w_shoup),
                      scale0 * ds, level0)


def fedavg_round_fused(ctx: CkksContext, sk: SecretKey, values: torch.Tensor,
                       rng, weights,
                       scale: float | None = None) -> torch.Tensor:
    """One secure-FedAvg round in one call: encrypt all K clients
    (secret-key), weighted sum, decrypt. values (K, chunks, N) f32 ->
    averaged (chunks, N) f32 on the same device."""
    ct = encrypt_symmetric_stacked(ctx, sk, values, rng, scale)
    return decrypt(ctx, sk, weighted_sum(ctx, ct, weights))
