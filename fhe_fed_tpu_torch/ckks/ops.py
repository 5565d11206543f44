"""CKKS operations of the encrypted FedAvg round, batched over chunks.

A ciphertext is int32 residues (..., chunks, 2, live, N) in the evaluation
domain (bit-reversed order), as in fhe_fed_tpu.ckks.ops. Each encrypt is a
sampling step (from an explicit torch.Generator) followed by a
deterministic core that takes the samples as arguments, so the cores can be
held bit-exact against the JAX package's own pieces.

Kernels on the path: the NTT (K1, via ntt/ntt.py) in encrypt and decrypt,
the weighted sum (K3, ckks/pallas_agg.py) and the decode (K4, via
encoding.decode_coeff). The glue between them is plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..rns import modops
from ..ntt import ntt as ntt_mod
from . import encoding, pallas_agg
from .params import CkksContext
from .keys import (SecretKey, PublicKey, uniform_mod_q, ternary_coeffs,
                   cbd_coeffs, lift_signed)


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    """RLWE ciphertext batch in the evaluation domain."""
    data: torch.Tensor        # (chunks, 2, live, N) or (K, chunks, 2, live, N)
    scale: float
    level: int

    @property
    def live_limbs(self) -> int:
        return int(self.data.shape[-2])


def _scale(ctx: CkksContext, scale: float | None) -> float:
    return float(ctx.params.scale if scale is None else scale)


def _tables(ctx: CkksContext, live: int):
    return None if ctx.mxu is None else ctx.mxu.slice_limbs(0, live)


def encrypt_symmetric_core(ctx: CkksContext, sk: SecretKey,
                           values: torch.Tensor, a_hat: torch.Tensor,
                           e: torch.Tensor, scale: float) -> torch.Tensor:
    """Secret-key RLWE: ct = (a*s + NTT(m + e), -a), with `a_hat` (..., L, N)
    uniform in the evaluation domain and `e` (..., N) small signed error.
    values (..., N) f32 -> data (..., 2, L, N) int32. One NTT batch."""
    L = ctx.params.chain_len
    qb = ctx.q[:L, None]
    pt = encoding.encode_coeff(ctx, values, scale)
    w = modops.add_mod(pt, lift_signed(e, ctx.q[:L]), qb).to(torch.int32)
    w_hat = ntt_mod.ntt(w, _tables(ctx, L))
    c0 = modops.add_mod(
        modops.mul_mod_shoup(a_hat, sk.s[:L], sk.s_shoup[:L], qb), w_hat, qb)
    c1 = modops.neg_mod(a_hat, qb)
    return torch.stack([c0, c1], dim=-3).to(torch.int32)


def encrypt_symmetric(ctx: CkksContext, sk: SecretKey, values: torch.Tensor,
                      gen: torch.Generator,
                      scale: float | None = None) -> Ciphertext:
    """Secret-key encrypt of (chunks, N) f32 values."""
    scale = _scale(ctx, scale)
    *lead, n = values.shape
    a_hat = uniform_mod_q(gen, (*lead, ctx.params.chain_len, n),
                          ctx.params.moduli)
    e = cbd_coeffs(gen, (*lead, n))
    return Ciphertext(encrypt_symmetric_core(ctx, sk, values, a_hat, e, scale),
                      scale, 0)


def encrypt_symmetric_stacked(ctx: CkksContext, sk: SecretKey,
                              values: torch.Tensor, gen: torch.Generator,
                              scale: float | None = None) -> Ciphertext:
    """Encrypt a whole cohort: values (K, chunks, N) -> data
    (K, chunks, 2, L, N), one NTT batch for all K clients."""
    if values.dim() != 3:
        raise ValueError(f"expected (K, chunks, N) values, got "
                         f"{tuple(values.shape)}")
    return encrypt_symmetric(ctx, sk, values, gen, scale)


def encrypt_core(ctx: CkksContext, pk: PublicKey, values: torch.Tensor,
                 u: torch.Tensor, e0: torch.Tensor, e1: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Public-key RLWE: (b*u + e0 + m, a*u + e1) in the evaluation domain,
    for ternary `u` and errors `e0`, `e1` of shape (..., N). The four
    transforms (m, u, e0, e1) run as ONE NTT batch."""
    L = ctx.params.chain_len
    q = ctx.q[:L]
    qb = q[:, None]
    pt = encoding.encode_coeff(ctx, values, scale)
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


def encrypt(ctx: CkksContext, pk: PublicKey, values: torch.Tensor,
            gen: torch.Generator, scale: float | None = None) -> Ciphertext:
    """Public-key encrypt of (chunks, N) f32 values."""
    scale = _scale(ctx, scale)
    shape = values.shape
    u = ternary_coeffs(gen, shape)
    e0 = cbd_coeffs(gen, shape)
    e1 = cbd_coeffs(gen, shape)
    return Ciphertext(encrypt_core(ctx, pk, values, u, e0, e1, scale),
                      scale, 0)


def encrypt_stacked(ctx: CkksContext, pk: PublicKey, values: torch.Tensor,
                    gen: torch.Generator,
                    scale: float | None = None) -> Ciphertext:
    """Public-key analogue of encrypt_symmetric_stacked."""
    if values.dim() != 3:
        raise ValueError(f"expected (K, chunks, N) values, got "
                         f"{tuple(values.shape)}")
    return encrypt(ctx, pk, values, gen, scale)


def decrypt_residues(ctx: CkksContext, sk: SecretKey,
                     ct: Ciphertext) -> torch.Tensor:
    """Decrypt to coefficient-order residues (chunks, live, N) int32."""
    live = ct.live_limbs
    qb = ctx.q[:live, None]
    c0, c1 = ct.data.unbind(dim=-3)
    phase = modops.add_mod(
        c0, modops.mul_mod_shoup(c1, sk.s[:live], sk.s_shoup[:live], qb), qb)
    return ntt_mod.intt(phase.to(torch.int32), _tables(ctx, live))


def decrypt(ctx: CkksContext, sk: SecretKey, ct: Ciphertext) -> torch.Tensor:
    """Decrypt to (chunks, N) f32."""
    return encoding.decode_coeff(ctx, decrypt_residues(ctx, sk, ct), ct.scale)


def _scalar_scale(ctx: CkksContext, level: int) -> float:
    """Scalars are encoded at the current top rescale prime."""
    return float(ctx.params.moduli[ctx.params.chain_len - 1 - level])


def _mod_u32(x: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Reduce a value < 2**32 mod q for q > 2**30 (<= 3 subtractions)."""
    x = torch.where(x >= 2 * qb, x - 2 * qb, x)
    x = torch.where(x >= qb, x - qb, x)
    return torch.where(x >= qb, x - qb, x)


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
    r = _mod_u32(lo, qb)
    r = modops.add_mod(r, _mod_u32(b << 16, qb), qb)
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
        return pallas_agg.weighted_sum_fused(stacked, w_res, w_shoup,
                                             ctx.params.moduli[:live])
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
                       gen: torch.Generator, weights,
                       scale: float | None = None) -> torch.Tensor:
    """One secure-FedAvg round in one call: encrypt all K clients
    (secret-key), weighted sum, decrypt. values (K, chunks, N) f32 ->
    averaged (chunks, N) f32 on the same device."""
    ct = encrypt_symmetric_stacked(ctx, sk, values, gen, scale)
    return decrypt(ctx, sk, weighted_sum(ctx, ct, weights))
