"""Key containers, samplers and key generation.

Keys live in the NTT (evaluation) domain with their Shoup companion words:
residues int32, companions int64 (rns/modops.py). Every sampler draws from
an explicit torch.Generator, on the generator's device. The streams differ
from the JAX package's threefry streams; the distributions are the same.
`keygen` is a sampling step followed by the deterministic `keygen_core`,
which takes the samples as arguments, so the core can be held bit-exact
against fhe_fed_tpu.ckks.keys.keygen fed the same samples. Keys can also be
loaded (ckks/serial.py) or carried over from the JAX package (interop.py).
"""

from __future__ import annotations

import dataclasses

import torch

from ..rns import modops
from ..ntt import ntt as ntt_mod
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
    return (_popcount20(a) - _popcount20(b)).to(torch.int32)


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


def keygen(ctx: CkksContext, gen: torch.Generator
           ) -> tuple[SecretKey, PublicKey]:
    """Generate (sk, pk) on the generator's device (cc->KeyGen())."""
    n, L = ctx.ring_dim, ctx.num_limbs
    s = ternary_coeffs(gen, (n,))
    a = uniform_mod_q(gen, (L, n), ctx.params.moduli)
    e = cbd_coeffs(gen, (n,))
    return keygen_core(ctx, s, a, e)
