"""RNS key switching: relinearisation and Galois rotations.

The BV-style key switch with one special prime P of
fhe_fed_tpu.ckks.keyswitch, step for step. The switching key from t to s
has one row per ciphertext limb j over the extended basis
{q_0 .. q_{chain-1}, P}:

    evk_j = (b_j, a_j),   b_j = -a_j * s + e_j + delta_j * [P]_{q_j} * t

so the same key works at every level: a ciphertext with `live` limbs uses
the digits j < live and the basis {q_0 .. q_{live-1}, P}. The switch is

    ks(d) = ModDown_P( sum_j NTT(lift([d]_{q_j})) * evk_j )

with a flooring ModDown. Kernels on the path: the NTT (K1 where the ring
has a four-step split, e.g. N = 8192; K2 otherwise, e.g. N = 32768, via
ntt/ntt.py). The digit reduction reuses ops.modsum_clients; the rest is
plain PyTorch in int64.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..rns import modops
from ..ntt import ntt as ntt_mod
from .params import CkksContext, CkksParams
from .keys import SecretKey, uniform_mod_q, cbd_coeffs, lift_signed
from . import ops as ckks_ops

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class KSwitchKey:
    """Digit-indexed RLWE rows in the evaluation domain, each (dnum, L, N):
    row j covers the full modulus list; only limbs {0 .. live-1, P} are
    read. Residues int32, Shoup words int64."""
    b: torch.Tensor
    b_shoup: torch.Tensor
    a: torch.Tensor
    a_shoup: torch.Tensor


@functools.lru_cache(maxsize=None)
def _ks_consts(params: CkksParams):
    """Host int64: [P]_{q_j}, its Shoup words, P^-1 mod q_j, its Shoup
    words, for the chain's limbs."""
    P = params.special_prime
    moduli = params.moduli[:params.chain_len]
    qs = np.array(moduli, dtype=np.int64)
    p_mod = np.array([P % q for q in moduli], dtype=np.int64)
    pinv = np.array([pow(P % q, q - 2, q) for q in moduli], dtype=np.int64)
    return (p_mod, modops.shoup_precompute(p_mod, qs),
            pinv, modops.shoup_precompute(pinv, qs))


def _ext_indices(ctx: CkksContext, live: int) -> np.ndarray:
    """Limb indices of the extended basis {q_0 .. q_{live-1}, P}."""
    return np.array(list(range(live)) + [ctx.num_limbs - 1])


def ks_payload(ctx: CkksContext, target_hat: torch.Tensor) -> torch.Tensor:
    """The gadget payload of a switching key from `target_hat` (..., L, N):
    limb j of row j holds [P]_{q_j} * target, every other limb 0. Returns
    (..., chain, L, N) int64 (int64, so the product with the identity
    pattern cannot wrap)."""
    chain, L = ctx.params.chain_len, ctx.num_limbs
    dev = target_hat.device
    p_mod, p_mod_shoup, _, _ = _ks_consts(ctx.params)
    pt = modops.mul_mod_shoup(
        target_hat[..., :chain, :],
        torch.as_tensor(p_mod, device=dev)[:, None],
        torch.as_tensor(p_mod_shoup, device=dev)[:, None],
        ctx.q[:chain, None])                               # (..., chain, N)
    eye = torch.eye(chain, L, dtype=torch.int64, device=dev)[:, :, None]
    return pt[..., :, None, :] * eye


def make_kswitch_key_core(ctx: CkksContext, sk: SecretKey,
                          target_hat: torch.Tensor, a: torch.Tensor,
                          e_coeffs: torch.Tensor) -> KSwitchKey:
    """Key switching FROM `target_hat` (L, N), eval domain, TO sk, from a
    uniform `a` (chain, L, N) and small errors `e_coeffs` (chain, N)."""
    qb = ctx.q[:, None]
    e_hat = ntt_mod.ntt(lift_signed(e_coeffs, ctx.q), ctx.tables)
    a_s = modops.mul_mod_shoup(a, sk.s[None], sk.s_shoup[None], qb)
    b = modops.add_mod(modops.neg_mod(a_s, qb), e_hat, qb)
    b = modops.add_mod(b, ks_payload(ctx, target_hat), qb).to(_I32)
    a = a.to(_I32)
    return KSwitchKey(b=b, b_shoup=modops.shoup_tensor(b, qb),
                      a=a, a_shoup=modops.shoup_tensor(a, qb))


def make_kswitch_key(ctx: CkksContext, sk: SecretKey, target_hat: torch.Tensor,
                     gen: torch.Generator) -> KSwitchKey:
    """Sample a and e on the generator's device, then the core."""
    n, L, chain = ctx.ring_dim, ctx.num_limbs, ctx.params.chain_len
    a = uniform_mod_q(gen, (chain, L, n), ctx.params.moduli)
    e = cbd_coeffs(gen, (chain, n))
    return make_kswitch_key_core(ctx, sk, target_hat, a, e)


def make_relin_key(ctx: CkksContext, sk: SecretKey,
                   gen: torch.Generator) -> KSwitchKey:
    """EvalMultKeyGen: the key for s**2 -> s."""
    s2 = modops.mul_mod_shoup(sk.s, sk.s, sk.s_shoup, ctx.q[:, None])
    return make_kswitch_key(ctx, sk, s2, gen)


def key_switch(ctx: CkksContext, d: torch.Tensor, ksk: KSwitchKey):
    """Switch the polynomials d (..., live, N), eval domain, to sk.
    Returns (ks0, ks1), each (..., live, N) int64, ModDown applied."""
    live = d.shape[-2]
    idx = _ext_indices(ctx, live)
    ti = torch.as_tensor(idx, device=d.device)
    q_ext = ctx.q[ti][:, None]                             # (ext, 1)

    # 1. To the coefficient domain: the digits [d]_{q_j}.
    c = ntt_mod.intt(d.to(_I32).contiguous(),
                     ctx.tables.slice_limbs(0, live)).to(torch.int64)
    # 2. Lift each digit to the extended basis: one conditional subtraction
    #    (every prime is 31-bit, so x < q_j < 2 q_i).
    x = c[..., :, None, :]                                 # (..., dig, 1, N)
    x = torch.where(x >= q_ext, x - q_ext, x).to(_I32)     # (..., dig, ext, N)
    # 3. Forward NTT over the extended basis.
    x_hat = ntt_mod.ntt(x, ctx.tables.take(idx))
    # 4. Multiply by the key rows and reduce over the digit axis.
    pow32 = ctx.pow32[ti][:, None]
    pow32_sh = ctx.pow32_shoup[ti][:, None]

    def digit_reduce(rows, rows_shoup):
        sel = rows[:live].index_select(1, ti)              # (dig, ext, N)
        sel_sh = rows_shoup[:live].index_select(1, ti)
        terms = modops.mul_mod_shoup(x_hat, sel, sel_sh, q_ext)
        terms = torch.movedim(terms, -3, 0)                # (dig, ..., ext, N)
        return ckks_ops.modsum_clients(terms, q_ext, pow32, pow32_sh)

    u0 = digit_reduce(ksk.b, ksk.b_shoup)                  # (..., ext, N)
    u1 = digit_reduce(ksk.a, ksk.a_shoup)
    # 5. ModDown by P.
    return _mod_down(ctx, u0, live), _mod_down(ctx, u1, live)


def _mod_down(ctx: CkksContext, u: torch.Tensor, live: int) -> torch.Tensor:
    """Floor-divide by the special prime: (u - [u]_P) * P^-1 mod q_i."""
    L = ctx.num_limbs
    dev = u.device
    _, _, pinv, pinv_shoup = _ks_consts(ctx.params)
    up = ntt_mod.intt(u[..., -1:, :].to(_I32).contiguous(),
                      ctx.tables.slice_limbs(L - 1, L)).to(torch.int64)
    qb = ctx.q[:live, None]
    delta = torch.where(up >= qb, up - qb, up).to(_I32)   # (..., live, N)
    delta_hat = ntt_mod.ntt(delta, ctx.tables.slice_limbs(0, live))
    diff = modops.sub_mod(u[..., :live, :], delta_hat, qb)
    return modops.mul_mod_shoup(
        diff, torch.as_tensor(pinv[:live], device=dev)[:, None],
        torch.as_tensor(pinv_shoup[:live], device=dev)[:, None], qb)


# ---------------------------------------------------------------------------
# ct x ct multiplication + relinearisation
# ---------------------------------------------------------------------------

def mul_ct(ctx: CkksContext, a: ckks_ops.Ciphertext, b: ckks_ops.Ciphertext,
           rlk: KSwitchKey) -> ckks_ops.Ciphertext:
    """EvalMult(ct, ct) + Relinearize on (..., 2, live, N) ciphertexts; the
    caller typically rescales afterwards."""
    if a.level != b.level or a.live_limbs != b.live_limbs:
        raise ValueError("mul_ct: ciphertexts differ in level or limbs")
    qb = ctx.q[:a.live_limbs, None]
    a0, a1 = a.data.unbind(dim=-3)
    b0, b1 = b.data.unbind(dim=-3)
    d0 = modops.mul_mod(a0, b0, qb)
    d1 = modops.add_mod(modops.mul_mod(a0, b1, qb),
                        modops.mul_mod(a1, b0, qb), qb)
    d2 = modops.mul_mod(a1, b1, qb)
    ks0, ks1 = key_switch(ctx, d2, rlk)
    data = torch.stack([modops.add_mod(d0, ks0, qb),
                        modops.add_mod(d1, ks1, qb)], dim=-3).to(_I32)
    return ckks_ops.Ciphertext(data, a.scale * b.scale, a.level)


# ---------------------------------------------------------------------------
# Galois automorphisms / rotations
# ---------------------------------------------------------------------------

def _bitrev(x: np.ndarray, bits: int) -> np.ndarray:
    r = np.zeros_like(x)
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x = x >> 1
    return r


@functools.lru_cache(maxsize=None)
def _auto_perm(n: int, g: int) -> np.ndarray:
    """Eval-domain permutation of the automorphism X -> X**g: eval slot k
    (bit-reversed order) holds m(psi**(2*brv(k)+1)) and goes to the slot of
    exponent (2*brv(k)+1)*g; out[k] = in[perm[k]]. The JAX package's loop,
    vectorised."""
    bits = n.bit_length() - 1
    k = np.arange(n, dtype=np.int64)
    e = (2 * _bitrev(k, bits) + 1) * g % (2 * n)
    return _bitrev((e - 1) // 2, bits).astype(np.int32)


def galois_element(r: int, n: int) -> int:
    """Galois element of a rotation by r slots."""
    return pow(5, r, 2 * n)


def conj_element(n: int) -> int:
    return 2 * n - 1


def automorphism(data: torch.Tensor, n: int, g: int) -> torch.Tensor:
    """X -> X**g on eval-domain data (..., N): a slot gather."""
    perm = torch.as_tensor(_auto_perm(n, g), dtype=torch.int64,
                           device=data.device)
    return data.index_select(-1, perm)


def make_galois_key(ctx: CkksContext, sk: SecretKey, g: int,
                    gen: torch.Generator) -> KSwitchKey:
    """EvalAtIndexKeyGen for one Galois element g."""
    return make_kswitch_key(ctx, sk, automorphism(sk.s, ctx.ring_dim, g), gen)


def apply_galois(ctx: CkksContext, ct: ckks_ops.Ciphertext, g: int,
                 gk: KSwitchKey) -> ckks_ops.Ciphertext:
    """X -> X**g on a ciphertext, switched back to sk."""
    qb = ctx.q[:ct.live_limbs, None]
    n = ctx.ring_dim
    c0, c1 = ct.data.unbind(dim=-3)
    c0 = automorphism(c0, n, g)
    ks0, ks1 = key_switch(ctx, automorphism(c1, n, g), gk)
    data = torch.stack([modops.add_mod(c0, ks0, qb), ks1], dim=-3).to(_I32)
    return ckks_ops.Ciphertext(data, ct.scale, ct.level)


def rotate(ctx: CkksContext, ct: ckks_ops.Ciphertext, r: int,
           gk: KSwitchKey) -> ckks_ops.Ciphertext:
    """Rotate packed slots by r positions (EvalAtIndex)."""
    return apply_galois(ctx, ct, galois_element(r, ctx.ring_dim), gk)


def eval_sum(ctx: CkksContext, ct: ckks_ops.Ciphertext,
             gks: dict[int, KSwitchKey], width: int) -> ckks_ops.Ciphertext:
    """Sum over `width` packed slots by log2(width) rotations (EvalSum);
    gks: {r: Galois key of the rotation by r} for r = 1, 2, 4 .. width/2."""
    if width < 1 or width & (width - 1):
        raise ValueError(f"width {width} must be a power of two")
    out = ct
    r = 1
    while r < width:
        out = ckks_ops.add(ctx, out, rotate(ctx, out, r, gks[r]))
        r <<= 1
    return out
