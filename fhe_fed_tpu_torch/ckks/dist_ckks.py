"""The CKKS FedAvg round under ('limb', 'coeff') mesh sharding: the
counterpart of fhe_fed_tpu/ckks/dist_ckks.py on torch.distributed.

encrypt -> fused weighted sum -> rescale -> decrypt, every step on the
rank's block of the four-step layout of ntt/dist.py. A distributed
ciphertext is int32 (..., 2, L, N1, N2):

  * coefficient domain: n = N2*n1 + n2, n2 sharded over 'coeff';
  * evaluation domain: the dist-eval order (position (r, c) holds the
    evaluation at psi^(2k+1), k = rev(r) + N1*rev(c)), r sharded over
    'coeff';
  * the limb axis sharded over 'limb' as well when the spec names it;
    every step here but the rescale and the CRT decode is limb-local.

Collectives per round, explicit where GSPMD inserts them in JAX: ONE
all_to_all per NTT / iNTT (the stage exchange, ntt/dist._reshard); in
rescale_dist one all_gather of the limbs over 'limb' (the top limb must
reach every limb rank, and t = live - 1 limbs never divide a limb axis
that live divides unless it has one rank: the rescaled ciphertext keeps
every limb on every rank); in decrypt_dist an all_gather of the limbs
before the CRT decode, when they are sharded. Keys are whole on every
rank in the dist-eval layout (sk_to_dist) and each step takes its block.

Random draws are the JAX package's global draws (at the global shape)
cut to the rank's block, so ciphertexts are its bit for bit.

Equivalence contract (tested): a distributed ciphertext converted to the
on-chip layout (ct_dist_to_onchip) is a valid on-chip ciphertext, and the
weighted sum, rescale and decrypt commute with the conversion bit-exactly.

Kernels: K3 serves weighted_sum_dist on a CUDA tensor (over the flattened
N1*N2 axis) and K4 the decode; the dist transforms are plain torch, as in
JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..rns import modops
from ..ntt import dist as D
from ..parallel.multihost import axis_coord, block
from ..utils import threefry
from . import encoding, ops, pallas_agg
from .keys import SecretKey, cbd_coeffs_tf, lift_signed
from .params import CkksContext

_I32 = torch.int32


# ---------------------------------------------------------------------------
# Key / layout conversion
# ---------------------------------------------------------------------------

def sk_to_dist(sk: SecretKey, n1: int) -> SecretKey:
    """Secret key (eval domain, on-chip order) -> dist-eval layout
    (L, N1, N2). The Shoup companions are per element, so they permute."""
    return SecretKey(s=D.eval_to_dist(sk.s, n1),
                     s_shoup=D.eval_to_dist(sk.s_shoup, n1))


def ct_dist_to_onchip(data_dist):
    """Distributed ct (..., 2, L, N1, N2) -> on-chip ct (..., 2, L, N)."""
    return D.dist_to_eval(data_dist)


def _key_block(sk_d: SecretKey, ds: D.DistSpec, live: int):
    """The rank's eval-layout block of the first `live` key limbs."""
    return (D.row_block(sk_d.s[:live], ds),
            D.row_block(sk_d.s_shoup[:live], ds))


# ---------------------------------------------------------------------------
# Sharded primitives
# ---------------------------------------------------------------------------

def _uniform_mod_q_dist(key: torch.Tensor, shape, q, pow32, pow32_shoup
                        ) -> torch.Tensor:
    """Uniform residues in [0, q_l) at the global shape (..., L, N1, N2),
    int64: (hi * 2**32 + lo) mod q as the JAX function. hi is brought
    below q first (modops.reduce_u32): the int64 Shoup multiply is exact
    only below 2**31, and the result is the canonical residue JAX's u32
    multiply gives for the full word."""
    q3 = q[:, None, None]
    k1, k2 = threefry.split(key).unbind(-2)
    hi = modops.reduce_u32(threefry.bits(k1, shape), q3)
    lo = modops.reduce_u32(threefry.bits(k2, shape), q3)
    return modops.add_mod(
        modops.mul_mod_shoup(hi, pow32[:, None, None],
                             pow32_shoup[:, None, None], q3), lo, q3)


def encrypt_symmetric_dist(ctx: CkksContext, dt: D.DistNttTables,
                           ds: D.DistSpec, sk_d: SecretKey,
                           values: torch.Tensor, rng_key: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Secret-key encrypt of the rank's coefficient-layout block of values
    (chunks, N1, N2_loc) f32 -> its block of the dist ct (chunks, 2, L_loc,
    N1_loc, N2) int32.

    ops.encrypt_symmetric's construction (ct = (a*s + [m+e]^, -a), ONE
    forward transform), with `a` drawn directly in the dist-eval layout:
    k_a, k_e = split(key); e = cbd(k_e, (chunks, N1, N2)); a from k_a at
    (chunks, L, N1, N2)."""
    chunks, n1, _ = values.shape
    n2 = dt.n2
    L = ctx.params.chain_len
    lim = ds.limbs(L)
    q = ctx.q[lim]
    q3 = q[:, None, None]
    # encode_coeff / lift_signed put the limb axis at -2 of a (..., n2)
    # trailing layout; move it to the dist position.
    pt = encoding.encode_coeff(ctx, values, scale).movedim(-2, -3)[:, lim]
    k_a, k_e = threefry.split(rng_key).unbind(-2)
    e = D.col_block(cbd_coeffs_tf(k_e, (chunks, n1, n2)), ds, limbs=False)
    e = lift_signed(e, q).movedim(-2, -3)
    w_hat = D.dist_ntt(modops.add_mod(pt, e, q3), dt, ds)
    a_hat = D.row_block(_uniform_mod_q_dist(
        k_a, (chunks, L, n1, n2), ctx.q[:L], ctx.pow32[:L],
        ctx.pow32_shoup[:L]), ds)
    s, s_sh = _key_block(sk_d, ds, L)
    c0 = modops.add_mod(modops.mul_mod_shoup(a_hat, s, s_sh, q3), w_hat, q3)
    c1 = modops.neg_mod(a_hat, q3)
    return torch.stack([c0, c1], dim=1).to(_I32)


def weighted_sum_dist(ctx: CkksContext, stacked: torch.Tensor, w_res,
                      w_shoup, ds: D.DistSpec = D.DistSpec()
                      ) -> torch.Tensor:
    """stacked: the rank's (K, chunks, 2, live_loc, N1_loc, N2) block;
    w_* (K, live) for the global limbs (numpy int64). The fused FedAvg
    fan-in in the dist layout: on a CUDA tensor K3 over the flattened
    N1*N2 axis, on the CPU the JAX function's unrolled chain."""
    K, chunks, _, live_loc, r, c = stacked.shape
    lim = ds.limbs(live_loc * axis_coord(ds.mesh, ds.limb_axis)[1])
    w_res = np.asarray(w_res)[:, lim]
    w_shoup = np.asarray(w_shoup)[:, lim]
    if stacked.is_cuda:
        flat = stacked.reshape(K, chunks, 2, live_loc, r * c).contiguous()
        out = pallas_agg.weighted_sum_fused(flat, pallas_agg.weight_block(
            w_res, w_shoup, ctx.params.moduli[lim]))
        return out.reshape(chunks, 2, live_loc, r, c)
    if stacked.device.type != "cpu":
        raise ValueError(f"no weighted-sum backend for {stacked.device}")
    qb = ctx.q[lim, None, None]
    acc = None
    for i in range(K):
        wr = torch.as_tensor(w_res[i])[:, None, None]
        ws = torch.as_tensor(w_shoup[i])[:, None, None]
        t = modops.mul_mod_shoup(stacked[i], wr, ws, qb)
        acc = t if acc is None else modops.add_mod(acc, t, qb)
    return acc.to(_I32)


def rescale_dist(ctx: CkksContext, dt: D.DistNttTables, ds: D.DistSpec,
                 data: torch.Tensor) -> torch.Tensor:
    """RNS rescale of the rank's eval-layout block (..., live_loc, N1_loc,
    N2): iNTT the top limb (sharded over coeff), reduce it mod the
    remaining primes, NTT back, subtract, multiply by q_t^-1; ops.rescale
    exactly. The limbs are first gathered over 'limb', and the result
    (..., live - 1, N1_loc, N2) holds every limb on every rank: pass
    ds.without_limbs() to what follows."""
    full = D.gather_axis(data, ds.mesh, ds.limb_axis, -3)
    ds_nl = ds.without_limbs()
    live = full.shape[-3]
    t = live - 1
    lvl = ctx.params.chain_len - live
    qt_poly = D.dist_intt(full[..., t:t + 1, :, :].contiguous(),
                          dt.slice_limbs(t, t + 1), ds_nl)
    qj = ctx.q[:t, None, None]
    qt_poly = qt_poly.to(torch.int64)
    delta = torch.where(qt_poly >= qj, qt_poly - qj, qt_poly)
    delta_hat = D.dist_ntt(delta, dt.slice_limbs(0, t), ds_nl)
    inv, inv_shoup = ctx.rescale_inv[lvl]
    num = modops.sub_mod(full[..., :t, :, :], delta_hat, qj)
    return modops.mul_mod_shoup(num, inv[:, None, None],
                                inv_shoup[:, None, None], qj).to(_I32)


def _coeff_rows(ctx: CkksContext, dt: D.DistNttTables, ds: D.DistSpec,
                sk_d: SecretKey, data: torch.Tensor) -> torch.Tensor:
    """decrypt_dist's residues before the decode: (chunks * N1, live,
    N2_loc) int32, every limb of each coefficient together."""
    live = data.shape[-3] * axis_coord(ds.mesh, ds.limb_axis)[1]
    q3 = ctx.q[ds.limbs(live), None, None]
    s, s_sh = _key_block(sk_d, ds, live)
    phase = modops.add_mod(data[:, 0],
                           modops.mul_mod_shoup(data[:, 1], s, s_sh, q3), q3)
    coeffs = D.dist_intt(phase, dt.slice_limbs(0, live), ds)
    coeffs = D.gather_axis(coeffs, ds.mesh, ds.limb_axis, -3)
    chunks, _, n1, n2_loc = coeffs.shape
    return coeffs.movedim(-3, -2).reshape(chunks * n1, live,
                                          n2_loc).contiguous()


def decrypt_dist(ctx: CkksContext, dt: D.DistNttTables, ds: D.DistSpec,
                 sk_d: SecretKey, data: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """The rank's block of a dist ct (chunks, 2, live_loc, N1_loc, N2),
    laid out as `ds` says -> its coefficient-layout block of the decoded
    values (chunks, N1, N2_loc) f32.

    The phase and the inverse transform stay sharded; the CRT decode needs
    all limbs of a coefficient together, so sharded limbs are gathered
    over 'limb' (the one intrinsically cross-limb step of the round) while
    the coefficient axis stays sharded. The decode runs on (chunks*N1,
    live, N2_loc): K4 on a CUDA tensor."""
    rows = _coeff_rows(ctx, dt, ds, sk_d, data)
    out = encoding.decode_coeff(ctx, rows, scale)
    return out.reshape(data.shape[0], -1, rows.shape[-1])


# ---------------------------------------------------------------------------
# Galois automorphism (rotation data movement) under coefficient sharding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dist_auto_perms(n: int, n1: int, g: int) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """Index maps of X -> X^g in the dist-eval layout (r, c).

    Position (r, c) holds the evaluation at psi^(2k+1), k = rev1(r) +
    N1*rev2(c). The automorphism pulls from slot k_src = g*k + (g-1)/2 mod
    N, which separates over the layout:

        k1_src = (g*k1 + t) mod N1            -- depends on the ROW only
        k2_src = (g*k2 + carry(k1)) mod N2    -- column map, row-dependent

    so the data movement is ONE permutation of the (sharded) row axis plus
    a LOCAL row-dependent column gather. Returns (row_perm (N1,), col_perm
    (N1, N2)) with out[r, c] = in[row_perm[r], col_perm[r, c]]."""
    from ..ntt.tables import _bitrev_perm
    n2 = n // n1
    rev1, rev2 = _bitrev_perm(n1), _bitrev_perm(n2)
    t = (g - 1) // 2 % n
    k = rev1[:, None] + n1 * rev2[None, :]
    k_src = (g * k + t) % n
    rows = rev1[k_src % n1]
    if not (rows == rows[:, :1]).all():
        raise AssertionError("the row map of X -> X^g depends on the column")
    return rows[:, 0].astype(np.int64), rev2[k_src // n1].astype(np.int64)


def dist_automorphism(x: torch.Tensor, g: int, dt: D.DistNttTables,
                      ds: D.DistSpec) -> torch.Tensor:
    """X -> X^g on the rank's eval-layout block (..., L_loc, N1_loc, N2).

    The row permutation crosses the sharded axis: the rows are gathered
    over 'coeff' (one all_gather, the rotation's only cross-device data
    movement; the key switch is coefficient-wise per limb in the eval
    domain), then the rank takes its rows and gathers its columns
    locally."""
    row_perm, col_perm = _dist_auto_perms(dt.ring_dim, dt.n1, int(g))
    rows = block(*ds.coeff(), dt.n1)
    full = D.gather_axis(x, ds.mesh, ds.coeff_axis, -2)
    dev = x.device
    y = full.index_select(-2, torch.as_tensor(row_perm[rows], device=dev))
    idx = torch.as_tensor(col_perm[rows], device=dev).expand(y.shape)
    return torch.gather(y, -1, idx)


# ---------------------------------------------------------------------------
# The full round
# ---------------------------------------------------------------------------

def make_dist_fed_step(ctx: CkksContext, dt: D.DistNttTables,
                       ds: D.DistSpec, weights: list[float]):
    """A sharded secure-FedAvg round:

        step(sk_d, values (K, chunks, N1, N2_loc) f32, rng_key)
            -> the rank's (chunks, N1, N2_loc) f32 block of the average

    encrypt (all K clients folded into the chunk axis, one key) -> fused
    weighted sum -> rescale -> decrypt, all in the ('limb', 'coeff')
    layout."""
    K = len(weights)
    chain = ctx.params.chain_len
    dscale = float(ctx.params.moduli[chain - 1])
    w_res, w_shoup, _ = ops._encode_weights(ctx, weights, chain, 0)
    enc_scale = float(ctx.params.scale)
    out_scale = enc_scale * dscale / float(ctx.params.moduli[chain - 1])

    def step(sk_d: SecretKey, values: torch.Tensor, rng_key: torch.Tensor
             ) -> torch.Tensor:
        if values.shape[0] != K:
            raise ValueError(f"{values.shape[0]} clients for {K} weights")
        flat = values.reshape(-1, *values.shape[2:])
        cts = encrypt_symmetric_dist(ctx, dt, ds, sk_d, flat, rng_key,
                                     enc_scale)
        stacked = cts.reshape(K, -1, *cts.shape[1:])
        agg = weighted_sum_dist(ctx, stacked, w_res, w_shoup, ds)
        agg = rescale_dist(ctx, dt, ds, agg)
        return decrypt_dist(ctx, dt, ds.without_limbs(), sk_d, agg,
                            out_scale)

    return step
