"""Threshold (N-of-N multiparty) CKKS, as fhe_fed_tpu.ckks.threshold.

The joint secret is additive, s = sum_i s_i, with one COMMON uniform `a`,
so the joint public key is pk = (b, a), b = sum_i (-a * s_i + e_i), built
as a chain: party i adds -a*s_i + e_i to party i-1's b. Decryption is one
round: the lead party publishes c0 + s_0*c1 + e_sm, every other party
s_i*c1 + e_sm, and fusion is a modular sum followed by the INTT and the
decode. `e_sm` is smudging noise, much wider than the encryption noise, so
that a partial decryption shows nothing of s_i beyond the plaintext.

Joint Galois keys take one additive round over common rows a_j (a public
seed); the joint relinearisation key takes two (round 1: a switch key for
the joint s with payload P*s_i; round 2: each party multiplies both rows
of the combined round-1 key by s_i and adds fresh noise; the sum is a key
for s**2 -> s).

Random streams are keys (utils/prng.py): every ceremony stream is
fold_in(fold_in(root, tag), party), and every split follows the JAX
function of the same name, so a seed gives the JAX package's residues bit
for bit. An int root seed and the public common seed are threefry keys,
as `jax.random.key(seed)` is on any device; a caller's key (the helper's
session key, a decryption's smudging keys) may be rbg, whose streams then
follow it (keys.*_key), bit for bit with JAX's rbg. Where the JAX
package vmaps a draw over the parties (the smudging of the stacked
partial decryptions, the partial-Galois noise), the port draws under JAX's
batching rule: under rbg every party's noise comes from the first party's
key (prng.batch_rule); where it loops over the parties, each party draws
its own stream. The per-party functions are the protocol (what
each party computes and publishes); the batched ceremonies compute the
same residues with the party axis stacked: one NTT batch and one Shoup
multiply over all parties, Shoup companions computed on the device.

Kernels on the path: the NTT (K1 / K2 via ntt/ntt.py) for key and smudging
noise and the fusion INTT, the weighted sum (K3, via ops._aggregate) in
threshold_round_fused, the decode (K4, via encoding.decode_coeff).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..rns import modops
from ..ntt import ntt as ntt_mod
from ..utils import prng, threefry
from .params import CkksContext
from .keys import (SecretKey, PublicKey, uniform_mod_q_tf, uniform_mod_q_key,
                   ternary_coeffs_key, cbd_coeffs_key, lift_signed)
from . import encoding
from . import ops as ckks_ops
from . import keyswitch as ks_mod

_I32 = torch.int32

# Smudging noise: centered binomial of variance 2**_SMUDGE_BITS / 2 per
# coefficient (~2**20 >> the encryption noise), as the JAX package.
_SMUDGE_BITS = 40

# Domain tags of the per-party streams fold_in(fold_in(root, tag), party).
_TAG_SECRET, _TAG_PK_A, _TAG_PK_NOISE = 0, 1, 2
_TAG_RELIN_R1, _TAG_RELIN_R2 = 3, 4


def _root_key(seed, device) -> torch.Tensor:
    """An int seed (tests, benchmarks) -> threefry key(seed) on `device`; a
    key tensor (2,) or (4,) keeps all its bits and its implementation.
    Single-process keygen is a simulation either way: a deployment runs the
    per-party functions on separate machines, so no process holds more
    than one share."""
    if isinstance(seed, (int, np.integer)):
        return threefry.key(seed, device)
    return seed.to(device)


def _stream(root: torch.Tensor, tag: int, i: int) -> torch.Tensor:
    return prng.fold_in(prng.fold_in(root, tag), i)


def _streams(root: torch.Tensor, tag: int, n: int) -> torch.Tensor:
    """The streams of parties 0 .. n-1 as one key batch (n, W)."""
    return torch.stack([_stream(root, tag, i) for i in range(n)])


def _noise_hat(ctx: CkksContext, keys: torch.Tensor, shape, *,
               vmap: bool) -> torch.Tensor:
    """NTT(lift(cbd(key, shape))) over all L limbs: (*keys batch, *shape[:-1],
    L, N), one NTT batch; `vmap` as keys.cbd_coeffs_key."""
    return ntt_mod.ntt(lift_signed(cbd_coeffs_key(keys, shape, vmap=vmap),
                                   ctx.q), ctx.tables)


def _shoup(ctx: CkksContext, w: torch.Tensor) -> torch.Tensor:
    """Shoup companions of residues (..., L_live, N), on their device."""
    return modops.shoup_tensor(w, ctx.q[:w.shape[-2], None])


def _sum_parties(x: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Modular sum over the leading party axis, in party order."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = modops.add_mod(acc, x[i], qb)
    return acc


def _common_rows(ctx: CkksContext, common_seed: int) -> torch.Tensor:
    """The common rows a_j (chain, L, N) from the public seed."""
    return uniform_mod_q_tf(
        threefry.key(common_seed, ctx.device),
        (ctx.params.chain_len, ctx.num_limbs, ctx.ring_dim),
        ctx.params.moduli)


# ---------------------------------------------------------------------------
# Keygen: the chained MultipartyKeyGen
# ---------------------------------------------------------------------------

def party_secret(ctx: CkksContext, rng_key: torch.Tensor) -> SecretKey:
    """One party's additive share s_i (ternary, all limbs)."""
    s_hat = ntt_mod.ntt(
        lift_signed(ternary_coeffs_key(rng_key, (ctx.ring_dim,),
                                       vmap=False), ctx.q),
        ctx.tables)
    return SecretKey(s=s_hat, s_shoup=_shoup(ctx, s_hat))


def init_public_key(ctx: CkksContext, sk: SecretKey,
                    rng_key: torch.Tensor) -> PublicKey:
    """Party 0: pk_0 = (-a*s_0 + e_0, a)."""
    k_a, k_e = prng.split(rng_key).unbind(-2)
    a = uniform_mod_q_key(k_a, (ctx.num_limbs, ctx.ring_dim),
                          ctx.params.moduli, vmap=False)
    return _extend(ctx, a, None, sk, k_e)


def extend_public_key(ctx: CkksContext, pk_prev: PublicKey, sk: SecretKey,
                      rng_key: torch.Tensor) -> PublicKey:
    """Party i: pk_i = (b_{i-1} - a*s_i + e_i, a)."""
    return _extend(ctx, pk_prev.p1, pk_prev.p0, sk, rng_key)


def _extend(ctx, a, b_prev, sk, k_e) -> PublicKey:
    qb = ctx.q[:, None]
    e_hat = _noise_hat(ctx, k_e, (ctx.ring_dim,), vmap=False)
    a_s = modops.mul_mod(a, sk.s, qb)
    b = modops.add_mod(modops.neg_mod(a_s, qb), e_hat, qb)
    if b_prev is not None:
        b = modops.add_mod(b, b_prev, qb)
    b, a = b.to(_I32), a.to(_I32)
    return PublicKey(p0=b, p0_shoup=_shoup(ctx, b),
                     p1=a, p1_shoup=_shoup(ctx, a))


def multiparty_keygen(ctx: CkksContext, n_parties: int, seed=0
                      ) -> tuple[list[SecretKey], PublicKey]:
    """The whole ceremony, party by party: the shares and the joint public
    key. `seed` is an int or a key (all its bits reach the shares)."""
    root = _root_key(seed, ctx.device)
    sks = [party_secret(ctx, _stream(root, _TAG_SECRET, i))
           for i in range(n_parties)]
    a = uniform_mod_q_key(_stream(root, _TAG_PK_A, 0),
                          (ctx.num_limbs, ctx.ring_dim), ctx.params.moduli,
                          vmap=False)
    pk = _extend(ctx, a, None, sks[0], _stream(root, _TAG_PK_NOISE, 0))
    for i in range(1, n_parties):
        pk = extend_public_key(ctx, pk, sks[i],
                               _stream(root, _TAG_PK_NOISE, i))
    return sks, pk


# ---------------------------------------------------------------------------
# Threshold decryption
# ---------------------------------------------------------------------------

def _smudge(ctx: CkksContext, rng_key: torch.Tensor, chunks: int,
            live: int, *, vmap: bool) -> torch.Tensor:
    """Wide flooding noise in the evaluation domain: (*keys batch, chunks,
    live, N); `vmap`: a key batch is JAX's vmap of `_smudge` over the
    parties (_partials_impl). cbd * 2**20 + cbd stays below 2**31 in
    magnitude; its residue takes the sign of the divisor (torch.remainder,
    as the JAX `%`)."""
    n = ctx.ring_dim
    k1, k2 = prng.split(rng_key).unbind(-2)
    e = (cbd_coeffs_key(k1, (chunks, n), vmap=vmap).to(torch.int64)
         * (1 << (_SMUDGE_BITS // 2))
         + cbd_coeffs_key(k2, (chunks, n), vmap=vmap))
    r = torch.remainder(e[..., None, :], ctx.q[:live, None]).to(_I32)
    return ntt_mod.ntt(r, ctx.tables.slice_limbs(0, live))


def partial_decrypt_lead(ctx: CkksContext, sk: SecretKey,
                         ct: ckks_ops.Ciphertext,
                         rng_key: torch.Tensor) -> torch.Tensor:
    """Lead party's share c0 + s_0*c1 + e_sm: (chunks, live, N) int32."""
    live = ct.live_limbs
    qb = ctx.q[:live, None]
    c0, c1 = ct.data.unbind(dim=-3)
    t = modops.mul_mod_shoup(c1, sk.s[:live], sk.s_shoup[:live], qb)
    t = modops.add_mod(c0, t, qb)
    e = _smudge(ctx, rng_key, ct.num_chunks, live, vmap=False)
    return modops.add_mod(t, e, qb).to(_I32)


def partial_decrypt_main(ctx: CkksContext, sk: SecretKey,
                         ct: ckks_ops.Ciphertext,
                         rng_key: torch.Tensor) -> torch.Tensor:
    """Another party's share s_i*c1 + e_sm: (chunks, live, N) int32."""
    live = ct.live_limbs
    qb = ctx.q[:live, None]
    t = modops.mul_mod_shoup(ct.data[:, 1], sk.s[:live], sk.s_shoup[:live],
                             qb)
    e = _smudge(ctx, rng_key, ct.num_chunks, live, vmap=False)
    return modops.add_mod(t, e, qb).to(_I32)


def _fuse(ctx: CkksContext, parts: torch.Tensor, scale: float
          ) -> torch.Tensor:
    """Sum the shares (P, chunks, live, N), INTT, decode -> (chunks, N)."""
    live = parts.shape[-2]
    acc = _sum_parties(parts, ctx.q[:live, None]).to(_I32)
    coeffs = ntt_mod.intt(acc, ctx.tables.slice_limbs(0, live))
    return encoding.decode_coeff(ctx, coeffs, scale)


def fuse_decrypt(ctx: CkksContext, partials, scale: float) -> torch.Tensor:
    """MultipartyDecryptFusion of a list of shares: (chunks, N) f32."""
    return _fuse(ctx, torch.stack(list(partials)), scale)


# ---------------------------------------------------------------------------
# Joint Galois keys and the two-round joint relinearisation key
# ---------------------------------------------------------------------------

def partial_galois_key(ctx: CkksContext, sk: SecretKey, g: int,
                       common_seed: int,
                       rng_key: torch.Tensor) -> ks_mod.KSwitchKey:
    """Party share of the joint key for the Galois element g: the common
    rows a_j (from common_seed) and b_j = -a_j*s_i + e_j + payload
    P*sigma_g(s_i): a single-key switching key (make_kswitch_key_core) of
    party i on the common rows. The shares sum to a key valid for the
    joint s. Shares carry no Shoup words; combining computes them."""
    n = ctx.ring_dim
    key = ks_mod.make_kswitch_key_core(
        ctx, sk, ks_mod.automorphism(sk.s, n, g),
        _common_rows(ctx, common_seed),
        cbd_coeffs_key(rng_key, (ctx.params.chain_len, n), vmap=False))
    return dataclasses.replace(key, b_shoup=None, a_shoup=None)


def partial_relin_round1(ctx: CkksContext, sk: SecretKey, common_seed: int,
                         rng_key: torch.Tensor) -> ks_mod.KSwitchKey:
    """Round-1 share: payload P*s_i on the common rows (g = 1)."""
    return partial_galois_key(ctx, sk, 1, common_seed, rng_key)


def partial_relin_round2(ctx: CkksContext, sk: SecretKey,
                         d_joint: ks_mod.KSwitchKey,
                         rng_key: torch.Tensor) -> ks_mod.KSwitchKey:
    """Round-2 share: both rows of the combined round-1 key times s_i, plus
    fresh noise (k0 for b, k1 for a), each its own stream."""
    qb = ctx.q[:, None]
    e0, e1 = _noise_hat(ctx, prng.split(rng_key),
                        (ctx.params.chain_len, ctx.ring_dim), vmap=False)
    b = modops.add_mod(
        modops.mul_mod_shoup(d_joint.b, sk.s[None], sk.s_shoup[None], qb),
        e0, qb).to(_I32)
    a = modops.add_mod(
        modops.mul_mod_shoup(d_joint.a, sk.s[None], sk.s_shoup[None], qb),
        e1, qb).to(_I32)
    return ks_mod.KSwitchKey(b=b, b_shoup=None, a=a, a_shoup=None)


def _kswitch_key(ctx: CkksContext, b: torch.Tensor,
                 a: torch.Tensor) -> ks_mod.KSwitchKey:
    b, a = b.to(_I32), a.to(_I32)
    return ks_mod.KSwitchKey(b=b, b_shoup=_shoup(ctx, b),
                             a=a, a_shoup=_shoup(ctx, a))


def combine_relin_shares(ctx: CkksContext,
                         shares: list[ks_mod.KSwitchKey]
                         ) -> ks_mod.KSwitchKey:
    """Sum the round-2 shares row by row: the joint relinearisation key."""
    qb = ctx.q[:, None]
    return _kswitch_key(ctx,
                        _sum_parties(torch.stack([s.b for s in shares]), qb),
                        _sum_parties(torch.stack([s.a for s in shares]), qb))


def combine_switch_key_shares(ctx: CkksContext,
                              shares: list[ks_mod.KSwitchKey]
                              ) -> ks_mod.KSwitchKey:
    """Sum the parties' b over the common a: the joint switching key."""
    return _kswitch_key(
        ctx, _sum_parties(torch.stack([s.b for s in shares]), ctx.q[:, None]),
        shares[0].a)


def multiparty_relin_key(ctx: CkksContext, sks: list[SecretKey],
                         common_seed: int = 0,
                         seed=0) -> ks_mod.KSwitchKey:
    """The two-round ceremony, party by party. common_seed is the public
    seed of the common rows; `seed` roots the parties' noise streams."""
    root = _root_key(seed, ctx.device)
    r1 = [partial_relin_round1(ctx, sk, common_seed,
                               _stream(root, _TAG_RELIN_R1, i))
          for i, sk in enumerate(sks)]
    d = combine_switch_key_shares(ctx, r1)
    r2 = [partial_relin_round2(ctx, sk, d, _stream(root, _TAG_RELIN_R2, i))
          for i, sk in enumerate(sks)]
    return combine_relin_shares(ctx, r2)


# ---------------------------------------------------------------------------
# Batched ceremonies: the party axis stacked
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartySecrets:
    """All parties' additive shares on a leading party axis."""
    s: torch.Tensor          # (P, L, N) int32, eval domain
    s_shoup: torch.Tensor    # (P, L, N) int64

    @property
    def n_parties(self) -> int:
        return int(self.s.shape[0])

    def party(self, i: int) -> SecretKey:
        return SecretKey(s=self.s[i], s_shoup=self.s_shoup[i])


def stack_keys(keys) -> torch.Tensor:
    """A list of keys (W,) of one implementation -> a key batch (P, W)."""
    return torch.stack(list(keys))


def multiparty_keygen_batched(ctx: CkksContext, n_parties: int, seed=0
                              ) -> tuple[PartySecrets, PublicKey]:
    """The chained keygen with the party axis stacked: every secret and
    noise polynomial in one NTT batch, each party its own stream (JAX
    loops over the parties). The residues of
    multiparty_keygen(ctx, n_parties, seed)."""
    root = _root_key(seed, ctx.device)
    n, L = ctx.ring_dim, ctx.num_limbs
    qb = ctx.q[:, None]
    s_coef = ternary_coeffs_key(_streams(root, _TAG_SECRET, n_parties),
                                (n,), vmap=False)
    e_coef = cbd_coeffs_key(_streams(root, _TAG_PK_NOISE, n_parties), (n,),
                            vmap=False)
    s_hat, e_hat = ntt_mod.ntt(
        lift_signed(torch.stack([s_coef, e_coef]), ctx.q),
        ctx.tables)                                      # (P, L, N) each
    a = uniform_mod_q_key(_stream(root, _TAG_PK_A, 0), (L, n),
                          ctx.params.moduli, vmap=False)
    terms = modops.add_mod(modops.neg_mod(modops.mul_mod(a, s_hat, qb), qb),
                           e_hat, qb)
    b = _sum_parties(terms, qb).to(_I32)
    return (PartySecrets(s=s_hat, s_shoup=_shoup(ctx, s_hat)),
            PublicKey(p0=b, p0_shoup=_shoup(ctx, b),
                      p1=a, p1_shoup=_shoup(ctx, a)))


def _partials(ctx: CkksContext, secrets: PartySecrets, data: torch.Tensor,
              rng_keys: torch.Tensor) -> torch.Tensor:
    """(P, chunks, live, N) int64 partial decryptions; party 0 leads. The
    smudging is JAX's vmap over the parties' keys (_partials_impl)."""
    live = data.shape[-2]
    qb = ctx.q[:live, None]
    c0, c1 = data.unbind(dim=-3)
    t = modops.mul_mod_shoup(c1, secrets.s[:, None, :live],
                             secrets.s_shoup[:, None, :live], qb)
    parts = modops.add_mod(
        t, _smudge(ctx, rng_keys, data.shape[0], live, vmap=True), qb)
    parts[0] = modops.add_mod(parts[0], c0, qb)
    return parts


def threshold_decrypt(ctx: CkksContext, secrets: PartySecrets,
                      ct: ckks_ops.Ciphertext,
                      rng_keys: torch.Tensor) -> torch.Tensor:
    """Every party's MultipartyDecryptLead / Main and the fusion, stacked:
    (chunks, N) f32. rng_keys (P, W) are the fresh smudging streams, drawn
    as JAX's vmap over the parties; party 0 leads. Under threefry the
    residues of the per-party path under the same keys."""
    return _fuse(ctx, _partials(ctx, secrets, ct.data, rng_keys), ct.scale)


def partial_decrypt_stacked(ctx: CkksContext, secrets: PartySecrets,
                            ct: ckks_ops.Ciphertext,
                            rng_keys: torch.Tensor) -> torch.Tensor:
    """The (P, chunks, live, N) int32 shares each party would publish."""
    return _partials(ctx, secrets, ct.data, rng_keys).to(_I32)


def multiparty_relin_key_batched(ctx: CkksContext, secrets: PartySecrets,
                                 common_seed: int = 0,
                                 seed=0) -> ks_mod.KSwitchKey:
    """The two-round relinearisation ceremony with the party axis stacked:
    all 3P noise polynomials of both rounds in one NTT batch, each party
    its own streams (JAX loops over the parties). The residues of
    multiparty_relin_key under the same seeds."""
    root = _root_key(seed, ctx.device)
    chain, P = ctx.params.chain_len, secrets.n_parties
    qb = ctx.q[:, None]
    a = _common_rows(ctx, common_seed)
    r2_keys = prng.split(_streams(root, _TAG_RELIN_R2, P))       # (P, 2, W)
    keys = torch.stack([_streams(root, _TAG_RELIN_R1, P),
                        r2_keys[:, 0], r2_keys[:, 1]])           # (3, P, W)
    e1_hat, e0_r2, e1_r2 = _noise_hat(ctx, keys, (chain, ctx.ring_dim),
                                      vmap=False)
    s = secrets.s[:, None]                               # (P, 1, L, N)
    s_sh = secrets.s_shoup[:, None]
    # Round 1: -a*s_i + e_i + P*s_i on the gadget diagonal, summed.
    b = modops.add_mod(
        modops.neg_mod(modops.mul_mod_shoup(a, s, s_sh, qb), qb), e1_hat, qb)
    b = modops.add_mod(b, ks_mod.ks_payload(ctx, secrets.s), qb)
    d_b = _sum_parties(b, qb)
    # Round 2: both rows times s_i, fresh noise, summed.
    b2 = modops.add_mod(modops.mul_mod_shoup(d_b, s, s_sh, qb), e0_r2, qb)
    a2 = modops.add_mod(modops.mul_mod_shoup(a, s, s_sh, qb), e1_r2, qb)
    return _kswitch_key(ctx, _sum_parties(b2, qb), _sum_parties(a2, qb))


def multiparty_galois_key_batched(ctx: CkksContext, secrets: PartySecrets,
                                  g: int, common_seed: int,
                                  rng_keys: torch.Tensor
                                  ) -> ks_mod.KSwitchKey:
    """The joint Galois key ceremony with the party axis stacked; rng_keys
    (P, W), drawn as JAX's vmap over them (_multiparty_galois_impl). Under
    threefry the residues of per-party partial_galois_key +
    combine_switch_key_shares under the same keys."""
    qb = ctx.q[:, None]
    a = _common_rows(ctx, common_seed)
    e_hat = _noise_hat(ctx, rng_keys, (ctx.params.chain_len, ctx.ring_dim),
                       vmap=True)
    a_s = modops.mul_mod_shoup(a, secrets.s[:, None], secrets.s_shoup[:, None],
                               qb)
    b = modops.add_mod(modops.neg_mod(a_s, qb), e_hat, qb)
    s_g = ks_mod.automorphism(secrets.s, ctx.ring_dim, g)
    b = modops.add_mod(b, ks_mod.ks_payload(ctx, s_g), qb)
    return _kswitch_key(ctx, _sum_parties(b, qb), a)


def threshold_round_fused(ctx: CkksContext, secrets: PartySecrets,
                          pk: PublicKey, values: torch.Tensor,
                          enc_key: torch.Tensor, dec_keys: torch.Tensor,
                          weights, scale: float | None = None
                          ) -> torch.Tensor:
    """One threshold secure-FedAvg round in one call: joint-pk encrypt of
    all K clients, the weighted sum (K3 on a CUDA tensor), all parties'
    partial decryptions and the fusion. values (K, chunks, N) f32 ->
    averaged (chunks, N) f32 on their device. No single secret key is
    formed; dec_keys (P, W) are fresh smudging streams."""
    ct = ckks_ops.encrypt_stacked(ctx, pk, values, enc_key, scale)
    w_res, w_shoup, ds = ckks_ops._encode_weights(
        ctx, weights, ctx.params.chain_len, 0)
    agg = ckks_ops._aggregate(ctx, ct.data, w_res, w_shoup)
    return _fuse(ctx, _partials(ctx, secrets, agg, dec_keys), ct.scale * ds)
