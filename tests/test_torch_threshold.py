"""Port parity of threshold CKKS (fhe_fed_tpu_torch.ckks.threshold) against
fhe_fed_tpu.ckks.threshold, at make_params(batch=128, scale_bits=40,
ring_dim=256) with 3 parties, as tests/test_threshold.py.

Both packages draw every share, noise and smudging polynomial from the same
threefry streams, so residues, Shoup words and decoded f32 bits must be
equal (f32 compared as int32 bit patterns). The JAX functions are called
jitted. The smudging NTT runs on the context's four-step tables (K1's
branch) and on a copy without them (K2's butterfly branch).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_fed_tpu.ckks import params as J_params, ops as J_ops
from fhe_fed_tpu.ckks import keyswitch as J_ks, threshold as J_thr
from fhe_fed_tpu_torch import interop
from fhe_fed_tpu_torch.ckks import params as T_params, ops as T_ops
from fhe_fed_tpu_torch.ckks import keyswitch as T_ks, threshold as T_thr
from fhe_fed_tpu_torch.utils import threefry as TF

torch.set_num_threads(1)

N = 256
PARTIES = 3
SMALL = dict(batch=128, scale_bits=40, ring_dim=N)
WEIGHTS = [0.5, 0.2, 0.3]

_j_lead = jax.jit(J_thr.partial_decrypt_lead)
_j_main = jax.jit(J_thr.partial_decrypt_main)
_j_fuse = jax.jit(J_thr.fuse_decrypt, static_argnums=2)
_j_galois_share = jax.jit(J_thr.partial_galois_key, static_argnums=(2, 3))
_j_mul_ct = jax.jit(J_ks.mul_ct)
_j_rescale = jax.jit(J_ops.rescale)


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


def _same(port, jax_arr):
    """Residues (int32) or Shoup words (int64) equal the JAX u32 array."""
    np.testing.assert_array_equal(port.cpu().numpy().astype(np.int64),
                                  np.asarray(jax_arr).astype(np.int64))


def _same_f32(port, jax_arr):
    np.testing.assert_array_equal(port.cpu().numpy().view(np.int32),
                                  np.asarray(jax_arr).view(np.int32))


def _same_key(port, jax_key):
    for f in ("b", "a", "b_shoup", "a_shoup"):
        if getattr(jax_key, f) is None:
            assert getattr(port, f) is None, f
        else:
            _same(getattr(port, f), getattr(jax_key, f))


def _keys(seeds):
    return ([jax.random.key(s) for s in seeds], [TF.key(s) for s in seeds])


def _tct(ct):
    return interop.ciphertext_from_numpy(np.asarray(ct.data), ct.scale,
                                         ct.level, device="cpu")


def _port_ctx(params, branch="mxu"):
    ctx = T_params.make_context(T_params.make_params(**params), device="cpu")
    assert ctx.tables.mxu is not None
    if branch == "butterfly":
        ctx = dataclasses.replace(
            ctx, tables=dataclasses.replace(ctx.tables, mxu=None))
    return ctx


@pytest.fixture(scope="module")
def jax_side():
    jctx = J_params.make_context(J_params.make_params(mult_depth=1, **SMALL))
    sks, pk = J_thr.multiparty_keygen(jctx, PARTIES, seed=3)
    sec, pk_b = J_thr.multiparty_keygen_batched(jctx, PARTIES, seed=3)
    v = np.random.default_rng(4).standard_normal((2, N)).astype(np.float32)
    ct = J_ops.encrypt(jctx, pk, jnp.asarray(v), jax.random.key(5))
    return jctx, sks, pk, sec, pk_b, v, ct


@pytest.fixture(scope="module")
def port_side():
    ctx = _port_ctx(dict(mult_depth=1, **SMALL))
    sks, pk = T_thr.multiparty_keygen(ctx, PARTIES, seed=3)
    sec, pk_b = T_thr.multiparty_keygen_batched(ctx, PARTIES, seed=3)
    return ctx, sks, pk, sec, pk_b


def test_keygen_per_party_and_batched_match_jax(jax_side, port_side):
    _, jsks, jpk, jsec, jpk_b, *_ = jax_side
    _, sks, pk, sec, pk_b = port_side
    assert sec.n_parties == PARTIES
    for i in range(PARTIES):
        _same(sks[i].s, jsks[i].s)
        _same(sks[i].s_shoup, jsks[i].s_shoup)
        _same(sec.s[i], jsec.s[i])
        _same(sec.s_shoup[i], jsec.s_shoup[i])
        assert torch.equal(sec.party(i).s, sks[i].s)
    for f in ("p0", "p0_shoup", "p1", "p1_shoup"):
        _same(getattr(pk, f), getattr(jpk, f))
        _same(getattr(pk_b, f), getattr(jpk_b, f))
        assert torch.equal(getattr(pk, f), getattr(pk_b, f)), f
    # A threefry key as the seed keeps all its bits, as a jax key does.
    k_sec, k_pk = T_thr.multiparty_keygen_batched(port_side[0], 2,
                                                  seed=TF.key(9))
    j_sec, j_pk = J_thr.multiparty_keygen_batched(jax_side[0], 2,
                                                  seed=jax.random.key(9))
    _same(k_sec.s, j_sec.s)
    _same(k_pk.p0, j_pk.p0)


def test_interop_party_secrets(jax_side):
    jsec = jax_side[3]
    sec = interop.party_secrets_from_numpy(np.asarray(jsec.s),
                                           np.asarray(jsec.s_shoup),
                                           device="cpu")
    assert sec.s.dtype == torch.int32 and sec.s_shoup.dtype == torch.int64
    _same(sec.s, jsec.s)
    _same(sec.s_shoup, jsec.s_shoup)


@pytest.mark.parametrize("branch", ["mxu", "butterfly"])
def test_partials_fusion_and_threshold_decrypt_match_jax(jax_side, port_side,
                                                         branch):
    """Lead / main shares, the stacked shares, fusion and the stacked
    ceremony: residues and decoded bits equal JAX's; batched == per party."""
    jctx, jsks, _, jsec, _, v, jct = jax_side
    _, sks, _, sec, _ = port_side
    ctx = _port_ctx(dict(mult_depth=1, **SMALL), branch)
    ct = _tct(jct)
    jk, tk = _keys([10, 11, 12])
    jparts = [_j_lead(jctx, jsks[0], jct, jk[0])]
    jparts += [_j_main(jctx, s, jct, k) for s, k in zip(jsks[1:], jk[1:])]
    parts = [T_thr.partial_decrypt_lead(ctx, sks[0], ct, tk[0])]
    parts += [T_thr.partial_decrypt_main(ctx, s, ct, k)
              for s, k in zip(sks[1:], tk[1:])]
    for p, jp in zip(parts, jparts):
        assert p.dtype == torch.int32 and p.shape == (2, 4, N)
        _same(p, jp)
    stacked = T_thr.partial_decrypt_stacked(ctx, sec, ct, T_thr.stack_keys(tk))
    assert stacked.shape == (PARTIES, 2, 4, N)
    for i in range(PARTIES):
        assert torch.equal(stacked[i], parts[i])
    want = _j_fuse(jctx, jparts, jct.scale)
    fused = T_thr.fuse_decrypt(ctx, parts, ct.scale)
    _same_f32(fused, want)
    got = T_thr.threshold_decrypt(ctx, sec, ct, T_thr.stack_keys(tk))
    _same_f32(got, want)
    _same_f32(got, J_thr.threshold_decrypt(jctx, jsec, jct,
                                           J_thr.stack_keys(jk)))
    np.testing.assert_allclose(got.numpy(), v, atol=2e-3)


@pytest.mark.parametrize("branch", ["mxu", "butterfly"])
def test_smudge_matches_jax(jax_side, branch):
    """cbd * 2**20 + cbd reduced with the divisor's sign, then the NTT of
    the live limbs: one key and a key batch (JAX's vmap)."""
    jctx = jax_side[0]
    ctx = _port_ctx(dict(mult_depth=1, **SMALL), branch)
    jk, tk = _keys([21, 22])
    for live in (1, 4):
        _same(T_thr._smudge(ctx, tk[0], 3, live, vmap=False),
              jax.jit(J_thr._smudge, static_argnums=(2, 3))(
                  jctx, jk[0], 3, live))
    batch = T_thr._smudge(ctx, T_thr.stack_keys(tk), 3, 4, vmap=True)
    jbatch = jax.jit(jax.vmap(lambda k: J_thr._smudge(jctx, k, 3, 4)))(
        J_thr.stack_keys(jk))
    assert batch.shape == (2, 3, 4, N)
    _same(batch, jbatch)


def test_galois_key_shares_and_batched_match_jax(jax_side, port_side):
    jctx, jsks, _, jsec, *_ = jax_side
    ctx, sks, _, sec, _ = port_side
    g = T_ks.galois_element(1, N)
    jk, tk = _keys([40, 41, 42])
    jshares = [_j_galois_share(jctx, s, g, 77, k) for s, k in zip(jsks, jk)]
    shares = [T_thr.partial_galois_key(ctx, s, g, 77, k)
              for s, k in zip(sks, tk)]
    for sh, jsh in zip(shares, jshares):
        _same_key(sh, jsh)
    joint = T_thr.combine_switch_key_shares(ctx, shares)
    _same_key(joint, J_thr.combine_switch_key_shares(jctx, jshares))
    batched = T_thr.multiparty_galois_key_batched(ctx, sec, g, 77,
                                                  T_thr.stack_keys(tk))
    _same_key(batched, J_thr.multiparty_galois_key_batched(
        jctx, jsec, g, 77, J_thr.stack_keys(jk)))
    for f in ("b", "a", "b_shoup", "a_shoup"):
        assert torch.equal(getattr(batched, f), getattr(joint, f)), f


def test_rbg_galois_batched_and_partials_follow_jax_vmap(jax_side,
                                                        port_side):
    """Under rbg keys the batched Galois ceremony and the stacked partial
    decryptions draw as JAX's jax.vmap over the parties (every party's
    noise from the first party's key): the JAX package's residues bit for
    bit; the per-party shares draw each key's own stream, as JAX's."""
    from fhe_fed_tpu_torch.utils import prng
    jctx, jsks, _, jsec, *_ = jax_side
    ctx, sks, _, sec, _ = port_side
    g = T_ks.galois_element(1, N)
    jk = jax.random.split(jax.random.key(43, impl="rbg"), PARTIES)
    tk = prng.split(prng.key(43, "rbg", "cpu"), PARTIES)
    _same_key(T_thr.multiparty_galois_key_batched(ctx, sec, g, 77, tk),
              J_thr.multiparty_galois_key_batched(jctx, jsec, g, 77, jk))
    _same_key(T_thr.partial_galois_key(ctx, sks[1], g, 77, tk[1]),
              _j_galois_share(jctx, jsks[1], g, 77, jk[1]))
    jct = jax_side[6]
    ct = _tct(jct)
    _same(T_thr.partial_decrypt_stacked(ctx, sec, ct, tk),
          J_thr.partial_decrypt_stacked(jctx, jsec, jct, jk))
    _same(T_thr.partial_decrypt_main(ctx, sks[2], ct, tk[2]),
          _j_main(jctx, jsks[2], jct, jk[2]))


def test_threshold_round_fused_matches_jax(jax_side, port_side):
    jctx, _, _, jsec, jpk_b, *_ = jax_side
    ctx, _, _, sec, pk_b = port_side
    vals = np.random.default_rng(1).standard_normal((3, 2, N)).astype(
        np.float32)
    jk, tk = _keys([10, 11, 12])
    want = J_thr.threshold_round_fused(jctx, jsec, jpk_b, jnp.asarray(vals),
                                       jax.random.key(7),
                                       J_thr.stack_keys(jk), WEIGHTS)
    got = T_thr.threshold_round_fused(ctx, sec, pk_b, torch.as_tensor(vals),
                                      TF.key(7), T_thr.stack_keys(tk),
                                      WEIGHTS)
    _same_f32(got, want)
    np.testing.assert_allclose(got.numpy(), np.tensordot(WEIGHTS, vals, 1),
                               atol=1e-5)
    # The staged path with the same keys gives the same bits.
    ct = T_ops.encrypt_stacked(ctx, pk_b, torch.as_tensor(vals), TF.key(7))
    agg = T_ops.weighted_sum(ctx, ct, WEIGHTS)
    _same_f32(T_thr.threshold_decrypt(ctx, sec, agg, T_thr.stack_keys(tk)),
              want)


def test_joint_relin_key_and_ct_product_match_jax():
    """The two-round ceremony, per party and batched, then ct x ct under
    the joint key, rescale and the threshold decrypt: every residue and the
    decoded bits equal JAX's, and the product is the negacyclic convolution
    of the two coefficient vectors."""
    params = dict(mult_depth=2, **SMALL)
    jctx = J_params.make_context(J_params.make_params(**params))
    ctx = _port_ctx(params)
    jsks, jpk = J_thr.multiparty_keygen(jctx, PARTIES, seed=11)
    jsec, _ = J_thr.multiparty_keygen_batched(jctx, PARTIES, seed=11)
    sks, pk = T_thr.multiparty_keygen(ctx, PARTIES, seed=11)
    sec, _ = T_thr.multiparty_keygen_batched(ctx, PARTIES, seed=11)
    jrlk = J_thr.multiparty_relin_key(jctx, jsks, common_seed=5, seed=11)
    rlk = T_thr.multiparty_relin_key(ctx, sks, common_seed=5, seed=11)
    rlk_b = T_thr.multiparty_relin_key_batched(ctx, sec, common_seed=5,
                                               seed=11)
    _same_key(rlk, jrlk)
    _same_key(rlk_b, J_thr.multiparty_relin_key_batched(
        jctx, jsec, common_seed=5, seed=11))
    for f in ("b", "a", "b_shoup", "a_shoup"):
        assert torch.equal(getattr(rlk_b, f), getattr(rlk, f)), f

    rng = np.random.default_rng(8)
    a = (rng.random((2, N)).astype(np.float32) - 0.5) / 8
    b = (rng.random((2, N)).astype(np.float32) - 0.5) / 8
    ja = J_ops.encrypt(jctx, jpk, jnp.asarray(a), jax.random.key(70))
    jb = J_ops.encrypt(jctx, jpk, jnp.asarray(b), jax.random.key(71))
    ct_a = T_ops.encrypt(ctx, pk, torch.as_tensor(a), TF.key(70))
    ct_b = T_ops.encrypt(ctx, pk, torch.as_tensor(b), TF.key(71))
    _same(ct_a.data, ja.data)
    jprod = _j_rescale(jctx, _j_mul_ct(jctx, ja, jb, jrlk))
    prod = T_ops.rescale(ctx, T_ks.mul_ct(ctx, ct_a, ct_b, rlk_b))
    _same(prod.data, jprod.data)
    assert prod.scale == jprod.scale and prod.level == jprod.level
    jk, tk = _keys([90, 91, 92])
    got = T_thr.threshold_decrypt(ctx, sec, prod, T_thr.stack_keys(tk))
    _same_f32(got, J_thr.threshold_decrypt(jctx, jsec, jprod,
                                           J_thr.stack_keys(jk)))

    def conv(x, y):
        full = np.convolve(x.astype(np.float64), y.astype(np.float64))
        out = full[:N].copy()
        out[:N - 1] -= full[N:]
        return out

    want = np.stack([conv(a[i], b[i]) for i in range(2)])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)


def test_single_partial_reveals_nothing(port_side):
    """One party's share alone does not decode to the plaintext (zeros):
    it lacks the other shares and carries wide smudging noise."""
    ctx, sks, pk, *_ = port_side
    ct = T_ops.encrypt(ctx, pk, torch.zeros((1, N)), TF.key(60))
    part = T_thr.partial_decrypt_lead(ctx, sks[0], ct, TF.key(61))
    assert float(T_thr.fuse_decrypt(ctx, [part], ct.scale).abs().max()) > 1.0
