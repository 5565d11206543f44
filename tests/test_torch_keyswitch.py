"""Port parity: key generation, key switching, ct x ct multiply, rescale,
Galois rotations and EvalSum, bit-exact against fhe_fed_tpu.ckks.

At make_params(batch=128, scale_bits=40, mult_depth=2, ring_dim=256), as
tests/test_keyswitch.py. The deterministic cores are fed the JAX package's
own samples (its key splits reproduced here); the operations run on
JAX-made ciphertexts and keys carried across with interop. Every check runs
twice: on the context's tables (the four-step K1 branch at this ring) and
on a copy without four-step tables (the butterfly K2 branch).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_fed_tpu.rns import modops as J_modops
from fhe_fed_tpu.ckks import params as J_params, keys as J_keys, ops as J_ops
from fhe_fed_tpu.ckks import keyswitch as J_ks
from fhe_fed_tpu_torch import interop
from fhe_fed_tpu_torch.rns import modops as T_modops
from fhe_fed_tpu_torch.ckks import params as T_params, keys as T_keys
from fhe_fed_tpu_torch.ckks import ops as T_ops, keyswitch as T_ks

torch.set_num_threads(1)

SMALL = dict(batch=128, scale_bits=40, mult_depth=2, ring_dim=256)
N = 256
ROTATIONS = (1, 2, 4)


def _u32(t):
    return t.numpy().astype(np.uint32)


def _i32(a):
    return torch.as_tensor(np.asarray(a).astype(np.int32))


def _tkey(k):
    return interop.kswitch_key_from_numpy(
        *(np.asarray(a) for a in (k.b, k.b_shoup, k.a, k.a_shoup)),
        device="cpu")


def _tct(ct):
    return interop.ciphertext_from_numpy(np.asarray(ct.data), ct.scale,
                                         ct.level, device="cpu")


@pytest.fixture(scope="module")
def jax_side():
    jctx = J_params.make_context(J_params.make_params(**SMALL))
    sk, pk = J_keys.keygen(jctx, seed=5)
    rlk = J_ks.make_relin_key(jctx, sk, jax.random.key(17))
    gks = {r: J_ks.make_galois_key(jctx, sk, J_ks.galois_element(r, N),
                                   jax.random.key(20 + r))
           for r in ROTATIONS}
    rng = np.random.default_rng(0)
    a = (rng.random((2, N)).astype(np.float32) - 0.5) / 8
    b = (rng.random((2, N)).astype(np.float32) - 0.5) / 8
    ct_a = J_ops.encrypt(jctx, pk, jnp.asarray(a), jax.random.key(1))
    ct_b = J_ops.encrypt(jctx, pk, jnp.asarray(b), jax.random.key(2))
    return jctx, sk, pk, rlk, gks, ct_a, ct_b


@pytest.fixture(scope="module", params=["mxu", "butterfly"])
def port_ctx(request):
    ctx = T_params.make_context(T_params.make_params(**SMALL), device="cpu")
    assert ctx.tables.mxu is not None
    if request.param == "butterfly":
        ctx = dataclasses.replace(
            ctx, tables=dataclasses.replace(ctx.tables, mxu=None))
    return ctx


@pytest.fixture(scope="module")
def port_keys(jax_side):
    _, sk, pk, rlk, gks, *_ = jax_side
    tsk, tpk = interop.keys_from_numpy(
        [np.asarray(x) for x in (sk.s, sk.s_shoup)],
        [np.asarray(x) for x in (pk.p0, pk.p0_shoup, pk.p1, pk.p1_shoup)],
        device="cpu")
    return tsk, tpk, _tkey(rlk), {r: _tkey(k) for r, k in gks.items()}


def test_params_properties_match():
    jp = J_params.make_params(**SMALL)
    tp = T_params.make_params(**SMALL)
    assert tp.special_prime == jp.special_prime
    assert tp.rescale_primes == jp.rescale_primes
    assert tp.log_q == jp.log_q
    assert [tp.limbs_at_level(v) for v in range(3)] == \
        [jp.limbs_at_level(v) for v in range(3)]


def test_keygen_core_matches_jax(jax_side, port_ctx):
    """keygen(seed=5) = keygen_core on the samples of its own key splits."""
    jctx, sk, pk, *_ = jax_side
    k_s, k_a, k_e = jax.random.split(jax.random.key(5), 3)
    L = jctx.num_limbs
    s = J_keys.ternary_coeffs(k_s, (N,))
    a = J_keys.uniform_mod_q(k_a, (L, N), jctx)
    e = J_keys.cbd_coeffs(k_e, (N,))
    tsk, tpk = T_keys.keygen_core(port_ctx, _i32(s), _i32(a), _i32(e))
    for got, want in ((tsk.s, sk.s), (tsk.s_shoup, sk.s_shoup),
                      (tpk.p0, pk.p0), (tpk.p0_shoup, pk.p0_shoup),
                      (tpk.p1, pk.p1), (tpk.p1_shoup, pk.p1_shoup)):
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))
    assert tsk.s.dtype == torch.int32 and tsk.s_shoup.dtype == torch.int64


def test_kswitch_key_core_matches_jax(jax_side, port_ctx, port_keys):
    """make_relin_key(key(17)) = make_kswitch_key_core on its samples."""
    jctx, sk, _, rlk, *_ = jax_side
    tsk = port_keys[0]
    k_a, k_e = jax.random.split(jax.random.key(17))
    chain, L = jctx.params.chain_len, jctx.num_limbs
    a = J_keys.uniform_mod_q(k_a, (chain, L, N), jctx)
    e = J_keys.cbd_coeffs(k_e, (chain, N))
    qb = port_ctx.q[:, None]
    s2 = T_modops.mul_mod_shoup(tsk.s, tsk.s, tsk.s_shoup, qb)
    np.testing.assert_array_equal(
        _u32(s2), np.asarray(J_modops.mul_mod_shoup(
            sk.s, sk.s, sk.s_shoup, jctx.q[:, None])))
    got = T_ks.make_kswitch_key_core(port_ctx, tsk, s2, _i32(a), _i32(e))
    for f in ("b", "b_shoup", "a", "a_shoup"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.int64),
            np.asarray(getattr(rlk, f)).astype(np.int64), err_msg=f)


def test_key_switch_matches_jax(jax_side, port_ctx, port_keys):
    jctx, _, _, rlk, _, ct_a, _ = jax_side
    d = ct_a.data[:, 1]
    w0, w1 = jax.jit(J_ks.key_switch)(jctx, d, rlk)   # eager: ~40 s here
    g0, g1 = T_ks.key_switch(port_ctx, _i32(d), port_keys[2])
    np.testing.assert_array_equal(_u32(g0), np.asarray(w0))
    np.testing.assert_array_equal(_u32(g1), np.asarray(w1))


def test_mul_ct_and_rescale_match_jax(jax_side, port_ctx, port_keys):
    jctx, _, _, rlk, _, ct_a, ct_b = jax_side
    want = J_ks.mul_ct(jctx, ct_a, ct_b, rlk)
    got = T_ks.mul_ct(port_ctx, _tct(ct_a), _tct(ct_b), port_keys[2])
    assert (got.scale, got.level) == (want.scale, want.level)
    np.testing.assert_array_equal(_u32(got.data), np.asarray(want.data))
    want_rs = J_ops.rescale(jctx, want)
    got_rs = T_ops.rescale(port_ctx, got)
    assert (got_rs.scale, got_rs.level) == (want_rs.scale, want_rs.level)
    np.testing.assert_array_equal(_u32(got_rs.data),
                                  np.asarray(want_rs.data))
    # A second level: scalar multiply, then rescale from level 1.
    want2 = J_ops.rescale(jctx, J_ops.mul_scalar(jctx, want_rs, 0.75))
    got2 = T_ops.rescale(port_ctx, T_ops.mul_scalar(port_ctx, got_rs, 0.75))
    assert (got2.scale, got2.level) == (want2.scale, want2.level)
    np.testing.assert_array_equal(_u32(got2.data), np.asarray(want2.data))


def test_rotate_and_eval_sum_match_jax(jax_side, port_ctx, port_keys):
    jctx, _, _, _, gks, ct_a, _ = jax_side
    tgks = port_keys[3]
    tct = _tct(ct_a)
    for r in ROTATIONS:
        want = J_ks.rotate(jctx, ct_a, r, gks[r])
        got = T_ks.rotate(port_ctx, tct, r, tgks[r])
        np.testing.assert_array_equal(_u32(got.data), np.asarray(want.data))
    want = J_ks.eval_sum(jctx, ct_a, gks, 8)
    got = T_ks.eval_sum(port_ctx, tct, tgks, 8)
    assert (got.scale, got.level) == (want.scale, want.level)
    np.testing.assert_array_equal(_u32(got.data), np.asarray(want.data))
    np.testing.assert_array_equal(
        _u32(T_ops.add(port_ctx, tct, tct).data),
        np.asarray(J_ops.add(jctx, ct_a, ct_a).data))


def test_automorphism_permutation_matches_jax():
    for g in (J_ks.galois_element(1, N), J_ks.galois_element(5, N),
              J_ks.conj_element(N)):
        np.testing.assert_array_equal(T_ks._auto_perm(N, g),
                                      J_ks._auto_perm(N, g))
    assert T_ks.galois_element(3, N) == J_ks.galois_element(3, N)
    assert T_ks.conj_element(N) == J_ks.conj_element(N)


def test_port_keys_decrypt_products(port_ctx):
    """Keys made by the port's own samplers: mul_ct + rescale decrypts to
    the negacyclic product within the JAX test's tolerance."""
    gen = torch.Generator().manual_seed(3)
    sk, pk = T_keys.keygen(port_ctx, gen)
    rlk = T_ks.make_relin_key(port_ctx, sk, gen)
    rng = np.random.default_rng(4)
    a = (rng.random((1, N)).astype(np.float32) - 0.5) / 8
    b = (rng.random((1, N)).astype(np.float32) - 0.5) / 8
    ca = T_ops.encrypt(port_ctx, pk, torch.as_tensor(a), gen)
    cb = T_ops.encrypt(port_ctx, pk, torch.as_tensor(b), gen)
    out = T_ops.decrypt(port_ctx, sk, T_ops.rescale(
        port_ctx, T_ks.mul_ct(port_ctx, ca, cb, rlk)))
    full = np.convolve(a[0].astype(np.float64), b[0].astype(np.float64))
    want = full[:N].copy()
    want[:N - 1] -= full[N:]
    np.testing.assert_allclose(out.numpy()[0], want, atol=5e-4)
