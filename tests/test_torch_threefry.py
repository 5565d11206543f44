"""Port parity: threefry2x32 (utils/threefry.py) against jax.random, the
threefry samplers against fhe_fed_tpu.ckks.keys, and the known answers
that pin them: keygen(ctx, 0) at the bench parameters reproduces the
committed key files, and the KAT ciphertext digest of
tests/test_oracle_interop.py."""

import hashlib
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_fed_tpu.ckks import params as J_params, keys as J_keys
from fhe_fed_tpu_torch import cuda_lib
from fhe_fed_tpu_torch.utils import prng, threefry as TF
from fhe_fed_tpu_torch.ckks import params as T_params, keys as T_keys
from fhe_fed_tpu_torch.ckks import ops as T_ops, serial as T_serial

torch.set_num_threads(1)

KEY_DIR = (pathlib.Path(__file__).resolve().parents[1] / "results"
           / "bench_keys_headline")
SEEDS = [0, 7, 2024, 2 ** 31 - 1, 2 ** 62 + 12345]
SHAPES = [(), (1,), (5,), (3, 4), (2, 3, 7)]
SMALL = dict(batch=128, scale_bits=40, mult_depth=1, ring_dim=256)
KAT_CT = "e2cfa667b8fc7a5c93eddae47ee6fccf44e1db2db0e24344d88d00412d4f92b6"
KAT_SK = "fe0c00e9f396eb843bed8bba93021176f830c4a5efcbb1c4e67b8eaef3c9ffd9"


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _u(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_match_jax(seed):
    jk, tk = jax.random.key(seed), TF.key(seed)
    assert tk.dtype == torch.int64 and tuple(tk.shape) == (2,)
    np.testing.assert_array_equal(tk.numpy(), _kd(jk))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(TF.split(tk, num).numpy(),
                                      _kd(jax.random.split(jk, num)))
    for d in (0, 1, 0x5eed, 2 ** 32 - 1):
        np.testing.assert_array_equal(TF.fold_in(tk, d).numpy(),
                                      _kd(jax.random.fold_in(jk, d)))


@pytest.mark.parametrize("impl", prng.IMPLS)
def test_cpu_keys_split_without_the_kernel_library(monkeypatch, impl):
    """CPU keys of either PRNG split in torch ops to jax.random.split's
    words and never reach the kernel library (csrc/threefry_split.cu)."""
    def refuse():
        raise AssertionError("a CPU key reached the kernel library")
    monkeypatch.setattr(cuda_lib, "lib", refuse)
    launches = dict(cuda_lib.launches)
    for seed in (0, 2 ** 32 - 1, 2 ** 62 + 12345):
        jk = jax.random.key(seed, impl={"threefry": "threefry2x32"}.get(
            impl, impl))
        k = prng.key(seed, impl, "cpu")
        for num in (1, 2, 5):
            np.testing.assert_array_equal(prng.split(k, num).numpy(),
                                          _kd(jax.random.split(jk, num)))
        kb, jkb = prng.split(k, 3), jax.random.split(jk, 3)
        np.testing.assert_array_equal(
            prng.split(kb, 2).numpy(),
            _kd(jax.vmap(lambda x: jax.random.split(x, 2))(jkb)))
    assert dict(cuda_lib.launches) == launches


def test_large_seed_keeps_low_32_bits():
    """With 64-bit mode off, jax.random.key keeps a seed's low 32 bits."""
    np.testing.assert_array_equal(TF.key(2 ** 62 + 12345).numpy(), [0, 12345])
    np.testing.assert_array_equal(TF.key(-5).numpy(),
                                  _kd(jax.random.key(-5)))
    with pytest.raises(OverflowError):
        TF.key(2 ** 63)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_match_jax(seed, shape):
    got = TF.bits(TF.key(seed), shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(
        got.numpy(), _u(jax.random.bits(jax.random.key(seed), shape,
                                        jnp.uint32)))


def test_batched_keys_and_wrap_key_data():
    """A (K, 2) key batch samples in one pass what jax.vmap gives."""
    jks = jax.random.split(jax.random.key(11), 4)
    tks = TF.split(TF.key(11), 4)
    np.testing.assert_array_equal(
        TF.bits(tks, (3, 5)).numpy(),
        _u(jax.vmap(lambda k: jax.random.bits(k, (3, 5), jnp.uint32))(jks)))
    np.testing.assert_array_equal(
        TF.split(tks, 3).numpy(),
        _kd(jax.vmap(lambda k: jax.random.split(k, 3))(jks)))
    np.testing.assert_array_equal(
        TF.fold_in(tks, 9).numpy(),
        _kd(jax.vmap(lambda k: jax.random.fold_in(k, 9))(jks)))
    words = np.asarray(jax.random.bits(jax.random.key(3), (4,), jnp.uint32))
    for half in (words[:2], words[2:]):
        want = _kd(jax.random.wrap_key_data(half, impl="threefry2x32"))
        np.testing.assert_array_equal(TF.wrap_key_data(half).numpy(), want)
        np.testing.assert_array_equal(
            TF.wrap_key_data(torch.as_tensor(half.astype(np.int64))).numpy(),
            want)
    with pytest.raises(TypeError, match="threefry key"):
        TF.bits(torch.Generator(), (3,))


@pytest.fixture(scope="module")
def small():
    return (J_params.make_context(J_params.make_params(**SMALL)),
            T_params.make_params(**SMALL).moduli)


@pytest.mark.parametrize("shape", [(3, 256), (2, 3, 3, 256)])
def test_uniform_mod_q_matches_jax(small, shape):
    """Half of the hi words are >= 2**31: the int64 Shoup multiply must
    reduce them below q first (keys.uniform_from_words)."""
    jctx, moduli = small
    L = shape[-2]
    jk = jax.random.key(5)
    hi = np.asarray(jax.random.bits(jax.random.split(jk)[0], shape,
                                    jnp.uint32))
    assert (hi >= 2 ** 31).mean() > 0.4
    got = T_keys.uniform_mod_q_tf(TF.key(5), shape, moduli)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _u(J_keys.uniform_mod_q(jk, shape, jctx)))
    assert int(got.min()) >= 0 and all(
        int(got[..., l, :].max()) < moduli[l] for l in range(L))


def test_reduce_bits_mod_q_at_the_word_limits(small):
    jctx, moduli = small
    words = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1,
                      moduli[0] - 1, moduli[0], 2 * moduli[0]],
                     dtype=np.uint32)
    hi = np.stack([words, words[::-1], words, words[::-1]])[None]
    lo = hi[:, ::-1].copy()
    want = _u(J_keys._reduce_bits_mod_q(jnp.asarray(hi), jnp.asarray(lo),
                                        hi.shape, jctx))
    got = T_keys.uniform_from_words(torch.as_tensor(hi.astype(np.int64)),
                                    torch.as_tensor(lo.astype(np.int64)),
                                    moduli)
    np.testing.assert_array_equal(got.numpy(), want)
    q = np.array(moduli[:4], dtype=object)[:, None]
    exact = (hi[0].astype(object) * 2 ** 32 + lo[0].astype(object)) % q
    np.testing.assert_array_equal(got[0].numpy(), exact.astype(np.int64))


def test_uniform_mod_q_xor2_matches_jax(small):
    jctx, moduli = small
    words = np.asarray(jax.random.bits(jax.random.key(8), (4,), jnp.uint32))
    ka, kb = (jax.random.wrap_key_data(w, impl="threefry2x32")
              for w in (words[:2], words[2:]))
    tw = TF.wrap_key_data(words)
    np.testing.assert_array_equal(
        T_keys.uniform_mod_q_xor2(tw[:2], tw[2:], (2, 4, 256),
                                  moduli).numpy(),
        _u(J_keys.uniform_mod_q_xor2(ka, kb, (2, 4, 256), jctx)))


@pytest.mark.parametrize("seed", [1, 2024])
def test_ternary_and_cbd_match_jax(seed):
    jk, tk = jax.random.key(seed), TF.key(seed)
    t = T_keys.ternary_coeffs_tf(tk, (4, 256))
    e = T_keys.cbd_coeffs_tf(tk, (4, 256))
    assert t.dtype == e.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(),
                                  _u(J_keys.ternary_coeffs(jk, (4, 256))))
    np.testing.assert_array_equal(e.numpy(),
                                  _u(J_keys.cbd_coeffs(jk, (4, 256))))
    # A batch of keys: one pass, the same as each key alone.
    ks = TF.split(tk, 3)
    np.testing.assert_array_equal(
        T_keys.cbd_coeffs_tf(ks, (2, 256)).numpy(),
        np.stack([T_keys.cbd_coeffs_tf(k, (2, 256)).numpy() for k in ks]))


def test_keygen_seed_matches_jax_small(small):
    jctx, _ = small
    tctx = T_params.make_context(T_params.make_params(**SMALL), device="cpu")
    jsk, jpk = J_keys.keygen(jctx, seed=9)
    tsk, tpk = T_keys.keygen(tctx, 9)
    for t, j in ((tsk.s, jsk.s), (tsk.s_shoup, jsk.s_shoup),
                 (tpk.p0, jpk.p0), (tpk.p0_shoup, jpk.p0_shoup),
                 (tpk.p1, jpk.p1), (tpk.p1_shoup, jpk.p1_shoup)):
        np.testing.assert_array_equal(t.numpy(), _u(j))


def test_bench_keygen_and_kat_digest():
    """keygen(ctx, 0) at batch 4096 / 2**52 / N 8192 is the committed key
    pair byte for byte, and encrypt_symmetric of linspace(-1, 1, 8192)
    under key(2024) serializes to the pinned KAT digest."""
    ctx = T_params.make_context(T_params.make_params(batch=4096,
                                                     scale_bits=52,
                                                     mult_depth=1),
                                device="cpu")
    sk, pk = T_keys.keygen(ctx, 0)
    sk_blob = T_serial.serialize_secret_key(ctx, sk)
    assert sk_blob == (KEY_DIR / "key-private.txt").read_bytes()
    assert T_serial.serialize_public_key(ctx, pk) == \
        (KEY_DIR / "key-public.txt").read_bytes()
    assert hashlib.sha256(sk_blob).hexdigest() == KAT_SK
    v = torch.as_tensor(np.linspace(-1.0, 1.0, 8192, dtype=np.float32)[None])
    ct = T_ops.encrypt_symmetric(ctx, sk, v, TF.key(2024))
    assert hashlib.sha256(T_serial.serialize_ct(ctx, ct)).hexdigest() == \
        KAT_CT
