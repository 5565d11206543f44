"""The port's PRNG dispatch (fhe_fed_tpu_torch.utils.prng) against
jax.random, and the rbg samplers on the CPU.

- rbg `key`, `split` (nested and batched) and `fold_in` equal jax 0.9.0's
  rbg key data bit for bit over several seeds; threefry keys pass through
  to utils/threefry.py unchanged;
- the rule that tells the implementations apart (the last dimension)
  holds on a (4, 2) batch of threefry keys and a (2, 4) batch of rbg keys,
  and threefry's functions refuse an rbg key;
- rbg `bits` is `jax.random.bits(key, shape, uint32)` bit for bit (XLA's
  RngBitGenerator, Philox4x32-10): several seeds and split keys, shapes
  () to (4, 8192), keys whose 128-bit counter carries across 2**32 and
  2**64 (`wrap_key_data`); a key batch draws each key alone, or under
  `vmap=True` as `jax.vmap` (nested once) draws: the whole batch from its
  first key;
- the three `*_key` samplers equal fhe_fed_tpu.ckks.keys.uniform_mod_q,
  ternary_coeffs and cbd_coeffs under rbg keys, alone, key by key and
  vmapped;
- the rbg samplers' statistics over 2**20 draws (chip_smoke.rbg_sample_z,
  which the chip run applies to ~10^7 draws on the card): the mean and
  variance of the uniform residues per limb, the ternary frequencies, the
  CBD mean and variance (10), each within chip_smoke.Z_BOUND (5) standard
  errors;
- the stacked encrypts under an rbg key equal the JAX package's (its
  jax.vmap over the clients), and the seeded encrypt's wire seed and c0
  are JAX's while a seeded blob's `a` stays the threefry stream of that
  seed.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke

from fhe_fed_tpu.ckks import keys as J_keys, ops as J_ops
from fhe_fed_tpu.ckks import params as J_params
from fhe_fed_tpu_torch.utils import prng, threefry as TF
from fhe_fed_tpu_torch.ckks import params as P, keys as K, ops as O

torch.set_num_threads(1)

SEEDS = [0, 7, 2024, 2 ** 31 - 1, 2 ** 62 + 12345]
BITS_SEEDS = [0, 7, 1234, 2 ** 31 - 1]
BITS_SHAPES = [(), (5,), (3, 5, 7), (4, 8192)]
# Key words whose counter (w3:w2) + i carries across 2**32 and across
# 2**64 within the draw.
CARRY_KEYS = [[1, 2, 0xFFFFFFFE, 0], [7, 9, 0xFFFFFFFF, 0xFFFFFFFF]]
SMALL = dict(batch=128, scale_bits=40, mult_depth=1, ring_dim=256)
DRAWS = 1 << 20
CPU = torch.device("cpu")


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _u(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _jbits(jk, shape) -> np.ndarray:
    return _u(jax.random.bits(jk, shape, jnp.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_rbg_key_split_fold_in_match_jax(seed):
    jk = jax.random.key(seed, impl="rbg")
    k = prng.key(seed, "rbg", CPU)
    np.testing.assert_array_equal(k.numpy(), _kd(jk))
    np.testing.assert_array_equal(prng.split(k, 3).numpy(),
                                  _kd(jax.random.split(jk, 3)))
    np.testing.assert_array_equal(prng.fold_in(k, 0x5eed).numpy(),
                                  _kd(jax.random.fold_in(jk, 0x5eed)))
    # Nested and batched: a (2,) batch split again and folded.
    kb, jkb = prng.split(k), jax.random.split(jk)
    np.testing.assert_array_equal(
        prng.split(kb, 5).numpy(),
        _kd(jax.vmap(lambda x: jax.random.split(x, 5))(jkb)))
    jk3 = jax.vmap(lambda x: jax.random.split(x, 3))(jkb)     # (2, 3)
    np.testing.assert_array_equal(
        prng.split(prng.split(kb, 3)[1], 2).numpy(),
        _kd(jax.vmap(lambda x: jax.random.split(x, 2))(jk3[1])))
    np.testing.assert_array_equal(
        prng.fold_in(kb, 9).numpy(),
        _kd(jax.vmap(lambda x: jax.random.fold_in(x, 9))(jkb)))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_threefry_keys_pass_through(seed):
    k = prng.key(seed, "threefry", CPU)
    assert torch.equal(k, TF.key(seed))
    assert torch.equal(prng.split(k, 4), TF.split(k, 4))
    assert torch.equal(prng.fold_in(k, 3), TF.fold_in(k, 3))
    assert torch.equal(prng.bits(k, (2, 5)), TF.bits(k, (2, 5)))


def test_last_dimension_tells_the_implementations_apart():
    tf_batch = TF.split(TF.key(1), 8).reshape(4, 2, 2)[:, 0]    # (4, 2)
    rbg_batch = prng.split(prng.key(1, "rbg", CPU), 2)          # (2, 4)
    assert tf_batch.shape == (4, 2) and rbg_batch.shape == (2, 4)
    assert prng.impl_of(tf_batch) == "threefry"
    assert prng.impl_of(rbg_batch) == "rbg"
    assert prng.impl_of(TF.split(TF.key(1), 4).reshape(2, 2, 2)) == \
        "threefry"
    assert prng.split(tf_batch).shape == (4, 2, 2)
    assert prng.split(rbg_batch).shape == (2, 2, 4)
    assert prng.bits(tf_batch, (3,)).shape == (4, 3)
    assert prng.bits(rbg_batch, (3,)).shape == (2, 3)
    for bad in (torch.zeros(3, dtype=torch.int64), torch.zeros(()),
                np.zeros(4)):
        with pytest.raises(TypeError):
            prng.impl_of(bad)
    with pytest.raises(TypeError):
        TF.split(rbg_batch[0], 2)
    with pytest.raises(TypeError):
        TF.bits(rbg_batch[0], (2,))
    with pytest.raises(TypeError, match="rbg"):
        prng.philox_bits(tf_batch, (3,))
    with pytest.raises(ValueError, match="PRNG"):
        prng.key(1, "threefry2x32", CPU)


def test_default_impl_is_rbg_on_the_card_only():
    assert prng.default_impl(torch.device("cuda")) == "rbg"
    assert prng.default_impl("cuda:1") == "rbg"
    assert prng.default_impl("cpu") == "threefry"
    assert prng.default_impl(torch.device("meta")) == "threefry"


def test_rbg_bits_reproducible_and_batched():
    k1, k2 = prng.split(prng.key(5, "rbg", CPU)).unbind(0)
    a = prng.bits(k1, (4, 1000))
    assert a.dtype == torch.int64 and a.shape == (4, 1000)
    assert int(a.min()) >= 0 and int(a.max()) < 2 ** 32
    assert int(a.max()) >= 2 ** 31            # the top bit is drawn
    assert torch.equal(a, prng.bits(k1, (4, 1000)))
    assert not torch.equal(a, prng.bits(k2, (4, 1000)))
    both = prng.bits(torch.stack([k1, k2]), (4, 1000))
    assert both.shape == (2, 4, 1000)
    assert torch.equal(both[0], a) and torch.equal(both[1],
                                                   prng.bits(k2, (4, 1000)))
    # Under the vmap rule the batch draws from its first key alone.
    vm = prng.bits(*prng.batch_rule(torch.stack([k1, k2]), (4, 1000),
                                     vmap=True))
    assert torch.equal(vm, prng.bits(k1, (2, 4, 1000)))
    assert prng.bits(k1, ()).shape == ()


@pytest.mark.parametrize("shape", BITS_SHAPES)
@pytest.mark.parametrize("seed", BITS_SEEDS)
def test_rbg_bits_match_jax(seed, shape):
    """rbg bits are XLA's Philox words, as jax.random.bits draws them, for
    a key and for its split keys."""
    jk = jax.random.key(seed, impl="rbg")
    k = prng.key(seed, "rbg", CPU)
    np.testing.assert_array_equal(prng.bits(k, shape).numpy(),
                                  _jbits(jk, shape))
    for jks, ks in zip(jax.random.split(jk, 3), prng.split(k, 3)):
        np.testing.assert_array_equal(prng.bits(ks, shape).numpy(),
                                      _jbits(jks, shape))


@pytest.mark.parametrize("words", CARRY_KEYS)
def test_rbg_counter_carries_match_jax(words):
    jk = jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32),
                                  impl="rbg")
    k = torch.tensor(words, dtype=torch.int64)
    for shape in ((3, 5, 7), (1001,)):
        np.testing.assert_array_equal(prng.bits(k, shape).numpy(),
                                      _jbits(jk, shape))
    np.testing.assert_array_equal(prng.philox_bits(k, (13,)).numpy(),
                                  _jbits(jk, (13,)))


def test_rbg_vmap_rule_matches_jax_vmap():
    """jax.vmap over a batch of 3 keys, and nested once over (2, 3): the
    batch rule's draw is what JAX's batching rule draws (the first key, the
    whole batch's shape); key by key it is not."""
    def vmapped(ks, shape):
        return prng.bits(*prng.batch_rule(ks, shape, vmap=True))

    jks = jax.random.split(jax.random.key(11, impl="rbg"), 6)
    ks = torch.as_tensor(_kd(jks))
    one = jax.vmap(lambda k: jax.random.bits(k, (2, 7), jnp.uint32))
    np.testing.assert_array_equal(vmapped(ks[:3], (2, 7)).numpy(),
                                  _u(one(jks[:3])))
    nested = jax.vmap(jax.vmap(
        lambda k: jax.random.bits(k, (5,), jnp.uint32)))
    np.testing.assert_array_equal(
        vmapped(ks.reshape(2, 3, 4), (5,)).numpy(),
        _u(nested(jks.reshape(2, 3))))
    assert not torch.equal(prng.bits(ks[:3], (2, 7)),
                           vmapped(ks[:3], (2, 7)))
    # threefry batches draw key by key either way, as JAX's threefry does.
    tks = TF.split(TF.key(3), 3)
    assert torch.equal(vmapped(tks, (5,)), prng.bits(tks, (5,)))


@pytest.fixture(scope="module")
def jsmall():
    return (J_params.make_context(J_params.make_params(**SMALL)),
            P.make_params(**SMALL).moduli)


@pytest.mark.parametrize("sampler", ["uniform", "ternary", "cbd"])
def test_rbg_samplers_match_jax(jsmall, sampler):
    """keys.*_key under rbg keys equal the JAX package's samplers, for a
    key, a key batch drawn key by key (a loop in JAX) and the same batch
    under jax.vmap."""
    jctx, moduli = jsmall
    shape = ((2, len(moduli) - 1, 256) if sampler == "uniform"
             else (3, 256))
    jfn, tfn = {
        "uniform": (lambda k: J_keys.uniform_mod_q(k, shape, jctx),
                    lambda k, v: K.uniform_mod_q_key(k, shape, moduli,
                                                     vmap=v)),
        "ternary": (lambda k: J_keys.ternary_coeffs(k, shape),
                    lambda k, v: K.ternary_coeffs_key(k, shape, vmap=v)),
        "cbd": (lambda k: J_keys.cbd_coeffs(k, shape),
                lambda k, v: K.cbd_coeffs_key(k, shape, vmap=v)),
    }[sampler]
    jks = jax.random.split(jax.random.key(21, impl="rbg"), 3)
    ks = torch.as_tensor(_kd(jks))
    got = tfn(ks[0], False)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _u(jfn(jks[0])))
    each = tfn(ks, False)
    for i in range(3):
        np.testing.assert_array_equal(each[i].numpy(), _u(jfn(jks[i])))
    np.testing.assert_array_equal(tfn(ks, True).numpy(),
                                  _u(jax.vmap(jfn)(jks)))


def test_rbg_sampler_statistics():
    """chip_smoke.rbg_sample_z on the CPU over 2**20 draws each: every
    statistic within its Z_BOUND standard errors, every sample in its
    support."""
    params = P.make_params(**SMALL)
    z = chip_smoke.rbg_sample_z(CPU, params.moduli[:params.chain_len],
                                params.ring_dim, DRAWS // params.ring_dim)
    assert len(z) == 2 * params.chain_len + 5
    assert all(abs(v) <= chip_smoke.Z_BOUND for v in z.values()), z


def test_rbg_samplers_draw_each_key_alone():
    """A key batch drawn key by key equals each key alone; under the vmap
    rule it equals the first key's draw of the whole batch's shape."""
    params = P.make_params(**SMALL)
    keys = prng.split(prng.key(3, "rbg", CPU), 3)
    shape = (2, params.chain_len, params.ring_dim)
    batch = K.uniform_mod_q_key(keys, shape, params.moduli, vmap=False)
    assert batch.shape == (3, *shape)
    for i in range(3):
        assert torch.equal(batch[i], K.uniform_mod_q_key(
            keys[i], shape, params.moduli, vmap=False))
    assert torch.equal(
        K.uniform_mod_q_key(keys, shape, params.moduli, vmap=True),
        K.uniform_mod_q_key(keys[0], (3, *shape), params.moduli,
                            vmap=False))
    for fn in (K.cbd_coeffs_key, K.ternary_coeffs_key):
        each = fn(keys, (5, 256), vmap=False)
        for i in range(3):
            assert torch.equal(each[i], fn(keys[i], (5, 256), vmap=False))
        assert torch.equal(fn(keys, (5, 256), vmap=True),
                           fn(keys[0], (3, 5, 256), vmap=False))


@pytest.fixture(scope="module")
def small():
    params = P.make_params(**SMALL)
    ctx = P.make_context(params, device="cpu")
    sk, pk = K.keygen(ctx, 0)
    vals = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3, 2, params.ring_dim)).astype(np.float32) * 0.1)
    return ctx, sk, pk, vals


@pytest.fixture(scope="module")
def jax_small():
    """The JAX package's context and keygen(ctx, 0): the port's keys."""
    jctx = J_params.make_context(J_params.make_params(**SMALL))
    return (jctx, *J_keys.keygen(jctx, 0))


@pytest.mark.parametrize("symmetric", [True, False])
def test_stacked_encrypt_splits_an_rbg_key_per_client(small, jax_small,
                                                      symmetric):
    """A stacked encrypt splits the key per client, split(key, K), and
    draws as the JAX package's jax.vmap over the clients: its ciphertexts
    equal JAX's bit for bit, and not those of a loop of encrypts under the
    clients' keys (each its own stream); it decrypts."""
    ctx, sk, pk, vals = small
    jctx, jsk, jpk = jax_small
    key = prng.key(9, "rbg", CPU)
    jkey = jax.random.key(9, impl="rbg")
    jvals = jnp.asarray(vals.numpy())
    if symmetric:
        ct = O.encrypt_symmetric_stacked(ctx, sk, vals, key)
        want = J_ops.encrypt_symmetric_stacked(jctx, jsk, jvals, jkey)
        one = O.encrypt_symmetric(ctx, sk, vals[1], prng.split(key, 3)[1])
    else:
        ct = O.encrypt_stacked(ctx, pk, vals, key)
        want = J_ops.encrypt_stacked(jctx, jpk, jvals, jkey)
        one = O.encrypt(ctx, pk, vals[1], prng.split(key, 3)[1])
    np.testing.assert_array_equal(ct.data.numpy(), _u(want.data))
    assert not torch.equal(ct.data[1], one.data)
    out = O.decrypt(ctx, sk, ct.__class__(ct.data[1], ct.scale, 0))
    assert float((out - vals[1]).abs().max()) <= 1e-6


def test_seeded_encrypt_under_rbg(small, jax_small):
    """The wire seed is rbg bits of the key (JAX's) and the error key its
    fold_in; `a` is the threefry pair of the seed, so expand_seeded
    rebuilds it; c0 is the JAX package's."""
    ctx, sk, _, vals = small
    jctx, jsk, _ = jax_small
    key = prng.key(4, "rbg", CPU)
    sct = O.encrypt_symmetric_seeded(ctx, sk, vals[0], key)
    assert torch.equal(sct.seed, prng.bits(key, (4,)))
    jsct = J_ops.encrypt_symmetric_seeded(
        jctx, jsk, jnp.asarray(vals[0].numpy()),
        jax.random.key(4, impl="rbg"))
    np.testing.assert_array_equal(sct.seed.numpy(), _u(jsct.seed))
    np.testing.assert_array_equal(sct.c0.numpy(), _u(jsct.c0))
    ct = O.expand_seeded(ctx, sct)
    a = K.uniform_mod_q_xor2(sct.seed[:2], sct.seed[2:],
                             (2, ctx.params.chain_len, ctx.ring_dim),
                             ctx.params.moduli)
    assert torch.equal(ct.data[:, 1].long(),
                       (-a.long()) % ctx.q[:ctx.params.chain_len, None])
    assert float((O.decrypt(ctx, sk, ct) - vals[0]).abs().max()) <= 1e-6
    assert torch.equal(
        O.encrypt_symmetric_seeded(ctx, sk, vals[0], key).c0, sct.c0)
