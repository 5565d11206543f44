"""The port's PRNG dispatch (fhe_fed_tpu_torch.utils.prng) against
jax.random, and the rbg samplers on the CPU.

- rbg `key`, `split` (nested and batched) and `fold_in` equal jax 0.9.0's
  rbg key data bit for bit over several seeds; threefry keys pass through
  to utils/threefry.py unchanged;
- the rule that tells the implementations apart (the last dimension)
  holds on a (4, 2) batch of threefry keys and a (2, 4) batch of rbg keys,
  and threefry's functions refuse an rbg key;
- an rbg key's Generator seed is threefry2x32 of its halves (checked with
  JAX's own threefry_2x32); rbg `bits` are reproducible for one key on
  the CPU, other keys give other words, and a batch of keys draws what
  each key draws alone;
- the rbg samplers' statistics over 2**20 draws (chip_smoke.rbg_sample_z,
  which the chip run applies to ~10^7 draws on the card): the mean and
  variance of the uniform residues per limb, the ternary frequencies, the
  CBD mean and variance (10), each within chip_smoke.Z_BOUND (5) standard
  errors;
- the encrypts split an rbg key as the JAX functions do (client i of a
  stacked encrypt draws under split(key, K)[i]), and a seeded blob's `a`
  stays the threefry stream of its wire seed.
"""

import numpy as np
import pytest
import torch
import jax
from jax._src import prng as jax_prng

import chip_smoke

from fhe_fed_tpu_torch.utils import prng, threefry as TF
from fhe_fed_tpu_torch.ckks import params as P, keys as K, ops as O

torch.set_num_threads(1)

SEEDS = [0, 7, 2024, 2 ** 31 - 1, 2 ** 62 + 12345]
SMALL = dict(batch=128, scale_bits=40, mult_depth=1, ring_dim=256)
DRAWS = 1 << 20
CPU = torch.device("cpu")


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


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
        prng.seeds(tf_batch)
    with pytest.raises(ValueError, match="PRNG"):
        prng.key(1, "threefry2x32", CPU)


def test_default_impl_is_rbg_on_the_card_only():
    assert prng.default_impl(torch.device("cuda")) == "rbg"
    assert prng.default_impl("cuda:1") == "rbg"
    assert prng.default_impl("cpu") == "threefry"
    assert prng.default_impl(torch.device("meta")) == "threefry"


def test_generator_seed_is_threefry_of_the_halves():
    keys = prng.split(prng.key(11, "rbg", CPU), 3)
    words = keys.numpy().astype(np.uint32)
    want = []
    for w in words:
        y = np.asarray(jax_prng.threefry_2x32((w[0], w[1]), w[2:]))
        want.append((int(y[0]) << 32) | int(y[1]))
    assert prng.seeds(keys) == want
    assert all(0 <= s < 2 ** 64 for s in want)
    assert len(set(want)) == 3


def test_threefry_block_on_words_equals_the_tensor_form():
    w = np.random.default_rng(0).integers(0, 2 ** 32, (64, 4))
    y0, y1 = TF.threefry2x32(*torch.as_tensor(w).unbind(1))
    got = [TF.threefry2x32_words(*map(int, row)) for row in w]
    assert got == list(zip(y0.tolist(), y1.tolist()))


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
    assert prng.bits(k1, ()).shape == ()


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
    params = P.make_params(**SMALL)
    keys = prng.split(prng.key(3, "rbg", CPU), 3)
    shape = (2, params.chain_len, params.ring_dim)
    batch = K.uniform_mod_q_key(keys, shape, params.moduli)
    assert batch.shape == (3, *shape)
    for i in range(3):
        g = prng.generators(keys[i])[0]
        assert torch.equal(batch[i], K.uniform_mod_q(g, shape,
                                                     params.moduli))
    cbd = K.cbd_coeffs_key(keys, (5, 256))
    tern = K.ternary_coeffs_key(keys, (5, 256))
    for i in range(3):
        assert torch.equal(cbd[i], K.cbd_coeffs_key(keys[i], (5, 256)))
        assert torch.equal(tern[i], K.ternary_coeffs(
            prng.generators(keys[i])[0], (5, 256)))


@pytest.fixture(scope="module")
def small():
    params = P.make_params(**SMALL)
    ctx = P.make_context(params, device="cpu")
    sk, pk = K.keygen(ctx, 0)
    vals = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3, 2, params.ring_dim)).astype(np.float32) * 0.1)
    return ctx, sk, pk, vals


@pytest.mark.parametrize("symmetric", [True, False])
def test_stacked_encrypt_splits_an_rbg_key_per_client(small, symmetric):
    ctx, sk, pk, vals = small
    key = prng.key(9, "rbg", CPU)
    if symmetric:
        ct = O.encrypt_symmetric_stacked(ctx, sk, vals, key)
        one = [O.encrypt_symmetric(ctx, sk, vals[i], k)
               for i, k in enumerate(prng.split(key, 3))]
    else:
        ct = O.encrypt_stacked(ctx, pk, vals, key)
        one = [O.encrypt(ctx, pk, vals[i], k)
               for i, k in enumerate(prng.split(key, 3))]
    for i in range(3):
        assert torch.equal(ct.data[i], one[i].data)
    again = (O.encrypt_symmetric_stacked(ctx, sk, vals, key) if symmetric
             else O.encrypt_stacked(ctx, pk, vals, key))
    assert torch.equal(ct.data, again.data)
    other = (O.encrypt_symmetric(ctx, sk, vals[0], prng.key(9, "threefry",
                                                            CPU))
             if symmetric else O.encrypt(ctx, pk, vals[0],
                                         prng.key(9, "threefry", CPU)))
    assert not torch.equal(other.data, one[0].data)
    out = O.decrypt(ctx, sk, ct.__class__(ct.data[1], ct.scale, 0))
    assert float((out - vals[1]).abs().max()) <= 1e-6


def test_seeded_encrypt_under_rbg(small):
    """The wire seed is rbg bits of the key and the error key its fold_in;
    `a` is the threefry pair of the seed, so expand_seeded rebuilds it."""
    ctx, sk, _, vals = small
    key = prng.key(4, "rbg", CPU)
    sct = O.encrypt_symmetric_seeded(ctx, sk, vals[0], key)
    assert torch.equal(sct.seed, prng.bits(key, (4,)))
    ct = O.expand_seeded(ctx, sct)
    a = K.uniform_mod_q_xor2(sct.seed[:2], sct.seed[2:],
                             (2, ctx.params.chain_len, ctx.ring_dim),
                             ctx.params.moduli)
    assert torch.equal(ct.data[:, 1].long(),
                       (-a.long()) % ctx.q[:ctx.params.chain_len, None])
    assert float((O.decrypt(ctx, sk, ct) - vals[0]).abs().max()) <= 1e-6
    assert torch.equal(
        O.encrypt_symmetric_seeded(ctx, sk, vals[0], key).c0, sct.c0)
