"""Port parity: primes, modular arithmetic, two-float ops and samplers.

Inputs are made with numpy from a seed and handed to both packages; integer
results must be bit-identical, two-float results bit-identical too.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fhe_fed_tpu.rns import primes as J_primes, modops as J_modops
from fhe_fed_tpu.utils import dfloat as J_df
from fhe_fed_tpu.ckks import params as J_params
from fhe_fed_tpu_torch.rns import primes as T_primes, modops as T_modops
from fhe_fed_tpu_torch.utils import dfloat as T_df
from fhe_fed_tpu_torch.ckks import params as T_params, keys as T_keys

torch.set_num_threads(1)

# Every make_params point the test suite uses, plus the defaults.
PARAM_POINTS = [
    dict(batch=128, scale_bits=40, mult_depth=1, ring_dim=256),
    dict(batch=128, scale_bits=40, mult_depth=2, ring_dim=256),
    dict(batch=128, scale_bits=52, mult_depth=1, ring_dim=256),
    dict(batch=128, scale_bits=40, mult_depth=1, ring_dim=512),
    dict(batch=128, scale_bits=40, mult_depth=2, ring_dim=1024),
    dict(batch=128, scale_bits=40, mult_depth=2, ring_dim=2048),
    dict(batch=4096, scale_bits=40, mult_depth=1),
    dict(batch=4096, scale_bits=52, mult_depth=1),
    dict(batch=128, scale_bits=40, mult_depth=2, ring_dim=32768),
    dict(),
]


@pytest.mark.parametrize("kw", PARAM_POINTS)
def test_params_and_moduli_match(kw):
    j = J_params.make_params(**kw)
    t = T_params.make_params(**kw)
    assert (t.ring_dim, t.moduli, t.num_base, t.chain_len, t.scale) == \
        (j.ring_dim, j.moduli, j.num_base, j.chain_len, j.scale)


def test_prime_helpers_match():
    for n, count in [(256, 5), (8192, 5), (32768, 3)]:
        mods = T_primes.ntt_primes(n, count)
        assert mods == J_primes.ntt_primes(n, count)
        for q in mods:
            assert T_primes.primitive_root_2n(q, n) == \
                J_primes.primitive_root_2n(q, n)
    for log_q in (20, 54, 100, 155, 218, 400, 881):
        assert T_primes.min_ring_dim_128(log_q) == \
            J_primes.min_ring_dim_128(log_q)


def _residues(q, rng, size):
    qa = np.array(q, dtype=np.uint64)[:, None]
    r = rng.integers(0, 1 << 32, size=(len(q), size), dtype=np.uint64) % qa
    r[:, 0] = 0                                  # edge values 0 and q-1
    r[:, 1] = qa[:, 0] - 1
    return r.astype(np.uint32)


def test_modops_bit_exact():
    rng = np.random.default_rng(0)
    q = np.array(T_primes.ntt_primes(256, 5), dtype=np.uint32)
    a = _residues(q, rng, 4096)
    b = _residues(q, rng, 4096)
    b[:, :2] = b[:, 1::-1]                       # pair 0 with q-1 and back
    qj = jnp.asarray(q)[:, None]
    qt = torch.as_tensor(q.astype(np.int64))[:, None]
    at, bt = torch.as_tensor(a.astype(np.int32)), torch.as_tensor(
        b.astype(np.int32))
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    for jf, tf in ((J_modops.add_mod, T_modops.add_mod),
                   (J_modops.sub_mod, T_modops.sub_mod)):
        np.testing.assert_array_equal(
            tf(at, bt, qt).numpy(), np.asarray(jf(aj, bj, qj)))
    np.testing.assert_array_equal(T_modops.neg_mod(at, qt).numpy(),
                                  np.asarray(J_modops.neg_mod(aj, qj)))

    w = b
    ws = T_modops.shoup_precompute(w, q[:, None])
    np.testing.assert_array_equal(
        ws, J_modops.shoup_precompute(w, q[:, None]).astype(np.int64))
    # x may be any u32 below 2**31 for the Shoup multiply: add 2**31 - 1.
    x = a.copy()
    x[:, 2] = 2 ** 31 - 1
    got = T_modops.mul_mod_shoup(torch.as_tensor(x.astype(np.int64)),
                                 torch.as_tensor(w.astype(np.int64)),
                                 torch.as_tensor(ws), qt)
    want = J_modops.mul_mod_shoup(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(ws.astype(np.uint32)), qj)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dfloat_bit_exact():
    rng = np.random.default_rng(1)
    a, b, c, d = (rng.standard_normal(2048).astype(np.float32)
                  * np.float32(2.0) ** rng.integers(-40, 40, 2048)
                  .astype(np.float32) for _ in range(4))
    ta, tb, tc, td = (torch.as_tensor(v) for v in (a, b, c, d))
    ja, jb, jc, jd = (jnp.asarray(v) for v in (a, b, c, d))
    pairs = [
        (T_df.two_sum(ta, tb), J_df.two_sum(ja, jb)),
        (T_df.fast_two_sum(ta, tb), J_df.fast_two_sum(ja, jb)),
        (T_df.two_prod(ta, tb), J_df.two_prod(ja, jb)),
        (T_df.df_add_f32(ta, tb, tc), J_df.df_add_f32(ja, jb, jc)),
        (T_df.df_mul(ta, tb, tc, td), J_df.df_mul(ja, jb, jc, jd)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          np.asarray(w).view(np.int32))
    for v in (0.1, 1.0 / 3.0, 2.0 ** -83 * 7):
        assert T_df.df_from_f64(v) == J_df.df_from_f64(v)


def test_samplers():
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 1 << 20, (50000,), generator=gen)
    want = torch.tensor([bin(int(v)).count("1") for v in x])
    assert torch.equal(T_keys._popcount20(x), want)
    e = T_keys.cbd_coeffs(gen, (64, 256)).double()
    assert e.dtype == torch.float64 and e.abs().max() <= 20
    assert abs(e.mean()) < 0.1 and abs(e.var() - 10.0) < 0.5
    t = T_keys.ternary_coeffs(gen, (64, 256))
    assert set(t.unique().tolist()) == {-1, 0, 1}
    q = T_primes.ntt_primes(256, 3)
    u = T_keys.uniform_mod_q(gen, (7, 3, 256), q)
    assert u.dtype == torch.int32 and u.shape == (7, 3, 256)
    for l, ql in enumerate(q):
        assert 0 <= int(u[:, l].min()) and int(u[:, l].max()) < ql
        assert int(u[:, l].max()) > ql // 2
