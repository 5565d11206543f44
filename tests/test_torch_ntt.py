"""Port parity: the NTT tables and the plain versions of kernels K1 and K2.

The port's tables (four-step and butterfly) must be the JAX package's
arrays, and both its transforms must be bit-identical to the JAX butterfly
ntt.ntt / ntt.intt, to the unfused mxu.ntt_mxu / intt_mxu, to the Pallas
kernel mxu_pallas.ntt_mxu_fused / intt_mxu_fused and to the Pallas
butterfly pallas_ntt.ntt_fused / intt_fused (interpret mode off the TPU).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fhe_fed_tpu.rns import primes
from fhe_fed_tpu.ntt import tables as J_tables, ntt as J_ntt, mxu as J_mxu
from fhe_fed_tpu.ntt import mxu_pallas as J_mxu_pallas
from fhe_fed_tpu.ntt import pallas_ntt as J_pallas_ntt
from fhe_fed_tpu.ckks import keyswitch as J_ks
from fhe_fed_tpu_torch.ntt import mxu as T_mxu, ntt as T_ntt
from fhe_fed_tpu_torch.ntt import tables as T_tables
from fhe_fed_tpu_torch.ntt import mxu_pallas as T_mxu_pallas
from fhe_fed_tpu_torch.ntt import pallas_ntt as T_pallas_ntt
from fhe_fed_tpu_torch.ckks import params as T_params, ops as T_ops
from fhe_fed_tpu_torch.ckks import keys as T_keys

torch.set_num_threads(1)

_JAX_FIELDS = ("q", "c32", "c32_shoup", "offm", "r1f", "r2f", "r1i", "r2i",
               "midf", "midf_shoup", "midi", "midi_shoup")


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("n,L", [(256, 3), (8192, 5)])
def test_mxu_tables_match(n, L):
    mod = primes.ntt_primes(n, L)
    jt = J_mxu.make_mxu_tables(n, tuple(mod), materialize=False)
    tt = T_mxu.make_mxu_tables(n, mod)
    assert (tt.n1, tt.n2, tt.ring_dim) == (jt.n1, jt.n2, jt.ring_dim)
    for f in _JAX_FIELDS:
        np.testing.assert_array_equal(
            _np(getattr(tt, f)).astype(np.int64),
            np.asarray(getattr(jt, f)).astype(np.int64), err_msg=f)
    # The kernel's n-major copies are the same matrices transposed.
    for f in ("r1f", "r2f", "r1i", "r2i"):
        r = _np(getattr(tt, f))
        L_, _, s, s4 = r.shape
        np.testing.assert_array_equal(
            _np(getattr(tt, f + "_nk")),
            np.swapaxes(r.reshape(L_, 4 * s, s4), 1, 2))
    assert T_mxu.mxu_viable(n) == J_mxu.mxu_viable(n)
    assert not T_mxu.mxu_viable(32768) and not J_mxu.mxu_viable(32768)


_TABLE_FIELDS = ("q", "tab", "tab_shoup", "itab", "itab_shoup", "ninv",
                 "ninv_shoup")


def _assert_tables_equal(tt, jt):
    assert tt.ring_dim == jt.ring_dim
    for f in _TABLE_FIELDS:
        np.testing.assert_array_equal(
            _np(getattr(tt, f)).astype(np.int64),
            np.asarray(getattr(jt, f)).astype(np.int64), err_msg=f)
    # K2's pairs: each twiddle beside the low 32 bits of its Shoup word.
    for tw, w, ws in ((tt.tw_fwd, jt.tab, jt.tab_shoup),
                      (tt.tw_inv, jt.itab, jt.itab_shoup)):
        pairs = _np(tw).view(np.uint32)
        np.testing.assert_array_equal(pairs[..., 0], np.asarray(w))
        np.testing.assert_array_equal(pairs[..., 1], np.asarray(ws))


@pytest.mark.parametrize("n,L", [(256, 3), (32768, 2)])
def test_ntt_tables_match(n, L):
    mod = primes.ntt_primes(n, L)
    tt = T_tables.make_tables(n, mod)
    _assert_tables_equal(tt, J_tables.make_tables(n, mod))
    assert (tt.mxu is None) == (not J_mxu.mxu_viable(n))


def test_take_of_both_table_kinds():
    """take() is the key switch's extended basis {q_0 .. q_{live-1}, P}:
    the same tables as the JAX keyswitch._take_tables, and the four-step
    tables as the JAX MxuNttTables.take."""
    n, L = 256, 5
    mod = primes.ntt_primes(n, L)
    idx = np.array([0, 1, 2, L - 1])
    tt = T_tables.make_tables(n, mod).take(idx)
    _assert_tables_equal(
        tt, J_ks._take_tables(J_tables.make_tables(n, mod), idx))
    jm = J_mxu.make_mxu_tables(n, tuple(mod), materialize=False).take(idx)
    for f in _JAX_FIELDS:
        np.testing.assert_array_equal(
            _np(getattr(tt.mxu, f)).astype(np.int64),
            np.asarray(getattr(jm, f)).astype(np.int64), err_msg=f)
    sub = T_tables.make_tables(n, mod).slice_limbs(1, 3)
    _assert_tables_equal(sub, J_tables.make_tables(n, mod).slice_limbs(1, 3))
    assert sub.mxu.num_limbs == 2


def _case(n, L, batch, seed):
    mod = primes.ntt_primes(n, L)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, np.array(mod)[:, None],
                     size=(batch, L, n)).astype(np.uint32)
    return (mod, J_tables.make_tables(n, mod),
            J_mxu.make_mxu_tables(n, tuple(mod)) if J_mxu.mxu_viable(n)
            else None,
            T_tables.make_tables(n, mod), x)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int32))


@pytest.mark.parametrize("n,L,batch", [(256, 3, 3), (512, 2, 1), (512, 2, 3),
                                       (512, 2, 19), (8192, 5, 2)])
def test_ntt_matches_jax(n, L, batch):
    mod, tb, jmt, tt, x = _case(n, L, batch, seed=batch + n)
    assert tt.mxu is not None                 # the dispatch takes K1's path
    xj = jnp.asarray(x)
    want = np.asarray(J_ntt.ntt_jit(xj, tb))
    got = T_ntt.ntt(_t(x), tt).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got,
                                  np.asarray(J_mxu.ntt_mxu_jit(xj, jmt)))
    np.testing.assert_array_equal(
        got, np.asarray(J_mxu_pallas.ntt_mxu_fused(xj, jmt)))

    wantj = jnp.asarray(want)
    inv = np.asarray(J_ntt.intt_jit(wantj, tb))
    goti = T_ntt.intt(_t(want), tt).numpy().astype(np.uint32)
    np.testing.assert_array_equal(goti, inv)
    np.testing.assert_array_equal(goti, x)
    np.testing.assert_array_equal(
        goti, np.asarray(J_mxu.intt_mxu_jit(wantj, jmt)))
    np.testing.assert_array_equal(
        goti, np.asarray(J_mxu_pallas.intt_mxu_fused(wantj, jmt)))


@pytest.mark.parametrize("n,L,batch", [(256, 3, 7), (2048, 2, 3),
                                       (32768, 2, 1)])
def test_butterfly_matches_jax(n, L, batch):
    """The plain version of K2 against the JAX butterfly network; where the
    ring has a four-step split, also against the port's K1 plain version
    (two independent transforms)."""
    mod, tb, _, tt, x = _case(n, L, batch, seed=batch * n)
    want = np.asarray(J_ntt.ntt_jit(jnp.asarray(x), tb))
    got = T_ntt.ntt_butterfly(_t(x), tt)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    inv = T_ntt.intt_butterfly(got, tt)
    np.testing.assert_array_equal(
        inv.numpy().astype(np.uint32),
        np.asarray(J_ntt.intt_jit(jnp.asarray(want), tb)))
    np.testing.assert_array_equal(inv.numpy().astype(np.uint32), x)
    if tt.mxu is None:
        # No four-step split: the dispatch takes the butterfly.
        assert torch.equal(T_ntt.ntt(_t(x), tt), got)
        assert torch.equal(T_ntt.intt(got, tt), inv)
    else:
        assert torch.equal(T_mxu.ntt_mxu(_t(x), tt.mxu), got)


def test_butterfly_matches_pallas_interpret():
    """Once against JAX's Pallas butterfly kernel K2 in interpret mode."""
    mod, tb, _, tt, x = _case(256, 2, 1, seed=3)
    got = T_ntt.ntt_butterfly(_t(x), tt)
    np.testing.assert_array_equal(
        got.numpy().astype(np.uint32),
        np.asarray(J_pallas_ntt.ntt_fused(jnp.asarray(x), tb.stages,
                                          interpret=True)))
    np.testing.assert_array_equal(
        T_ntt.intt_butterfly(got, tt).numpy().astype(np.uint32),
        np.asarray(J_pallas_ntt.intt_fused(
            jnp.asarray(got.numpy().astype(np.uint32)), tb.stages,
            interpret=True)))


def test_ntt_leading_dims_and_slice_limbs():
    mod, tb, _, tt, x = _case(256, 4, 6, seed=4)
    x = x.reshape(2, 3, 4, 256)
    got = T_ntt.ntt(_t(x), tt).numpy().astype(np.uint32)
    np.testing.assert_array_equal(
        got, np.asarray(J_ntt.ntt_jit(jnp.asarray(x), tb)))
    sub = T_ntt.ntt(_t(x[..., 1:3, :]), tt.slice_limbs(1, 3))
    np.testing.assert_array_equal(
        sub.numpy().astype(np.uint32),
        np.asarray(J_ntt.ntt_jit(jnp.asarray(x[..., 1:3, :]),
                                 tb.slice_limbs(1, 3))))
    subb = T_ntt.ntt_butterfly(_t(x[..., 1:3, :]), tt.slice_limbs(1, 3))
    assert torch.equal(subb, sub)


def test_ring_without_mxu_split_round_trips():
    """N = 32768 has no four-step split: keygen, both encrypts and decrypt
    run through the plain butterfly on the CPU."""
    p = T_params.make_params(batch=128, scale_bits=40, mult_depth=1,
                             ring_dim=32768)
    ctx = T_params.make_context(p)
    assert ctx.tables.mxu is None
    gen = torch.Generator().manual_seed(0)
    sk, pk = T_keys.keygen(ctx, gen)
    vals = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (1, 32768)).astype(np.float32))
    for ct in (T_ops.encrypt(ctx, pk, vals, gen),
               T_ops.encrypt_symmetric(ctx, sk, vals, gen)):
        out = T_ops.decrypt(ctx, sk, ct)
        np.testing.assert_allclose(out.numpy(), vals.numpy(), atol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    _, _, _, tt, x = _case(256, 3, 1, seed=0)
    for fn in (T_mxu_pallas.ntt_mxu_fused, T_mxu_pallas.intt_mxu_fused):
        with pytest.raises(ValueError, match="CUDA"):
            fn(_t(x), tt.mxu)
    for fn in (T_pallas_ntt.ntt_fused, T_pallas_ntt.intt_fused):
        with pytest.raises(ValueError, match="CUDA"):
            fn(_t(x), tt)
