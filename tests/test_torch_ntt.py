"""Port parity: the four-step NTT tables and the plain version of kernel K1.

The port's MXU tables must be the JAX package's arrays, and its transform
must be bit-identical to the JAX butterfly ntt.ntt / ntt.intt, to the
unfused mxu.ntt_mxu / intt_mxu and to the Pallas kernel
mxu_pallas.ntt_mxu_fused / intt_mxu_fused (interpret mode off the TPU).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fhe_fed_tpu.rns import primes
from fhe_fed_tpu.ntt import tables as J_tables, ntt as J_ntt, mxu as J_mxu
from fhe_fed_tpu.ntt import mxu_pallas as J_mxu_pallas
from fhe_fed_tpu_torch.ntt import mxu as T_mxu, ntt as T_ntt
from fhe_fed_tpu_torch.ntt import mxu_pallas as T_mxu_pallas
from fhe_fed_tpu_torch.ckks import params as T_params, ops as T_ops

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


def _case(n, L, batch, seed):
    mod = primes.ntt_primes(n, L)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, np.array(mod)[:, None],
                     size=(batch, L, n)).astype(np.uint32)
    return (mod, J_tables.make_tables(n, mod),
            J_mxu.make_mxu_tables(n, tuple(mod)),
            T_mxu.make_mxu_tables(n, mod), x)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int32))


@pytest.mark.parametrize("n,L,batch", [(256, 3, 3), (512, 2, 1), (512, 2, 3),
                                       (512, 2, 19), (8192, 5, 2)])
def test_ntt_matches_jax(n, L, batch):
    mod, tb, jmt, tmt, x = _case(n, L, batch, seed=batch + n)
    xj = jnp.asarray(x)
    want = np.asarray(J_ntt.ntt_jit(xj, tb))
    got = T_ntt.ntt(_t(x), tmt).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got,
                                  np.asarray(J_mxu.ntt_mxu_jit(xj, jmt)))
    np.testing.assert_array_equal(
        got, np.asarray(J_mxu_pallas.ntt_mxu_fused(xj, jmt)))

    wantj = jnp.asarray(want)
    inv = np.asarray(J_ntt.intt_jit(wantj, tb))
    goti = T_ntt.intt(_t(want), tmt).numpy().astype(np.uint32)
    np.testing.assert_array_equal(goti, inv)
    np.testing.assert_array_equal(goti, x)
    np.testing.assert_array_equal(
        goti, np.asarray(J_mxu.intt_mxu_jit(wantj, jmt)))
    np.testing.assert_array_equal(
        goti, np.asarray(J_mxu_pallas.intt_mxu_fused(wantj, jmt)))


def test_ntt_leading_dims_and_slice_limbs():
    mod, tb, _, tmt, x = _case(256, 4, 6, seed=4)
    x = x.reshape(2, 3, 4, 256)
    got = T_ntt.ntt(_t(x), tmt).numpy().astype(np.uint32)
    np.testing.assert_array_equal(
        got, np.asarray(J_ntt.ntt_jit(jnp.asarray(x), tb)))
    sub = T_ntt.ntt(_t(x[..., 1:3, :]), tmt.slice_limbs(1, 3))
    np.testing.assert_array_equal(
        sub.numpy().astype(np.uint32),
        np.asarray(J_ntt.ntt_jit(jnp.asarray(x[..., 1:3, :]),
                                 tb.slice_limbs(1, 3))))


def test_ring_without_mxu_split_raises():
    p = T_params.make_params(batch=128, scale_bits=40, mult_depth=1,
                             ring_dim=32768)
    ctx = T_params.make_context(p)
    assert ctx.mxu is None
    x = torch.zeros((1, p.chain_len, 32768), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="K2"):
        T_ntt.ntt(x, ctx.mxu)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="K2"):
        T_ops.encrypt(ctx, None, torch.zeros(1, 32768), gen)


def test_kernel_wrapper_refuses_cpu_tensors():
    _, _, _, tmt, x = _case(256, 3, 1, seed=0)
    for fn in (T_mxu_pallas.ntt_mxu_fused, T_mxu_pallas.intt_mxu_fused):
        with pytest.raises(ValueError, match="CUDA"):
            fn(_t(x), tmt)
