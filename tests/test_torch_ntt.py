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


def _w(f):
    """K1's copy of the JAX-layout table `f` (r1f -> w1f)."""
    return "w" + f[1:]


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
    # K1's copies: the same matrices in its body's layout (mma_sync at
    # N = 256: transposed n-major; wgmma at 8192: wg_layout).
    assert tt.body == ("mma_sync" if n == 256 else "wgmma")
    for f in ("r1f", "r2f", "r1i", "r2i"):
        r = _np(getattr(tt, f))
        L_, _, s, s4 = r.shape
        want = (np.swapaxes(r.reshape(L_, 4 * s, s4), 1, 2)
                if tt.body == "mma_sync" else T_mxu.wg_layout(r))
        np.testing.assert_array_equal(_np(getattr(tt, _w(f))), want)
    assert (tt.midf_pair is None) == (tt.body == "mma_sync")
    assert T_mxu.mxu_viable(n) == J_mxu.mxu_viable(n)
    assert not T_mxu.mxu_viable(32768) and not J_mxu.mxu_viable(32768)


@pytest.mark.parametrize("n", [256, 4096, 8192, 16384])
def test_wg_tables_permute_jax_tables(n):
    """K1's wgmma copies hold the JAX package's planes, moved: entry
    [l, wg_column(j, t), 4s + i] is r[l, i, s, j*S + t]. At N = 256, which
    the mma_sync body serves, the tables hold no such copy: wg_layout
    itself is checked."""
    mod = primes.ntt_primes(n, 2)
    jt = J_mxu.make_mxu_tables(n, tuple(mod), materialize=False)
    tt = T_mxu.make_mxu_tables(n, mod)
    wgmma = tt.body == "wgmma"
    assert wgmma == (n >= 4096)
    for f in ("r1f", "r2f", "r1i", "r2i"):
        r = np.asarray(getattr(jt, f))
        L, _, S, _ = r.shape
        w = _np(getattr(tt, _w(f))) if wgmma else T_mxu.wg_layout(r)
        assert w.shape == (L, 4 * S, 4 * S) and w.dtype == np.int8
        i, s, j, t = np.meshgrid(np.arange(4), np.arange(S), np.arange(4),
                                 np.arange(S), indexing="ij")
        np.testing.assert_array_equal(
            w[:, T_mxu.wg_column(j, t), 4 * s + i], r[:, i, s, j * S + t],
            err_msg=f)
        jj, tt_ = np.meshgrid(np.arange(4), np.arange(S), indexing="ij")
        assert sorted(T_mxu.wg_column(jj, tt_).ravel()) == list(range(4 * S))
    for f in ("midf", "midi"):
        if not wgmma:
            assert getattr(tt, f + "_pair") is None
            continue
        pair = _np(getattr(tt, f + "_pair"))
        np.testing.assert_array_equal(pair[..., 0], np.asarray(getattr(jt, f))
                                      .astype(np.int64).astype(np.int32))
        np.testing.assert_array_equal(
            pair[..., 1].view(np.uint32),
            np.asarray(getattr(jt, f + "_shoup")).astype(np.uint32))


def _digits4(x, q):
    """The kernel's packed digit split: the centred residue plus
    0x80808080, XOR 0x80808080, read as four little-endian int8."""
    xs = x - torch.where(x > (q >> 1), q, 0)
    w = ((xs + 0x80808080) & 0xFFFFFFFF) ^ 0x80808080
    return torch.stack([((w >> (8 * i)) & 255).to(torch.uint8).view(torch.int8)
                        for i in range(4)], dim=-1)


def _plane_offset(q):
    """The kernel's plane_offset: q shifted into [2^48, 2^49)."""
    return torch.as_tensor([int(v) << (49 - int(v).bit_length())
                            for v in q.ravel()]).view(q.shape)


def _umulhi(a, b):
    """The high word of the u32 product a * b, without int64 overflow."""
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def _mullo(a, b):
    """The low word of the u32 product a * b."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) \
        & 0xFFFFFFFF


def _reasm64(p0, p1, p2, p3, q, c32, c32s, qinv):
    """The kernel's reassembly in its u32 / u64 arithmetic: one 64-bit sum
    made positive with plane_offset(q) (a negative sum would wrap, as the
    kernel's uint64 does), then hi * (2^32 mod q) + lo, each reduced by a
    Shoup step."""
    m32 = 0xFFFFFFFF
    s = p0 + p1 * 256 + p2 * 65536 + p3 * 16777216 + _plane_offset(q)
    hi, lo = (s >> 32) & m32, s & m32
    r1 = (_mullo(hi, c32) - _mullo(_umulhi(hi, c32s), q)) & m32
    r1 = torch.where(r1 >= q, r1 - q, r1)
    r2 = (lo - _mullo(_umulhi(lo, qinv), q)) & m32
    r2 = torch.where(r2 >= q, r2 - q, r2)
    r = r1 + r2
    return torch.where(r >= q, r - q, r)


def _stage_wg(x, w, mt):
    """One stage as K1's wgmma body computes it: packed digits (K byte
    4s + i) times the wg table, each output's four planes read from the
    columns wg_column(j, t), reassembled with the kernel's arithmetic."""
    L, B, F, S = x.shape
    q = torch.as_tensor(mt.q).view(L, 1, 1, 1)
    c32 = torch.as_tensor(mt.c32).view(L, 1, 1, 1)
    c32s = torch.as_tensor(mt.c32_shoup).view(L, 1, 1, 1)
    qinv = (1 << 32) // q
    d = _digits4(x, q).reshape(L, B * F, 4 * S).to(torch.float32)
    planes = torch.bmm(d, w.to(torch.float32).transpose(1, 2))
    planes = planes.to(torch.int64).view(L, B, F, 4 * S)
    t = torch.arange(S)
    p = [planes[..., T_mxu.wg_column(j, t)] for j in range(4)]
    return _reasm64(*p, q, c32, c32s, qinv)


@pytest.mark.parametrize("n", [4096, 8192, 16384])
def test_wg_layout_product_matches_stage(n):
    """The wgmma body's layout and arithmetic, rehearsed on the CPU: each
    stage on the wg tables equals mxu._stage on the JAX-layout tables, bit
    for bit, at uniform residues and at the extremes 0, q // 2, q // 2 + 1,
    q - 1."""
    mod = primes.ntt_primes(n, 2)
    mt = T_mxu.make_mxu_tables(n, mod)
    q = torch.as_tensor(mt.q)
    rng = np.random.default_rng(n)
    for f in ("r1f", "r2f", "r1i", "r2i"):
        S = getattr(mt, f).shape[2]
        x = torch.as_tensor(rng.integers(0, np.array(mod)[:, None, None, None],
                                         size=(2, 3, 4, S)))
        qq = q.view(2, 1, 1, 1)
        x[:, 0, 0, :4] = torch.cat([0 * qq, qq // 2, qq // 2 + 1, qq - 1],
                                   dim=-1)[:, 0, 0]
        assert torch.equal(_stage_wg(x, getattr(mt, _w(f)), mt),
                           T_mxu._stage(x, getattr(mt, f), q)), f


@pytest.mark.parametrize("bits", [22, 26, 30, 31])
def test_wg_reassembly_any_modulus(bits):
    """The wgmma body's reassembly is exact for every q < 2^31: at the
    extreme plane sums (each P_j at +-2^23) against Python's exact
    remainder, and a whole stage at N = 4096 against mxu._stage, for
    `bits`-bit NTT primes."""
    mod = primes.ntt_primes(4096, 2, target_bits=bits)
    mt = T_mxu.make_mxu_tables(4096, mod)
    q = torch.as_tensor(mt.q).view(2, 1)
    signs = torch.as_tensor(np.array(np.meshgrid(*[[-1, 0, 1]] * 4))
                            .reshape(4, -1)) * (1 << 23)
    got = _reasm64(*signs[:, None, :], q, torch.as_tensor(mt.c32).view(2, 1),
                   torch.as_tensor(mt.c32_shoup).view(2, 1), (1 << 32) // q)
    for l, ql in enumerate(mod):
        want = [int(sum(int(v) << (8 * j) for j, v in enumerate(col))) % ql
                for col in signs.T]
        assert got[l].tolist() == want, (bits, ql)
    x = torch.as_tensor(np.random.default_rng(bits).integers(
        0, np.array(mod)[:, None, None, None], size=(2, 3, 64, 64)))
    assert torch.equal(_stage_wg(x, mt.w1f, mt),
                       T_mxu._stage(x, mt.r1f, torch.as_tensor(mt.q)))


def test_entry_points_default_to_the_card(tmp_path):
    """CKKS, ThresholdCKKS, Masking, make_context, the key decoders and the
    interop helpers take "cuda" when no device is given; where torch sees
    no card, asking for it raises (naming device=) before anything is
    allocated. On the card: tests/test_torch_cuda.py."""
    import inspect
    from fhe_fed_tpu_torch import CKKS, ThresholdCKKS, Masking, interop
    from fhe_fed_tpu_torch.ckks import serial as T_serial
    for fn in (CKKS.__init__, ThresholdCKKS.__init__, Masking.__init__,
               T_params.make_context, T_serial.deserialize_secret_key,
               T_serial.deserialize_public_key,
               interop.context_arrays_from_numpy, interop.keys_from_numpy,
               interop.ciphertext_from_numpy,
               interop.seeded_ciphertext_from_numpy,
               interop.kswitch_key_from_numpy,
               interop.party_secrets_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    params = T_params.make_params(batch=128, scale_bits=40, mult_depth=1,
                                  ring_dim=256)
    if not torch.cuda.is_available():
        for make in (lambda: CKKS(cryptodir=str(tmp_path)),
                     lambda: Masking(cryptodir=str(tmp_path)),
                     lambda: T_params.make_context(params),
                     lambda: interop.ciphertext_from_numpy(
                         np.zeros((1, 2, 1, 256), np.uint32), 1.0, 0)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    assert CKKS(cryptodir=str(tmp_path), device="cpu").device.type == "cpu"


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
    ctx = T_params.make_context(p, device="cpu")
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
