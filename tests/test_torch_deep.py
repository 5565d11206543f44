"""Port parity at the limits of the parameter range: the deepest chains
make_params accepts (17 and 27 live limbs) and the ring N = 65536, and CPU
rehearsals of the kernels that serve them.

Held against the JAX package, bit-exact (residues as uint32, decoded f32 as
int32 bit patterns, NaN positions included): the plain weighted sum (K3's
plain version) and decode_core (K4's) at 17 and 27 live limbs, the plain
NTT at N = 65536. Rehearsed against the port's plain versions, mirroring
each kernel's index arithmetic: K4's tensor-core decode (bytes(y) @ m_bytes
from the kernel's constant block, one carry pass over NP planes, the tail
that stops at the top nonzero digit) at every live count, with the
exactness bounds the kernel's source states; K2's two-half split at
N = 512 and 65536; K3's parameter block.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fhe_fed_tpu.rns import primes
from fhe_fed_tpu.ntt import tables as J_tables, ntt as J_ntt
from fhe_fed_tpu.ckks import params as J_params, ops as J_ops
from fhe_fed_tpu.ckks import encoding as J_enc
from fhe_fed_tpu_torch.ntt import tables as T_tables, ntt as T_ntt
from fhe_fed_tpu_torch.ckks import params as T_params, ops as T_ops
from fhe_fed_tpu_torch.ckks import encoding as T_enc
from fhe_fed_tpu_torch.ckks import pallas_agg as T_pagg
from fhe_fed_tpu_torch.ckks import pallas_decode as T_pdec
from fhe_fed_tpu_torch.rns import modops
from fhe_fed_tpu_torch.utils import dfloat
from fhe_fed_tpu_torch import interop

torch.set_num_threads(1)

# mult_depth 14 and 24: 17 and 27 live limbs (3 base primes at 2^40), the
# latter the deepest chain make_params accepts at N = 32768; ring 256 here.
DEPTH = {17: 14, 27: 24}


def _small(live):
    return dict(batch=128, scale_bits=40, mult_depth=DEPTH[live],
                ring_dim=256)


@pytest.fixture(scope="module")
def ctxs():
    out = {}
    for live in DEPTH:
        jctx = J_params.make_context(J_params.make_params(**_small(live)))
        tctx = T_params.make_context(T_params.make_params(**_small(live)),
                                     device="cpu")
        assert tctx.params.chain_len == live
        out[live] = (jctx, tctx)
    return out


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _residues(rng, moduli, shape):
    q = np.array(moduli, dtype=np.uint64)
    return (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64)
            % q[:, None]).astype(np.uint32)


@pytest.mark.parametrize("live", [17, 27])
@pytest.mark.parametrize("K", [3, 9])
def test_weighted_sum_deep_chain_matches_jax(ctxs, live, K):
    """Both lowerings (K <= 8 chain, modsum_clients) against the JAX
    _weighted_sum_impl (a jitted function)."""
    jctx, tctx = ctxs[live]
    rng = np.random.default_rng(live * K)
    moduli = tctx.params.moduli[:live]
    stacked = _residues(rng, moduli, (K, 2, 2, live, 256))
    weights = rng.uniform(0, 1, K)
    ds = float(moduli[-1])
    jr, js = zip(*(J_enc.encode_scalar(moduli, w, ds) for w in weights))
    want = np.asarray(J_ops._weighted_sum_impl(      # jitted
        jctx, jnp.asarray(stacked), jnp.asarray(np.stack(jr)),
        jnp.asarray(np.stack(js))))
    ct = interop.ciphertext_from_numpy(stacked, 2.0 ** 40, 0, device="cpu")
    got = T_ops.weighted_sum(tctx, ct, weights)
    np.testing.assert_array_equal(got.data.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("live", [17, 27])
def test_decode_core_deep_chain_matches_jax(ctxs, live):
    """The plain decode against the JAX decode_core on random residues
    and on the residues of -1 (every residue q_l - 1), at a scale that
    decodes them and at scales that overflow (NaN, compared by position)
    and underflow. Op by op: jitted, XLA compiles the unrolled live x ndig
    plane loop for ~45 s per scale at 27 limbs, eagerly it runs in ~3 s."""
    jctx, tctx = ctxs[live]
    moduli = tctx.params.moduli[:live]
    res = _residues(np.random.default_rng(live), moduli, (2, live, 256))
    res[1] = (np.array(moduli, dtype=np.uint32) - 1)[:, None]
    jdc = jctx.dec_consts[live - 1]
    for scale in (2.0 ** 40, 2.0 ** 700, 2.0 ** -30):
        want = J_enc.decode_core(jdc, jctx.q[:live], jnp.asarray(res), scale)
        got = T_enc.decode_core(tctx.dec_consts[live - 1], tctx.q[:live],
                                torch.as_tensor(res.astype(np.int32)),
                                scale).numpy()
        # XLA and torch give an overflow's NaN different sign bits.
        nan = np.isnan(np.asarray(want))
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("live", [17, 27])
def test_decode_bytes_match_jax(ctxs, live):
    """DecodeConsts.m_bytes (K4's B operand) is the JAX package's."""
    jctx, tctx = ctxs[live]
    np.testing.assert_array_equal(
        tctx.dec_consts[live - 1].m_bytes,
        np.asarray(jctx.dec_consts[live - 1].m_bytes).astype(np.uint8))


def test_ntt_65536_matches_jax():
    """N = 65536 (no four-step split: the dispatch takes K2's plain
    version), batch 1, two limbs, against the JAX ntt / intt, jitted."""
    n, L = 65536, 2
    mod = primes.ntt_primes(n, L)
    jtb = J_tables.make_tables(n, mod)
    ttb = T_tables.make_tables(n, mod)
    assert ttb.mxu is None
    x = _residues(np.random.default_rng(1), mod, (1, L, n))
    want = np.asarray(J_ntt.ntt_jit(jnp.asarray(x), jtb))
    got = T_ntt.ntt(torch.as_tensor(x.astype(np.int32)), ttb)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    inv = T_ntt.intt(got, ttb)
    np.testing.assert_array_equal(
        inv.numpy().astype(np.uint32),
        np.asarray(J_ntt.intt_jit(jnp.asarray(want), jtb)))
    np.testing.assert_array_equal(inv.numpy().astype(np.uint32), x)


# -- K4: the tensor-core decode, rehearsed ----------------------------------

def _unpack_consts(words, live):
    """The fields of K4's constant block, read back at the offsets of the
    kernel's Dims<live>; B rebuilt from its fragment order."""
    ks, nt, npl = T_pdec.dims(live)
    h = T_pdec.HEADER
    assert list(words[:3]) == [live, ks, nt] and words[6] == words.size
    f = {"q": words[h:h + live], "pinv": words[h + live:h + 2 * live],
         "pinvs": words[h + 2 * live:h + 3 * live],
         "invq": words[h + 3 * live:h + 4 * live].view(np.float32),
         "qdig": words[h + 4 * live:h + 4 * live + npl],
         "tw": words[h + 4 * live + npl:h + 4 * live + 2 * npl].view(
             np.float32),
         "du": int(words[3]), "c": words[4:6].view(np.float32)}
    b_off = (h + 4 * live + 2 * npl + 1) & ~1
    frag = words[b_off:].reshape(ks, nt, 32, 2)
    B = np.zeros((32 * ks, 8 * nt), dtype=np.int64)
    for s in range(ks):
        for j in range(nt):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r in range(2):
                    w = int(frag[s, j, lane, r])
                    for i in range(4):
                        B[32 * s + 16 * r + 4 * t + i, 8 * j + g] = \
                            (w >> (8 * i)) & 0xFF
    f["B"] = B
    return f


def _k4_rehearsal(dc, moduli, res, scale):
    """K4's arithmetic on the CPU from its constant block: y and k as phase
    1, P8 = bytes(y) @ B in int64 and the 16-bit planes as phase 2 (bounds
    asserted), one carry pass over NP planes, the sign from its final carry,
    and the magnitude's digits and the tail up to the highest nonzero one
    as phase 3."""
    live = dc.live
    _, _, npl = T_pdec.dims(live)
    f = _unpack_consts(T_pdec.kernel_consts(dc, moduli, scale), live)

    def col(a):
        return torch.as_tensor(a.astype(np.int64))[:, None]

    y = modops.mul_mod_shoup(res.to(torch.int64), col(f["pinv"]),
                             col(f["pinvs"]), col(f["q"]))
    fsum = torch.zeros(res.shape[:-2] + res.shape[-1:], dtype=torch.float32)
    for l in range(live):
        fsum = fsum + y[..., l, :].to(torch.int32).to(torch.float32) * \
            torch.tensor(f["invq"][l])
    k = torch.round(fsum).to(torch.int64)
    assert int(k.max()) <= live
    a = torch.stack([(y >> (8 * i)) & 0xFF for i in range(4)], dim=-2)
    a = a.reshape(res.shape[:-2] + (4 * live, res.shape[-1]))
    a = torch.nn.functional.pad(a, (0, 0, 0, f["B"].shape[0] - 4 * live))
    p8 = torch.einsum("...kn,kd->...dn", a, torch.as_tensor(f["B"]))
    assert int(p8.max()) < 4 * live * 255 ** 2 < 2 ** 23
    pl = p8[..., 0::2, :] + (p8[..., 1::2, :] << 8)
    assert int(pl.max()) < 2 ** 31
    carry = torch.zeros_like(k)
    v = []
    for d in range(npl):
        r = pl[..., d, :] - k * int(f["qdig"][d]) + carry
        assert int(r.abs().max()) < 2 ** 31
        v.append(r & 0xFFFF)
        carry = r >> 16
    neg = carry < 0
    flip = torch.where(neg, 0xFFFF, 0)
    carry = neg.to(torch.int64)
    top = torch.full_like(k, -1)
    mag = []
    for d in range(npl):
        tt = (v[d] ^ flip) + carry
        mag.append(tt & 0xFFFF)
        carry = tt >> 16
        top = torch.where(mag[d] != 0, d, top)
    hi = torch.zeros(k.shape, dtype=torch.float32)
    lo = torch.zeros_like(hi)
    overflow = torch.zeros(k.shape, dtype=torch.bool)
    for d in range(npl):
        run = d <= top                  # the tail stops at the top digit
        if d < f["du"]:
            h2, l2 = dfloat.df_add_f32(
                hi, lo, mag[d].to(torch.float32) * torch.tensor(f["tw"][d]))
            hi, lo = torch.where(run, h2, hi), torch.where(run, l2, lo)
        else:
            overflow = overflow | (run & (mag[d] != 0))
    hi = torch.where(overflow, torch.full_like(hi, math.inf), hi)
    c = torch.tensor(f["c"])
    hi, lo = dfloat.df_mul(hi, lo, c[0], c[1])
    return (hi + lo) * torch.where(neg, -1.0, 1.0).to(torch.float32)


@pytest.fixture(scope="module")
def deep_tctx():
    return T_params.make_context(T_params.make_params(**_small(27)),
                                 device="cpu")


@pytest.mark.parametrize("live", range(1, 28))
def test_k4_rehearsal_matches_decode_core(deep_tctx, live):
    """At every live count, on random residues, on every residue q_l - 1
    (the value -1) and on y_l = q_l - 1 for every limb (the largest k,
    k = live), at scales that decode, overflow and underflow."""
    tctx = deep_tctx
    moduli = tctx.params.moduli[:live]
    Q = math.prod(moduli)
    res = _residues(np.random.default_rng(live), moduli, (3, live, 64))
    res[1] = (np.array(moduli, dtype=np.uint32) - 1)[:, None]
    res[2] = np.array([(q - 1) * (Q // q) % q for q in moduli],
                      dtype=np.uint32)[:, None]
    r = torch.as_tensor(res.astype(np.int32))
    dc = tctx.dec_consts[live - 1]
    for scale in (2.0 ** 40, 2.0 ** 71, 2.0 ** -30, 2.0 ** (31 * live)):
        got = _k4_rehearsal(dc, tctx.params.moduli, r, scale)
        want = T_enc.decode_core(dc, tctx.q[:live], r, scale)
        np.testing.assert_array_equal(_bits(got.numpy()),
                                      _bits(want.numpy()))


def test_k4_constant_block_layout(deep_tctx):
    """The block's fields are the DecodeConsts they come from, zero past
    ndig and past the digits that count, and B is m_bytes zero-padded."""
    tctx = deep_tctx
    for live in (1, 4, 17, 27):
        dc = tctx.dec_consts[live - 1]
        _, _, npl = T_pdec.dims(live)
        assert dc.ndig <= npl
        f = _unpack_consts(T_pdec.kernel_consts(dc, tctx.params.moduli,
                                                2.0 ** 40), live)
        np.testing.assert_array_equal(f["q"], tctx.params.moduli[:live])
        np.testing.assert_array_equal(f["pinv"], dc.punc_inv)
        np.testing.assert_array_equal(f["pinvs"], dc.punc_inv_shoup)
        np.testing.assert_array_equal(f["qdig"][:dc.ndig], dc.q_digits)
        assert not f["qdig"][dc.ndig:].any()
        du = min(11, npl)          # 16 d - 40 <= 127
        assert f["du"] == du and not f["tw"][du:].any()
        B = f["B"]
        np.testing.assert_array_equal(
            B[:4 * live, :2 * dc.ndig], dc.m_bytes)
        assert not B[4 * live:].any() and not B[:, 2 * dc.ndig:].any()


# -- K2: the two-half split at N = 65536, rehearsed --------------------------

def _k2_halves(x, tb, forward):
    """K2's two-block split on the CPU: H = 2 blocks per polynomial, block
    h holding residues [h N/2, (h+1) N/2), each in-half stage a butterfly
    j -> (i0, i1) under twiddle index m + h*m/2 + j/t; the cross-half stage
    as the kernel runs it (forward: on load; inverse: from the partner's
    half). The kernel's stage groups within a half are rehearsed in
    tests/test_torch_k2.py."""
    n = tb.ring_dim
    nl, log_n = n // 2, n.bit_length() - 1
    q = int(tb.q[0])
    tab = (tb.tab if forward else tb.itab)[0].to(torch.int64)
    tabs = (tb.tab_shoup if forward else tb.itab_shoup)[0].to(torch.int64)
    qt = torch.tensor(q)

    def mul(a, i):
        return modops.mul_mod_shoup(a, tab[i], tabs[i], qt)

    x = x.to(torch.int64)
    if forward:
        u, v = x[:nl], mul(x[nl:], 1)
        s = [modops.add_mod(u, v, qt), modops.sub_mod(u, v, qt)]
    else:
        s = [x[:nl].clone(), x[nl:].clone()]
    j = torch.arange(nl // 2)
    for h in range(2):
        log_t = log_n - 2 if forward else 0
        stages = (2 ** e for e in (range(1, log_n) if forward
                                   else range(log_n - 1, 0, -1)))
        for m in stages:
            i = j >> log_t
            i0 = (i << (log_t + 1)) + (j & ((1 << log_t) - 1))
            i1 = i0 + (1 << log_t)
            w = m + h * (m // 2) + i
            a, b = s[h][i0], s[h][i1]
            if forward:
                bw = mul(b, w)
                s[h][i0], s[h][i1] = (modops.add_mod(a, bw, qt),
                                      modops.sub_mod(a, bw, qt))
                log_t -= 1
            else:
                s[h][i0] = modops.add_mod(a, b, qt)
                s[h][i1] = mul(modops.sub_mod(a, b, qt), w)
                log_t += 1
    if not forward:
        x0, x1 = s
        s = [modops.add_mod(x0, x1, qt), mul(modops.sub_mod(x0, x1, qt), 1)]
        ni = torch.tensor(int(tb.ninv[0]))
        nis = torch.tensor(int(tb.ninv_shoup[0]))
        s = [modops.mul_mod_shoup(p, ni, nis, qt) for p in s]
    return torch.cat(s).to(torch.int32)


@pytest.mark.parametrize("n", [512, 65536])
def test_k2_half_split_matches_butterfly(n):
    tb = T_tables.make_tables(n, primes.ntt_primes(n, 1))
    x = torch.as_tensor(_residues(np.random.default_rng(n), tuple(tb.q),
                                  (1, n)).astype(np.int32))
    y = T_ntt.ntt_butterfly(x[None], tb)[0, 0]
    assert torch.equal(_k2_halves(x[0], tb, True), y)
    assert torch.equal(_k2_halves(y, tb, False), x[0])
    assert torch.equal(_k2_halves(y, tb, False),
                       T_ntt.intt_butterfly(y[None, None], tb)[0, 0])


# -- K3: the parameter block --------------------------------------------------

def test_k3_weight_block(ctxs):
    """The live moduli, then the (K, live) pairs (weight, low word of its
    Shoup word) as uint32; a wrong shape raises."""
    _, tctx = ctxs[27]
    moduli = tctx.params.moduli[:27]
    w_res, w_shoup, _ = T_ops._encode_weights(tctx, [0.5, 0.2, 0.3], 27, 0)
    block = T_pagg.weight_block(w_res, w_shoup, moduli)
    assert block.dtype == np.uint32 and block.shape == (27 + 2 * 3 * 27,)
    np.testing.assert_array_equal(block[:27], moduli)
    pairs = block[27:].reshape(3, 27, 2).astype(np.int64)
    np.testing.assert_array_equal(pairs[..., 0], w_res)
    np.testing.assert_array_equal(pairs[..., 1], w_shoup)
    assert 3 * 27 <= T_pagg.PARAM_PAIRS < 64 * 27
    with pytest.raises(ValueError, match="moduli"):
        T_pagg.weight_block(w_res, w_shoup, moduli[:26])
