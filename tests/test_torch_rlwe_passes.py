"""The encode, encrypt and decrypt passes of csrc/rlwe_passes.cu on the
CPU: the encode table, a rehearsal of the encode pass's arithmetic
(tests/rlwe_rehearsal.py) against the plain version it replaces, what it
gives outside the plain version's exact range, the CPU dispatch of the
encrypt and decrypt to their plain versions, and the wrappers' refusals.
The kernels themselves run in tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

from fhe_fed_tpu_torch import cuda_lib
from fhe_fed_tpu_torch.ckks import params as P, encoding, ops, keys
from fhe_fed_tpu_torch.ckks import rlwe_passes
from fhe_fed_tpu_torch.rns import modops

import rlwe_rehearsal as R

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _ctx(**kw):
    kw = {**dict(batch=128, scale_bits=52, mult_depth=1, ring_dim=256), **kw}
    return P.make_context(P.make_params(**kw), device=CPU)


@pytest.mark.parametrize("kw", [
    dict(), dict(batch=4096, mult_depth=1, ring_dim=8192),
    dict(batch=4096, mult_depth=24, ring_dim=32768),
    dict(batch=128, scale_bits=20, ring_dim=256)])
def test_encode_table_is_powers_of_two_with_shoup_words(kw):
    ctx = _ctx(**kw)
    moduli = ctx.params.moduli
    tab = ctx.enc_table.to(torch.int64) & 0xFFFFFFFF
    assert tab.shape == (len(moduli), P.ENCODE_EXPS, 2)
    for l, q in enumerate(moduli):
        want = [pow(2, k, q) for k in range(P.ENCODE_EXPS)]
        assert tab[l, :, 0].tolist() == want
        assert tab[l, :, 1].tolist() == [(w << 32) // q for w in want]
    # The largest finite float32's exponent less 23 is the last entry.
    assert P.ENCODE_EXPS - 1 == 127 - 23


@pytest.mark.parametrize("scale_bits,limbs,kw", [
    (52, 4, dict(batch=4096, ring_dim=8192)),
    (40, 2, dict(batch=128, ring_dim=256)),
    (52, 27, dict(batch=4096, mult_depth=24, ring_dim=32768)),
    (20, 3, dict(batch=128, ring_dim=256))])
def test_encode_rehearsal_equals_the_plain_version(scale_bits, limbs, kw):
    """Inside |round(v * scale)| < 2**96 the pass's method gives the plain
    version's residues, with and without the error, over random values of
    every magnitude and the edges."""
    ctx = _ctx(scale_bits=scale_bits, **kw)
    scale = 2.0 ** scale_bits
    rng = np.random.default_rng(scale_bits + limbs)
    n = 256
    mag = 2.0 ** rng.uniform(-70, 95 - scale_bits, size=(3, n))
    vals = (rng.choice([-1.0, 1.0], size=(3, n)) * mag).astype(np.float32)
    vals[0, :2] = rng.standard_normal(2)
    edges = R.edge_values(scale_bits)
    vals[1, :edges.size] = edges
    values = torch.as_tensor(vals)
    err = torch.as_tensor(rng.integers(-10, 11, size=(3, n)),
                          dtype=torch.int32)
    err[2, :4] = torch.tensor([-(2 ** 31), 2 ** 31 - 1, -ctx.params.moduli[0],
                               ctx.params.moduli[0] - 1])
    for e in (None, err):
        want = encoding.encode_coeff(ctx, values, scale, limbs, error=e)
        got = R.rehearse_encode(ctx, values, scale, limbs, e)
        assert want.dtype == torch.int32 and want.shape == (3, limbs, n)
        assert torch.equal(got, want)


def test_encode_coeff_error_is_lift_and_add():
    """encode_coeff with `error` on the CPU is the old secret-key encrypt's
    first step: the encode, keys.lift_signed and add_mod."""
    ctx = _ctx()
    g = torch.Generator().manual_seed(3)
    values = torch.randn((2, 256), generator=g)
    e = keys.cbd_coeffs(g, (2, 256))
    L = ctx.params.chain_len
    pt = encoding.encode_coeff(ctx, values, ctx.params.scale)
    want = modops.add_mod(pt, keys.lift_signed(e, ctx.q[:L]),
                          ctx.q[:L, None]).to(torch.int32)
    assert torch.equal(
        encoding.encode_coeff(ctx, values, ctx.params.scale, error=e), want)


def test_encode_rehearsal_outside_the_plain_range():
    """What the pass gives where the plain version is not exact: t mod q_l
    exactly for a finite |t| >= 2**96 (up to the largest float32, at scale
    1), 0 for a non-finite t (NaN, +-inf, v * scale past the float32
    range), the error's lift added after."""
    ctx = _ctx()
    L = ctx.params.chain_len
    moduli = ctx.params.moduli[:L]
    big = np.array([2.0 ** 96, -(2.0 ** 96), 1.5 * 2.0 ** 100,
                    np.finfo(np.float32).max, -np.finfo(np.float32).max,
                    2.0 ** 127], dtype=np.float32)
    got = R.rehearse_encode(ctx, torch.as_tensor(big[None]), 1.0, L)[0]
    want = R.exact_residues([int(v) for v in big.astype(np.float64)], moduli)
    np.testing.assert_array_equal(got.numpy(), want)
    bad = torch.tensor([[math.nan, math.inf, -math.inf, 3e38, -3e38]],
                       dtype=torch.float32)
    e = torch.tensor([[0, -3, 5, 7, -1]], dtype=torch.int32)
    got = R.rehearse_encode(ctx, bad, ctx.params.scale, L, e)[0]
    q = ctx.q[:L, None]
    lift = torch.where(e.to(torch.int64) < 0, e + q, e)
    assert torch.equal(got, lift.to(torch.int32))


def _ct_inputs(ctx, seed=0, lead=(2, 3)):
    g = torch.Generator().manual_seed(seed)
    L, n = ctx.params.chain_len, ctx.ring_dim
    sk, _ = keys.keygen(ctx, g)
    a = keys.uniform_mod_q(g, (*lead, L, n), ctx.params.moduli)
    w = keys.uniform_mod_q(g, (*lead, L, n), ctx.params.moduli)
    return sk, a, w


def test_cpu_encrypt_is_the_old_int64_chain():
    """On the CPU the secret-key encrypt takes the plain versions: c0 =
    a*s + NTT(m + e), c1 = -a stacked, as ckks/ops.py computed them; the
    seeded encrypt's c0 alone is the same c0; no kernel is launched."""
    ctx = _ctx()
    L = ctx.params.chain_len
    qb = ctx.q[:L, None]
    sk, a, _ = _ct_inputs(ctx)
    g = torch.Generator().manual_seed(1)
    values = torch.randn((2, 3, ctx.ring_dim), generator=g)
    e = keys.cbd_coeffs(g, (2, 3, ctx.ring_dim))
    before = dict(cuda_lib.launches)
    got = ops.encrypt_symmetric_core(ctx, sk, values, a, e, ctx.params.scale)
    pt = encoding.encode_coeff(ctx, values, ctx.params.scale)
    w = modops.add_mod(pt, keys.lift_signed(e, ctx.q[:L]), qb)
    w_hat = ops.ntt_mod.ntt(w.to(torch.int32), ctx.tables.slice_limbs(0, L))
    c0 = modops.add_mod(modops.mul_mod_shoup(a, sk.s[:L], sk.s_shoup[:L], qb),
                        w_hat, qb)
    want = torch.stack([c0, modops.neg_mod(a, qb)], dim=-3).to(torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(ops.encrypt_symmetric_core(ctx, sk, values, a, e,
                                                  ctx.params.scale, c1=False),
                       want[..., 0, :, :])
    assert dict(cuda_lib.launches) == before


def test_cpu_decrypt_phase_is_the_old_int64_chain():
    ctx = _ctx()
    sk, a, w = _ct_inputs(ctx, seed=4)
    data = torch.stack([a, w], dim=-3)        # (2, 3, 2, L, N)
    live = data.shape[-2]
    qb = ctx.q[:live, None]
    want = modops.add_mod(
        a, modops.mul_mod_shoup(w, sk.s[:live], sk.s_shoup[:live], qb),
        qb).to(torch.int32)
    assert torch.equal(ops._phase_plain(ctx, sk, data), want)
    ct = ops.Ciphertext(data[0], ctx.params.scale, 0)
    assert torch.equal(ops.decrypt_residues(ctx, sk, ct), ops.ntt_mod.intt(
        want[0], ctx.tables.slice_limbs(0, live)))


def test_pass_wrappers_refuse_what_they_do_not_take():
    """CPU tensors (the dispatch sends those to the plain versions), and
    shapes the kernels do not take, before any build or launch."""
    ctx = _ctx()
    sk, a, w = _ct_inputs(ctx)
    v = torch.zeros((3, ctx.ring_dim))
    with pytest.raises(ValueError, match="CUDA"):
        rlwe_passes.encode(ctx, v, ctx.params.scale, 2)
    with pytest.raises(ValueError, match="CUDA"):
        rlwe_passes.encrypt(ctx, sk, a, w)
    with pytest.raises(ValueError, match="differ"):
        rlwe_passes.encrypt(ctx, sk, a, w[..., :2, :])
    with pytest.raises(ValueError, match="CUDA"):
        rlwe_passes.decrypt(ctx, sk, torch.stack([a, w], dim=-3))
    with pytest.raises(ValueError, match="live"):
        rlwe_passes.decrypt(ctx, sk, a)
    with pytest.raises(ValueError, match="no encode backend"):
        encoding.encode_coeff(ctx, v.to("meta"), ctx.params.scale)
