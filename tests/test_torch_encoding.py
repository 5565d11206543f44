"""Port parity: coefficient encode and the exact-CRT decode (plain version of
kernel K4).

Residues must be bit-identical; decoded float32 must be bit-identical too
(compared as int32 bit patterns, NaN included) to the JAX package's
encoding.decode_core and to its Pallas kernel pallas_decode.decode_fused
(interpret mode off the TPU).
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_fed_tpu.ckks import params as J_params, keys as J_keys, ops as J_ops
from fhe_fed_tpu.ckks import encoding as J_enc, pallas_decode as J_pdec
from fhe_fed_tpu_torch.ckks import params as T_params, encoding as T_enc
from fhe_fed_tpu_torch.ckks import pallas_decode as T_pdec

torch.set_num_threads(1)

SMALL = dict(batch=128, scale_bits=40, mult_depth=1, ring_dim=256)


def _ctxs(**kw):
    kw = {**SMALL, **kw}
    return (J_params.make_context(J_params.make_params(**kw)),
            T_params.make_context(T_params.make_params(**kw), device="cpu"))


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("scale_bits", [40, 52])
def test_encode_coeff_bit_exact(scale_bits):
    jctx, tctx = _ctxs(scale_bits=scale_bits)
    rng = np.random.default_rng(scale_bits)
    vals = rng.uniform(-100, 100, size=(3, 256)).astype(np.float32)
    vals[0, :6] = [0.0, -0.0, 1e-12, -1e-12, 3e4, -3e4]
    scale = 2.0 ** scale_bits
    want = np.asarray(J_enc.encode_coeff(jctx, jnp.asarray(vals), scale))
    got = T_enc.encode_coeff(tctx, torch.as_tensor(vals), scale)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    want2 = np.asarray(J_enc.encode_coeff(jctx, jnp.asarray(vals), scale,
                                          num_limbs=2))
    np.testing.assert_array_equal(
        T_enc.encode_coeff(tctx, torch.as_tensor(vals), scale,
                           num_limbs=2).numpy().astype(np.uint32), want2)


def test_encode_scalar_matches():
    p = T_params.make_params(**SMALL)
    for w in (0.5, 1.0 / 3.0, -0.2, 0.0):
        jr, js = J_enc.encode_scalar(p.moduli[:4], w, float(p.moduli[3]))
        tr, ts = T_enc.encode_scalar(p.moduli[:4], w, float(p.moduli[3]))
        np.testing.assert_array_equal(tr, jr.astype(np.int64))
        np.testing.assert_array_equal(ts, js.astype(np.int64))


def _decode_all(jctx, tctx, res_u32, scale):
    """(port decode_core, port decode_coeff, JAX decode_core, JAX kernel)."""
    live = res_u32.shape[-2]
    jdc = jctx.dec_consts[live - 1]
    tdc = tctx.dec_consts[live - 1]
    rt = torch.as_tensor(res_u32.astype(np.int32))
    rj = jnp.asarray(res_u32)
    return (T_enc.decode_core(tdc, tctx.q[:live], rt, scale).numpy(),
            T_enc.decode_coeff(tctx, rt, scale).numpy(),
            np.asarray(J_enc.decode_core(jdc, jctx.q[:live], rj, scale)),
            np.asarray(J_pdec.decode_fused(jctx, jdc, rj, scale)))


def _assert_all_equal(outs):
    """Bit-identical to decode_coeff and JAX's decode_core, NaN bits
    included. Against JAX's interpret-mode kernel, NaN positions must agree
    and every other value bit for bit: the kernel's NaNs may carry another
    sign bit than decode_core's own."""
    port, coeff, core, kernel = outs
    np.testing.assert_array_equal(_bits(port), _bits(coeff))
    np.testing.assert_array_equal(_bits(port), _bits(core))
    nan = np.isnan(port)
    np.testing.assert_array_equal(nan, np.isnan(kernel))
    np.testing.assert_array_equal(_bits(port)[~nan], _bits(kernel)[~nan])


def test_decode_real_decrypt_residues():
    """Residues of a decrypted weighted sum (scale 2**40 * q_top)."""
    jctx, tctx = _ctxs()
    sk, _ = J_keys.keygen(jctx, seed=1)
    rng = np.random.default_rng(9)
    vals = rng.standard_normal((3, 5, 256)).astype(np.float32)
    ct = J_ops.encrypt_symmetric_stacked(jctx, sk, jnp.asarray(vals),
                                         jax.random.key(2))
    agg = J_ops.weighted_sum(jctx, ct, [0.5, 0.2, 0.3])
    res = np.asarray(J_ops.decrypt_residues(jctx, sk, agg))
    outs = _decode_all(jctx, tctx, res, agg.scale)
    _assert_all_equal(outs)
    np.testing.assert_allclose(
        outs[0], np.tensordot([0.5, 0.2, 0.3], vals, axes=1), atol=1e-5)


def _residues_of(values, moduli):
    """Residues (chunks, live, N) of exact signed integers."""
    return np.array([[[int(v) % q for v in row] for q in moduli]
                     for row in values], dtype=np.uint32)


def test_decode_negative_and_overflow_cases():
    """Negative values decode with their sign; values whose magnitude over
    the scale leaves the f32 range overflow. The JAX reference turns the
    overflow into NaN, not +-inf: the overflow flag sets hi = inf, and
    df_mul's Dekker split of inf gives inf - inf. The port keeps that
    result bit for bit."""
    jctx, tctx = _ctxs()
    moduli = tctx.params.moduli[:4]
    Q = math.prod(moduli)
    rng = np.random.default_rng(5)
    small = rng.integers(-(1 << 62), 1 << 62, size=256)
    small[:4] = [-1, -(1 << 40), -(1 << 40) - 1, 0]
    big = [int(s) << 50 for s in rng.integers(-(1 << 60), 1 << 60,
                                               size=256)]
    big[:3] = [1 << 112, -(1 << 112), (Q // 2) >> 6]
    res = _residues_of([small.tolist(), big], moduli)

    outs = _decode_all(jctx, tctx, res, 2.0 ** 40)
    _assert_all_equal(outs)
    np.testing.assert_allclose(outs[0][0].astype(np.float64),
                               small / 2.0 ** 40, rtol=1e-6)
    assert outs[0][0, 0] == np.float32(-2.0 ** -40)
    assert outs[0][0, 1] == -1.0

    outs = _decode_all(jctx, tctx, res, 2.0 ** -30)
    _assert_all_equal(outs)
    assert np.isnan(outs[0][1, :3]).all()
    assert np.isfinite(outs[0][0]).all()


def test_decode_core_eleven_limbs_matches_jax():
    """live = 11 (a fresh ciphertext at mult_depth 8), beyond the eight
    limbs the decode kernel once took: the plain decode against the JAX
    decode_core, as int32 bit patterns."""
    jctx, tctx = _ctxs(mult_depth=8)
    live = 11
    assert tctx.params.chain_len == live
    rng = np.random.default_rng(11)
    q = np.array(tctx.params.moduli[:live], dtype=np.uint64)
    res = (rng.integers(0, 1 << 62, size=(2, live, 256), dtype=np.uint64)
           % q[:, None]).astype(np.uint32)
    for scale in (2.0 ** 40, 2.0 ** 300):
        got = T_enc.decode_core(tctx.dec_consts[live - 1], tctx.q[:live],
                                torch.as_tensor(res.astype(np.int32)), scale)
        want = J_enc.decode_core(jctx.dec_consts[live - 1], jctx.q[:live],
                                 jnp.asarray(res), scale)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_decode_kernel_wrapper_refuses_cpu_tensors():
    _, tctx = _ctxs()
    dc = tctx.dec_consts[3]
    with pytest.raises(ValueError, match="CUDA"):
        T_pdec.decode_fused(tctx, dc, torch.zeros((1, 4, 256),
                                                  dtype=torch.int32), 2.0)
