"""Port parity: the FFTK key and FFTC ciphertext wire formats, and
cross-package decryption at the bench crypto point (batch 4096, scale
2**52, N 8192) with the committed key fixtures."""

import pathlib
import struct

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_fed_tpu.ckks import params as J_params, ops as J_ops
from fhe_fed_tpu.ckks import serial as J_serial
from fhe_fed_tpu_torch.ckks import params as T_params, ops as T_ops
from fhe_fed_tpu_torch.ckks import serial as T_serial
from fhe_fed_tpu_torch import interop

torch.set_num_threads(1)

KEY_DIR = (pathlib.Path(__file__).resolve().parents[1] / "results"
           / "bench_keys_headline")
BENCH = dict(batch=4096, scale_bits=52, mult_depth=1)


@pytest.fixture(scope="module")
def bench():
    sk_blob = (KEY_DIR / "key-private.txt").read_bytes()
    pk_blob = (KEY_DIR / "key-public.txt").read_bytes()
    jctx = J_params.make_context(J_params.make_params(**BENCH))
    tctx = T_params.make_context(T_params.make_params(**BENCH), device="cpu")
    return jctx, tctx, sk_blob, pk_blob


def test_fixture_keys_match_and_reserialize(bench):
    jctx, tctx, sk_blob, pk_blob = bench
    jsk = J_serial.deserialize_secret_key(sk_blob)
    jpk = J_serial.deserialize_public_key(pk_blob)
    tsk = T_serial.deserialize_secret_key(sk_blob, device="cpu")
    tpk = T_serial.deserialize_public_key(pk_blob, device="cpu")
    assert tsk.s.dtype == torch.int32 and tsk.s_shoup.dtype == torch.int64
    for t, j in ((tsk.s, jsk.s), (tsk.s_shoup, jsk.s_shoup),
                 (tpk.p0, jpk.p0), (tpk.p0_shoup, jpk.p0_shoup),
                 (tpk.p1, jpk.p1), (tpk.p1_shoup, jpk.p1_shoup)):
        np.testing.assert_array_equal(t.numpy().astype(np.uint32),
                                      np.asarray(j))
    assert T_serial.serialize_secret_key(tctx, tsk) == sk_blob
    assert T_serial.serialize_public_key(tctx, tpk) == pk_blob
    assert T_serial.serialize_secret_key(tctx, tsk) == \
        J_serial.serialize_secret_key(jctx, jsk)


def test_jax_ciphertext_decrypts_bit_identically_in_port(bench):
    """A 2-chunk ciphertext that the JAX package encrypts under the fixture
    keys, carried over as FFTC bytes, decrypts bit-identically in the port;
    the port's bytes of it are the JAX package's bytes."""
    jctx, tctx, sk_blob, _ = bench
    jsk = J_serial.deserialize_secret_key(sk_blob)
    tsk = T_serial.deserialize_secret_key(sk_blob, device="cpu")
    rng = np.random.default_rng(0)
    vals = (rng.standard_normal((2, 8192)) * 0.1).astype(np.float32)
    jct = J_ops.encrypt_symmetric(jctx, jsk, jnp.asarray(vals),
                                  jax.random.key(5))
    want = np.asarray(J_ops.decrypt(jctx, jsk, jct))
    blob = J_serial.serialize_ct(jctx, jct)
    tct = T_serial.deserialize_ct(tctx, blob)
    assert tct.data.dtype == torch.int32 and tct.scale == jct.scale
    assert T_serial.serialize_ct(tctx, tct) == blob
    got = T_ops.decrypt(tctx, tsk, tct).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(got, vals, atol=1e-7)


def test_deserialize_refuses_other_blobs(bench):
    _, tctx, sk_blob, _ = bench
    hdr = struct.Struct("<4sHIIHIIHd")
    for magic, packing in ((b"FFTP", "coeff"), (b"FFTC", "slots")):
        blob = hdr.pack(magic, 1, 8192, 4096, 52, 1, 4, 0, 2.0 ** 52)
        with pytest.raises(ValueError, match="packing mismatch"):
            T_serial.deserialize_ct(tctx, blob, packing=packing)
    blob = hdr.pack(b"FFTS", 1, 8192, 4096, 52, 1, 4, 0, 2.0 ** 52)
    with pytest.raises(ValueError, match="not a fhe_fed_tpu ciphertext"):
        T_serial.deserialize_ct(tctx, blob)
    with pytest.raises(ValueError, match="seeded-ciphertext"):
        T_serial.deserialize_seeded_ct(tctx, hdr.pack(
            b"FFTC", 1, 8192, 4096, 52, 1, 4, 0, 2.0 ** 52))
    with pytest.raises(ValueError, match="do not match"):
        T_serial.deserialize_ct(
            tctx, hdr.pack(b"FFTC", 1, 4096, 4096, 52, 1, 4, 0, 1.0))
    with pytest.raises(ValueError, match="not a fhe_fed_tpu"):
        T_serial.deserialize_ct(tctx, hdr.pack(b"XXXX", 1, 8192, 4096, 52, 1,
                                               4, 0, 1.0))
    with pytest.raises(ValueError, match="key blob"):
        T_serial.deserialize_public_key(sk_blob, device="cpu")


def test_seeded_and_slot_blobs_cross_both_ways(bench):
    """A JAX FFTS blob parses to the same seed and c0 in the port and
    re-serializes to the same bytes; its expansion is the JAX one's; an
    FFTP blob round-trips through both packages."""
    jctx, tctx, sk_blob, _ = bench
    jsk = J_serial.deserialize_secret_key(sk_blob)
    vals = np.linspace(-1, 1, 2 * 8192, dtype=np.float32).reshape(2, 8192)
    sct = J_ops.encrypt_symmetric_seeded(jctx, jsk, jnp.asarray(vals),
                                         jax.random.key(6))
    blob = J_serial.serialize_seeded_ct(jctx, sct)
    tsct = T_serial.deserialize_seeded_ct(tctx, blob)
    np.testing.assert_array_equal(tsct.seed.numpy(), np.asarray(sct.seed))
    assert T_serial.serialize_seeded_ct(tctx, tsct) == blob
    carried = interop.seeded_ciphertext_from_numpy(
        np.asarray(sct.c0), np.asarray(sct.seed), sct.scale, sct.level,
        device="cpu")
    assert T_serial.serialize_seeded_ct(tctx, carried) == blob
    full = J_serial.serialize_ct(jctx, J_ops.expand_seeded(jctx, sct))
    assert T_serial.serialize_ct(
        tctx, T_serial.deserialize_any_ct(tctx, blob)) == full
    slot_blob = b"FFTP" + full[4:]
    tct = T_serial.deserialize_ct(tctx, slot_blob, packing="slots")
    assert T_serial.serialize_ct(tctx, tct, packing="slots") == slot_blob
    assert J_serial.serialize_ct(jctx, J_serial.deserialize_ct(
        jctx, slot_blob, packing="slots"), packing="slots") == slot_blob
