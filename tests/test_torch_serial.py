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

torch.set_num_threads(1)

KEY_DIR = (pathlib.Path(__file__).resolve().parents[1] / "results"
           / "bench_keys_headline")
BENCH = dict(batch=4096, scale_bits=52, mult_depth=1)


@pytest.fixture(scope="module")
def bench():
    sk_blob = (KEY_DIR / "key-private.txt").read_bytes()
    pk_blob = (KEY_DIR / "key-public.txt").read_bytes()
    jctx = J_params.make_context(J_params.make_params(**BENCH))
    tctx = T_params.make_context(T_params.make_params(**BENCH))
    return jctx, tctx, sk_blob, pk_blob


def test_fixture_keys_match_and_reserialize(bench):
    jctx, tctx, sk_blob, pk_blob = bench
    jsk = J_serial.deserialize_secret_key(sk_blob)
    jpk = J_serial.deserialize_public_key(pk_blob)
    tsk = T_serial.deserialize_secret_key(sk_blob)
    tpk = T_serial.deserialize_public_key(pk_blob)
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
    tsk = T_serial.deserialize_secret_key(sk_blob)
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
    for magic in (b"FFTP", b"FFTS"):
        blob = hdr.pack(magic, 1, 8192, 4096, 52, 1, 4, 0, 2.0 ** 52)
        with pytest.raises(NotImplementedError, match="not ported"):
            T_serial.deserialize_ct(tctx, blob)
    with pytest.raises(ValueError, match="do not match"):
        T_serial.deserialize_ct(
            tctx, hdr.pack(b"FFTC", 1, 4096, 4096, 52, 1, 4, 0, 1.0))
    with pytest.raises(ValueError, match="not a fhe_fed_tpu"):
        T_serial.deserialize_ct(tctx, hdr.pack(b"XXXX", 1, 8192, 4096, 52, 1,
                                               4, 0, 1.0))
    with pytest.raises(ValueError, match="key blob"):
        T_serial.deserialize_public_key(sk_blob)
