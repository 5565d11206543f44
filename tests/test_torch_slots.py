"""Port parity: slot packing (canonical embedding).

encode_slots must give the JAX package's residues and decode_slots its
slots, identically (both run the same numpy float64 operations on the
host); a rotation in the port moves the slots as slot_rotation_map says.
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from fhe_fed_tpu.ckks import params as J_params, keys as J_keys, ops as J_ops
from fhe_fed_tpu.ckks import slots as J_slots
from fhe_fed_tpu_torch.ckks import params as T_params, keys as T_keys
from fhe_fed_tpu_torch.ckks import ops as T_ops, keyswitch as T_ks
from fhe_fed_tpu_torch.ckks import slots as T_slots

torch.set_num_threads(1)

SMALL = dict(batch=128, scale_bits=40, mult_depth=2, ring_dim=256)


def _ctxs():
    return (J_params.make_context(J_params.make_params(**SMALL)),
            T_params.make_context(T_params.make_params(**SMALL), device="cpu"))


def test_encode_and_decode_slots_match_jax():
    jctx, tctx = _ctxs()
    assert T_slots.num_slots(tctx) == J_slots.num_slots(jctx) == 128
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 128)) + 1j * rng.standard_normal((2, 128))
    for zz in (z, z.real * 0.1):
        got = T_slots.encode_slots(tctx, zz)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy().astype(np.uint32),
            np.asarray(J_slots.encode_slots(jctx, zz)))

    # Decode real decrypted residues, and at a live count below the chain.
    sk, pk = J_keys.keygen(jctx, seed=2)
    pt = J_slots.encode_slots(jctx, z.real * 0.1)
    ct = J_ops.encrypt_encoded(jctx, pk, pt, jax.random.key(3),
                               jctx.params.scale)
    res = np.asarray(J_ops.decrypt_residues(jctx, sk, ct))
    for r in (res, res[:, :2]):
        want = J_slots.decode_slots(jctx, jnp.asarray(r), ct.scale)
        np.testing.assert_array_equal(
            T_slots.decode_slots(tctx, torch.as_tensor(r.astype(np.int32)),
                                 ct.scale), want)
    np.testing.assert_allclose(want.real, z.real[:, :] * 0.1, atol=1e-6)
    np.testing.assert_array_equal(T_slots.slot_rotation_map(256, 3),
                                  J_slots.slot_rotation_map(256, 3))


def test_rotation_moves_slots_as_the_map_says():
    """Port keys, port encrypt_encoded, port rotate: slot j of the result
    holds slot slot_rotation_map(N, r)[j] of the input."""
    _, tctx = _ctxs()
    gen = torch.Generator().manual_seed(7)
    sk, pk = T_keys.keygen(tctx, gen)
    z = np.random.default_rng(8).standard_normal(128) * 0.1
    ct = T_ops.encrypt_encoded(tctx, pk, T_slots.encode_slots(tctx, z[None]),
                               gen, tctx.params.scale)
    for r in (1, 5):
        gk = T_ks.make_galois_key(tctx, sk, T_ks.galois_element(r, 256), gen)
        rot = T_ks.rotate(tctx, ct, r, gk)
        got = T_slots.decode_slots(tctx, T_ops.decrypt_residues(tctx, sk, rot),
                                   rot.scale)[0]
        np.testing.assert_allclose(got.real,
                                   z[T_slots.slot_rotation_map(256, r)],
                                   atol=1e-6)
