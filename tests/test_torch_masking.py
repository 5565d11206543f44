"""Port parity of the masking scheme (fhe_fed_tpu_torch.fed.masking) and its
Paillier back end (fhe_fed_tpu_torch.native.paillier) against
fhe_fed_tpu.fed.masking and fhe_fed_tpu.native.paillier, with 512-bit
Paillier keys as tests/test_masking.py.

Both wrappers run the same native source, fhe_fed_tpu/native/paillier.cpp
(the port builds it into build/). Under one `randbelow` stream both encrypt
to the same limbs; the fixed-point codec gives the JAX package's ring values
and floats bit for bit, edge values included; learners of both packages
share one round's files and wire bytes.
"""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fhe_fed_tpu.fed import masking as J_mask
from fhe_fed_tpu.native import paillier as J_pail
from fhe_fed_tpu_torch import Masking, get_scheme
from fhe_fed_tpu_torch.fed import masking as T_mask
from fhe_fed_tpu_torch.native import paillier as T_pail

torch.set_num_threads(1)

BITS = 512
NB, PREC = 17, 13


class _Randbelow:
    """A seeded stand-in for the `secrets` module: randbelow only."""

    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_wrapper_on_the_port_build():
    """The JAX wrapper loads the port's build of the same paillier.cpp, so
    these tests never start its in-place build, which another test process
    may be running at the same time."""
    saved = J_pail._lib
    J_pail._lib = T_pail.load_lib()
    yield
    J_pail._lib = saved


@pytest.fixture(scope="module")
def keys():
    return T_pail.keygen(bits=BITS)


def _jax_ctx(pk, sk):
    return J_pail.PaillierContext(
        J_pail.PaillierPublicKey.from_hex(pk.to_hex(), bits=pk.bits),
        J_pail.PaillierSecretKey.from_hex(sk.to_hex()))


def test_paillier_limbs_match_jax_and_python_ints(keys):
    pk, sk = keys
    assert pk.n.bit_length() == BITS
    ctx, jctx = T_pail.PaillierContext(pk, sk), _jax_ctx(pk, sk)
    msgs = [0, 3, 1 << 200, pk.n - 1] + [
        int(x) for x in np.random.default_rng(0).integers(0, 1 << 60, 6)]
    cts = ctx.encrypt(msgs, _Randbelow(1))
    assert cts.dtype == np.uint64 and cts.shape == (len(msgs), 2 * ctx.k)
    np.testing.assert_array_equal(cts, jctx.encrypt(msgs, _Randbelow(1)))
    rands = _Randbelow(1)
    n2 = pk.n_sq
    for m, row in zip(msgs, cts):
        r = rands.randbelow(pk.n - 1) + 1
        assert T_pail._from_limbs(row) == \
            pow(pk.n + 1, m, n2) * pow(r, pk.n, n2) % n2
    assert ctx.decrypt(cts) == msgs
    other = list(reversed(msgs))
    s = ctx.add(cts, ctx.encrypt(other))
    assert ctx.decrypt(s) == [(a + b) % pk.n for a, b in zip(msgs, other)]
    # The port decrypts the JAX package's ciphertexts and sums, and back.
    jcts = jctx.encrypt(msgs)
    assert ctx.decrypt(jcts) == msgs
    assert ctx.decrypt(ctx.add(jcts, cts)) == [2 * m % pk.n for m in msgs]
    assert jctx.decrypt(ctx.encrypt(msgs)) == msgs
    blob = ctx.ct_to_bytes(cts)
    assert blob == jctx.ct_to_bytes(cts)
    np.testing.assert_array_equal(ctx.ct_from_bytes(blob),
                                  jctx.ct_from_bytes(blob))


def test_homomorphic_add_matches_jax_limbs(keys):
    pk, sk = keys
    ctx, jctx = T_pail.PaillierContext(pk, sk), _jax_ctx(pk, sk)
    a = ctx.encrypt([5, 7, 11], _Randbelow(3))
    b = ctx.encrypt([1, 2, 3], _Randbelow(4))
    np.testing.assert_array_equal(ctx.add(a, b), jctx.add(a, b))
    with pytest.raises(ValueError):
        ctx.add(a, b[:2])


def test_keys_hex_and_reference_import(keys):
    pk, sk = keys
    assert T_pail.PaillierPublicKey.from_hex(pk.to_hex()) == pk
    assert T_pail.PaillierSecretKey.from_hex(sk.to_hex()) == sk
    ref = T_pail.PaillierSecretKey.from_reference_hex(format(sk.lam, "x"),
                                                      pk.n)
    assert ref == sk
    assert ref.to_hex() == J_pail.PaillierSecretKey.from_reference_hex(
        format(sk.lam, "x"), pk.n).to_hex()
    with pytest.raises(ValueError):
        T_pail.PaillierContext(pk).decrypt(np.zeros((1, 16), np.uint64))


@pytest.mark.parametrize("learners,num_bits,modulus_bits",
                         [(4, 17, 2048), (2, 16, 512), (9, 17, 512),
                          (300, 20, 1024)])
def test_packing_matches_jax(learners, num_bits, modulus_bits):
    assert T_mask._packing_geometry(learners, num_bits, modulus_bits) == \
        J_mask._packing_geometry(learners, num_bits, modulus_bits)
    rng = np.random.default_rng(learners)
    allv = [rng.integers(0, 1 << num_bits, size=257).astype(np.uint32)
            for _ in range(learners)]
    blocks = [T_mask.pack_values(v, learners, num_bits, modulus_bits)
              for v in allv]
    assert blocks[0] == J_mask.pack_values(allv[0], learners, num_bits,
                                           modulus_bits)
    summed = [sum(col) for col in zip(*blocks)]
    got = T_mask.unpack_values(summed, 257, learners, num_bits, modulus_bits)
    np.testing.assert_array_equal(got, J_mask.unpack_values(
        summed, 257, learners, num_bits, modulus_bits))
    np.testing.assert_array_equal(
        got, np.sum(np.stack(allv).astype(np.uint64), axis=0))


def test_packing_geometry_of_the_default_round():
    # 3-byte slots, 85 values per 2048-bit plaintext.
    assert T_mask._packing_geometry(4, 17, 2048) == (3, 85)


_EDGES = np.array(
    [np.nan, np.inf, -np.inf, 3e9, -3e9, 1e6, -1e6, 0.5 * 2.0 ** -13,
     -0.5 * 2.0 ** -13, 1.5 * 2.0 ** -13, -1.5 * 2.0 ** -13, 2.5 * 2.0 ** -13,
     0.0, -0.0, 1.5, -1.5, 0.123, -7.9, 3.999, 7.9998, -7.9998, 8.0, 100.0,
     -100.0, 1e-30, 2.0 ** 17, -(2.0 ** 17)], dtype=np.float32)


def test_fixed_point_codec_matches_jax_at_the_edges():
    """NaN -> 0 and saturation as XLA's f32 -> s32 convert, then the clip;
    round half to even; the two f32 divisions of the decode."""
    enc = T_mask.fixed_point_encode(torch.as_tensor(_EDGES), NB, PREC)
    jenc = np.asarray(J_mask.fixed_point_encode(jnp.asarray(_EDGES), NB,
                                                PREC))
    assert enc.dtype == torch.int64
    np.testing.assert_array_equal(enc.numpy(), jenc.astype(np.int64))
    assert enc[0] == 0 and enc[1] == (1 << 16) - 1
    assert enc[2] == (1 << 17) - ((1 << 16) - 1)
    ring = np.random.default_rng(5).integers(0, 1 << NB, 1000)
    ring[:4] = [0, (1 << 16) - 1, 1 << 16, (1 << 17) - 1]
    for divide_by in (1, 3, 4, 7):
        dec = T_mask.fixed_point_decode(torch.as_tensor(ring), NB, PREC,
                                        divide_by)
        jdec = np.asarray(J_mask.fixed_point_decode(
            jnp.asarray(ring.astype(np.uint32)), NB, PREC, divide_by))
        assert dec.dtype == torch.float32
        np.testing.assert_array_equal(dec.numpy().view(np.int32),
                                      jdec.view(np.int32))


def test_mask_and_sum_match_the_uint32_forms():
    rng = np.random.default_rng(6)
    mask = (1 << NB) - 1
    fixed = rng.integers(0, 1 << NB, (4, 500))
    r = rng.integers(0, 1 << NB, (4, 500))
    masked = T_mask.mask_values(torch.as_tensor(fixed), torch.as_tensor(r),
                                mask)
    want = (fixed.astype(np.uint32) - r.astype(np.uint32)) & np.uint32(mask)
    np.testing.assert_array_equal(masked.numpy(), want)
    np.testing.assert_array_equal(
        T_mask.sum_masked(masked, mask).numpy(),
        np.asarray(J_mask._sum_masked_impl(jnp.asarray(want), mask)))


def _cpu(cls) -> dict:
    """device="cpu" for a port class (its default is the card); the JAX
    classes take no device."""
    return ({"device": "cpu"} if cls.__module__.startswith("fhe_fed_tpu_torch")
            else {})


def _schemes(tmp_path, learners, n_port):
    """Learners 0 .. n_port-1 from the port, the rest from JAX, on one
    cryptodir; learner i keeps its randomness in rand<i>."""
    out = []
    for i in range(learners):
        cls = Masking if i < n_port else J_mask.Masking
        out.append(cls("paillier", learners, modulus_bits=BITS,
                       num_bits=NB, precision_bits=PREC,
                       cryptodir=str(tmp_path / "crypto"),
                       randomnessdir=str(tmp_path / f"rand{i}"), **_cpu(cls)))
    return out


def test_mixed_round_gives_identical_bytes(tmp_path):
    """2 port learners + 2 JAX learners, offline and online; the port
    aggregates and a JAX learner decrypts. Every online blob and the output
    equal what the other package computes from the same files."""
    learners, n = 4, 300
    ss = _schemes(tmp_path, learners, 2)
    ss[0].genCryptoContextAndKeyGen()
    for s in ss:
        s.loadCryptoParams()
    blobs = [s.genPaillierRandOffline(n, iteration=0) for s in ss]
    enc_sum = ss[1].addPaillierRandOffline(blobs)
    assert enc_sum == ss[2].addPaillierRandOffline(blobs)
    for s in ss:
        s.decryptRandomnessSum(enc_sum, n, iteration=0)
    r_sum = np.load(tmp_path / "rand0" / "0" / "learner_rand_sum.npy")
    np.testing.assert_array_equal(
        r_sum, np.load(tmp_path / "rand3" / "0" / "learner_rand_sum.npy"))
    np.testing.assert_array_equal(r_sum, np.sum(
        [np.load(tmp_path / f"rand{i}" / "0" / "learner_rand.npy")
         for i in range(learners)], axis=0).astype(np.uint32)
        & np.uint32((1 << NB) - 1))

    rng = np.random.default_rng(3)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(learners)]
    masked = [s.encrypt(d, iteration=0) for s, d in zip(ss, data)]
    # Each learner's blob is the other package's blob for the same files.
    for i, (s, d) in enumerate(zip(ss, data)):
        twin = _schemes(tmp_path, learners, 0 if i < 2 else learners)[i]
        assert twin.encrypt(d, iteration=0) == masked[i]
    agg = ss[0].computeWeightedAverage(masked, [1 / learners] * learners)
    assert agg == ss[3].computeWeightedAverage(masked,
                                               [1 / learners] * learners)
    out = ss[3].decrypt(agg, n, iteration=0)
    port_out = ss[1].decrypt(agg, n, iteration=0)
    assert out.dtype == port_out.dtype == np.float64
    np.testing.assert_array_equal(port_out.view(np.int64), out.view(np.int64))
    np.testing.assert_allclose(out, np.mean(np.stack(data), axis=0),
                               atol=learners * 2 ** -PREC)


def test_dropout_recovery_subset(tmp_path):
    """Learners {0, 2, 3} of 4 take part online; the retained offline blobs
    of the survivors are re-summed and decrypted (both packages write the
    same subset file)."""
    learners, n = 4, 200
    ss = _schemes(tmp_path, learners, learners)
    ss[0].genCryptoContextAndKeyGen()
    for s in ss:
        s.loadCryptoParams()
    blobs = [s.genPaillierRandOffline(n, iteration=1) for s in ss]
    survivors = [0, 2, 3]
    rng = np.random.default_rng(7)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(learners)]
    agg = ss[0].computeWeightedAverage(
        [ss[i].encrypt(data[i], iteration=1) for i in survivors])
    ss[0].recoverRandomnessSubset(blobs, n, iteration=1, subset=survivors)
    name = "learner_rand_sum_s0_2_3.npy"
    jax_side = J_mask.Masking("paillier", learners, modulus_bits=BITS,
                              cryptodir=str(tmp_path / "crypto"),
                              randomnessdir=str(tmp_path / "jaxrand"))
    jax_side.loadCryptoParams()
    jax_side.recoverRandomnessSubset(blobs, n, iteration=1, subset=survivors)
    np.testing.assert_array_equal(
        np.load(tmp_path / "rand0" / "1" / name),
        np.load(tmp_path / "jaxrand" / "1" / name))
    out = ss[0].decrypt(agg, n, iteration=1, subset=survivors)
    np.testing.assert_allclose(
        out, np.mean(np.stack([data[i] for i in survivors]), axis=0),
        atol=learners * 2 ** -PREC)


def test_weight_count_mismatch_and_registry(tmp_path):
    s = Masking("paillier", 2, modulus_bits=BITS, cryptodir=str(tmp_path),
                randomnessdir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="size mismatch"):
        s.computeWeightedAverage([b"\x00" * 4], [0.5, 0.5])
    with pytest.raises(RuntimeError, match="first"):
        s.genPaillierRandOffline(4, 0)
    assert get_scheme("paillier") is Masking
    assert get_scheme("masking") is Masking


def test_native_thread_control():
    full = T_pail.num_threads()
    assert full >= 1
    T_pail.set_threads(1)
    try:
        assert T_pail.num_threads() == 1
    finally:
        T_pail.set_threads(full)
    assert T_pail.num_threads() == full


def test_library_builds_beside_the_port_not_the_source():
    lib = T_pail.build()
    assert lib.is_file() and T_pail.BUILD_ROOT in lib.parents
    assert T_pail.SRC.parent not in lib.parents
    assert T_pail.build() == lib
