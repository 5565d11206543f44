"""Port parity of the drop-in CKKS surface (fhe_fed_tpu_torch.fed.api)
against fhe_fed_tpu.fed.api at batch 128 / scale 2**40 (ring 8192), as
tests/test_fed_api.py builds it: with one seed both classes write the same
cryptodir and the same blobs in every mode, cryptodirs and blobs cross
both ways, the streamed round agrees fused, staged and with JAX (and a
(K, E) tensor's round, packed where it lies, with the host vectors'), and
the port refuses what the JAX class refuses."""

import os

import numpy as np
import pytest
import torch

import fhe_fed_tpu as J
import fhe_fed_tpu_torch as T
from fhe_fed_tpu.ckks import serial as J_serial
from fhe_fed_tpu_torch.ckks import serial as T_serial
from fhe_fed_tpu_torch.fed import api as T_api

torch.set_num_threads(1)

WEIGHTS = [0.5, 0.2, 0.3]
DIMS = 300
MODES = {
    "public_key": {},
    "symmetric": dict(symmetric=True),
    "seeded_fresh": dict(seeded_fresh=True),
    "dense_pack": dict(dense_pack=True),
    "slots": dict(packing="slots"),
}


def _cpu(cls) -> dict:
    """device="cpu" for a port class (its default is the card); the JAX
    classes take no device."""
    return ({"device": "cpu"} if cls.__module__.startswith("fhe_fed_tpu_torch")
            else {})


def _helpers(tmp_path, seed, **kw):
    """A JAX and a port helper with the same seed, each with its own
    freshly generated cryptodir."""
    j = J.CKKS("ckks", 128, 40, cryptodir=str(tmp_path / "jax"), seed=seed,
               **kw)
    t = T.CKKS("ckks", 128, 40, cryptodir=str(tmp_path / "port"), seed=seed,
               device="cpu", **kw)
    j.genCryptoContextAndKeyGen()
    t.genCryptoContextAndKeyGen()
    return j, t


def _same_f64(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.int64),
                                  np.asarray(b).view(np.int64))


@pytest.mark.parametrize("mode", MODES)
def test_helpers_write_the_same_bytes_as_jax(tmp_path, mode):
    """Key files, each client's blob and the aggregate are the JAX
    package's bytes; decrypt outputs are bit-equal."""
    j, t = _helpers(tmp_path, 7, **MODES[mode])
    for name in ("cryptocontext.txt", "key-public.txt", "key-private.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    rng = np.random.default_rng(1)
    data = [rng.standard_normal(DIMS) for _ in range(3)]
    jb = [j.encrypt(d) for d in data]
    tb = [t.encrypt(d) for d in data]
    assert tb == jb
    magic = {"seeded_fresh": b"FFTS", "slots": b"FFTP"}.get(mode, b"FFTC")
    assert tb[0][:4] == magic
    agg = t.computeWeightedAverage(tb, WEIGHTS)
    assert agg == j.computeWeightedAverage(jb, WEIGHTS)
    out = t.decrypt(agg, DIMS)
    assert out.dtype == np.float64 and out.shape == (DIMS,)
    _same_f64(out, j.decrypt(agg, DIMS))
    np.testing.assert_allclose(
        out, sum(w * d for w, d in zip(WEIGHTS, data)), atol=1e-6)


def test_seeded_blob_halves_the_upload(tmp_path):
    j, t = _helpers(tmp_path, 3, seeded_fresh=True)
    full = T.CKKS("ckks", 128, 40, cryptodir=str(tmp_path / "port"),
                  symmetric=True, seed=4, device="cpu")
    full.loadCryptoParams()
    d = np.random.default_rng(2).standard_normal(DIMS)
    seeded, plain = t.encrypt(d), full.encrypt(d)
    assert seeded[:4] == b"FFTS" and plain[:4] == b"FFTC"
    assert len(seeded) <= 0.51 * len(plain)
    # A mixed cohort aggregates; the port's aggregate is the JAX one's.
    agg = t.computeWeightedAverage([seeded, plain], [0.5, 0.5])
    assert agg == j.computeWeightedAverage([seeded, plain], [0.5, 0.5])
    np.testing.assert_allclose(t.decrypt(agg, DIMS), d, atol=1e-6)


def test_cryptodirs_and_blobs_cross_both_ways(tmp_path):
    """JAX-written cryptodir -> port reads; port-written -> JAX reads; a
    blob from either side decrypts bit-identically on the other."""
    j, t = _helpers(tmp_path, 5, symmetric=True)
    d = np.random.default_rng(3).standard_normal(1000)
    for writer, reader_cls in ((tmp_path / "jax", T.CKKS),
                               (tmp_path / "port", J.CKKS)):
        reader = reader_cls("ckks", 128, 40, cryptodir=str(writer),
                            **_cpu(reader_cls))
        reader.loadCryptoParams()
        src = j if writer.name == "jax" else t
        blob = src.encrypt(d)
        _same_f64(reader.decrypt(blob, 1000), src.decrypt(blob, 1000))
        back = reader.encrypt(d)
        _same_f64(src.decrypt(back, 1000), reader.decrypt(back, 1000))
        np.testing.assert_allclose(src.decrypt(back, 1000), d, atol=1e-6)


@pytest.fixture(scope="module")
def shared_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("shared")
    J.CKKS("ckks", 128, 40, cryptodir=str(d), seed=1
           ).genCryptoContextAndKeyGen()
    return str(d)


def _loaded(cls, d, **kw):
    h = cls("ckks", 128, 40, cryptodir=d, seed=11, **_cpu(cls), **kw)
    h.loadCryptoParams()
    return h


@pytest.mark.parametrize("max_chunks", [None, 3])
def test_fedavg_round_fused_staged_and_jax_agree(shared_dir, max_chunks):
    """1000 values are 8 chunks: max_chunks=3 pads to 9 and streams three
    slices. Fused, staged and the JAX round give the same bits."""
    rng = np.random.default_rng(5)
    data = [rng.standard_normal(1000).astype(np.float32) for _ in range(3)]
    want = _loaded(J.CKKS, shared_dir, symmetric=True).fedavg_round(
        data, WEIGHTS, 1000, max_chunks=max_chunks)
    fused = _loaded(T.CKKS, shared_dir, symmetric=True).fedavg_round(
        data, WEIGHTS, 1000, max_chunks=max_chunks)
    staged = _loaded(T.CKKS, shared_dir, symmetric=True).fedavg_round(
        data, WEIGHTS, 1000, max_chunks=max_chunks, fused=False)
    assert fused.shape == (1000,) and fused.dtype == np.float64
    _same_f64(fused, want)
    _same_f64(staged, want)
    np.testing.assert_allclose(
        fused, sum(w * d.astype(np.float64) for w, d in zip(WEIGHTS, data)),
        atol=1e-6)


@pytest.mark.parametrize("dense,size", [(False, 1100), (True, 20000)])
@pytest.mark.parametrize("max_chunks", [None, 2])
def test_fedavg_round_packs_a_tensor_where_it_lies(shared_dir, max_chunks,
                                                   dense, size):
    """A (K, E) tensor is packed on the helper's device into the host
    pack's bits, zero tail and padding to whole slices included (9 chunks
    of 128 values, or 3 dense chunks of 8192, padded to 10 or 4 in slices
    of 2), and its round gives an (E,) float32 tensor there, bit-equal to
    the host vectors' float64 round cast to float32 under a helper of the
    same seed; `staging` counts one round on each side."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, size)).astype(np.float32))
    rows = list(x.numpy())
    kw = dict(symmetric=True, dense_pack=dense)
    host, dev = (_loaded(T.CKKS, shared_dir, **kw) for _ in range(2))
    chunks = -(-size // host.capacity)
    padded = chunks if max_chunks is None else -(-chunks // 2) * 2
    want = host._pack_cohort(rows)
    want = torch.cat([want, want.new_zeros((3, padded - chunks, 8192))], 1)
    got = dev._pack_tensor(x, padded)
    assert got.shape == (3, padded, 8192)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    T_api.staging.clear()
    avg64 = host.fedavg_round(rows, WEIGHTS, max_chunks=max_chunks)
    avg = dev.fedavg_round(x, WEIGHTS, max_chunks=max_chunks)
    assert dict(T_api.staging) == {"host": 1, "device": 1}
    assert avg64.dtype == np.float64 and avg64.shape == (size,)
    assert torch.is_tensor(avg) and avg.dtype == torch.float32
    assert avg.shape == (size,) and avg.device == dev.device
    np.testing.assert_array_equal(avg.numpy().view(np.int32),
                                  avg64.astype(np.float32).view(np.int32))


def test_cohort_methods_match_jax_in_public_key_mode(shared_dir):
    rng = np.random.default_rng(6)
    data = [rng.standard_normal(500).astype(np.float32) for _ in range(2)]
    j, t = _loaded(J.CKKS, shared_dir), _loaded(T.CKKS, shared_dir)
    jct, tct = j.encrypt_cohort(data), t.encrypt_cohort(t.pack_cohort(data))
    assert tct.data.shape == (2, 4, 2, 4, 8192) and tct.num_chunks == 4
    np.testing.assert_array_equal(tct.data.numpy().astype(np.uint32),
                                  np.asarray(jct.data))
    assert t.ct_wire_bytes(tct) == j.ct_wire_bytes(jct)
    assert t.ct_wire_bytes(tct, per_client=True) == \
        j.ct_wire_bytes(jct, per_client=True)
    agg = t.aggregate_cohort(tct, [0.4, 0.6])
    raw = t.decrypt_cohort(agg, raw=True)
    assert torch.is_tensor(raw) and raw.shape == (4, 8192)
    out = t.unpack_values(raw, 500)
    _same_f64(out, t.decrypt_cohort(agg, 500))
    _same_f64(out, j.decrypt_cohort(j.aggregate_cohort(jct, [0.4, 0.6]),
                                    500))


def test_chunk_tail_rule(shared_dir):
    """ceil chunking and the exact tail, as test_fed_api.test_chunk_tail_rule;
    the JAX helper decrypts the port's blob to the same bits."""
    t, j = _loaded(T.CKKS, shared_dir), _loaded(J.CKKS, shared_dir)
    for dims in [1, 127, 128, 129, 1000]:
        d = np.random.default_rng(dims).random(dims)
        blob = t.encrypt(d)
        out = t.decrypt(blob, dims)
        assert out.shape == (dims,)
        np.testing.assert_allclose(out, d, atol=1e-6)
        _same_f64(out, j.decrypt(blob, dims))


def test_refusals_match_jax(shared_dir):
    for kw in (dict(packing="dense"), dict(packing="slots", dense_pack=True),
               dict(packing="slots", symmetric=True),
               dict(packing="slots", seeded_fresh=True)):
        for cls in (J.CKKS, T.CKKS):
            with pytest.raises(ValueError):
                cls("ckks", 128, 40, cryptodir=shared_dir, **_cpu(cls), **kw)
    t = _loaded(T.CKKS, shared_dir)
    with pytest.raises(ValueError, match="size mismatch"):
        t.computeWeightedAverage([b"", b""], [1.0])
    s = _loaded(T.CKKS, shared_dir, packing="slots")
    with pytest.raises(ValueError, match="cohort fast path"):
        s.encrypt_cohort([np.zeros(10)])
    with pytest.raises(ValueError, match="fedavg_round is coefficient"):
        s.fedavg_round([np.zeros(10)], [1.0])
    with pytest.raises(ValueError, match="packing mismatch"):
        s.decrypt(t.encrypt(np.zeros(10)), 10)
    with pytest.raises(RuntimeError, match="first"):
        T.CKKS("ckks", 128, 40, cryptodir=shared_dir,
               device="cpu").encrypt(np.zeros(3))
    with pytest.raises(ValueError, match="does not match"):
        T.CKKS("ckks", 256, 40, cryptodir=shared_dir,
               device="cpu").loadCryptoParams()


def test_slot_helper_refuses_a_seeded_blob_that_jax_accepts(shared_dir):
    """fhe_fed_tpu.ckks.serial.deserialize_any_ct expands an FFTS blob
    before it checks packing, so a JAX slot-mode server aggregates a
    coefficient-packed seeded upload as if it were slot-packed. The port
    checks packing first and refuses it."""
    blob = _loaded(T.CKKS, shared_dir, seeded_fresh=True).encrypt(
        np.linspace(-1, 1, 200))
    assert blob[:4] == b"FFTS"
    j = _loaded(J.CKKS, shared_dir, packing="slots")
    agg = j.computeWeightedAverage([blob], [1.0])
    assert agg[:4] == b"FFTP"                   # the JAX package accepts it
    t = _loaded(T.CKKS, shared_dir, packing="slots")
    with pytest.raises(ValueError, match="packing mismatch"):
        t.computeWeightedAverage([blob], [1.0])
    with pytest.raises(ValueError, match="packing mismatch"):
        T_serial.deserialize_any_ct(t.ctx, blob, packing="slots")
    # Both packages expand the seeded blob alike under coefficient packing.
    ct = T_serial.deserialize_any_ct(_loaded(T.CKKS, shared_dir).ctx, blob)
    jct = J_serial.deserialize_any_ct(_loaded(J.CKKS, shared_dir).ctx, blob)
    np.testing.assert_array_equal(ct.data.numpy().astype(np.uint32),
                                  np.asarray(jct.data))


def test_scheme_registry_and_cpp_aliases(shared_dir):
    assert T.get_scheme("CKKS") is T.CKKS
    t = _loaded(T.CKKS, shared_dir)
    d = np.random.default_rng(9).standard_normal(50)
    blob = t.encrypt_cpp(d)
    agg = t.computeWeightedAverage_cpp((blob,), (1.0,))
    np.testing.assert_allclose(t.decrypt_cpp(agg, 50), d, atol=1e-6)
    assert os.path.isfile(os.path.join(shared_dir, "cryptocontext.txt"))


def test_prng_defaults_to_threefry_on_the_cpu_and_rbg_on_the_card(tmp_path):
    """The helper's PRNG follows its device, as the JAX class follows its
    backend: threefry on the CPU (the JAX package's bytes; the helpers of
    the parity tests above), rbg for a CUDA device (the selection
    function; nothing is allocated). An explicit prng wins; an unknown one
    is refused."""
    from fhe_fed_tpu_torch.utils import prng
    assert prng.default_impl(torch.device("cuda")) == "rbg"
    assert prng.default_impl(torch.device("cpu")) == "threefry"
    d = str(tmp_path)
    h = T.CKKS("ckks", 128, 40, cryptodir=d, seed=7, device="cpu")
    assert h.prng == "threefry" and h._rng.shape == (2,)
    r = T.CKKS("ckks", 128, 40, cryptodir=d, seed=7, device="cpu",
               prng="rbg")
    assert r.prng == "rbg" and r._rng.shape == (4,)
    np.testing.assert_array_equal(r._rng.numpy(), [0, 7, 0, 7])
    x = T.CKKS("ckks", 128, 40, cryptodir=d, seed=7, device="cpu",
               prng="threefry")
    assert torch.equal(x._rng, h._rng)
    with pytest.raises(ValueError, match="PRNG"):
        T.CKKS("ckks", 128, 40, cryptodir=d, device="cpu", prng="philox")


RBG_MODES = {k: MODES[k] for k in ("symmetric", "public_key", "seeded_fresh",
                                   "slots")}


@pytest.mark.parametrize("mode", RBG_MODES)
def test_rbg_helper_rounds_decrypt(shared_dir, mode):
    """prng="rbg" on the CPU: the bytes surface and the cohort round
    decrypt within 1e-6; the same seed gives the same bytes, another seed
    others, and neither is the threefry helper's."""
    rng = np.random.default_rng(12)
    data = [rng.standard_normal(DIMS) for _ in range(3)]
    want = sum(w * d for w, d in zip(WEIGHTS, data))
    h = _loaded(T.CKKS, shared_dir, prng="rbg", **RBG_MODES[mode])
    blobs = [h.encrypt(d) for d in data]
    out = h.decrypt(h.computeWeightedAverage(blobs, WEIGHTS), DIMS)
    np.testing.assert_allclose(out, want, atol=1e-6)
    twin = _loaded(T.CKKS, shared_dir, prng="rbg", **RBG_MODES[mode])
    assert [twin.encrypt(d) for d in data] == blobs
    other = T.CKKS("ckks", 128, 40, cryptodir=shared_dir, seed=12,
                   device="cpu", prng="rbg", **RBG_MODES[mode])
    other.loadCryptoParams()
    assert other.encrypt(data[0]) != blobs[0]
    assert _loaded(T.CKKS, shared_dir, **RBG_MODES[mode]).encrypt(
        data[0]) != blobs[0]
    if mode != "slots":
        for fused in (True, False):
            np.testing.assert_allclose(
                h.fedavg_round(data, WEIGHTS, DIMS, fused=fused), want,
                atol=1e-6)


def test_rbg_ffts_blob_is_aggregated_and_decrypted_by_jax(shared_dir):
    """An FFTS blob the port seals under rbg carries its a-stream as a
    threefry seed pair, so the JAX package expands, aggregates and
    decrypts it within 1e-6, and expands it to the port's ciphertext."""
    rng = np.random.default_rng(13)
    data = [rng.standard_normal(DIMS) for _ in range(2)]
    t = _loaded(T.CKKS, shared_dir, prng="rbg", seeded_fresh=True)
    blobs = [t.encrypt(d) for d in data]
    assert all(b[:4] == b"FFTS" for b in blobs)
    j = _loaded(J.CKKS, shared_dir)
    agg = j.computeWeightedAverage(blobs, [0.25, 0.75])
    np.testing.assert_allclose(j.decrypt(agg, DIMS),
                               0.25 * data[0] + 0.75 * data[1], atol=1e-6)
    assert agg == t.computeWeightedAverage(blobs, [0.25, 0.75])


RBG_PARITY_MODES = {k: MODES[k] for k in ("public_key", "symmetric",
                                          "seeded_fresh", "slots")}


@pytest.mark.parametrize("mode", RBG_PARITY_MODES)
def test_rbg_helpers_write_the_same_bytes_as_jax(tmp_path, monkeypatch,
                                                 mode):
    """Under rbg (the JAX class's FHE_FED_TPU_PRNG=rbg, the port's
    prng="rbg") one seed gives the JAX class's key files, blobs and
    aggregate byte for byte, bit-equal decrypts and, in the coefficient
    modes, the same cohort ciphertext and fused round."""
    monkeypatch.setenv("FHE_FED_TPU_PRNG", "rbg")
    kw = RBG_PARITY_MODES[mode]
    j = J.CKKS("ckks", 128, 40, cryptodir=str(tmp_path / "jax"), seed=17,
               **kw)
    t = T.CKKS("ckks", 128, 40, cryptodir=str(tmp_path / "port"), seed=17,
               device="cpu", prng="rbg", **kw)
    j.genCryptoContextAndKeyGen()
    t.genCryptoContextAndKeyGen()
    for name in ("cryptocontext.txt", "key-public.txt", "key-private.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    rng = np.random.default_rng(4)
    data = [rng.standard_normal(DIMS) for _ in range(3)]
    jb = [j.encrypt(d) for d in data]
    assert [t.encrypt(d) for d in data] == jb
    agg = t.computeWeightedAverage(jb, WEIGHTS)
    assert agg == j.computeWeightedAverage(jb, WEIGHTS)
    _same_f64(t.decrypt(agg, DIMS), j.decrypt(agg, DIMS))
    if mode == "slots":
        return
    ct = t.encrypt_cohort(data)
    np.testing.assert_array_equal(ct.data.numpy(), np.asarray(
        j.encrypt_cohort(data).data).astype(np.int32))
    _same_f64(t.fedavg_round(data, WEIGHTS, DIMS),
              j.fedavg_round(data, WEIGHTS, DIMS))
