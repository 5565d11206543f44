"""Port parity of the threshold-CKKS scheme (fhe_fed_tpu_torch.ThresholdCKKS)
against fhe_fed_tpu.ThresholdCKKS at batch 128 / scale 2**40 (ring 8192),
3 parties, as tests/test_threshold_scheme.py: with one seed both classes
write the same cryptodir (key shares, joint public key, context JSON) and
the same blobs, decrypt and run fedavg_round to the same bits, read each
other's cryptodirs and fuse each other's partial decryptions."""

import numpy as np
import pytest
import torch
import jax

import fhe_fed_tpu as J
import fhe_fed_tpu_torch as T
from fhe_fed_tpu_torch.utils import threefry as TF

torch.set_num_threads(1)

WEIGHTS = [0.5, 0.2, 0.3]
DIMS = 500
FILES = ("cryptocontext.txt", "key-public.txt", "key-share-0.txt",
         "key-share-1.txt", "key-share-2.txt")


def _cpu(cls) -> dict:
    """device="cpu" for a port class (its default is the card); the JAX
    classes take no device."""
    return ({"device": "cpu"} if cls.__module__.startswith("fhe_fed_tpu_torch")
            else {})


def _same_f64(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.int64),
                                  np.asarray(b).view(np.int64))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX and a port helper with the same seed, each with its own
    freshly generated cryptodir."""
    d = tmp_path_factory.mktemp("thr")
    j = J.ThresholdCKKS("ckks-threshold", 128, 40, cryptodir=str(d / "jax"),
                        parties=3, seed=5)
    t = T.ThresholdCKKS("ckks-threshold", 128, 40, cryptodir=str(d / "port"),
                        parties=3, seed=5, device="cpu")
    j.genCryptoContextAndKeyGen()
    t.genCryptoContextAndKeyGen()
    return j, t, d


def _loaded(cls, d, seed=9):
    h = cls("ckks-threshold", 128, 40, cryptodir=str(d), parties=3,
            seed=seed, **_cpu(cls))
    h.loadCryptoParams()
    return h


def _data(seed, k=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(DIMS).astype(np.float32) for _ in range(k)]


def test_keygen_writes_the_jax_cryptodir(pair):
    j, t, d = pair
    for name in FILES:
        assert (d / "port" / name).read_bytes() == \
            (d / "jax" / name).read_bytes(), name
    assert T.get_scheme("ckks-threshold") is T.ThresholdCKKS
    assert t._sk is None and t._secrets.n_parties == 3


def test_blobs_decrypt_and_rounds_match_jax(pair):
    """Same session stream: every blob, the aggregate, the threshold
    decrypt and both fedavg_round forms are the JAX class's bits."""
    j, t, _ = pair
    data = _data(0)
    jb = [j.encrypt(x) for x in data]
    tb = [t.encrypt(x) for x in data]
    assert tb == jb
    agg = t.computeWeightedAverage(tb, WEIGHTS)
    assert agg == j.computeWeightedAverage(jb, WEIGHTS)
    out = t.decrypt(agg, DIMS)
    _same_f64(out, j.decrypt(agg, DIMS))
    want = sum(w * x.astype(np.float64) for w, x in zip(WEIGHTS, data))
    np.testing.assert_allclose(out, want, atol=1e-5)
    for fused in (True, False):
        got = t.fedavg_round(data, WEIGHTS, DIMS, fused=fused)
        _same_f64(got, j.fedavg_round(data, WEIGHTS, DIMS, fused=fused))
        np.testing.assert_allclose(got, want, atol=1e-5)
    raw = t.decrypt_cohort(t.aggregate_cohort(t.encrypt_cohort(data),
                                              WEIGHTS), raw=True)
    jraw = j.decrypt_cohort(j.aggregate_cohort(j.encrypt_cohort(data),
                                               WEIGHTS), raw=True)
    assert torch.is_tensor(raw) and raw.shape == (4, 8192)
    np.testing.assert_array_equal(raw.numpy().view(np.int32),
                                  np.asarray(jraw).view(np.int32))


def test_cryptodirs_cross_both_ways(pair):
    """A port helper loads the JAX cryptodir and the other way round; a
    blob from the writer decrypts on the reader to the bits the writer
    gets with the same smudging stream."""
    j, t, d = pair
    x = _data(1, 1)[0]
    for writer, reader_cls, src in ((d / "jax", T.ThresholdCKKS, j),
                                    (d / "port", J.ThresholdCKKS, t)):
        reader = reader_cls("ckks-threshold", 128, 40, cryptodir=str(writer),
                            parties=3, seed=8, **_cpu(reader_cls))
        reader.loadCryptoParams()
        twin = type(src)("ckks-threshold", 128, 40, cryptodir=str(writer),
                         parties=3, seed=8, **_cpu(type(src)))
        twin.loadCryptoParams()
        blob = src.encrypt(x)
        got = reader.decrypt(blob, DIMS)
        _same_f64(got, twin.decrypt(blob, DIMS))
        np.testing.assert_allclose(got, x, atol=1e-4)


def test_partials_fuse_in_either_package(pair):
    """Each party's published share is the JAX class's uint32 array; a
    mixed set of shares fuses to the same bits in both packages."""
    j, t, _ = pair
    data = _data(4)
    agg = t.computeWeightedAverage([t.encrypt(x) for x in data], WEIGHTS)
    tparts = [t.partial_decrypt(i, agg, rng_key=TF.key(70 + i))
              for i in range(3)]
    jparts = [j.partial_decrypt(i, agg, rng_key=jax.random.key(70 + i))
              for i in range(3)]
    for p, jp in zip(tparts, jparts):
        assert p.dtype == np.uint32 and p.shape == (4, 4, 8192)
        np.testing.assert_array_equal(p, np.asarray(jp))
    mixed = [tparts[0], np.asarray(jparts[1]), tparts[2]]
    out = t.fuse_partials(mixed, agg, DIMS)
    _same_f64(out, j.fuse_partials(mixed, agg, DIMS))
    np.testing.assert_allclose(
        out, sum(w * x.astype(np.float64) for w, x in zip(WEIGHTS, data)),
        atol=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        t.partial_decrypt(3, agg)


def test_single_partial_reveals_nothing(pair):
    _, t, _ = pair
    blob = t.computeWeightedAverage([t.encrypt(np.zeros(DIMS))], [1.0])
    part = t.partial_decrypt(0, blob, rng_key=TF.key(80))
    assert np.abs(t.fuse_partials([part], blob, DIMS)).max() > 1.0


def test_refusals(pair):
    j, t, d = pair
    for parties in (2, 4):
        for cls in (T.ThresholdCKKS, J.ThresholdCKKS):
            h = cls("ckks-threshold", 128, 40, cryptodir=str(d / "port"),
                    parties=parties, **_cpu(cls))
            with pytest.raises(ValueError, match="does not match"):
                h.loadCryptoParams()
    fresh = T.ThresholdCKKS("ckks-threshold", 128, 40,
                            cryptodir=str(d / "port"), device="cpu")
    with pytest.raises(RuntimeError, match="first"):
        fresh.decrypt(t.encrypt(np.zeros(3)), 3)
    with pytest.raises(RuntimeError, match="first"):
        fresh.partial_decrypt(0, b"")


def test_fhe_fedavg_state_dict_selective(pair):
    """fhe_fedavg over torch state_dicts, whole and with rate=0.4; the
    JAX class gives the same bits on the same arrays as numpy."""
    _, _, d = pair
    j = _loaded(J.ThresholdCKKS, d / "jax")
    t = _loaded(T.ThresholdCKKS, d / "jax")
    gen = torch.Generator().manual_seed(2)
    sds = [{"a.weight": torch.randn((7, 9), generator=gen),
            "b.bias": torch.randn((33,), generator=gen)} for _ in range(3)]
    w = [1 / 3] * 3
    want = T.plain_fedavg(sds, w)
    for policy in (T.SelectivePolicy(), T.SelectivePolicy(rate=0.4)):
        got = T.fhe_fedavg(t, sds, w, policy)
        jgot = J.fhe_fedavg(j, [{k: v.numpy() for k, v in sd.items()}
                                for sd in sds], w,
                            J.SelectivePolicy(rate=policy.rate))
        for k in want:
            assert got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jgot[k]))
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=1e-5)


def test_fedavg_round_never_runs_the_single_key_round(pair, monkeypatch):
    """There is no single secret key: fedavg_round runs
    threshold_round_fused (fused) or stages with the threshold decrypt."""
    from fhe_fed_tpu_torch.ckks import ops, threshold as thr
    _, t, _ = pair
    monkeypatch.setattr(ops, "fedavg_round_fused", lambda *a, **k: pytest.fail(
        "the single-key fused round ran"))
    calls = []
    real = thr.threshold_round_fused
    monkeypatch.setattr(thr, "threshold_round_fused",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    data = _data(6)
    want = sum(w * x.astype(np.float64) for w, x in zip(WEIGHTS, data))
    np.testing.assert_allclose(t.fedavg_round(data, WEIGHTS, DIMS), want,
                               atol=1e-5)
    assert calls == [1]
    np.testing.assert_allclose(t.fedavg_round(data, WEIGHTS, DIMS,
                                              fused=False), want, atol=1e-5)
    assert calls == [1]


def test_prng_default_is_threefry_on_the_cpu(pair):
    """ThresholdCKKS on the CPU samples with threefry (the JAX cryptodir
    and bytes above), rbg when asked or on the card."""
    from fhe_fed_tpu_torch.utils import prng
    _, t, d = pair
    assert t.prng == "threefry" and t._rng.shape == (2,)
    assert prng.default_impl(torch.device("cuda")) == "rbg"
    r = T.ThresholdCKKS("ckks-threshold", 128, 40, cryptodir=str(d / "x"),
                        parties=3, seed=5, device="cpu", prng="rbg")
    assert r.prng == "rbg" and r._dec_keys().shape == (3, 4)


def test_rbg_threshold_round_decrypts(tmp_path):
    """prng="rbg" on the CPU: the keygen ceremony rooted at an rbg session
    key, the bytes surface, both fedavg_round forms and three partial
    decryptions under rbg smudging keys, fused, all within the threshold
    bound (1e-5 at 2**40); the same seed gives the same key shares."""
    from fhe_fed_tpu_torch.utils import prng
    hs = []
    for sub in ("a", "b"):
        h = T.ThresholdCKKS("ckks-threshold", 128, 40,
                            cryptodir=str(tmp_path / sub), parties=3, seed=5,
                            device="cpu", prng="rbg")
        h.genCryptoContextAndKeyGen()
        hs.append(h)
    for name in FILES:
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name
    T.ThresholdCKKS("ckks-threshold", 128, 40, cryptodir=str(tmp_path / "c"),
                    parties=3, seed=5, device="cpu"
                    ).genCryptoContextAndKeyGen()
    assert (tmp_path / "a" / FILES[2]).read_bytes() != \
        (tmp_path / "c" / FILES[2]).read_bytes()
    h = hs[0]
    data = _data(7)
    want = sum(w * x.astype(np.float64) for w, x in zip(WEIGHTS, data))
    agg = h.computeWeightedAverage([h.encrypt(x) for x in data], WEIGHTS)
    np.testing.assert_allclose(h.decrypt(agg, DIMS), want, atol=1e-5)
    for fused in (True, False):
        np.testing.assert_allclose(
            h.fedavg_round(data, WEIGHTS, DIMS, fused=fused), want,
            atol=1e-5)
    keys = prng.split(prng.key(70, "rbg", "cpu"), 3)
    parts = [h.partial_decrypt(i, agg, rng_key=keys[i]) for i in range(3)]
    np.testing.assert_allclose(h.fuse_partials(parts, agg, DIMS), want,
                               atol=1e-5)


def test_rbg_threshold_writes_the_jax_bytes(tmp_path, monkeypatch):
    """Under rbg (the JAX class's FHE_FED_TPU_PRNG=rbg, the port's
    prng="rbg") one seed gives the JAX class's cryptodir (key shares
    included), blobs, stacked threshold decryptions, per-party partial
    decryptions and fused rounds byte for byte: the smudging's vmap over
    the parties draws from the first party's key in both."""
    monkeypatch.setenv("FHE_FED_TPU_PRNG", "rbg")
    j = J.ThresholdCKKS("ckks-threshold", 128, 40,
                        cryptodir=str(tmp_path / "jax"), parties=3, seed=8)
    t = T.ThresholdCKKS("ckks-threshold", 128, 40,
                        cryptodir=str(tmp_path / "port"), parties=3, seed=8,
                        device="cpu", prng="rbg")
    j.genCryptoContextAndKeyGen()
    t.genCryptoContextAndKeyGen()
    for name in FILES:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    data = _data(21)
    jb = [j.encrypt(x) for x in data]
    assert [t.encrypt(x) for x in data] == jb
    agg = j.computeWeightedAverage(jb, WEIGHTS)
    _same_f64(t.decrypt(agg, DIMS), j.decrypt(agg, DIMS))
    for i in range(3):
        np.testing.assert_array_equal(
            t.partial_decrypt(i, agg).astype(np.int64),
            np.asarray(j.partial_decrypt(i, agg)).astype(np.int64))
    for fused in (True, False):
        _same_f64(t.fedavg_round(data, WEIGHTS, DIMS, fused=fused),
                  j.fedavg_round(data, WEIGHTS, DIMS, fused=fused))
