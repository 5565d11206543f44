"""Port parity of the headline benchmark, fhe_fed_tpu_torch/bench.py,
against bench.py and the JAX package's ops on the CPU.

At the bench's crypto point (batch 4096, 2^52: N 8192, 4 live limbs) with
the committed key fixtures, 3 clients, 2 chunks and blocks of 2 rounds:
the cohort is bench.py's construction byte for byte; under
prng="threefry" every round's ciphertexts, aggregates, decrypts and fused
rounds equal the JAX package's for the same tag bit for bit (decrypted
f32 compared as int32 bit patterns: tolerance 0), and so they do under
prng="rbg", bench.py's own choice (round keys
jax.random.split(jax.random.key(tag, impl="rbg")), XLA's Philox draws),
there also at full width: one round of the CNN's 3 x 1,663,370 values
at 204 chunks; the rbg rounds are reproducible per tag and decrypt within
bench.py's 1e-6; the JSON dict has bench.py's keys.
"""

import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_fed_tpu.ckks import params as J_params, ops as J_ops
from fhe_fed_tpu.ckks import serial as J_serial
from fhe_fed_tpu_torch import bench
from fhe_fed_tpu_torch.utils import prng

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_VALUES = 12_000         # 2 dense chunks of N = 8192
ROUNDS = 2
TAGS = (2, 201)           # bench.py's first measured staged / fused tags
CPU = torch.device("cpu")


def _u32(t):
    return t.numpy().astype(np.uint32)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.fixture(scope="module")
def pair():
    """Both packages' context and fixture keys, and the bench's cohort."""
    sk_blob = (bench.KEY_DIR / bench.SK_NAME).read_bytes()
    pk_blob = (bench.KEY_DIR / bench.PK_NAME).read_bytes()
    jctx = J_params.make_context(J_params.make_params(**bench.PARAMS))
    jsk = J_serial.deserialize_secret_key(sk_blob)
    jpk = J_serial.deserialize_public_key(pk_blob)
    _, params, tctx, tsk, tpk = bench.run_init(CPU)
    values, flats = bench.make_clients(N_VALUES, bench.N_CLIENTS,
                                       params.ring_dim, params.ring_dim)
    weights = [1.0 / bench.N_CLIENTS] * bench.N_CLIENTS
    cohort = bench.Cohort(tctx, tsk, tpk, values, weights, "threefry")
    return dict(jctx=jctx, jsk=jsk, jpk=jpk, jvals=jnp.asarray(
        values.numpy()), cohort=cohort, flats=flats)


def _bench_py_clients(n_params, n_clients, n, cap):
    """bench.py:137-153, written out."""
    chunks = -(-n_params // cap)
    rng = np.random.default_rng(0)

    def make_client(i):
        buf = np.zeros((chunks, n), dtype=np.float32)
        flat = rng.standard_normal(n_params).astype(np.float32) * 0.1
        pay = buf[:, :cap].reshape(-1)
        pay[:n_params] = flat
        buf[:, :cap] = pay.reshape(chunks, cap)
        return buf, flat

    clients = [make_client(i) for i in range(n_clients)]
    return np.stack([v for v, _ in clients]), [f for _, f in clients]


@pytest.mark.parametrize("cap,chunks", [(8192, 204), (4096, 407)])
def test_make_clients_is_bench_py_construction(cap, chunks):
    """Byte-equal to bench.py's cohort at the CNN's 1,663,370 values, and
    its chunk arithmetic: 204 dense chunks, 407 at 4096 values a chunk."""
    assert bench.chunks_for(bench.CNN_PARAMS, cap) == chunks
    got, flats = bench.make_clients(bench.CNN_PARAMS, bench.N_CLIENTS, 8192,
                                    cap)
    want, want_flats = _bench_py_clients(bench.CNN_PARAMS, bench.N_CLIENTS,
                                         8192, cap)
    assert got.dtype == torch.float32 and got.device == CPU
    assert tuple(got.shape) == (bench.N_CLIENTS, chunks, 8192)
    assert got.numpy().tobytes() == want.tobytes()
    for f, w in zip(flats, want_flats):
        assert f.tobytes() == w.tobytes()


def test_fixture_keys_equal_in_both_packages(pair):
    """Both deserializers read the committed fixtures into equal
    residues and Shoup words."""
    t = pair["cohort"]
    for a, b in ((t.sk.s, pair["jsk"].s), (t.sk.s_shoup, pair["jsk"].s_shoup),
                 (t.pk.p0, pair["jpk"].p0), (t.pk.p0_shoup,
                                              pair["jpk"].p0_shoup),
                 (t.pk.p1, pair["jpk"].p1), (t.pk.p1_shoup,
                                              pair["jpk"].p1_shoup)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_keygen_main_writes_the_committed_fixtures(tmp_path):
    bench.keygen_main(tmp_path, "cpu")
    for name in (bench.SK_NAME, bench.PK_NAME):
        assert ((tmp_path / name).read_bytes()
                == (bench.KEY_DIR / name).read_bytes()), name


@pytest.mark.parametrize("tag", TAGS)
def test_threefry_round_keys_are_jax_split(tag):
    want = jax.random.key_data(jax.random.split(jax.random.key(tag),
                                                ROUNDS))
    got = bench.round_rngs(tag, ROUNDS, "threefry", CPU)
    assert len(got) == ROUNDS
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("tag", TAGS)
def test_rbg_round_keys_are_jax_split(tag):
    """bench.py:164's keys: split(key(tag, "rbg"), rounds), the port's and
    JAX's key data alike."""
    got = bench.round_rngs(tag, ROUNDS, "rbg", CPU)
    assert len(got) == ROUNDS
    assert torch.equal(torch.stack(got),
                       prng.split(prng.key(tag, "rbg", CPU), ROUNDS))
    want = jax.random.key_data(jax.random.split(
        jax.random.key(tag, impl="rbg"), ROUNDS))
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  np.asarray(want).astype(np.int64))


def _jax_keys(tag, rounds, prng_name):
    """bench.py:164's round keys under `prng_name`."""
    impl = "rbg" if prng_name == "rbg" else "threefry2x32"
    return jax.random.split(jax.random.key(tag, impl=impl), rounds)


def _rounds_equal_jax(c, pair, jvals, prng_name, symmetric, tag, rounds):
    """Each round's cohort ciphertext, its weighted sum and its decrypt
    equal the JAX package's for the same tag: residues bit for bit,
    decrypted f32 bit for bit (tolerance 0)."""
    jctx = pair["jctx"]
    c = dataclasses.replace(c, prng=prng_name)
    cts = bench.encrypt_rounds(c, bench.round_rngs(tag, rounds, prng_name,
                                                   CPU), symmetric)
    aggs = bench.aggregate_rounds(c, cts)
    outs = bench.decrypt_rounds(c, aggs)
    keys = _jax_keys(tag, rounds, prng_name)
    for r in range(rounds):
        if symmetric:
            jct = J_ops.encrypt_symmetric_stacked(jctx, pair["jsk"], jvals,
                                                  keys[r])
        else:
            jct = J_ops.encrypt_stacked(jctx, pair["jpk"], jvals, keys[r])
        np.testing.assert_array_equal(_u32(cts[r].data), np.asarray(jct.data))
        jagg = J_ops.weighted_sum(jctx, jct, c.weights)
        assert aggs[r].scale == jagg.scale
        np.testing.assert_array_equal(_u32(aggs[r].data),
                                      np.asarray(jagg.data))
        np.testing.assert_array_equal(
            _bits(outs[r]), _bits(J_ops.decrypt(jctx, pair["jsk"], jagg)))
    if rounds > 1:
        assert not torch.equal(cts[0].data, cts[1].data)
    return outs


@pytest.mark.parametrize("symmetric", [True, False])
def test_threefry_round_equals_jax(pair, symmetric):
    """Each round's cohort ciphertext, its weighted sum and its decrypt
    equal the JAX package's for the same tag: residues bit for bit,
    decrypted f32 bit for bit (tolerance 0)."""
    _rounds_equal_jax(pair["cohort"], pair, pair["jvals"], "threefry",
                      symmetric, TAGS[0], ROUNDS)


@pytest.mark.parametrize("symmetric", [True, False])
def test_rbg_round_equals_jax(pair, symmetric):
    """bench.py's own PRNG: under rbg round keys every round's cohort
    ciphertext (secret and public key), aggregate and decrypt equal the
    JAX package's bit for bit, as under threefry."""
    _rounds_equal_jax(pair["cohort"], pair, pair["jvals"], "rbg", symmetric,
                      TAGS[0], ROUNDS)


def test_rbg_round_at_204_chunks_equals_bench_py(pair):
    """One staged round of bench.py's headline at full width (the CNN's
    1,663,370 values x 3 clients, 204 dense chunks) under its rbg round
    keys: the port's ciphertexts, aggregate and decrypt are bench.py's on
    the CPU bit for bit, and the decrypt is within bench.py's 1e-6."""
    c = pair["cohort"]
    values, flats = bench.make_clients(bench.CNN_PARAMS, bench.N_CLIENTS,
                                       8192, 8192)
    assert values.shape[1] == 204
    full = dataclasses.replace(c, values=values)
    out = _rounds_equal_jax(full, pair, jnp.asarray(values.numpy()), "rbg",
                            True, TAGS[0], 1)[0]
    want = sum(w * f for w, f in zip(c.weights, flats))
    assert bench._max_err(out, want, 8192) <= 1e-6


def _fused_equal_jax(pair, prng_name):
    c, jctx = dataclasses.replace(pair["cohort"], prng=prng_name), \
        pair["jctx"]
    tag = TAGS[1]
    rngs = bench.round_rngs(tag, ROUNDS, prng_name, CPU)
    outs = bench.fused_rounds(c, rngs)
    keys = _jax_keys(tag, ROUNDS, prng_name)
    for r in range(ROUNDS):
        want = J_ops.fedavg_round_fused(jctx, pair["jsk"], pair["jvals"],
                                        keys[r], c.weights)
        np.testing.assert_array_equal(_bits(outs[r]), _bits(want))
    staged = bench.decrypt_rounds(c, bench.aggregate_rounds(
        c, bench.encrypt_rounds(c, rngs[:1])))
    np.testing.assert_array_equal(_bits(staged[0]), _bits(outs[0]))


def test_threefry_fused_round_equals_jax(pair):
    """fedavg_round_fused per round equals the JAX package's bit for bit
    (tolerance 0), and the staged round's decrypt."""
    _fused_equal_jax(pair, "threefry")


def test_rbg_fused_round_equals_jax(pair):
    """The same under bench.py's rbg round keys."""
    _fused_equal_jax(pair, "rbg")


def test_generator_rounds_are_reproducible_and_decrypt(pair):
    """The rbg path (XLA's Philox stream under rbg keys): the same tag
    gives the same ciphertexts, another tag others; the decrypt is within
    1e-6 of the f32 plaintext average."""
    c = pair["cohort"]
    g = bench.Cohort(c.ctx, c.sk, c.pk, c.values, c.weights, "rbg")
    a = bench.encrypt_rounds(g, bench.round_rngs(5, ROUNDS, "rbg", CPU))
    b = bench.encrypt_rounds(g, bench.round_rngs(5, ROUNDS, "rbg", CPU))
    other = bench.encrypt_rounds(g, bench.round_rngs(6, 1, "rbg", CPU))
    for x, y in zip(a, b):
        assert torch.equal(x.data, y.data)
    assert not torch.equal(a[0].data, a[1].data)
    assert not torch.equal(a[0].data, other[0].data)
    want = sum(w * f for w, f in zip(c.weights, pair["flats"]))
    out = bench.decrypt_rounds(g, bench.aggregate_rounds(g, a))[0]
    assert bench._max_err(out, want, 8192) <= 1e-6


def test_round_rngs_refuses_an_unknown_prng():
    with pytest.raises(ValueError, match="prng"):
        bench.round_rngs(1, 2, "generator", CPU)


def _bench_py_json_keys():
    """The keys of the dict bench.py prints (its json.dumps call), read
    from its syntax tree: (top level, phases, config)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")

    def keys(d):
        return {k.value for k in d.keys if k is not None}

    top = call.args[0]
    sub = {k.value: v for k, v in zip(top.keys, top.values)}
    return keys(top), keys(sub["phases"]), keys(sub["config"])


def test_headline_json_has_bench_py_keys_and_holds_max_err():
    """One headline on the CPU at 407-chunk packing (4096 values a chunk)
    over 2 chunks, blocks of 2, one rep, rbg PRNG: bench.py's metric
    and keys, plus backend / prng / device / power_limit_w; max_err <=
    1e-6; JSON-serialisable."""
    r = bench.headline(4096, "rbg", "cpu", n_params=8000, n_times=2,
                       reps=1)
    top, phases, config = _bench_py_json_keys()
    assert set(r) == top
    assert r["metric"] == "fedavg_cnn1.66M_3clients_enc_agg_dec"
    assert set(r["phases"]) == phases
    assert set(r["config"]) == config | {"prng", "device", "power_limit_w"}
    assert r["config"]["chunks"] == 2 and r["config"]["values_per_ct"] == 4096
    assert (r["config"]["backend"], r["config"]["prng"],
            r["config"]["device"], r["config"]["power_limit_w"]) == (
                "cpu", "rbg", "cpu", None)
    assert r["max_err"] <= 1e-6
    assert r["value"] == pytest.approx(sum(
        r["phases"][k] for k in ("encrypt", "aggregate", "decrypt")))
    assert all(v > 0 for v in r["phases"].values())
    json.dumps(r)


def test_default_device_is_the_card(monkeypatch):
    """No fallback: with no CUDA device the default device raises before
    any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.headline(n_params=8000)
