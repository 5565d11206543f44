"""The port's `fhe.*` spans (fhe_fed_tpu_torch/utils/spans.py) and the
benchmark's readers of them (fedbench/metrics/).

With no profiler running a span never enters `record_function`. Under a
CPU torch.profiler the helper's calls give the spans the code makes: one
`fhe.key_split` per key split, one `fhe.serialize` / `fhe.deserialize`
per blob written / read, one `fhe.slice` per streamed slice, one
outermost `fhe.pack` / `fhe.unpack` a round, and in `fhe_fedavg` one
`fhe.tree_flatten`, a gather's `fhe.tree_split`, `fhe.plain_average`,
`fhe.encrypted_part`, a scatter's `fhe.tree_split` and
`fhe.tree_unflatten`. The readers are held to
synthetic traces, and the breakdown labels an idle gap with the innermost
program span."""

import collections

import numpy as np
import pytest
import torch

import fhe_fed_tpu_torch as T
from fhe_fed_tpu_torch.utils import spans, threefry
from fedbench import run, spec, trace as tr

torch.set_num_threads(1)

WEIGHTS = [0.5, 0.2, 0.3]
DIMS = 1000     # 8 chunks of 128 values at batch 128 (ring 8192)
ENCLOSING = "fedbench.round"


@pytest.fixture(scope="module")
def helper(tmp_path_factory):
    """A secret-key helper on the CPU drawing with rbg keys (4 words)."""
    d = str(tmp_path_factory.mktemp("spans"))
    h = T.CKKS("ckks", 128, 40, cryptodir=d, seed=3, symmetric=True,
               device="cpu", prng="rbg")
    h.genCryptoContextAndKeyGen()
    h.loadCryptoParams()
    return h


@pytest.fixture(scope="module")
def vectors():
    rng = np.random.default_rng(8)
    return [rng.standard_normal(DIMS).astype(np.float32) for _ in WEIGHTS]


def _traced(fn, rounds=1) -> tr.Trace:
    """`rounds` calls of fn under a CPU profiler, each inside ENCLOSING."""
    def run(i):
        with torch.profiler.record_function(ENCLOSING):
            fn()
    return tr.profile(run, rounds, "cpu")


def _names(t: tr.Trace, name: str) -> list:
    return [e for e in t.host if e.cat == "user_annotation" and e.name == name]


def _outermost(t: tr.Trace, *names) -> list:
    return spec.load_file(spec.HERE / "metrics" / "keys_ms.cohort.py"
                          ).outermost(t, names)


def _inside(e: tr.Event, outer: tr.Event) -> bool:
    return outer.ts <= e.ts and e.end <= outer.end


def test_no_profiler_never_enters_record_function(monkeypatch, helper,
                                                  vectors):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()

    @spans.traced("fhe.test")
    def f(x, *, y):
        return x + y
    assert f(1, y=2) == 3 and f.__name__ == "f"
    with spans.span("fhe.test"):
        pass
    blobs = [helper.encrypt(v) for v in vectors]
    helper.decrypt(helper.computeWeightedAverage(blobs, WEIGHTS), DIMS)
    helper.fedavg_round(vectors, WEIGHTS, DIMS, max_chunks=5)
    helper.encrypt_cohort(vectors)
    T.fhe_fedavg(helper, _trees(), WEIGHTS, T.SelectivePolicy(rate=0.1))


def test_profiler_enters_each_span_once():
    @spans.traced("fhe.test_fn")
    def f():
        with spans.span("fhe.test_block"):
            return 7
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert f() == 7
    names = collections.Counter(e.key for e in prof.events())
    assert names["fhe.test_fn"] == 1 and names["fhe.test_block"] == 1


def test_encrypt_cohort_key_splits(monkeypatch, helper, vectors):
    """One `fhe.key_split` per key split the cohort encrypt makes:
    `_next_key`, `_split_clients`, `_sym_samples` and the two `_rbg_pair`
    draws (the uniform `a`, the error), each inside the enclosing
    annotation; three of them inside `fhe.sample`."""
    calls = []
    split = threefry.split

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return split(*args, **kwargs)
    monkeypatch.setattr(threefry, "split", counting)
    packed = helper.pack_cohort(vectors)
    assert helper._rng.shape == (4,)
    t = _traced(lambda: helper.encrypt_cohort(packed), rounds=2)
    assert len(calls) == 2 * 5
    outer = _names(t, ENCLOSING)
    splits = _names(t, "fhe.key_split")
    assert len(outer) == 2 and len(splits) == len(calls)
    assert len(_outermost(t, "fhe.key_split")) == len(splits)
    for o in outer:
        mine = [s for s in splits if _inside(s, o)]
        assert len(mine) == 5
        (sample,) = [s for s in _names(t, "fhe.sample") if _inside(s, o)]
        assert sum(_inside(s, sample) for s in mine) == 3
        (encode,) = [s for s in _names(t, "fhe.encode") if _inside(s, o)]
        assert not any(_inside(s, encode) for s in mine)


def test_bytes_round_wire_spans(helper, vectors):
    """Three encrypts, the weighted average and the decrypt: 3 + 1 blobs
    written, 3 + 1 read."""
    def round_():
        blobs = [helper.encrypt(v) for v in vectors]
        helper.decrypt(helper.computeWeightedAverage(blobs, WEIGHTS), DIMS)
    t = _traced(round_)
    assert len(_outermost(t, "fhe.serialize")) == 4
    assert len(_outermost(t, "fhe.deserialize")) == 4
    assert len(_names(t, "fhe.deserialize")) == 4
    assert len(_outermost(t, "fhe.serialize", "fhe.deserialize")) == 8
    assert len(_names(t, "fhe.pack")) == 3
    assert len(_names(t, "fhe.unpack")) == 1


def test_streamed_round_spans(helper, vectors):
    """fedavg_round of 8 chunks in slices of 5: padded to 10, two slices,
    one outermost pack (the packing and the padding) and one outermost
    unpack (the join and the unpack); the answer is the unsliced one."""
    want = helper.fedavg_round(vectors, WEIGHTS, DIMS, max_chunks=None)
    got = []
    t = _traced(lambda: got.append(
        helper.fedavg_round(vectors, WEIGHTS, DIMS, max_chunks=5)))
    np.testing.assert_allclose(got[0], want, atol=1e-6)
    assert len(_names(t, "fhe.slice")) == 2
    assert len(_outermost(t, "fhe.pack")) == 1
    assert len(_names(t, "fhe.pack")) == 2
    assert len(_outermost(t, "fhe.unpack")) == 1
    assert len(_names(t, "fhe.unpack")) == 2
    pack, unpack = _outermost(t, "fhe.pack")[0], _outermost(t, "fhe.unpack")[0]
    for s in _names(t, "fhe.slice"):
        assert pack.end <= s.ts and s.end <= unpack.ts


def _trees():
    """Three state dicts of 1,000 values each in 4 leaves."""
    rng = np.random.default_rng(9)
    shapes = (("a.weight", (20, 30)), ("a.bias", (30,)), ("b.weight", (10, 9)),
              ("b.norm", (280,)))
    return [collections.OrderedDict(
        (k, torch.as_tensor(rng.standard_normal(s).astype(np.float32)))
        for k, s in shapes) for _ in WEIGHTS]


def test_fhe_fedavg_spans(helper):
    """A selective round on CPU tensors takes the one flow: the flatten,
    the gather's split, the plain average, the encrypted part (holding the
    streamed round's pack and unpack), the scatter's split and the
    unflatten, in that order; the three readers of the `selective` cell
    read them."""
    trees = _trees()
    got = []
    t = _traced(lambda: got.append(T.fhe_fedavg(
        helper, trees, WEIGHTS, T.SelectivePolicy(rate=0.1))))
    want = T.plain_fedavg(trees, WEIGHTS)
    for k in want:
        torch.testing.assert_close(got[0][k], want[k], atol=1e-6, rtol=0)
    names = ("fhe.tree_flatten", "fhe.tree_split", "fhe.encrypted_part",
             "fhe.plain_average", "fhe.tree_unflatten")
    order = [e.name for e in _outermost(t, *names)]
    assert order == ["fhe.tree_flatten", "fhe.tree_split",
                     "fhe.plain_average", "fhe.encrypted_part",
                     "fhe.tree_split", "fhe.tree_unflatten"]
    (enc,) = _names(t, "fhe.encrypted_part")
    packs = _names(t, "fhe.pack")
    assert packs and all(_inside(e, enc) for e in packs)
    reading = _reading(t)
    for name, spans_ in (
            ("tree_ms.selective", ("fhe.tree_flatten", "fhe.tree_split",
                                   "fhe.tree_unflatten")),
            ("plain_ms.selective", ("fhe.plain_average",)),
            ("encrypted_ms.selective", ("fhe.encrypted_part",))):
        value = spec.load_reader(name)(reading)
        assert value == pytest.approx(1e-3 * sum(
            e.dur for e in _outermost(t, *spans_)))
        assert value > 0


def _synthetic(rounds=2) -> tr.Trace:
    """A window of 1000 us: two outermost `fhe.key_split` spans, one with
    a nested split, launches inside and outside them; a serialise, a
    deserialise, a pack with a nested pack, an unpack; a tree round's
    flatten, split, encrypted part, plain average and unflatten."""
    ev = tr.Event
    host = [
        ev(tr.WINDOW, "user_annotation", 0, 1000),
        ev("fedbench.encrypt_cohort", "user_annotation", 0, 400),
        ev("fhe.key_split", "user_annotation", 10, 100),
        ev("fhe.key_split", "user_annotation", 20, 30),
        ev("cudaLaunchKernel", "cuda_runtime", 25, 2),
        ev("cudaLaunchKernel", "cuda_runtime", 60, 2),
        ev("cudaLaunchKernelExC", "cuda_runtime", 100, 2),
        ev("cudaMemcpyAsync", "cuda_runtime", 105, 2),
        ev("cudaLaunchKernel", "cuda_runtime", 115, 2),
        ev("fhe.sample", "user_annotation", 200, 100),
        ev("fhe.key_split", "user_annotation", 210, 40),
        ev("cudaLaunchKernel", "cuda_runtime", 220, 2),
        ev("cudaLaunchKernel", "cuda_runtime", 260, 2),
        ev("fhe.serialize", "user_annotation", 400, 50),
        ev("fhe.deserialize", "user_annotation", 500, 30),
        ev("fhe.pack", "user_annotation", 600, 80),
        ev("fhe.pack", "user_annotation", 610, 40),
        ev("fhe.unpack", "user_annotation", 800, 20),
        ev("fhe.tree_flatten", "user_annotation", 830, 10),
        ev("fhe.tree_split", "user_annotation", 842, 6),
        ev("fhe.encrypted_part", "user_annotation", 850, 40),
        ev("fhe.plain_average", "user_annotation", 900, 30),
        ev("fhe.tree_split", "user_annotation", 935, 4),
        ev("fhe.tree_unflatten", "user_annotation", 940, 8),
    ]
    return tr.Trace([], sorted(host, key=lambda e: (e.ts, -e.dur)),
                    (0.0, 1000.0), rounds)


def _reading(trace):
    config = spec.cell("cnn1.66m.cohort").config
    return run.Reading(config, {"surface": "cohort"}, 1.0, 1.0, 10,
                       [1.0], {}, trace)


@pytest.mark.parametrize("name,want", [
    # Outermost spans only: the nested split's 30 us and launch count once.
    ("keys_ms.cohort", 1e-3 * (100 + 40) / 2),
    # 25, 60 and 100 (ExC) in the first span, 220 in the second; 115 and
    # 260 outside, and the memcpy is no launch.
    ("key_launches.cohort", 4 / 2),
    ("wire_ms.bytes", 1e-3 * (50 + 30) / 2),
    ("staging_ms.streamed", 1e-3 * (80 + 20) / 2),
    ("tree_ms.selective", 1e-3 * (10 + 6 + 4 + 8) / 2),
    ("plain_ms.selective", 1e-3 * 30 / 2),
    ("encrypted_ms.selective", 1e-3 * 40 / 2),
])
def test_span_readers(name, want):
    read = spec.load_reader(name)
    assert read(_reading(_synthetic())) == pytest.approx(want)
    assert read(_reading(_synthetic(rounds=4))) == pytest.approx(want / 2)
    assert read(_reading(None)) is None
    bare = _synthetic()
    bare.host = [e for e in bare.host if not e.name.startswith("fhe.")]
    assert read(_reading(bare)) is None


def test_breakdown_labels_gaps_with_the_innermost_program_span():
    """The device is idle from 100 to 900 us; at 500 the host is in
    `fhe.key_split` inside `fhe.sample` inside the benchmark's call,
    launching a kernel."""
    ev = tr.Event
    host = [ev(tr.WINDOW, "user_annotation", 0, 1000),
            ev("fedbench.encrypt_cohort", "user_annotation", 0, 1000),
            ev("fhe.sample", "user_annotation", 200, 600),
            ev("fhe.key_split", "user_annotation", 300, 400),
            ev("cudaLaunchKernel", "cuda_runtime", 450, 100)]
    device = [ev("k", "kernel", 0, 100), ev("k", "kernel", 900, 100)]
    t = tr.Trace(device, sorted(host, key=lambda e: (e.ts, -e.dur)),
                 (0.0, 1000.0), 1)
    gaps = tr.breakdown(t)["idle_gaps"]
    assert gaps == [["fhe.key_split / cudaLaunchKernel", pytest.approx(8e-4)]]
