"""fhe_fedavg's one flow, as far as the CPU reaches it: the leaf plan
(fed/tree_average.py `leaf_plan`) against split_by_policy's plan and
segment offsets, on the CNN's state dict and on the DeepSeek-V2-Lite
shard's 153 leaves; the plain versions of the kernel's three entries
against the numpy split, average and merge, bit for bit; cohorts of
bfloat16 leaves, and of bfloat16 and float32 leaves, against the same
leaves cast to float32, bit for bit; fhe_fedavg over CPU tensors, numpy
arrays, mixed trees, bfloat16, float64 and int64 leaves, which runs those
plain entries without touching the kernel's wrappers and gives the JAX
package's tree bit for bit (the encrypted part as the gathered tensor
through the port's helper, as host rows through a scheme that takes only
those); and the leaves it copies to float32 first,
counted in `tree_average.casts`. The kernel itself
is held to these plain versions and to the same flow on the CPU on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import collections

import numpy as np
import pytest
import torch

import fhe_fed_tpu as J
import fhe_fed_tpu_torch as T
from fhe_fed_tpu_torch import cuda_lib
from fhe_fed_tpu_torch.fed import fedavg as F
from fhe_fed_tpu_torch.fed import api as TA_api, tree_average as TA
from fhe_fed_tpu_torch.models import zoo
from fhe_fed_tpu_torch.models.basic import CNNOriginalFedAvg

torch.set_num_threads(1)

WEIGHTS = [0.5, 0.2, 0.3]
POLICIES = {
    "full": T.SelectivePolicy(),
    "rate_0.1": T.SelectivePolicy(rate=0.1),
    "layer_mask_list": T.SelectivePolicy(layer_mask=[0, 2, 5]),
    "callable_on_paths": T.SelectivePolicy(
        layer_mask=lambda i, path: path.endswith(".weight"), rate=0.5),
    "nothing_encrypted": T.SelectivePolicy(layer_mask=[]),
}


def _check_plan(sizes, paths, policy, flat):
    """leaf_plan against split_by_policy over `flat` (spec of sizes and
    paths): the plan, and the offsets the plan's segments take in the
    encrypted and plain vectors and in the layout."""
    plan = TA.leaf_plan(sizes, paths, policy)
    enc, plain, want = F.split_by_policy(flat, (None, None, sizes, paths),
                                         policy)
    assert plan.plan == want
    k = np.array([e for e, _ in want], dtype=np.int64)
    r = np.array([p for _, p in want], dtype=np.int64)
    np.testing.assert_array_equal(plan.enc, np.concatenate([[0],
                                                            np.cumsum(k)]))
    np.testing.assert_array_equal(plan.plain,
                                  np.concatenate([[0], np.cumsum(r)]))
    np.testing.assert_array_equal(plan.out,
                                  np.concatenate([[0], np.cumsum(sizes)]))
    assert plan.enc[-1] == enc.size and plan.plain[-1] == plain.size
    return plan, enc, plain


@pytest.mark.parametrize("name", ["full", "rate_0.1", "layer_mask_list",
                                  "callable_on_paths"])
def test_leaf_plan_matches_split_by_policy_on_the_cnn(name):
    """On CNN_OriginalFedAvg's state dict, each segment of the plan holds
    split_by_policy's values: the prefix of leaf i at plan.enc[i], its
    remainder at plan.plain[i]."""
    torch.manual_seed(0)
    flat, spec = T.flatten_params(CNNOriginalFedAvg().state_dict())
    plan, enc, plain = _check_plan(spec[2], spec[3], POLICIES[name], flat)
    for i, (k, n) in enumerate(zip(plan.k, plan.sizes)):
        leaf = flat[plan.out[i]:plan.out[i + 1]]
        np.testing.assert_array_equal(enc[plan.enc[i]:plan.enc[i + 1]],
                                      leaf[:k])
        np.testing.assert_array_equal(
            plain[plan.plain[i]:plan.plain[i + 1]], leaf[k:])


@pytest.mark.parametrize("rate", [0.1, 1.0])
def test_leaf_plan_on_the_deepseek_shard_layout(rate):
    """The 153 leaves of DeepSeek-V2-Lite's shard (the zoo on "meta", no
    memory): at rate 0.1 the plan encrypts 53,506,181 values a client, as
    the benchmark's cell counts; split_by_policy runs over a flat of
    int8 zeros that takes no memory (its concatenations do)."""
    built = zoo.build("deepseek_v2_lite_shard", device="meta")
    paths = list(built.params)
    sizes = [v.numel() for v in built.params.values()]
    flat = np.broadcast_to(np.int8(0), (sum(sizes),))
    plan, _, _ = _check_plan(sizes, paths, T.SelectivePolicy(rate=rate),
                             flat)
    assert len(plan.k) == 153 and plan.out[-1] == 535_060_992
    assert plan.enc[-1] == (53_506_181 if rate == 0.1 else 535_060_992)


def _trees(sizes=(1, 4095, 4097, 0, 6, 30), clients=3, seed=0):
    """State dicts of float32 CPU tensors with leaves of `sizes` values
    (a zero-size one among them), the last two of shapes (2, 3) and
    (5, 6)."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(n,) for n in sizes[:-2]] + [(2, 3), (5, 6)]
    return [collections.OrderedDict(
        (f"layer{i}.weight" if i % 2 else f"layer{i}.bias",
         torch.randn(shp, generator=gen)) for i, shp in enumerate(shapes))
        for _ in range(clients)]


@pytest.mark.parametrize("name", list(POLICIES))
def test_plain_entries_match_the_host_split_average_and_merge(name):
    """gather_plain is split_by_policy's encrypted vector of each client;
    average_plain then scatter_plain of a decrypted vector give
    merge_by_policy of it and the numpy f64 average, bit for bit."""
    policy, trees = POLICIES[name], _trees()
    flats, specs = zip(*(T.flatten_params(t) for t in trees))
    spec = specs[0]
    splits = [F.split_by_policy(f, spec, policy) for f in flats]
    leaves = [list(t.values()) for t in trees]
    cohort = TA.Cohort(TA.leaf_plan(spec[2], spec[3], policy), leaves,
                       WEIGHTS)
    enc = TA.gather(cohort)
    assert enc.shape == (3, splits[0][0].size)
    for row, (want, _, _) in zip(enc, splits):
        np.testing.assert_array_equal(row.numpy(), want)
    plain = sum(w * pl.astype(np.float64) for w, (_, pl, _) in
                zip(WEIGHTS, splits)).astype(np.float32)
    dec = np.random.default_rng(1).standard_normal(
        splits[0][0].size).astype(np.float32)
    out = cohort.empty_output()
    TA.average(cohort, out)
    TA.scatter(cohort, torch.from_numpy(dec), out)
    want = F.merge_by_policy(dec, plain, splits[0][2])
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  want.view(np.int32))


def test_cohort_refuses_trees_that_differ():
    trees = _trees()
    leaves = [list(t.values()) for t in trees]
    leaves[1][2] = leaves[1][2][:-1]
    plan = TA.leaf_plan([x.numel() for x in leaves[0]], list(trees[0]),
                        F.FULL)
    with pytest.raises(ValueError, match="differ"):
        TA.Cohort(plan, leaves, WEIGHTS)


def _as(trees, dtypes):
    """`trees` with leaf i cast to dtypes[i % len(dtypes)]."""
    return [collections.OrderedDict(
        (k, v.to(dtypes[i % len(dtypes)])) for i, (k, v) in
        enumerate(t.items())) for t in trees]


@pytest.mark.parametrize("kind", ["bfloat16", "mixed"])
@pytest.mark.parametrize("name", list(POLICIES))
def test_plain_entries_read_bfloat16_as_its_float32_cast(kind, name):
    """A cohort of bfloat16 leaves, or of bfloat16 and float32 leaves in
    turn, gathers, averages and scatters bit for bit what the cohort of
    the same leaves cast to float32 does; its mode is 1 (every leaf
    bfloat16) or 2 (mixed), a float32 cohort's 0."""
    dtypes = ((torch.bfloat16,) if kind == "bfloat16"
              else (torch.bfloat16, torch.float32))
    trees = _as(_trees(), dtypes)
    policy = POLICIES[name]
    plan = TA.leaf_plan([v.numel() for v in trees[0].values()],
                        list(trees[0]), policy)
    cohorts = [TA.Cohort(plan, [[x.float() if cast else x for x in
                                 t.values()] for t in trees], WEIGHTS)
               for cast in (False, True)]
    assert [c.mode for c in cohorts] == [1 if kind == "bfloat16" else 2, 0]
    dec = torch.randn(int(plan.enc[-1]),
                      generator=torch.Generator().manual_seed(2))
    outs = []
    for c in cohorts:
        enc = TA.gather(c)
        assert enc.dtype == torch.float32
        out = c.empty_output()
        TA.average(c, out)
        TA.scatter(c, dec, out)
        outs.append((enc, out))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_cohort_refuses_other_dtypes_and_a_dtype_that_differs():
    """A cohort reads float32 and bfloat16 leaves alone, and leaf i of one
    dtype in every client."""
    trees = _trees()
    plan = TA.leaf_plan([v.numel() for v in trees[0].values()],
                        list(trees[0]), F.FULL)
    for dtypes in ([(torch.float16,)] * 3,
                   [(torch.bfloat16,), (torch.float32,), (torch.float32,)]):
        leaves = [list(_as([t], d)[0].values())
                  for t, d in zip(trees, dtypes)]
        with pytest.raises(ValueError, match="bfloat16"):
            TA.Cohort(plan, leaves, WEIGHTS)


@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    """Make helpers of one key pair and one seed, the port's on the CPU
    (threefry there), as tests/test_torch_fedavg.py makes them."""
    d = str(tmp_path_factory.mktemp("tree"))
    J.CKKS("ckks", 128, 40, cryptodir=d, seed=3).genCryptoContextAndKeyGen()

    def make(cls):
        h = cls("ckks", 128, 40, cryptodir=d, seed=5,
                **({"device": "cpu"} if cls is T.CKKS else {}))
        h.loadCryptoParams()
        return h
    return make


def _jax_policy(policy, paths):
    """`policy` as a JAX SelectivePolicy, whose callable mask is given no
    path: the same leaves selected by index."""
    mask = policy.layer_mask
    if callable(mask):
        mask = [i for i, path in enumerate(paths)
                if policy.leaf_selected(i, path)]
    return J.SelectivePolicy(layer_mask=mask, rate=policy.rate)


def _numpy_tree(tree):
    """A tree of tensors as numpy, bfloat16 widened exactly to float32
    (numpy has no bfloat16)."""
    return collections.OrderedDict(
        (k, v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy())
        if torch.is_tensor(v) else (k, v) for k, v in tree.items())


def _check_jax(helpers, trees, policy, use_bytes=False, wrap=None):
    """fhe_fedavg of `trees` through the plain entries (the port's helper
    as `wrap` gives it, if given), none of the kernel's wrappers reached
    and no launch counted, bit-equal to the JAX package's over the trees
    as numpy; the leaves float32 CPU views of one buffer."""
    launches = dict(cuda_lib.launches)
    helper = helpers(T.CKKS)
    got = T.fhe_fedavg(wrap(helper) if wrap else helper, trees, WEIGHTS,
                       policy, use_bytes)
    assert dict(cuda_lib.launches) == launches
    want = J.fhe_fedavg(helpers(J.CKKS), [_numpy_tree(t) for t in trees],
                        WEIGHTS, _jax_policy(policy, list(trees[0])),
                        use_bytes)
    assert type(got) is collections.OrderedDict and list(got) == list(want)
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      want[k].view(np.int32), err_msg=k)
    storages = {v.untyped_storage().data_ptr() for v in got.values()}
    assert len(storages) == 1


def _refuse(*args, **kwargs):
    raise AssertionError("the kernel's wrappers were reached")


@pytest.fixture
def plain_entries(monkeypatch):
    """Count the calls of the plain entries; make the kernel's launch
    raise."""
    calls = collections.Counter()
    for name in ("gather_plain", "average_plain", "scatter_plain"):
        def counted(*args, _name=name, _fn=getattr(TA, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(TA, name, counted)
    monkeypatch.setattr(TA.Cohort, "_launch", _refuse)
    return calls


@pytest.mark.parametrize("name", list(POLICIES))
def test_card_path_flow_on_cpu_tensors_equals_the_host_path(
        name, helpers, plain_entries):
    """fhe_fedavg over float32 CPU tensors under each policy takes the one
    flow through the plain entries and gives the JAX package's tree bit
    for bit under two helpers of one seed; the leaves come back as float32
    CPU views of one buffer."""
    trees, policy = _trees(sizes=(1, 129, 0, 6, 30)), POLICIES[name]
    _check_jax(helpers, trees, policy)
    plan = TA.leaf_plan([v.numel() for v in trees[0].values()],
                        list(trees[0]), policy)
    enc, plain = int(plan.enc[-1] > 0), int(plan.plain[-1] > 0)
    assert dict(plain_entries) == {
        k: v for k, v in (("gather_plain", enc), ("average_plain", plain),
                          ("scatter_plain", enc)) if v}


@pytest.mark.parametrize("kind", ["numpy", "cpu_tensors", "mixed",
                                  "bfloat16"])
def test_dispatch_sends_host_trees_down_the_host_path(kind, helpers,
                                                      plain_entries):
    """Numpy trees, CPU tensors (bfloat16 ones too, widened exactly to
    float32) and a mix take the one flow on the CPU: each plain entry runs
    once, the kernel is never launched, and the tree is the JAX
    package's."""
    trees = _trees(sizes=(7, 300, 0, 6, 30))
    if kind == "bfloat16":
        trees = [collections.OrderedDict((k, v.bfloat16()) for k, v in
                                         t.items()) for t in trees]
    elif kind == "numpy":
        trees = [_numpy_tree(t) for t in trees]
    elif kind == "mixed":
        trees[1] = collections.OrderedDict(
            (k, v.numpy() if i % 2 else v)
            for i, (k, v) in enumerate(trees[1].items()))
    _check_jax(helpers, trees, T.SelectivePolicy(rate=0.1))
    assert dict(plain_entries) == dict.fromkeys(
        ("gather_plain", "average_plain", "scatter_plain"), 1)


class _HostRows:
    """A scheme whose fedavg_round takes K host vectors only (it declares
    no `fedavg_round_takes_tensor`), as the benchmark's plain reference
    helper."""

    def __init__(self, helper):
        self.helper = helper

    def fedavg_round(self, vectors, *args, **kwargs):
        assert all(isinstance(v, np.ndarray) for v in vectors)
        return self.helper.fedavg_round(vectors, *args, **kwargs)


@pytest.mark.parametrize("scheme,staging", [
    ("port", {"device": 1}),
    ("host_rows", {"host": 1}),
])
def test_encrypted_part_staging_by_what_the_scheme_declares(
        scheme, staging, helpers, plain_entries):
    """The port's CPU helper takes the gathered (K, E) buffer as it lies
    and packs it on its device; a scheme that declares no tensor input
    gets host rows; either gives the JAX package's tree bit for bit."""
    TA_api.staging.clear()
    _check_jax(helpers, _trees(sizes=(7, 300, 0, 6, 30)),
               T.SelectivePolicy(rate=0.5),
               wrap=_HostRows if scheme == "host_rows" else None)
    assert dict(TA_api.staging) == staging


def _batchnorm_state_dicts():
    """Three state dicts of a Linear + BatchNorm1d model: float32 CPU
    tensors and BatchNorm's 0-d int64 `num_batches_tracked`, each client's
    its own."""
    out = []
    for c in range(3):
        torch.manual_seed(c)
        m = torch.nn.Sequential(torch.nn.Linear(5, 4),
                                torch.nn.BatchNorm1d(4))
        m(torch.randn(8, 5))     # training mode: running stats, counter 1
        m[1].num_batches_tracked += 1000 * c
        out.append(m.state_dict())
    return out


@pytest.mark.parametrize("use_bytes", [False, True])
@pytest.mark.parametrize("kind", ["int64_leaf", "float64_numpy"])
def test_one_flow_on_int64_and_float64_leaves(kind, use_bytes, helpers,
                                              plain_entries):
    """A BatchNorm model's state dicts (an int64 leaf among float32 ones)
    and a tree of float64 numpy arrays, rounded to float32 as numpy rounds
    them: the JAX package's tree bit for bit, through the plain entries,
    on fedavg_round and on the bytes path."""
    if kind == "int64_leaf":
        trees = _batchnorm_state_dicts()
        assert trees[2]["1.num_batches_tracked"].dtype == torch.int64
    else:
        trees = [collections.OrderedDict((k, v.double().numpy()) for k, v
                                         in t.items()) for t in _trees()]
    _check_jax(helpers, trees, T.SelectivePolicy(layer_mask=[0, 2, 5],
                                                 rate=0.5), use_bytes)
    assert dict(plain_entries) == dict.fromkeys(
        ("gather_plain", "average_plain", "scatter_plain"), 1)


@pytest.mark.parametrize("kind,casts", [
    ("float32", {}),
    ("bfloat16", {"bfloat16": 18}),
    ("float16_leaf", {"float16": 3}),
    ("transposed_leaf", {"float32": 3}),
    ("dtype_differs", {"bfloat16": 6}),
])
def test_casts_count_the_leaves_copied_to_float32(kind, casts, helpers,
                                                   plain_entries):
    """On the CPU a cohort reads contiguous float32 leaves as they lie and
    every other leaf through a float32 copy, one count a leaf and client
    in `tree_average.casts` by its dtype (6 leaves, 3 clients); the tree
    is the JAX package's either way."""
    trees = _trees()
    if kind == "bfloat16":
        trees = _as(trees, (torch.bfloat16,))
    elif kind == "float16_leaf":
        for t in trees:
            t["layer4.bias"] = t["layer4.bias"].half()
    elif kind == "transposed_leaf":
        for t in trees:
            t["layer5.weight"] = t["layer5.weight"].t()
    elif kind == "dtype_differs":
        trees[:2] = _as(trees[:2], (torch.bfloat16, torch.float32))
    TA.casts.clear()
    _check_jax(helpers, trees, T.SelectivePolicy(rate=0.5))
    assert dict(TA.casts) == casts
