"""The card path of fhe_fedavg, as far as the CPU reaches it: the leaf
plan (fed/tree_average.py `leaf_plan`) against split_by_policy's plan and
segment offsets, on the CNN's state dict and on the DeepSeek-V2-Lite
shard's 153 leaves; the plain versions of the kernel's three entries
against the host path's split, average and merge, bit for bit; and the
dispatch, which sends numpy arrays, CPU tensors and mixed trees down the
host path without touching the kernel's wrappers. The kernel itself is
held to these plain versions and to the host path on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import collections

import numpy as np
import pytest
import torch

import fhe_fed_tpu_torch as T
from fhe_fed_tpu_torch.fed import fedavg as F
from fhe_fed_tpu_torch.fed import tree_average as TA
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
    merge_by_policy of it and the host's f64 average, bit for bit."""
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


@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    """Make CPU helpers of one key pair and one seed."""
    d = str(tmp_path_factory.mktemp("tree"))
    T.CKKS("ckks", 128, 40, cryptodir=d, seed=3, symmetric=True,
           device="cpu").genCryptoContextAndKeyGen()

    def make():
        h = T.CKKS("ckks", 128, 40, cryptodir=d, seed=5, symmetric=True,
                   device="cpu")
        h.loadCryptoParams()
        return h
    return make


@pytest.mark.parametrize("name", list(POLICIES))
def test_card_path_flow_on_cpu_tensors_equals_the_host_path(name, helpers):
    """The card path's steps (leaf table, gather, average, the scheme's
    round, scatter, one output and its views), run here with the plain
    entries, give the host path's tree bit for bit under two helpers of
    one seed; the leaves come back as float32 CPU views of one buffer."""
    trees, policy = _trees(sizes=(1, 129, 0, 6, 30)), POLICIES[name]
    want = T.fhe_fedavg(helpers(), trees, WEIGHTS, policy)
    got = F._fhe_fedavg_card(helpers(), trees[0],
                             [list(t.values()) for t in trees], WEIGHTS,
                             policy, False)
    assert type(got) is collections.OrderedDict and list(got) == list(want)
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape
        assert torch.equal(got[k].view(torch.int32), want[k].view(torch.int32))
    storages = {v.untyped_storage().data_ptr() for v in got.values()}
    assert len(storages) == 1


def _refuse(*args, **kwargs):
    raise AssertionError("the kernel's wrappers were reached")


@pytest.mark.parametrize("kind", ["numpy", "cpu_tensors", "mixed",
                                  "bfloat16"])
def test_dispatch_sends_host_trees_down_the_host_path(kind, helpers,
                                                      monkeypatch):
    """Numpy trees, CPU tensors (bfloat16 ones too, widened exactly to
    float32 on the host) and a mix take the host path: the kernel's
    wrappers are never reached (patched to raise), and the result is the
    host path's."""
    trees = _trees(sizes=(7, 300, 0, 6, 30))
    if kind == "bfloat16":
        trees = [collections.OrderedDict((k, v.bfloat16()) for k, v in
                                         t.items()) for t in trees]
    elif kind == "numpy":
        trees = [collections.OrderedDict((k, v.numpy()) for k, v in
                                         t.items()) for t in trees]
    elif kind == "mixed":
        trees[1] = collections.OrderedDict(
            (k, v.numpy() if i % 2 else v)
            for i, (k, v) in enumerate(trees[1].items()))
    for name in ("Cohort", "gather", "average", "scatter"):
        monkeypatch.setattr(TA, name, _refuse)
    got = T.fhe_fedavg(helpers(), trees, WEIGHTS,
                       T.SelectivePolicy(rate=0.1))
    want = T.plain_fedavg(trees, WEIGHTS)
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=0)
