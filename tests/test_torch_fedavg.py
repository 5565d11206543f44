"""Port parity of the pytree FedAvg (fhe_fed_tpu_torch.fed.fedavg) and of
CNN_OriginalFedAvg (fhe_fed_tpu_torch.models.basic) against the JAX
package: leaf order as jax.tree_util, fhe_fedavg bit-equal under the three
policies for one seed, the model's size and forward pass."""

import collections

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import fhe_fed_tpu as J
import fhe_fed_tpu_torch as T
from fhe_fed_tpu.fed import fedavg as J_fedavg
from fhe_fed_tpu.models import basic as J_basic
from fhe_fed_tpu_torch import interop
from fhe_fed_tpu_torch.fed import fedavg as T_fedavg
from fhe_fed_tpu_torch.models.basic import CNNOriginalFedAvg

torch.set_num_threads(1)


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _trees(rng):
    """One tree per container kind, keys deliberately out of sorted order."""
    od = collections.OrderedDict([("zeta", _arr(rng, 3)), ("alpha",
                                                         _arr(rng, 2, 2))])
    return {
        "dict": {"b": _arr(rng, 4), "a": _arr(rng, 2, 3)},
        "ordered_dict": od,
        "list": [_arr(rng, 5), {"y": _arr(rng, 1), "x": _arr(rng, 2)}],
        "tuple": (_arr(rng, 2), [od, _arr(rng, 3)]),
    }


@pytest.mark.parametrize("kind", ["dict", "ordered_dict", "list", "tuple"])
def test_leaf_order_matches_jax_tree_util(kind):
    tree = _trees(np.random.default_rng(0))[kind]
    flat, spec = T.flatten_params(tree)
    want, _ = J_fedavg.flatten_params(tree)
    np.testing.assert_array_equal(flat, want)
    assert spec[2] == [int(np.asarray(x).size)
                       for x in jax.tree_util.tree_leaves(tree)]
    back = T.unflatten_params(flat, spec)
    assert type(back) is type(tree)
    for got, leaf in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, back)),
            jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got, leaf)


def test_unflatten_gives_float32_cpu_tensors_in_a_state_dict():
    torch.manual_seed(0)
    m = CNNOriginalFedAvg()
    sd = m.state_dict()
    flat, spec = T.flatten_params(sd)
    assert flat.dtype == np.float32 and flat.size == 1_663_370
    back = T.unflatten_params(flat, spec)
    assert type(back) is collections.OrderedDict and list(back) == list(sd)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in back.values())
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    CNNOriginalFedAvg().load_state_dict(back)


def _cpu(cls) -> dict:
    """device="cpu" for a port class (its default is the card); the JAX
    classes take no device."""
    return ({"device": "cpu"} if cls.__module__.startswith("fhe_fed_tpu_torch")
            else {})


@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("crypto"))
    J.CKKS("ckks", 128, 40, cryptodir=d, seed=2).genCryptoContextAndKeyGen()

    def make(cls):
        h = cls("ckks", 128, 40, cryptodir=d, seed=21, **_cpu(cls))
        h.loadCryptoParams()
        return h
    return make


def _model(rng):
    return {"conv": {"w": _arr(rng, 3, 3, 8), "b": _arr(rng, 8)},
            "fc": {"w": _arr(rng, 64, 10)}}


@pytest.mark.parametrize("policy", [
    dict(), dict(rate=0.3), dict(layer_mask={0, 2})])
@pytest.mark.parametrize("use_bytes", [False, True])
def test_fhe_fedavg_is_bit_equal_to_jax(helpers, policy, use_bytes):
    rng = np.random.default_rng(7)
    clients = [_model(rng) for _ in range(3)]
    weights = [0.5, 0.25, 0.25]
    got = T.fhe_fedavg(helpers(T.CKKS), clients, weights,
                       T.SelectivePolicy(**policy), use_bytes=use_bytes)
    want = J.fhe_fedavg(helpers(J.CKKS), clients, weights,
                        J.SelectivePolicy(**policy), use_bytes=use_bytes)
    plain = T.plain_fedavg(clients, weights)
    jplain = J.plain_fedavg(clients, weights)
    for path in (("conv", "w"), ("conv", "b"), ("fc", "w")):
        g = got[path[0]][path[1]]
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      want[path[0]][path[1]].view(np.int32))
        p = plain[path[0]][path[1]].numpy()
        np.testing.assert_array_equal(p, jplain[path[0]][path[1]])
        np.testing.assert_allclose(g.numpy(), p, atol=1e-6)


def test_fhe_fedavg_over_torch_state_dicts(helpers):
    """Tensors in, an OrderedDict out in the state_dict's key order;
    conv1.weight (leaf 0) encrypted, conv1.bias averaged in the clear
    (bit-equal to plain_fedavg)."""
    models = []
    for s in range(3):
        torch.manual_seed(s)
        models.append(CNNOriginalFedAvg())
    sds = [m.state_dict() for m in models]
    small = [collections.OrderedDict(
        (k, v) for k, v in sd.items() if k.startswith("conv1"))
        for sd in sds]
    got = T.fhe_fedavg(helpers(T.CKKS), small, [1 / 3] * 3,
                       T.SelectivePolicy(layer_mask={0}))
    want = T.plain_fedavg(small, [1 / 3] * 3)
    assert list(got) == ["conv1.weight", "conv1.bias"]
    for k in got:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["conv1.bias"].numpy(),
                                  want["conv1.bias"].numpy())


def test_cnn_fedavg_size_and_forward_match_jax():
    m = CNNOriginalFedAvg()
    assert sum(p.numel() for p in m.parameters()) == 1_663_370
    assert sum(p.numel() for p in CNNOriginalFedAvg(False).parameters()) == \
        sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(
            J_basic.cnn_fedavg_init(jax.random.key(0), only_digits=False)))
    params = J_basic.cnn_fedavg_init(jax.random.key(3))
    m.load_state_dict(interop.cnn_fedavg_state_dict_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    x = np.random.default_rng(4).standard_normal((2, 28, 28)).astype(
        np.float32)
    want = np.asarray(jax.jit(J_basic.cnn_fedavg_apply)(params,
                                                        jnp.asarray(x)))
    with torch.no_grad():
        got = m(torch.as_tensor(x)).numpy()
        got4 = m(torch.as_tensor(x)[:, None]).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got4, got)


def test_selective_policy_and_split_merge_match_jax():
    rng = np.random.default_rng(8)
    tree = _model(rng)
    flat, spec = T_fedavg.flatten_params(tree)
    jflat, jspec = J_fedavg.flatten_params(tree)
    for kw in (dict(), dict(rate=0.3), dict(layer_mask={1}),
               dict(layer_mask=lambda i, _: i != 1, rate=0.5)):
        e, p, plan = T_fedavg.split_by_policy(flat, spec,
                                              T.SelectivePolicy(**kw))
        je, jp, jplan = J_fedavg.split_by_policy(
            jflat, jspec, J.SelectivePolicy(**kw))
        np.testing.assert_array_equal(e, je)
        np.testing.assert_array_equal(p, jp)
        assert plan == jplan
        np.testing.assert_array_equal(T_fedavg.merge_by_policy(e, p, plan),
                                      flat)
    assert T_fedavg.FULL == T.SelectivePolicy()
