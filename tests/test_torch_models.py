"""The port's model zoo (fhe_fed_tpu_torch.models) against the JAX
package's: parameter counts, the leaf order and shapes of the flattened
trees, seeded builds, and forwards on carried-over weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fhe_fed_tpu.models import zoo as JZ
from fhe_fed_tpu.models import layers as JL
from fhe_fed_tpu.models import graph_tabular as JG
from fhe_fed_tpu_torch import interop
from fhe_fed_tpu_torch.fed.fedavg import flatten_params, tree_leaves
from fhe_fed_tpu_torch.models import zoo as TZ
from fhe_fed_tpu_torch.models import layers as TL
from fhe_fed_tpu_torch.models import graph_tabular as TG

torch.set_num_threads(1)

# tests/test_models.py's ladder, plus its canonical resnet18 and the four
# models off the figure ladder (counts of the JAX package's zoo).
EXACT = {
    "linear": 101,
    "tst": 124608,
    "lenet": 88648,
    "gcn": 23063,
    "tabnet": 8929,
    "mlp": 79510,
    "rnn_lstm": 822570,
    "cnn_fedavg": 1663370,
    "mobilenet": 3315428,
    "resnet18": 11689512,
    "resnet34": 21797672,
    "resnet50": 25557032,
    "groupvit": 55726609,
    "vit": 86389248,
    "bert": 109482240,
}
SMALL = ("linear", "mlp", "lenet", "cnn_fedavg", "rnn_lstm", "tst", "gcn",
         "tabnet", "mobilenet")
# Leaves drawn with jax.random.normal (embeddings, tst's projections and
# positions, tabnet's GLU weights). The port computes XLA's float32
# erf_inv polynomial with torch's log1p, which differs from XLA's by an ulp
# now and then: up to 3 ulp in the normal draw, up to 4 after the
# scaling's roundings. Every other leaf is bit-exact.
NORMAL_ULP = 4
# Forwards: the same f32 function in two frameworks (other summation
# orders, other exp / erf / rsqrt): a few ulp an op, over up to 12
# layers, relative to max(1, |y|).
FWD_REL = 2e-5


def _port_paths(tree, prefix=()):
    """(path, shape) of every leaf in flatten_params' order."""
    if type(tree) is dict:
        for k in sorted(tree):
            yield from _port_paths(tree[k], prefix + (k,))
    elif type(tree) in (list, tuple):
        for i, c in enumerate(tree):
            yield from _port_paths(c, prefix + (i,))
    else:
        yield prefix, tuple(tree.shape)


def _jax_paths(tree):
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
             tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _jax_model(name):
    """The JAX registry's (param shapes, state shapes) without computing a
    value, and its apply."""
    box = []

    def init(key):
        params, state, apply = JZ._REGISTRY[name][0](key)
        box.append(apply)
        return params, state
    shapes = jax.eval_shape(init, jax.random.key(0))
    return shapes, box[0]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("name,count", sorted(EXACT.items()))
def test_param_ladder_exact(name, count):
    spec = TZ.build(name, device="meta")
    assert spec.count == count
    assert spec.reference_count == JZ._REGISTRY[name][1]


@pytest.mark.parametrize("name", TZ.MODEL_NAMES)
def test_leaf_order_and_shapes_match_jax(name):
    """flatten_params(spec.params) orders and shapes the leaves as the JAX
    package's flatten of build(name).params, so the encrypted vector and a
    SelectivePolicy's leaf indices mean the same; the BatchNorm state too."""
    spec = TZ.build(name, device="meta")
    (jp, js), _ = _jax_model(name)
    assert list(_port_paths(spec.params)) == _jax_paths(jp)
    assert (spec.state is None) == (js is None)
    if js is not None:
        assert list(_port_paths(spec.state)) == _jax_paths(js)
    assert spec.count == sum(int(np.prod(s)) for _, s in _jax_paths(jp))


def test_registry_matches_jax():
    assert TZ.MODEL_NAMES == JZ.MODEL_NAMES
    assert TZ.LADDER == JZ.LADDER


@pytest.mark.parametrize("name", SMALL)
def test_seeded_build_matches_jax(name):
    """build(name, seed) draws the JAX package's parameters: uniform leaves
    bit for bit, normal ones within NORMAL_ULP; the flat vectors agree the
    same way, and the BatchNorm state is equal."""
    seed = 3
    spec = TZ.build(name, seed=seed, device="cpu")
    want = JZ.build(name, seed=seed)
    paths = [p for p, _ in _port_paths(spec.params)]
    got_l = [x.numpy() for x in tree_leaves(spec.params)]
    want_l = [np.asarray(x) for x in jax.tree_util.tree_leaves(want.params)]
    assert len(got_l) == len(want_l)
    normal = 0
    for path, g, w in zip(paths, got_l, want_l):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        ulps = _ulps(g, w)
        if ulps.any():
            assert _drawn_normal(name, path), path
            assert ulps.max() <= NORMAL_ULP, (path, ulps.max())
            normal += 1
    assert normal <= sum(_drawn_normal(name, p) for p in paths)
    flat, _ = flatten_params(spec.params)
    assert flat.size == spec.count
    if spec.state is not None:
        for g, w in zip(tree_leaves(spec.state),
                        jax.tree_util.tree_leaves(want.state)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _drawn_normal(name, path) -> bool:
    if name == "rnn_lstm":
        return path[0] == "embed"
    if name == "tst":
        return path[0] in ("value_proj", "enc_pos", "dec_pos")
    if name == "tabnet":
        return "fc" in path and "final" not in path and "att_fc" not in path
    return False


def _random_tree(shapes, rng):
    """Random weights in the JAX layout: BN variances and scales in
    [0.5, 1.5], everything else U(-1, 1) / sqrt(fan_in), so that every
    leaf (positions, class tokens, BN statistics) takes part."""
    def leaf(path, s):
        if str(getattr(path[-1], "key", "")) in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        fan = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 100
        return (rng.uniform(-1, 1, s.shape) / np.sqrt(fan)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("name", TZ.MODEL_NAMES)
def test_forward_matches_jax(name):
    """Each model's forward, its JAX-layout weights carried over by
    interop.zoo_model_from_numpy, against the JAX apply on the same numpy
    inputs (zoo.example_inputs: the JAX tests' shapes, ImageNet 224 x 224
    for the convnets and ViTs, batch 1 for ResNet-50, ViT, BERT and
    GroupViT)."""
    (ps, ss), japply = _jax_model(name)
    rng = np.random.default_rng(7)
    params = _random_tree(ps, rng)
    state = None if ss is None else _random_tree(ss, rng)
    inputs = TZ.example_inputs(name)
    jargs = ([params] if state is None else [params, state]) + [
        jnp.asarray(x) for x in inputs]
    want = [np.asarray(y) for y in
            jax.tree_util.tree_leaves(jax.jit(japply)(*jargs))]
    spec = interop.zoo_model_from_numpy(name, params, state, device="cpu")
    got = spec.forward(*[torch.as_tensor(x) for x in inputs])
    got = [y.numpy() for y in (got if isinstance(got, tuple) else (got,))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= FWD_REL * scale


@pytest.mark.parametrize("k,size", [(3, 16), (7, 32), (1, 16), (4, 15)])
def test_conv2d_same_stride2_pads_like_xla(k, size):
    """Stride 2 on an even input: XLA's SAME pads (0, 1) for 3 x 3 and
    (2, 3) for 7 x 7, where torch's symmetric padding=k//2 gives the same
    output size with every pixel shifted."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(JL.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                jnp.asarray(x), stride=2))
    p = {"w": torch.as_tensor(w), "b": torch.as_tensor(b)}
    got = TL.conv2d(p, torch.as_tensor(x), stride=2).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if k % 2 and size % 2 == 0 and k > 1:
        sym = F.conv2d(torch.as_tensor(x).permute(0, 3, 1, 2),
                       p["w"].permute(3, 2, 0, 1), p["b"], stride=2,
                       padding=k // 2).permute(0, 2, 3, 1).numpy()
        assert sym.shape == want.shape
        assert np.abs(sym - want).max() > 0.1


def test_depthwise_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 10, 10, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1, 4)).astype(np.float32)
    for stride in (1, 2):
        want = np.asarray(JL.depthwise_conv2d({"w": jnp.asarray(w)},
                                              jnp.asarray(x), stride))
        got = TL.depthwise_conv2d({"w": torch.as_tensor(w)},
                                  torch.as_tensor(x), stride).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sparsemax_and_adjacency_match_jax():
    rng = np.random.default_rng(5)
    z = rng.standard_normal((6, 10)).astype(np.float32)
    z[0, :3] = 1.5                                   # ties
    for axis in (-1, 0):
        want = np.asarray(JG.sparsemax(jnp.asarray(z), axis=axis))
        got = TG.sparsemax(torch.as_tensor(z), dim=axis).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got.sum(axis), 1.0, atol=1e-5)
    assert (got == 0).any()
    a = (rng.random((20, 20)) < 0.2).astype(np.float32)
    np.testing.assert_allclose(
        TG.normalize_adjacency(torch.as_tensor(a)).numpy(),
        np.asarray(JG.normalize_adjacency(jnp.asarray(a))), rtol=1e-6)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TZ.build("linear")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.zoo_model_from_numpy(
            "linear", {"w": np.zeros((100, 1)), "b": np.zeros(1)})
