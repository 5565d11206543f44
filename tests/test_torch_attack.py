"""The port's attack suite (fhe_fed_tpu_torch.attack) against
fhe_fed_tpu.attack on the CPU, on the tiny MLP of tests/test_attack.py
and attack_eval's _small_net: the shared gradients, the attack's initial
dummies and objective, its first and first five steps, the sensitivity,
the masks and the similarity metrics; then tests/test_attack.py's outcomes
on the port.

Tolerances: gradients and sensitivities are float32 sums in another order
than XLA's, so they are held within rtol 1e-5 / atol 1e-7 (a few f32 ulp
of the largest element); the dummies within 4 ulp (threefry.normal: torch's
log1p under XLA's erf_inv polynomial); the DLG objective and its gradient
within rel 1e-4 (a sum of squared gradient differences); masks and the
numpy similarity metrics bit for bit.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import benchmarks.common as JBC

# The JAX driver points JAX at a persistent compile cache outside the
# checkout when it is imported; these tests keep JAX's default.
JBC.enable_compile_cache = lambda: None
from benchmarks import attack_eval as JAE  # noqa: E402

from fhe_fed_tpu import attack as JA  # noqa: E402
from fhe_fed_tpu.models import layers as JL  # noqa: E402
from fhe_fed_tpu_torch import attack as TA, interop  # noqa: E402
from fhe_fed_tpu_torch.attack import dlg as TD  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import attack_eval as TAE  # noqa: E402
from fhe_fed_tpu_torch.fed.fedavg import tree_leaves  # noqa: E402
from fhe_fed_tpu_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(1)

D_IN, D_HID, N_CLS = 24, 12, 5
RTOL, ATOL = 1e-5, 1e-7
OBJ_REL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tapply(p, x):
    return TL.dense(p["fc2"], torch.relu(TL.dense(p["fc1"], x)))


def _japply(p, x):
    return JL.dense(p["fc2"], jax.nn.relu(JL.dense(p["fc1"], x)))


@pytest.fixture(scope="module")
def mlp():
    """tests/test_attack.py's target in both packages: (jax (params, apply,
    x, onehot), port (params, apply, x, onehot), x as numpy)."""
    k1, k2 = jax.random.split(jax.random.key(0))
    jp = {"fc1": JL.dense_init(k1, D_IN, D_HID),
          "fc2": JL.dense_init(k2, D_HID, N_CLS)}
    x = np.random.default_rng(0).random((1, D_IN), dtype=np.float32)
    jo = jax.nn.one_hot(jnp.asarray([2]), N_CLS)
    tp = interop.params_from_numpy(_np(jp), "cpu")
    return ((jp, jax.jit(_japply), jnp.asarray(x), jo),
            (tp, _tapply, torch.as_tensor(x), torch.as_tensor(np.array(jo))),
            x)


@pytest.fixture(scope="module")
def small_net():
    """attack_eval's --small target in both packages, each built from its
    own threefry / jax.random keys."""
    jp, japply = JAE._small_net()
    tp, tapply = TAE._small_net(device="cpu")
    x = np.random.default_rng(0).random((1, 16, 16, 1), dtype=np.float32)
    jo = jax.nn.one_hot(jnp.asarray([3]), 10)
    return ((jp, jax.jit(japply), jnp.asarray(x), jo),
            (tp, tapply, torch.as_tensor(x), torch.as_tensor(np.array(jo))),
            x)


def _close(got: list, want: list, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(w).max()))


def test_small_net_params_equal_jax(small_net):
    (jp, _, _, _), (tp, _, _, _), _ = small_net
    for t, j in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("target", ["mlp", "small_net"])
@pytest.mark.parametrize("protected", [(), (0, 1)])
def test_model_gradients_match_jax(request, target, protected):
    (jp, japply, jx, jo), (tp, tapply, tx, to), _ = \
        request.getfixturevalue(target)
    got = TA.model_gradients(tapply, tp, tx, to, protected_layers=protected)
    want = JA.model_gradients(japply, jp, jx, jo, protected_layers=protected)
    _close(got, want)
    for i in protected:
        assert not got[i].any()


def test_initial_dummies_within_4_ulp():
    shape, n_cls = (2, 16, 16, 1), 10
    for seed in (0, 1, 7):
        data, label = TD.initial_dummies(seed, shape, n_cls, "cpu")
        k1, k2 = jax.random.split(jax.random.key(seed))
        for got, want in ((data, jax.random.normal(k1, shape, jnp.float32)),
                          (label, jax.random.normal(k2, (2, n_cls),
                                                    jnp.float32))):
            want = np.asarray(want)
            ulp = np.spacing(np.abs(want).astype(np.float32))
            assert np.all(np.abs(got.numpy() - want) <= 4 * ulp)


def _jax_objective(japply, jp, target, protected=(), keep=None):
    """The JAX attack's match loss, built from attack.model_gradients."""
    def loss(d):
        onehot = jax.nn.softmax(d["label"], axis=-1)
        leaves = JA.model_gradients(japply, jp, d["data"], onehot, protected)
        if keep is not None:
            leaves = JA.dlg._apply_element_mask(leaves, keep)
        return sum(jnp.sum((gx - gy) ** 2) for gx, gy in zip(leaves, target))
    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("target", ["mlp", "small_net"])
@pytest.mark.parametrize("protected", [(), (0, 1)])
def test_match_objective_and_gradient_match_jax(request, target, protected):
    (jp, japply, jx, jo), (tp, tapply, tx, to), x = \
        request.getfixturevalue(target)
    n_cls = jo.shape[1]
    jt = JA.model_gradients(japply, jp, jx, jo, protected)
    data, label = TD.initial_dummies(1, x.shape, n_cls, "cpu")
    data.requires_grad_(True)
    label.requires_grad_(True)
    obj = TD.match_objective(tapply, tp, [np.array(g) for g in jt],
                             protected)
    loss = obj(data, label)
    gd, gl = torch.autograd.grad(loss, [data, label])
    # the JAX objective at the port's dummies (equal within 4 ulp anyway)
    jl, jg = _jax_objective(japply, jp, jt, protected)(
        {"data": jnp.asarray(data.detach().numpy()),
         "label": jnp.asarray(label.detach().numpy())})
    assert float(loss.detach()) == pytest.approx(float(jl), rel=OBJ_REL)
    for g, w in ((gd, jg["data"]), (gl, jg["label"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=OBJ_REL,
                                   atol=OBJ_REL * np.abs(w).max())


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_first_loss_matches_jax(mlp, optimizer):
    (jp, japply, jx, jo), (tp, tapply, tx, to), x = mlp
    grads = TA.model_gradients(tapply, tp, tx, to)
    got = TA.dlg_attack(tapply, tp, grads, x.shape, N_CLS, steps=1, seed=1,
                        optimizer=optimizer)
    want = JA.dlg_attack(_japply, jp, JA.model_gradients(japply, jp, jx, jo),
                         x.shape, N_CLS, steps=1, seed=1,
                         optimizer=optimizer)
    assert got.losses.shape == (1,) and len(got.history) == 1
    assert got.losses[0] == pytest.approx(want.losses[0], rel=OBJ_REL)


def test_five_adam_steps_match_jax(mlp):
    """Adam's update is the same function in both packages (bias-corrected
    moments, eps 1e-8); five steps from the same dummies agree to the
    objective's tolerance."""
    (jp, japply, jx, jo), (tp, tapply, tx, to), x = mlp
    grads = TA.model_gradients(tapply, tp, tx, to)
    got = TA.dlg_attack(tapply, tp, grads, x.shape, N_CLS, steps=5, lr=0.05,
                        seed=1, record_every=1)
    want = JA.dlg_attack(_japply, jp, JA.model_gradients(japply, jp, jx, jo),
                         x.shape, N_CLS, steps=5, lr=0.05, seed=1,
                         record_every=1)
    np.testing.assert_allclose(got.losses, want.losses, rtol=OBJ_REL)
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g, w, rtol=OBJ_REL, atol=OBJ_REL)
    np.testing.assert_allclose(got.label, want.label, rtol=OBJ_REL,
                               atol=OBJ_REL)


@pytest.mark.parametrize("target", ["mlp", "small_net"])
def test_gradient_sensitivity_matches_jax(request, target):
    (jp, japply, jx, jo), (tp, tapply, tx, to), _ = \
        request.getfixturevalue(target)
    got = TA.gradient_sensitivity(tapply, tp, tx, to)
    want = np.asarray(JA.gradient_sensitivity(japply, jp, jx, jo))
    _close([got], [want])


@pytest.mark.parametrize("fraction", [0.0, 0.001, 0.05, 0.4, 0.9, 1.0])
def test_top_k_mask_equals_jax(mlp, fraction):
    """One numpy sensitivity array (the MLP's, with its exact-zero ties,
    and a copy with more ties) -> bit-equal masks."""
    (jp, japply, jx, jo), _, _ = mlp
    sens = np.asarray(JA.gradient_sensitivity(japply, jp, jx, jo))
    assert (sens == 0).sum() > 10                  # ReLU ties
    tied = np.round(sens, 2)
    for s in (sens, tied):
        got = TA.top_k_mask(s, fraction)
        want = np.asarray(JA.top_k_mask(jnp.asarray(s), fraction))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)


def test_mask_gradients_matches_jax(mlp):
    (jp, japply, jx, jo), (tp, tapply, tx, to), _ = mlp
    n = sum(v.numel() for v in tree_leaves(tp))
    mask = (np.random.default_rng(3).random(n) < 0.3).astype(np.float32)
    got = TA.mask_gradients(TA.model_gradients(tapply, tp, tx, to), mask)
    want = JA.mask_gradients(JA.model_gradients(japply, jp, jx, jo),
                             jnp.asarray(mask))
    _close(got, want)
    flat = torch.cat([g.reshape(-1) for g in got]).numpy()
    assert not flat[mask == 1].any()


def test_similarity_metrics_equal_jax():
    rng = np.random.default_rng(5)
    pairs = [(rng.random((32, 32)), rng.random((32, 32))),
             (rng.random((32, 32, 3)), rng.random((32, 32, 3))),
             (rng.random((96, 96)), rng.random((96, 96)))]
    a = rng.random((16, 16))
    pairs.append((a, a + rng.normal(0, 0.1, a.shape)))
    for a, b in pairs:
        for name in ("mssim", "msssim", "uqi", "vifp"):
            got, want = getattr(TA, name)(a, b), getattr(JA, name)(a, b)
            assert type(got) is float and got == want, name


# --- tests/test_attack.py's outcomes on the port ---------------------------

def _corr(res, x):
    return np.corrcoef(res.data.reshape(-1), x.reshape(-1))[0, 1]


def test_dlg_recovers_unprotected(mlp):
    _, (tp, tapply, tx, to), x = mlp
    grads = TA.model_gradients(tapply, tp, tx, to)
    res = TA.dlg_attack(tapply, tp, grads, x.shape, N_CLS, steps=600,
                        lr=0.05, seed=1)
    assert int(np.argmax(res.label)) == 2
    assert _corr(res, x) > 0.9
    assert res.losses[-1] < res.losses[0] * 1e-3


def test_dlg_lbfgs_recovers(mlp):
    _, (tp, tapply, tx, to), x = mlp
    grads = TA.model_gradients(tapply, tp, tx, to)
    res = TA.dlg_attack(tapply, tp, grads, x.shape, N_CLS, steps=150, seed=1,
                        optimizer="lbfgs")
    assert int(np.argmax(res.label)) == 2
    assert _corr(res, x) > 0.99


def test_dlg_fails_when_protected(mlp):
    _, (tp, tapply, tx, to), x = mlp
    protected = (0, 1)   # fc1 w + b, the input-adjacent layer
    grads = TA.model_gradients(tapply, tp, tx, to,
                               protected_layers=protected)
    res = TA.dlg_attack(tapply, tp, grads, x.shape, N_CLS,
                        protected_layers=protected, steps=600, lr=0.05,
                        seed=1)
    assert abs(_corr(res, x)) < 0.5


def test_dlg_element_mask(mlp):
    _, (tp, tapply, tx, to), x = mlp
    n = sum(v.numel() for v in tree_leaves(tp))
    sens = TA.gradient_sensitivity(tapply, tp, tx, to)
    mask = TA.top_k_mask(sens, 1.0)                # protect everything
    grads = TA.mask_gradients(TA.model_gradients(tapply, tp, tx, to), mask)
    assert all(float(g.abs().max()) == 0.0 for g in grads)
    res = TA.dlg_attack(tapply, tp, grads, x.shape, N_CLS, element_mask=mask,
                        steps=100, lr=0.05, seed=1)
    assert abs(_corr(res, x)) < 0.5            # nothing to match -> no leak
    res2 = TA.dlg_attack(tapply, tp, TA.model_gradients(tapply, tp, tx, to),
                         x.shape, N_CLS, element_mask=torch.zeros(n),
                         steps=600, lr=0.05, seed=1)
    assert _corr(res2, x) > 0.9


def test_dlg_refuses_an_unknown_optimizer(mlp):
    _, (tp, tapply, tx, to), x = mlp
    with pytest.raises(ValueError):
        TA.dlg_attack(tapply, tp, [], x.shape, N_CLS, optimizer="sgd")


def test_full_f32_restores_the_callers_settings():
    """TF32 off and cuDNN deterministic inside; the caller's switches back
    after, and the generic matmul precision still readable after a caller
    that mixed the generic and the per-backend setters."""
    from fhe_fed_tpu_torch.utils.precision import full_f32
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32, cudnn.deterministic)
    try:
        torch.set_float32_matmul_precision("highest")
        mm.allow_tf32 = True
        cudnn.allow_tf32 = True
        cudnn.deterministic = False
        with full_f32():
            assert not mm.allow_tf32 and not cudnn.allow_tf32
            assert cudnn.deterministic
        assert mm.allow_tf32 and cudnn.allow_tf32
        assert not cudnn.deterministic
        mm.allow_tf32 = False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision("highest")
        mm.allow_tf32, cudnn.allow_tf32, cudnn.deterministic = saved


@pytest.mark.parametrize("topk", [False, True])
def test_attack_eval_main_small(tmp_path, topk):
    """The driver end to end on the CPU at a few steps: one row per
    protection set with the JAX driver's keys (plus the run's optimizer,
    steps, seconds and backend), written to --out."""
    argv = ["--small", "--steps", "3", "--device", "cpu",
            "--out", str(tmp_path)]
    rows = TAE.main(argv + (["--topk", "--restarts", "2"] if topk else []))
    names = [r["protection"] for r in rows]
    if topk:
        assert names == [f"topk_{k}" for k in TAE.TOPK_FRACTIONS]
    else:
        assert names == ["none", "protect_layer0", "protect_layer1",
                         "protect_all"]
    jax_keys = {"protection", "mssim", "uqi", "vifp", "corr", "final_loss"}
    if topk:
        jax_keys |= {"restarts", "selected_by"}
    for r in rows:
        assert set(r) == jax_keys | {"optimizer", "steps", "seconds",
                                     "backend"}
        assert r["backend"] == "cpu" and np.isfinite(r["corr"])
    lines = (tmp_path / "attack_eval.jsonl").read_text().splitlines()
    assert len(lines) == len(rows)
