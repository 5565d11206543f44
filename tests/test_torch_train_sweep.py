"""The port's training and sweep drivers (fhe_fed_tpu_torch.benchmarks:
train_synth, param_sweep) against the JAX package's on the CPU.

- train_synth: 5 Adam steps from the zoo's seed-0 MLP against optax's on
  the same batches, within 1e-5 relative + 1e-6 absolute per leaf (Adam's
  step is lr x m / sqrt(v): float32 gradient sums in another order move it
  by a few ulp of lr); `evaluate` of the committed results/trained_mlp.npz
  gives the JAX driver's accuracy exactly.
- param_sweep.run_config("mlp") at (4096, 20) and (4096, 52) on the same
  key files (the port writes them, the JAX driver loads them): equal
  communication and plain accuracy, FHE accuracy within 2 / n_eval, and
  max_err <= 1e-6 at 52 bits in both. The port reads a copy of the
  committed trained_mlp.npz in its results directory; the JAX driver reads
  the committed file itself and, since it exists, writes nothing.

The thin drivers (fedavg_demo, mkhe_bench, masking_bench) and param_sweep's
threshold point are tests/test_torch_drivers.py's.
"""

import functools
import pathlib
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import benchmarks.common as JBC

# The JAX drivers point JAX at a persistent compile cache outside the
# checkout when they are imported; these tests keep JAX's default.
JBC.enable_compile_cache = lambda: None
from benchmarks import train_synth as JTS  # noqa: E402
from benchmarks import param_sweep as JPS  # noqa: E402

from fhe_fed_tpu import models as JM, flatten_params as j_flatten  # noqa: E402
from fhe_fed_tpu import unflatten_params as j_unflatten  # noqa: E402
from fhe_fed_tpu.data import make_synth_images as j_synth  # noqa: E402
from fhe_fed_tpu_torch import models  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import train_synth as TS  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import param_sweep as PS  # noqa: E402
from fhe_fed_tpu_torch.fed.fedavg import tree_leaves  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAINED_MLP = ROOT / "results" / "trained_mlp.npz"
MAX_ERR = 1e-6
N_EVAL = 4096
SWEEP_SEED = 7           # the helpers of test_run_config_matches_jax


def test_five_adam_steps_match_optax():
    _, jparams, jacc = JTS.trained_model("mlp", steps=5, cache=False)
    spec, tparams, tacc = TS.trained_model("mlp", steps=5, cache=False,
                                           device="cpu")
    start = tree_leaves(spec.params)
    for t, j, s in zip(tree_leaves(tparams),
                       jax.tree_util.tree_leaves(jparams), start):
        j = np.asarray(j)
        assert not np.array_equal(j, s.numpy())      # the steps moved it
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6)
    assert abs(tacc - jacc) <= 2 / TS.TEST_N


def test_train_batches_follow_the_jax_order():
    """Step s trains on batch s mod 32 of the 8192 images, as the JAX
    driver (benchmarks/train_synth.py:63-68): 33 steps with a learning
    rate of 0 change nothing, and the images are the JAX package's."""
    x, y = TS.make_synth_images(TS.TRAIN_N, seed=7)
    jx, jy = j_synth(TS.TRAIN_N, seed=7)
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    spec = models.build("mlp", device="cpu")
    out = TS.train(spec.apply, spec.params, x, y, steps=33, lr=0.0)
    for a, b in zip(tree_leaves(out), tree_leaves(spec.params)):
        assert torch.equal(a, b)


def test_evaluate_committed_mlp_equals_jax():
    with np.load(TRAINED_MLP) as z:
        flat = z["flat"]
    x, y = TS.make_synth_images(TS.TEST_N, seed=99)
    spec = models.build("mlp", device="cpu")
    got = TS.evaluate(spec.apply, TS.params_from_flat(spec.params, flat,
                                                      "cpu"), x, y)
    jspec = JM.build("mlp")
    _, tree = j_flatten(jspec.params)
    want = JTS.evaluate(jspec.apply, j_unflatten(flat.astype(np.float32),
                                                 tree), x, y)
    assert got == want and got > 0.8


def test_trained_model_caches_in_out(tmp_path):
    """trained_model writes the JAX driver's flat .npz into its results
    directory and reads it back."""
    spec, params, acc = TS.trained_model("mlp", steps=2, out=tmp_path,
                                         device="cpu")
    path = tmp_path / "trained_mlp.npz"
    with np.load(path) as z:
        assert list(z) == ["flat"]
        flat = z["flat"]
    assert flat.dtype == np.float32 and flat.size == spec.count
    _, again, acc2 = TS.trained_model("mlp", out=tmp_path, device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(again)):
        assert torch.equal(a, b)
    assert acc == acc2


def test_client_vectors_match_jax_draws():
    """The clients are the JAX driver's: default_rng(0) normal x 0.02 per
    leaf in tree order, client by client (param_sweep.py:48-55)."""
    spec = models.build("mlp", device="cpu")
    got = PS.client_vectors(spec.params)
    jspec = JM.build("mlp")
    rng = np.random.default_rng(0)
    for c in got:
        jc = jax.tree_util.tree_map(
            lambda x: x + jnp.asarray(rng.standard_normal(x.shape).astype(
                np.float32)) * 0.02, jspec.params)
        assert np.array_equal(c, np.asarray(j_flatten(jc)[0]))


@pytest.fixture(scope="module")
def sweep_out(tmp_path_factory):
    """The port's results directory, holding a copy of the committed
    trained MLP."""
    out = tmp_path_factory.mktemp("sweep")
    shutil.copy(TRAINED_MLP, out / TRAINED_MLP.name)
    return out


@pytest.mark.parametrize("bits", [20, 52])
def test_run_config_matches_jax(sweep_out, bits, monkeypatch):
    # One seed for both helpers, and the keys written before either round,
    # so both load them and encrypt from the same key stream: acc_fhe then
    # compares equal ciphertexts. Unseeded, the packages draw independent
    # noise, which at 20 bits flips a few argmaxes either way.
    for mod in (PS, JPS):
        monkeypatch.setattr(mod, "CKKS", functools.partial(mod.CKKS,
                                                           seed=SWEEP_SEED))
    wd = sweep_out / f"keys_4096_{bits}"
    PS.CKKS("ckks", 4096, bits, cryptodir=str(wd),
            device="cpu").genCryptoContextAndKeyGen()
    got = PS.run_config(4096, bits, "mlp", wd, out=sweep_out, device="cpu")
    mtime = TRAINED_MLP.stat().st_mtime_ns
    want = JPS.run_config(4096, bits, "mlp", str(wd))
    assert TRAINED_MLP.stat().st_mtime_ns == mtime
    assert set(want) <= set(got)
    assert got["communication"] == want["communication"]
    assert got["acc_plain"] == want["acc_plain"]
    assert abs(got["acc_fhe"] - want["acc_fhe"]) <= 2 / N_EVAL
    assert set(got["phases"]) == set(want["phases"])
    assert got["chunks"] == 20 and got["backend"] == "cpu"
    assert got["peak_mem_bytes"] is None
    if bits == 52:
        assert got["max_err"] <= MAX_ERR and want["max_err"] <= MAX_ERR
        assert got["acc_delta"] == 0.0
