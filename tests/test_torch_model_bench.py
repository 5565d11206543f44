"""The port's benchmark drivers (fhe_fed_tpu_torch.benchmarks) on the CPU:
model_bench's records against the JAX driver's for the same arguments,
its main() and the threshold scheme, and selective_bench."""

import json
import math

import numpy as np
import pytest
import torch

import benchmarks.common as JBC

# The JAX driver points JAX at a persistent compile cache outside the
# checkout when it is imported; these tests keep JAX's default.
JBC.enable_compile_cache = lambda: None
from benchmarks import model_bench as JMB  # noqa: E402

from fhe_fed_tpu import CKKS as JCKKS  # noqa: E402
from fhe_fed_tpu_torch import CKKS  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import common, model_bench as MB  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import selective_bench as SB  # noqa: E402
from fhe_fed_tpu_torch.fed.fedavg import tree_leaves  # noqa: E402
from fhe_fed_tpu_torch.models import zoo  # noqa: E402

torch.set_num_threads(1)

MAX_ERR = 1e-6
SIZES = ("params", "clients", "ct_bytes", "plain_bytes", "comm_expansion",
         "path", "scheme", "encrypt_op", "reps")


@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    """A port helper and a JAX helper on the same crypto point (batch
    4096, 2^52, secret key) and the same key files (the port writes them,
    the JAX package reads them)."""
    d = str(tmp_path_factory.mktemp("keys"))
    h = CKKS("ckks", 4096, 52, cryptodir=d, symmetric=True, seed=1,
             device="cpu")
    h.genCryptoContextAndKeyGen()
    j = JCKKS("ckks", 4096, 52, cryptodir=d, symmetric=True)
    j.loadCryptoParams()
    return h, j


# mlp: 79,510 values in 20 chunks, its vector from a two-layer tree;
# max_chunks 8 streams it in three slices. (cnn_fedavg's 407 chunks take
# 137 s on the cohort path in the port's plain CPU versions on one thread,
# `OMP_NUM_THREADS=1 python -m fhe_fed_tpu_torch.benchmarks.model_bench
# --models cnn_fedavg --device cpu`; the card test and chip_smoke.py's zoo
# path run it.)
CASES = [("mlp", dict()), ("mlp", dict(use_fused=True)),
         ("mlp", dict(use_bytes=True)), ("mlp", dict(max_chunks=8))]


@pytest.mark.parametrize("name,kw", CASES)
def test_bench_model_record_matches_jax(helpers, name, kw):
    h, j = helpers
    got = MB.bench_model(name, 3, h, **kw)
    want = JMB.bench_model(name, 3, j, **kw)
    assert {k: got[k] for k in SIZES} == {k: want[k] for k in SIZES}
    assert got["max_err"] <= MAX_ERR and want["max_err"] <= MAX_ERR
    assert got["backend"] == "cpu"
    assert set(got["phases"]) == set(want["phases"])
    assert got["total"] == pytest.approx(sum(
        v for k, v in got["phases"].items() if k != "fetch"))


def test_run_model_returns_the_average(helpers):
    h, _ = helpers
    rec, spec, avg, want = MB.run_model("linear", 3, h, seed=2)
    assert spec.count == rec["params"] == avg.size == want.size == 101
    assert np.abs(avg - want).max() == rec["max_err"] <= MAX_ERR
    flat = np.concatenate([x.numpy().ravel() for x in
                           tree_leaves(spec.params)])
    assert np.abs(want - flat).max() < 0.1      # clients = flat + noise


def test_main_writes_results(tmp_path):
    seen = []
    recs = MB.main(["--models", "linear", "gcn", "--device", "cpu",
                    "--warmup", "--max-chunks", "4", "--out",
                    str(tmp_path)],
                   on_model=lambda r, s, a, w: seen.append((r, s.name)))
    assert [r["model"] for r in recs] == ["linear", "gcn"]
    assert [name for _, name in seen] == ["linear", "gcn"]
    assert all(r["max_err"] <= MAX_ERR for r in recs)
    assert all(r["init"] > 0 for r in recs)
    rows = [json.loads(x) for x in
            (tmp_path / "model_bench.jsonl").read_text().splitlines()]
    assert [r["model"] for r in rows] == ["linear", "gcn"]
    txt = (tmp_path / "model_results.txt").read_text()
    assert "Model #1 (gcn, 23063 params)" in txt
    assert (tmp_path / "bench_keys" / "cryptocontext.txt").exists()


def test_main_threshold_fused(tmp_path):
    recs = MB.main(["--models", "linear", "--scheme", "ckks-threshold",
                    "--fused", "--device", "cpu", "--out", str(tmp_path)])
    (r,) = recs
    assert r["scheme"] == "ckks-threshold"
    assert r["encrypt_op"] == "threshold_round_fused"
    assert r["max_err"] <= MAX_ERR
    assert (tmp_path / "model_results_threshold_fused.txt").exists()
    with pytest.raises(SystemExit):
        MB.main(["--fused", "--bytes", "--device", "cpu",
                 "--out", str(tmp_path)])


def test_selective_bench_one_rate(tmp_path):
    """cnn_fedavg at rate 0.02: the first 2% of every leaf encrypted
    (9 chunks), the rest averaged in the clear, merged within 1e-6."""
    rate = 0.02
    out = SB.main(["--models", "cnn_fedavg", "--rates", str(rate),
                   "--reps", "1", "--device", "cpu", "--out",
                   str(tmp_path)])
    (r,) = out
    sizes = [x.numel() for x in
             tree_leaves(zoo.build("cnn_fedavg", device="meta").params)]
    enc = sum(math.ceil(rate * s) for s in sizes)
    assert r["enc_params"] == enc
    assert r["plain_bytes"] == 4 * (sum(sizes) - enc)
    assert r["chunks"] == -(-enc // 4096)
    assert r["ct_bytes"] == r["chunks"] * 2 * 4 * 8192 * 4 + 64
    assert r["max_err"] <= MAX_ERR and r["backend"] == "cpu"
    rows = (tmp_path / "selective.jsonl").read_text().splitlines()
    assert [json.loads(x)["rate"] for x in rows] == [rate]


def test_phase_timer_and_results_dir(tmp_path):
    t = common.PhaseTimer("cpu")
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    assert set(t.phases) == {"a"} and t.total >= 0
    common.append_jsonl("x.jsonl", {"k": 1}, tmp_path / "sub")
    common.rewrite_jsonl("y.jsonl", [{"k": 2}, {"k": 3}], tmp_path / "sub")
    assert (tmp_path / "sub" / "x.jsonl").read_text() == '{"k": 1}\n'
    assert len((tmp_path / "sub" / "y.jsonl").read_text().split()) == 4
    assert common.DEFAULT_RESULTS.parts[-2:] == ("build", "results_torch")
    a = common.fake_client_params(10, 2, seed=4)
    np.testing.assert_array_equal(a[1], JBC.fake_client_params(10, 2, 4)[1])
