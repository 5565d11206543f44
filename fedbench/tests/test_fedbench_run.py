"""Whole runs of each cell at a size the CPU holds: two rounds of each
traffic mix's runner through the program, the control and the faults that the
comparison has to catch, and the command's refusals."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from fedbench import run, spec
from fedbench.tests.conftest import CELLS, tiny_cell


def _run(cell, sut="program", trace=False):
    return run.run_cell(cell, 2 ** 33 + 17, 0.0, trace, "cpu", sut=sut,
                        t0=time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_two_rounds_through_the_program(name):
    cell = tiny_cell(name)
    r = _run(cell)
    assert r["correct"] is True and r["failed"] == 0
    # Two rounds of one pool entry (of 2) at least, one of the first two.
    assert r["attempted"] in (3, 4)
    # All but the tail, which two rounds are too few for.
    assert set(r["metrics"]) == {m.name for m in cell.end_to_end} - {
        "round_p95_ms"}
    assert list(r)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())


def test_traced_run_reads_its_spans():
    r = _run(tiny_cell("cnn1.66m.cohort"), trace=True)
    assert r["correct"] is True
    assert {"encrypt_ms.cohort", "aggregate_ms.cohort",
            "decrypt_ms.cohort"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0
    assert r["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("sut,ok", [("reference-float32", True),
                                    ("reference-bfloat16", False)])
def test_reference_in_the_programs_place(name, sut, ok):
    """The control (the reference one precision below the stated float32)
    comes out as not correct; the reference at float32 as correct."""
    assert _run(tiny_cell(name), sut=sut)["correct"] is ok


class Faulty:
    """The program's helper with one fault planted in the timed path."""

    def __init__(self, helper, fault):
        self.h, self.fault, self.first, self.memo = helper, fault, None, {}

    def __getattr__(self, name):
        return getattr(self.h, name)

    def encrypt_cohort(self, x):
        if self.fault == "memoized":       # a ciphertext per pool entry
            return self.memo.setdefault(x.data_ptr(),
                                        self.h.encrypt_cohort(x))
        ct = self.h.encrypt_cohort(x)
        if self.fault == "stale":          # the state returned unchanged
            self.first = self.first or ct
            return self.first
        if self.fault == "altered_ct":
            ct.data[1, 0, 0, 2, 5] = (ct.data[1, 0, 0, 2, 5] + 1) % int(
                self.h.ctx.q[2])
        return ct

    def aggregate_cohort(self, ct, w):
        if self.fault == "half_batch":     # the mean over half the clients
            from fhe_fed_tpu_torch.ckks.ops import Ciphertext
            half = Ciphertext(ct.data[:2], ct.scale, ct.level)
            return self.h.aggregate_cohort(half, [x / sum(w[:2])
                                                  for x in w[:2]])
        if self.fault == "passthrough":
            from fhe_fed_tpu_torch.ckks.ops import Ciphertext
            return Ciphertext(ct.data[0], ct.scale * ct.scale, ct.level)
        return self.h.aggregate_cohort(ct, w)

    def decrypt_cohort(self, ct, dims=None, *, raw=False):
        out = self.h.decrypt_cohort(ct, dims, raw=raw)
        if self.fault == "altered_out":
            out[0, 7] += 1e-3
        return out

    def encrypt(self, v):
        if self.fault == "memoized":
            return self.memo.setdefault(id(v), self.h.encrypt(v))
        blob = self.h.encrypt(v)
        if self.fault == "altered_ct":
            blob = bytearray(blob)
            blob[-9] ^= 0x10
            blob = bytes(blob)
        return blob

    def computeWeightedAverage(self, blobs, w):
        if self.fault == "half_batch":
            return self.h.computeWeightedAverage(
                blobs[:2], [x / sum(w[:2]) for x in w[:2]])
        if self.fault == "stale":
            return self.h.computeWeightedAverage(blobs[:1], [1.0])
        return self.h.computeWeightedAverage(blobs, w)

    def decrypt(self, blob, dims):
        out = self.h.decrypt(blob, dims)
        if self.fault == "altered_out":
            out[11] += 1e-3
        return out

    def fedavg_round(self, vectors, w, *args, **kw):
        if self.fault == "half_batch":
            return self.h.fedavg_round(vectors[:2], [x / sum(w[:2])
                                                     for x in w[:2]])
        out = self.h.fedavg_round(vectors, w, *args, **kw)
        if self.fault == "stale":
            self.first = self.first if self.first is not None else out
            return self.first
        if self.fault == "altered_out":
            out[-3] += 1e-3
        return out


FAULTS = {"cnn1.66m.cohort": ("stale", "passthrough", "half_batch",
                              "altered_ct", "altered_out", "memoized",
                              "a_reused"),
          "cnn1.66m.bytes": ("stale", "half_batch", "altered_ct",
                             "altered_out", "memoized", "a_reused"),
          "bert-base.streamed": ("stale", "half_batch", "altered_out")}


def _reuse_a(monkeypatch):
    """The program's secret-key encrypt with the first `a` it drew kept
    for every later encrypt of that shape: valid ciphertexts, `a` stale."""
    from fhe_fed_tpu_torch.ckks import ops
    draw, kept = ops._sym_samples, {}

    def samples(ctx, rng, shape):
        a_hat, e = draw(ctx, rng, shape)
        return kept.setdefault(tuple(shape), a_hat), e
    monkeypatch.setattr(ops, "_sym_samples", samples)


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch):
    make = run.make_helper
    if fault == "a_reused":
        _reuse_a(monkeypatch)
    else:
        monkeypatch.setattr(run, "make_helper",
                            lambda *a, **k: Faulty(make(*a, **k), fault))
    cell = tiny_cell(name, check_rounds=3, pool=3)
    r = _run(cell)
    assert r["correct"] is False
    if fault in ("memoized", "a_reused"):
        # Each is otherwise a sound encryption: only the repeats catch it.
        assert r["checks"]["a_repeats"]["value"] > 0
        assert all(v["value"] <= v["limit"] for k, v in r["checks"].items()
                   if k != "a_repeats")


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "fedbench.run", "--workload",
                        "cnn1.66m.cohort", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=spec.ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_refuses_without_the_program(monkeypatch, capsys):
    """In a directory holding only BENCHMARK.json and fedbench/, the
    program is not importable: no result."""
    monkeypatch.setattr(run, "require_card", lambda chips: torch)
    monkeypatch.setattr(run, "PROGRAM", "fhe_fed_tpu_torch_absent")
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "cnn1.66m.cohort", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert e.value.code == 2 and capsys.readouterr().out == ""


def test_refuses_with_jax_loaded(monkeypatch, capsys):
    monkeypatch.setattr(run, "require_card", lambda chips: torch)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "cnn1.66m.cohort", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert e.value.code == 2 and capsys.readouterr().out == ""


def test_seeds_past_32_bits_and_same_seed_same_inputs():
    a, b = run.derive(2 ** 40 + 3), run.derive(2 ** 40 + 3)
    assert a == b and a != run.derive(2 ** 40 + 4)
    cell = tiny_cell("cnn1.66m.cohort")
    from fedbench import rounds
    p1 = rounds.make_pool(cell.config, cell.traffic, a.pool, "cpu")
    p2 = rounds.make_pool(cell.config, cell.traffic, a.pool, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(p1, p2))


@pytest.mark.cuda
def test_a_cell_on_the_card(card, tmp_path):
    """One short run of the cohort cell through the command."""
    p = subprocess.run([sys.executable, "-m", "fedbench.run", "--workload",
                        "cnn1.66m.cohort", "--seed", str(2 ** 31 + 5),
                        "--seconds", "2", "--trace", "0"], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_the_control_on_the_card(card):
    cell = tiny_cell("cnn1.66m.cohort", parameters=200_000)
    r = run.run_cell(cell, 7, 0.0, False, card, sut="reference-bfloat16",
                     t0=time.perf_counter(), log=lambda m: None)
    assert r["correct"] is False


@pytest.mark.parametrize("name", ["cnn1.66m.cohort", "cnn1.66m.bytes",
                                  "bert-base.streamed"])
def test_packing_by_the_batch(name):
    """Without dense packing a chunk holds `batch` values: the layout and
    the reference follow the configuration."""
    cell = tiny_cell(name, parameters=9000)
    cell.config["crypto"]["dense_pack"] = False
    r = _run(cell)
    assert r["correct"] is True
    assert _run(cell, sut="reference-bfloat16")["correct"] is False
