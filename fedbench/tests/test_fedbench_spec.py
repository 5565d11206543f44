"""BENCHMARK.json against the benchmark's contract, and every cell's
pieces found by name."""

import ast
import json
import pathlib
import re

import pytest

from fedbench import spec
from fedbench.reference import ckks as ref

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fedbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("fedbench/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"]
               + BENCH["per_layer"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell.traffic["surface"] in ("cohort", "bytes", "streamed")
    reported = {m.name for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.read)


@pytest.mark.parametrize("path", sorted((spec.HERE / "configs").glob(
    "*.json")), ids=lambda p: p.stem)
def test_config_crypto_point(path):
    """The moduli are the stated rule's (the largest 31-bit primes that are
    1 mod 2N); `reduced` is BENCHMARK.json's, where it lists the file."""
    c = json.loads(path.read_text())
    assert c["name"] == path.stem
    crypto = c["crypto"]
    n = crypto["ring_dim"]
    want, q = [], (2 ** 31 - 1) // (2 * n) * (2 * n) + 1
    while len(want) < len(crypto["moduli"]):
        if ref.is_prime(q):
            want.append(q)
        q -= 2 * n
    assert crypto["moduli"] == want
    assert crypto["chain_len"] == crypto["num_base"] + crypto["mult_depth"]
    assert c["reduced"] == []
    for entry in BENCH["configs"]:
        if entry["file"] == path.relative_to(spec.ROOT).as_posix():
            assert entry["reduced"] == c["reduced"]
    assert set(c["limits"]) >= {"format_faults", "avg_rel_err"}


def test_every_file_is_named_from_a_name():
    for path in spec.HERE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(spec.ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


FORBIDDEN = {"jax", "jaxlib", "optax", "fhe_fed_tpu", "benchmarks"}


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(spec.HERE.rglob("*.py")),
                         ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_imports(path):
    """No file imports JAX or the JAX package (top-level names compared
    whole: fhe_fed_tpu_torch begins with fhe_fed_tpu); the reference
    imports nothing of the program or of the repository's tests."""
    names = _imports(path)
    assert not names & FORBIDDEN
    if "reference" in path.relative_to(spec.HERE).parts:
        assert not names & {"fhe_fed_tpu_torch", "tests"}
