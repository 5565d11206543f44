"""The port's thin drivers (fhe_fed_tpu_torch.benchmarks: fedavg_demo,
mkhe_bench, masking_bench, baseline_configs, scaling_virtual) and
param_sweep's threshold point on the CPU, against the JAX drivers' records.

- param_sweep --scheme ckks-threshold on the MLP (a copy of the committed
  results/trained_mlp.npz in its results directory) appends one row to
  params_threshold.jsonl, within max_err 1e-6 and acc_delta 0;
- fedavg_demo in both schemes, within its 1e-4 gate;
- mkhe_bench's rows carry the keys, in order, of the JAX driver's rows in
  results/mkhe_bench.jsonl (one per mode), at 2,000 values; its jsonl is
  rewritten, never appended;
- masking_bench's record carries the JAX driver's keys, in order, and the
  same sizes as JAX's `bench` at 170 values and 2 learners (2048-bit
  Paillier keys); its protocol files are removed after the run;
- baseline_configs' configs 1 and 3 and a thinned config 5 (in one
  process, world size 1, and in 2 gloo ranks) and scaling_virtual at 1
  and 2 ranks carry the keys, in order, of the JAX drivers' committed
  records (results/baseline_configs_tpu.jsonl,
  results/scaling_virtual.jsonl);
- microprof at a small ring prints a line for each of the JAX script's
  operations (every draw under threefry and rbg) and the launch floor,
  then its JSON record, which it also appends to microprof.jsonl;
- each ported driver's flags are the JAX driver's plus --device / --out.
"""

import ast
import json
import pathlib
import shutil

import pytest
import torch

import benchmarks.common as JBC

# The JAX driver points JAX at a persistent compile cache outside the
# checkout when it is imported; these tests keep JAX's default.
JBC.enable_compile_cache = lambda: None
from benchmarks import masking_bench as JMB  # noqa: E402

from fhe_fed_tpu.native import paillier as J_pail  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import param_sweep as PS  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import fedavg_demo as FD  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import mkhe_bench as MK  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import masking_bench as MB  # noqa: E402
from fhe_fed_tpu_torch.native import paillier as T_pail  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import baseline_configs as BC  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import scaling_virtual as SV  # noqa: E402
from fhe_fed_tpu_torch.benchmarks import microprof as MP  # noqa: E402
from fhe_fed_tpu_torch.parallel import launch  # noqa: E402

import _torch_dist_child as C  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAINED_MLP = ROOT / "results" / "trained_mlp.npz"
MAX_ERR = 1e-6


def test_param_sweep_threshold_main_writes_jsonl(tmp_path):
    shutil.copy(TRAINED_MLP, tmp_path / TRAINED_MLP.name)
    rows = PS.main(["--scheme", "ckks-threshold", "--model", "mlp",
                    "--device", "cpu", "--out", str(tmp_path)])
    assert len(rows) == 1 and rows[0]["scheme"] == "ckks-threshold"
    assert rows[0]["max_err"] <= MAX_ERR and rows[0]["acc_delta"] == 0.0
    line = (tmp_path / "params_threshold.jsonl").read_text().splitlines()
    assert len(line) == 1 and json.loads(line[0])["scale_bits"] == 52


@pytest.mark.parametrize("scheme", ["ckks", "ckks-threshold"])
def test_fedavg_demo(tmp_path, scheme):
    err = FD.main(["--scheme", scheme, "--device", "cpu",
                   "--out", str(tmp_path)])
    assert err < FD.MAX_ERR
    assert (tmp_path / f"fedavg_demo_{scheme}" / "key-public.txt").exists()


def test_mkhe_bench_rows_carry_the_jax_keys(tmp_path):
    jax_rows = {}
    for line in (ROOT / "results" / "mkhe_bench.jsonl").read_text(
            ).splitlines():
        r = json.loads(line)
        jax_rows.setdefault(r["mode"], r)
    MK.main(["2000", "2", "--device", "cpu", "--out", str(tmp_path)])
    rows = MK.main(["2000", "--device", "cpu", "--out", str(tmp_path)])
    for r in rows:
        assert list(r) == list(jax_rows[r["mode"]]), r["mode"]
        assert r["max_err"] <= MAX_ERR and r["backend"] == "cpu"
    assert rows[1]["parties"] == 3 and rows[0]["ring_dim"] == 8192
    lines = (tmp_path / "mkhe_bench.jsonl").read_text().splitlines()
    assert [json.loads(s)["mode"] for s in lines] == ["single", "threshold"]


@pytest.fixture
def jax_paillier_on_the_port_build():
    """The JAX masking wrapper loads the port's build of the same
    paillier.cpp (as tests/test_torch_masking.py does), so it never starts
    its in-place build."""
    saved = J_pail._lib
    J_pail._lib = T_pail.load_lib()
    yield
    J_pail._lib = saved


def test_masking_bench_records_match_jax_keys(tmp_path,
                                              jax_paillier_on_the_port_build):
    got = MB.bench(170, 2, out=tmp_path, device="cpu")
    want = JMB.bench(170, 2)
    assert list(got) == list(want)
    for k in ("params", "learners", "upload_bytes", "plain_bytes",
              "comm_expansion"):
        assert got[k] == want[k], k
    assert got["max_err"] <= 2 * 2.0 ** -13 and got["backend"] == "cpu"
    assert list(tmp_path.iterdir()) == []          # its files are removed


def test_masking_bench_main_thread_sweep(tmp_path):
    rows = MB.main(["--params", "85", "--learners", "2", "--thread-sweep",
                    "--device", "cpu", "--out", str(tmp_path)])
    sweep = [r for r in rows if r.get("sweep") == "threads"]
    assert len(rows) == 1 + len(sweep) and sweep[0]["threads"] == 1
    lines = (tmp_path / "masking_bench.jsonl").read_text().splitlines()
    assert len(lines) == len(rows)


def _jax_records(name: str) -> dict:
    """The JAX driver's committed records by metric (the last of each)."""
    rows = {}
    for line in (ROOT / "results" / name).read_text().splitlines():
        r = json.loads(line)
        rows[r.get("metric", "row")] = r
    return rows


def test_baseline_configs_1_and_3(tmp_path):
    rows = BC.main(["--configs", "1,3", "--device", "cpu",
                    "--out", str(tmp_path)])
    want = _jax_records("baseline_configs_tpu.jsonl")
    assert [r["metric"] for r in rows] == ["ckks_example_2client_4096slots",
                                           "fedavg_100k_8clients"]
    for r in rows:
        assert list(r) == list(want[r["metric"]]), r["metric"]
        assert r["max_err"] <= MAX_ERR and r["backend"] == "cpu"
        assert r["value"] > 0
    lines = (tmp_path / "baseline_configs_cpu.jsonl").read_text().splitlines()
    assert [json.loads(s)["metric"] for s in lines] == [r["metric"]
                                                        for r in rows]


def test_baseline_config5_world_size_1(tmp_path, monkeypatch):
    """--cpu makes a one-rank gloo group, runs config 5 thinned and says
    so in the record; the group is gone afterwards."""
    monkeypatch.setattr(BC, "POD_SHAPE_CPU", C.POD_SHAPE_SMALL)
    (row,) = BC.main(["--configs", "5", "--cpu", "--out", str(tmp_path)])
    want = _jax_records("baseline_configs_tpu.jsonl")
    assert list(row) == list(want["pod_fedavg_1M_64clients"])
    assert row["mesh"] == {"clients": 1, "chunks": 1}
    assert row["config"] == {"n_params": 20_000, "n_clients": 4}
    assert row["max_err"] <= MAX_ERR and "world size 1" in row["note"]
    assert not torch.distributed.is_initialized()


def test_baseline_config5_in_two_ranks(tmp_path):
    """Under a 2-rank group the mesh is (clients 2, chunks 1) and the
    record adds the one-rank time and the scaling efficiency."""
    rows = launch.spawn(C.baseline_config5, 2, (str(tmp_path),),
                        device="cpu")
    assert rows[0] == rows[1]
    r = rows[0]
    assert r["mesh"] == {"clients": 2, "chunks": 1} and r["n_devices"] == 2
    assert r["max_err"] <= MAX_ERR and r["t_1dev_s"] > 0
    assert r["scaling_efficiency"] > 0 and "note" not in r
    lines = (tmp_path / "baseline_configs_cpu.jsonl").read_text().splitlines()
    assert len(lines) == 1                  # rank 0 alone writes


def test_scaling_virtual_two_ranks(tmp_path, monkeypatch):
    monkeypatch.setattr(SV, "SIZES", (1, 2))
    rows = SV.main(["--chunks-per-device", "1", "--clients", "2", "--reps",
                    "1", "--device", "cpu", "--out", str(tmp_path)])
    want = _jax_records("scaling_virtual.jsonl")["row"]
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert list(r) == list(want) and r["backend"] == "cpu"
        assert r["wall_mesh_s"] > 0 and r["wall_serial_same_work_s"] > 0
    assert rows[1]["chunks"] == 2 and rows[0]["weak_scaling_efficiency_raw"] \
        == 1.0
    lines = (tmp_path / "scaling_virtual.jsonl").read_text().splitlines()
    assert len(lines) == 2


MICROPROF_LINES = [
    "launch_floor_single", "launch_floor_pipelined", "ntt (3,4,256)",
    "intt same", "encode_coeff", "sampling u, e0, e1 (threefry)",
    "sampling u, e0, e1 (rbg)", "encrypt one client (threefry)",
    "encrypt one client (rbg)", "weighted_sum 3 clients", "decrypt",
    "[sym] encode (2,4,256)", "[sym] uniform a (threefry)",
    "[sym] uniform a (rbg)", "[sym] cbd error (threefry)",
    "[sym] cbd error (rbg)", "[sym] ntt", "[sym] a*s + w",
    "[sym] full encrypt_symmetric (threefry)",
    "[sym] full encrypt_symmetric (rbg)"]


def test_microprof_prints_every_line(tmp_path, capsys, monkeypatch):
    """microprof.main on the CPU at ring 256, 3 and 2 chunks, blocks of 2
    calls: one line per op in order, each a positive time, then the JSON
    record (host clock, on the CPU), appended to microprof.jsonl."""
    for name, value in (("PARAMS", dict(batch=128, scale_bits=40,
                                         mult_depth=1, ring_dim=256)),
                        ("CHUNKS", 3), ("SYM_CHUNKS", 2), ("ITERS", 2),
                        ("REPS", 1)):
        monkeypatch.setattr(MP, name, value)
    rec = MP.main(["--device", "cpu", "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("ring_dim=256 chain=4 chunks=3 sym_chunks=2")
    timed = [ln.split(": ")[0] for ln in lines[1:-1]
             if not ln.startswith("  (")]
    assert timed == MICROPROF_LINES
    assert list(rec["microprof_ms"]) == MICROPROF_LINES
    assert all(v > 0 for v in rec["microprof_ms"].values())
    assert (rec["config"]["timer"], rec["config"]["device"]) == (
        "host_clock", "cpu")
    assert json.loads(lines[-1]) == rec
    assert json.loads((tmp_path / "microprof.jsonl").read_text()) == rec


def _flags(path: pathlib.Path) -> set[str]:
    """The option strings of every add_argument call in a driver."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and str(a.value).startswith("--")}
    return out


@pytest.mark.parametrize("driver", [
    "baseline_configs", "scaling_virtual", "model_bench", "selective_bench",
    "train_synth", "param_sweep", "attack_eval", "fedavg_demo", "mkhe_bench",
    "masking_bench", "microprof"])
def test_driver_flags_are_the_jax_drivers_and_device_out(driver):
    jax_flags = _flags(ROOT / "benchmarks" / f"{driver}.py")
    port_flags = _flags(ROOT / "fhe_fed_tpu_torch" / "benchmarks"
                        / f"{driver}.py")
    assert jax_flags <= port_flags, jax_flags - port_flags
    assert {"--device", "--out"} <= port_flags
