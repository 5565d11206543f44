"""Finds a cell's pieces by name from BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration, whose file
`configs` gives, and a traffic mix, read from traffic/<traffic>.json. A
metric named M is read by metrics/M.py, which defines `read(reading)`
returning a number, or None where it finds nothing to read. Adding a cell
or a metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    read: object


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple      # Metric, the cell's
    per_layer: tuple


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_file(path: pathlib.Path):
    """The module in `path`, loaded by its path (its name may hold dots)."""
    path = pathlib.Path(path)
    rel = path.relative_to(HERE).with_suffix("")
    spec = importlib.util.spec_from_file_location(
        "fedbench." + ".".join(rel.parts).replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    """metrics/<name>.py's `read`."""
    return load_file(HERE / "metrics" / f"{name}.py").read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None,
         root: pathlib.Path = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in names]

    def metric(m):
        return Metric(m["name"], m["unit"], load_reader(m["name"]))

    return Cell(name, int(w["chips"]), config, traffic,
                tuple(metric(m) for m in e2e),
                tuple(metric(m) for m in layer))
