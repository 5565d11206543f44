"""Shared benchmark plumbing: phase timing, results files, fake client
vectors (the counterpart of benchmarks/common.py; reference
benchmark.py:474-532 timing taxonomy: Init / Encryption / Secure Agg /
Decryption)."""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import time

import numpy as np
import torch

DEFAULT_RESULTS = (pathlib.Path(__file__).resolve().parents[2] / "build"
                   / "results_torch")


class PhaseTimer:
    """Wall-clock seconds per named phase. On a CUDA device each phase
    synchronises the device as it starts and as it ends, so a phase times
    the device work it enqueued and nothing enqueued before it."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.phases: dict[str, float] = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.phases[name] = (self.phases.get(name, 0.0)
                             + time.perf_counter() - t0)

    @property
    def total(self) -> float:
        return sum(self.phases.values())


def backend(device: torch.device | str) -> str:
    """What a record ran on: the card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit` prints them, or the device
    type ("cpu")."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def results_dir(out: str | os.PathLike | None = None) -> pathlib.Path:
    d = pathlib.Path(out) if out is not None else DEFAULT_RESULTS
    d.mkdir(parents=True, exist_ok=True)
    return d


def append_jsonl(name: str, record: dict, out=None) -> pathlib.Path:
    path = results_dir(out) / name
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
    return path


def rewrite_jsonl(name: str, records: list[dict], out=None) -> pathlib.Path:
    """Replace a results file with exactly `records` (measured rows only,
    no warm-up rows)."""
    path = results_dir(out) / name
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return path


def fake_client_params(n_params: int, n_clients: int, seed: int = 0
                       ) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n_params).astype(np.float32) * 0.1
            for _ in range(n_clients)]
