"""Run one cell of the benchmark once, on the card:

    python3 -m fedbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Set-up makes the key pair and the inputs
from the seed (the reference's keygen, written in the format the
program's `loadCryptoParams` reads), builds the program's `CKKS` helper,
warms up the cell's rounds, and then runs rounds closed loop until the
first completion after --seconds. With --trace 1 the window also times
each call into the program, and a fixed number of rounds after it runs
under torch.profiler. Once the window has closed and the peak memory is
read, the program's helper is freed and a sample of the window's rounds,
drawn from the seed, is held against the reference (reference/check.py).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each number compared beside its limit; the same numbers
are the last lines of standard error. Without a CUDA card, without the
program in the checkout, or with JAX loaded once the window has closed,
it exits with 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

from fedbench import spec  # noqa: E402

PROGRAM = "fhe_fed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fhe_fed_tpu", "benchmarks")
CACHE = spec.ROOT / "build" / "fedbench_cache"
SUTS = ("program", "reference-float32", "reference-bfloat16")


class Refused(SystemExit):
    """Exit 2, no result."""

    def __init__(self, why: str):
        print(f"fedbench: {why}", file=sys.stderr, flush=True)
        super().__init__(2)


@dataclasses.dataclass
class Reading:
    """What the metric readers read."""
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    rounds: int
    latencies_ms: list
    spans: dict
    trace: object = None


@dataclasses.dataclass(frozen=True)
class Seeds:
    pool: int
    keys: int
    helper: int
    sample: int


def derive(seed: int) -> Seeds:
    """Independent sub-seeds of --seed (any whole number)."""
    words = np.random.SeedSequence(int(seed)).generate_state(4, np.uint32)
    return Seeds(*(int(w) for w in words))


class Reservoir:
    """A uniform sample of at most `k` of the items offered, drawn from
    `seed` (holds references, copies nothing)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def set_caches() -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def stages(marks: list, t0: float) -> str:
    """'imports 3.1 s, keys 0.2 s, ...': each set-up stage's seconds."""
    out, last = [], t0
    for name, t in marks:
        out.append(f"{name} {t - last:.3f} s")
        last = t
    return ", ".join(out)


def keep_freed_memory() -> None:
    """glibc: serve large blocks from the heap and keep freed memory
    there, so that the rounds' host buffers (tens of MB each, ~1 GB a
    round in the bytes cell) are reused and not mapped and faulted in
    afresh each time, whose cost drifts with the host's memory state."""
    import ctypes
    import platform
    if platform.libc_ver()[0] != "glibc":
        return
    libc = ctypes.CDLL(None)
    m_trim_threshold, m_top_pad, m_mmap_max = -1, -2, -4
    for opt, value in ((m_mmap_max, 0), (m_trim_threshold, 2 ** 31 - 1),
                       (m_top_pad, 64 << 20)):
        libc.mallopt(opt, value)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _max(a: float, b: float) -> float:
    if isinstance(a, float) and math.isnan(a):
        return a
    return b if (isinstance(b, float) and math.isnan(b)) or b > a else a


def make_helper(sut: str, config: dict, keys, seeds: Seeds, device):
    """The system under test: the program's helper at the configuration's
    crypto point, its keys loaded from a cryptodir the benchmark writes;
    or the reference in its place."""
    from fedbench.reference import ckks as ref
    from fedbench import rounds
    crypto = config["crypto"]
    if sut != "program":
        return ref.RefCKKS(crypto, keys, device, seeds.helper,
                           precision=sut.split("-", 1)[1])
    ring = ref.make_ring(crypto["ring_dim"], crypto["moduli"], device)
    cryptodir = tempfile.mkdtemp(prefix="fedbench-keys-")
    try:
        for name, blob in ref.cryptodir_files(crypto, ring, keys).items():
            pathlib.Path(cryptodir, name).write_bytes(blob)
        return rounds.program_helper(config, cryptodir, seeds.helper, device)
    finally:
        shutil.rmtree(cryptodir, ignore_errors=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, sut: str = "program", t0: float | None = None,
             log=None) -> dict:
    """One run of `cell`; returns the result object (without printing)."""
    import torch
    from fedbench import rounds, trace as tr
    from fedbench.reference import check as ref_check, ckks as ref

    t0 = T0 if t0 is None else t0
    log = log or (lambda msg: print(f"fedbench: {msg}", file=sys.stderr,
                                    flush=True))
    device = torch.device(device)
    cuda = device.type == "cuda"
    config, traffic = cell.config, cell.traffic
    crypto = config["crypto"]
    seeds = derive(seed)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    marks = [("imports", time.perf_counter())]
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.keys)
    keys = ref.keygen(ref.make_ring(crypto["ring_dim"], crypto["moduli"],
                                    device), gen, crypto["error_eta"])
    sync()
    marks.append(("keys", time.perf_counter()))
    helper = make_helper(sut, config, keys, seeds, device)
    sync()
    marks.append(("helper", time.perf_counter()))
    runner = rounds.runner(traffic, helper,
                        config, rounds.make_pool(config, traffic,
                                                 seeds.pool, device), device)
    sync()
    marks.append(("inputs", time.perf_counter()))
    spans = rounds.Spans(device) if trace else None
    i = 0
    for _ in range(traffic["warmup_rounds"]):
        runner.round(i, spans)
        i += 1
    if spans is not None:
        spans.ms.clear()
    sync()
    marks.append(("warm-up", time.perf_counter()))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sample = Reservoir(traffic["check_rounds"], seeds.sample)
    # Two window rounds of one pool entry are checked besides the sample:
    # a program that caches per input or reuses `a` repeats a c1 chunk.
    pool = len(runner.inputs)
    first = random.Random(seeds.sample + 1).randrange(pool)
    twins = {first: None, first + pool: None}
    least = max(traffic["check_rounds"], first + pool + 1)
    latencies = []
    start = time.perf_counter()
    setup_s = start - t0
    log(f"{cell.name}: set-up {setup_s:.3f} s ({stages(marks, t0)}), "
        f"window of {seconds} s")
    now = start
    while now - start < seconds or len(latencies) < least:
        obs = runner.round(i, spans)
        t = time.perf_counter()
        if len(latencies) in twins:
            twins[len(latencies)] = obs
        latencies.append(1e3 * (t - now))
        now = t
        sample.offer(obs)
        i += 1
    window_s = now - start
    rounds_done = len(latencies)
    q = np.percentile(latencies, [0, 25, 50, 75, 100])
    log(f"{cell.name}: {rounds_done} rounds in {window_s:.3f} s; round ms "
        f"first {latencies[:3]}, min/q1/median/q3/max {q.tolist()}")

    traced = None
    if trace:
        traced = tr.profile(lambda k: runner.round(i + k, rounds.Spans(device)),
                            traffic["traced_rounds"], device.type)
        if sut == "program":
            import importlib
            csrc = pathlib.Path(importlib.import_module(
                PROGRAM).__file__).parent / "csrc"
            traced.library_kernels = tr.library_kernels(csrc)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    runner.helper = helper = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checker = ref_check.Checker(crypto, keys, device)
    limits = config["limits"]
    numbers, failed = {}, 0
    held = {id(o): o for o in [*sample.items, *twins.values()]}
    sample.items.clear()
    twins.clear()
    for obs in held.values():
        checker.stats = ref_check.Stats()
        runner.check(checker, obs)
        got = checker.numbers()
        failed += not ref_check.verdict(got, limits)
        for k, v in got.items():
            numbers[k] = _max(numbers.get(k, v), v)
    held.clear()
    sync()

    reading = Reading(config, traffic, setup_s, window_s, rounds_done,
                      latencies, dict(spans.ms) if spans else {}, traced)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(reading)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(numbers) and failed == 0
              and ref_check.verdict(numbers, limits),
              "attempted": rounds_done, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = tr.busy_s(traced)
        dev["window_s"] = traced.window_s
        result["breakdown"] = tr.breakdown(traced)
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m fedbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_card(chips: int):
    """torch and a CUDA card, or Refused: nothing falls back to the CPU."""
    try:
        import torch
    except ImportError as e:
        raise Refused(f"torch is not importable: {e}") from None
    if not torch.cuda.is_available():
        raise Refused("torch sees no CUDA device; the benchmark runs only "
                      "on the card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, torch sees "
                      f"{torch.cuda.device_count()}")
    return torch


def main(argv=None) -> int:
    args = parse_args(argv)
    keep_freed_memory()
    cell = spec.cell(args.workload)
    torch = require_card(cell.chips)
    t_torch = time.perf_counter()
    set_caches()
    try:
        __import__(PROGRAM)
    except ImportError as e:
        raise Refused(f"the program {PROGRAM} is not in this checkout: "
                      f"{e}") from None
    print(f"fedbench: torch and the card {t_torch - T0:.3f} s, the program "
          f"{time.perf_counter() - t_torch:.3f} s", file=sys.stderr,
          flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        raise Refused(f"loaded once the window closed: {', '.join(bad)}")
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
