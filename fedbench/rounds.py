"""The round generator: one general runner per surface of the program's
`CKKS` helper, chosen and parametrised by a traffic mix's data file
(traffic/<mix>.json: `surface`, `pool`, `warmup_rounds`, `traced_rounds`,
`check_rounds`).

Each surface's runner is surfaces/<surface>.py, found by name. Inputs are
bench.py's cohort arithmetic, made here from the seed: each client's
update is `parameters` values drawn normal in float32 times the
configuration's standard deviation, laid into chunks as the packing lays
them (value i at coefficient i mod capacity of chunk i // capacity, zeros
after). A pool of `pool` cohorts is made at set-up, on the card in one
call a cohort, and round i takes cohort i mod pool.

Every surface runs closed loop, one round in flight, and a round ends
when its result is complete: after a synchronise on the card, or when the
host holds the answer. With `spans`, each call into the program is timed
(CUDA events on the card, the host clock where the call returns host
data) and wrapped in a `record_function` named after it, which the
traced window's breakdown reads.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

from . import spec
from .reference import ckks as ref_ckks


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    """`pool` cohorts of (clients, parameters) f32 on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    shape = (config["clients"], config["parameters"])
    std = float(config["values"]["std"])
    return [torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std
            for _ in range(traffic["pool"])]


def capacity(config: dict) -> int:
    """Values packed per chunk: N with dense packing, else the batch."""
    c = config["crypto"]
    return c["ring_dim"] if c["dense_pack"] else c["batch"]


def chunks_of(config: dict) -> int:
    return -(-config["parameters"] // capacity(config))


def lay_out(x: torch.Tensor, n: int, cap: int) -> torch.Tensor:
    """(..., values) -> (..., chunks, N): value i at coefficient i mod cap
    of chunk i // cap, zeros after."""
    *lead, size = x.shape
    chunks = -(-size // cap)
    pay = torch.zeros((*lead, chunks * cap), dtype=x.dtype, device=x.device)
    pay[..., :size] = x
    if cap == n:
        return pay.view(*lead, chunks, n)
    buf = torch.zeros((*lead, chunks, n), dtype=x.dtype, device=x.device)
    buf[..., :cap] = pay.view(*lead, chunks, cap)
    return buf


class Spans:
    """Per-call times of the window's rounds, in ms by name."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.ms = collections.defaultdict(list)
        self._pending = []

    def mark(self):
        """A point on the card's stream (on the host without a card)."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def device_span(self, name: str, start, end) -> None:
        """Kept until `settle`, after the round's synchronise."""
        self._pending.append((name, start, end))

    def settle(self) -> None:
        for name, a, b in self._pending:
            self.ms[name].append(a.elapsed_time(b) if self.cuda
                                 else 1e3 * (b - a))
        self._pending.clear()

    def host(self, name: str, seconds: float) -> None:
        self.ms[name].append(1e3 * seconds)


def label(spans, name):
    """A `record_function` span named after the call, when timing."""
    return (torch.profiler.record_function(f"fedbench.{name}")
            if spans is not None else contextlib.nullcontext())


class Runner:
    """One surface: `round(i, spans)` runs round i and returns what the
    check needs; `check(checker, obs)` holds it against the reference.
    `helper` is the program's CKKS helper, or the reference in its place
    (the control)."""

    def __init__(self, helper, config: dict, pool: list, device):
        self.helper = helper
        self.config = config
        self.weights = list(config["weights"])
        self.device = torch.device(device)
        self.n = config["crypto"]["ring_dim"]
        self.cap = capacity(config)
        self.chunks = chunks_of(config)
        self.live = config["crypto"]["chain_len"]
        self.scale = 2.0 ** config["crypto"]["scale_bits"]
        self.inputs = [self.prepare(x) for x in pool]

    def prepare(self, x: torch.Tensor):
        """A pool entry (K, values) on the card -> the surface's input."""
        return x

    def flat(self, j: int) -> torch.Tensor:
        """Cohort j as (K, values), on the card or the host."""
        raise NotImplementedError

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def want(self, j: int) -> torch.Tensor:
        """sum_k w_k x_k of cohort j in float64, (values,) on the card."""
        x = torch.as_tensor(self.flat(j)).to(self.device)
        return ref_ckks.weighted_mean(list(x), self.weights)


def runner(traffic: dict, helper, config: dict, pool: list, device):
    """The runner of the mix's surface: surfaces/<surface>.py's `Surface`."""
    surface = spec.load_file(
        spec.HERE / "surfaces" / f"{traffic['surface']}.py")
    return surface.Surface(helper, config, pool, device)


def program_helper(config: dict, cryptodir: str, seed: int, device):
    """The program's CKKS helper at the configuration's crypto point, its
    keys loaded from `cryptodir`."""
    from fhe_fed_tpu_torch import CKKS
    c = config["crypto"]
    h = CKKS(c["scheme"], c["batch"], c["scale_bits"], cryptodir=cryptodir,
             mult_depth=c["mult_depth"], dense_pack=c["dense_pack"],
             symmetric=c["symmetric"], seed=int(seed), device=device,
             prng=c["prng"])
    h.loadCryptoParams()
    return h
