"""Selective encryption over a model's bfloat16 tree: `fhe_fedavg(helper,
trees, weights, SelectivePolicy(rate=...))` of the clients' bfloat16
state dicts on the card, closed loop, one round in flight; the round ends
when the host holds the averaged float32 tree.

Each pool entry (clients, parameters), drawn in float32, is rounded to
bfloat16 once at set-up, and each client's state dict is views of its
bfloat16 row under the configuration's layout (reference/kimi_linear.py
`layout`: the names and shapes, in order), with nothing copied. The
program is handed surfaces/selective.py's `Counting` wrapper of the
helper, which counts the values passed to its encrypting calls.

A run holds up to HELD averaged trees at once (the two sampled rounds,
the two twins, the last round and the one in flight), each 5.2 GB in
pinned host memory from torch's caching host allocator; set-up allocates
and frees that many blocks of the tree's size, so that the window reuses
them and does not page-lock a new block a round while the held trees
build up (a new 8 GiB block took ~2 s).

The check counts one format fault for each name, shape or dtype of the
averaged tree that differs from the layout (float32 out), and one for a
round whose encrypting calls did not get clients x sum ceil(rate * size)
values; then each leaf is held against sum_k w_k x_k of the clients'
bfloat16 values, widened exactly to float64 (`avg_rel_err`, over the
largest |sum_k w_k x_k| of the tree)."""

import collections
import fractions
import itertools
import math
import time

import torch

from fedbench import rounds, spec
from fedbench.reference import ckks as ref_ckks
from fedbench.reference import kimi_linear as model

Counting = spec.load_file(spec.HERE / "surfaces" / "selective.py").Counting

HELD = 6


class Surface(rounds.Runner):

    def __init__(self, helper, config, pool, device):
        self.layout = [(name, tuple(shape))
                       for name, shape in model.layout(config)]
        self.rate = float(config["selective"]["rate"])
        exact = fractions.Fraction(str(config["selective"]["rate"]))
        self.encrypted = config["clients"] * sum(
            math.ceil(exact * math.prod(shape)) for _, shape in self.layout)
        super().__init__(helper, config, pool, device)
        if self.device.type == "cuda":
            blocks = [torch.empty(config["parameters"], dtype=torch.float32,
                                  pin_memory=True) for _ in range(HELD)]
            del blocks

    def prepare(self, x):
        """(x rounded to bfloat16, one state dict of views of its row k a
        client)."""
        x = x.to(torch.bfloat16)
        trees = []
        for row in x:
            tree, off = collections.OrderedDict(), 0
            for name, shape in self.layout:
                size = math.prod(shape)
                tree[name] = row[off:off + size].view(shape)
                off += size
            if off != row.numel():
                raise ValueError(f"the layout holds {off} values, the "
                                 f"configuration {row.numel()}")
            trees.append(tree)
        return x, trees

    def flat(self, j):
        return self.inputs[j][0]

    def round(self, i: int, spans=None) -> dict:
        from fhe_fed_tpu_torch import SelectivePolicy, fhe_fedavg
        j = i % len(self.inputs)
        helper = Counting(self.helper)
        t = time.perf_counter()
        with rounds.label(spans, "fhe_fedavg"):
            out = fhe_fedavg(helper, self.inputs[j][1], self.weights,
                             SelectivePolicy(rate=self.rate))
        if spans is not None:
            spans.host("fhe_fedavg", time.perf_counter() - t)
        return dict(pool=j, out=out, encrypted=helper.values)

    def check(self, checker, obs: dict) -> None:
        out = obs["out"]
        names = list(out) if isinstance(out, dict) else []
        faults = sum(a != b for a, b in itertools.zip_longest(
            names, [name for name, _ in self.layout]))
        for name, shape in self.layout:
            leaf = out.get(name) if names else None
            if leaf is not None:
                faults += tuple(leaf.shape) != shape
                faults += getattr(leaf, "dtype", None) != torch.float32
        # Counted at 0 too, so that the result reports the number.
        checker._fault(faults + (obs["encrypted"] != self.encrypted))
        if faults:
            return
        rows, off, err, top = self.flat(obs["pool"]), 0, 0.0, 0.0
        for name, shape in self.layout:
            size = math.prod(shape)
            want = ref_ckks.weighted_mean([r[off:off + size] for r in rows],
                                          self.weights)
            got = out[name].reshape(-1).to(want.device, torch.float64)
            err = max(err, float((got - want).abs().max()))
            top = max(top, float(want.abs().max()))
            off += size
        checker.stats.max("avg_rel_err", err / top)
