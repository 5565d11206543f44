"""Selective encryption over a model's bfloat16 tree with a tied
embedding: `fhe_fedavg(helper, trees, weights, SelectivePolicy(rate=...))`
of the clients' bfloat16 state dicts on the card, closed loop, one round
in flight; the round ends when the host holds the averaged float32 tree.

Each pool entry (clients, parameters) is rounded to bfloat16 once at
set-up, and each client's state dict is views of its bfloat16 row under
the configuration's layout (reference/granite_hybrid.py `layout`: the
names and shapes, in order), with nothing copied; a key that `ties`
names (`lm_head.weight`) is the same view as the key it names
(`model.embed_tokens.weight`), so a row holds `parameters` values and the
tree more positions. The program is handed surfaces/selective.py's
`Counting` wrapper of the helper.

The pool is one entry: rounds.make_pool draws an entry's float32 normal
values and then multiplies them by the standard deviation, so while it
makes an entry it holds two float32 copies of it beside the entries
before it: 99 GiB for a second entry of the Granite stage (33.0 GiB
each), more than the card has, and 66 GiB for the first. The bfloat16
copy then adds 16.5 GiB before the float32 entry is freed.

A run holds up to HELD averaged trees at once (the two sampled rounds,
the two twins, the last round and the one in flight), each 12.2 GB of
page-locked host memory at the Granite stage. Above 8 GiB the program
takes such memory from its exact-size blocks (fed/fedavg.py
`host_blocks`; torch's caching host allocator would round each up to 16
GiB); set-up reserves HELD of them, so that the window page-locks none.
A program without those blocks cannot hold the run's trees on the host
and is refused at set-up.

The check counts one format fault for each name, shape or dtype of the
averaged tree that differs from the layout (float32 out), and one for a
round whose encrypting calls did not get clients x sum ceil(rate * size)
values over every key, the tied ones each time; then each key, both tied
keys included, is held against sum_k w_k x_k of the clients' bfloat16
values, widened exactly to float64 (`avg_rel_err`, over the largest
|sum_k w_k x_k| of the tree)."""

import collections
import fractions
import itertools
import math
import time

import torch

from fedbench import rounds, spec
from fedbench.reference import ckks as ref_ckks
from fedbench.reference import granite_hybrid as model

Counting = spec.load_file(spec.HERE / "surfaces" / "selective.py").Counting

HELD = 6


class Surface(rounds.Runner):

    def __init__(self, helper, config, pool, device):
        from fhe_fed_tpu_torch.fed import fedavg
        self.layout = [(name, tuple(shape))
                       for name, shape in model.layout(config)]
        self.ties = model.ties(config)
        self.rate = float(config["selective"]["rate"])
        exact = fractions.Fraction(str(config["selective"]["rate"]))
        self.encrypted = config["clients"] * sum(
            math.ceil(exact * math.prod(shape)) for _, shape in self.layout)
        positions = sum(math.prod(shape) for _, shape in self.layout)
        # Read before the pool is touched, so that a program without the
        # blocks is refused at once.
        blocks = fedavg.host_blocks
        super().__init__(helper, config, pool, device)
        if self.device.type == "cuda":
            blocks.reserve((positions,), torch.float32, HELD)

    def prepare(self, x):
        """(x rounded to bfloat16, one state dict of views of its row k a
        client, the tied keys the views of the keys they name)."""
        x = x.to(torch.bfloat16)
        trees = []
        for row in x:
            tree, off = collections.OrderedDict(), 0
            for name, shape in self.layout:
                if name in self.ties:
                    tree[name] = tree[self.ties[name]]
                    continue
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

    def offsets(self) -> dict:
        """Each key's offset in a row, the tied keys their source's."""
        at, off = {}, 0
        for name, shape in self.layout:
            if name not in self.ties:
                at[name] = off
                off += math.prod(shape)
        return {name: at[self.ties.get(name, name)]
                for name, _ in self.layout}

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
        rows, err, top = self.flat(obs["pool"]), 0.0, 0.0
        offsets = self.offsets()
        for name, shape in self.layout:
            off, size = offsets[name], math.prod(shape)
            want = ref_ckks.weighted_mean([r[off:off + size] for r in rows],
                                          self.weights)
            # Up as float32 (a pinned copy), widened on the card.
            got = out[name].reshape(-1).to(want.device).double()
            err = max(err, float((got - want).abs().max()))
            top = max(top, float(want.abs().max()))
        checker.stats.max("avg_rel_err", err / top)
