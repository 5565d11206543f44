"""Selective encryption over a model's tree: `fhe_fedavg(helper, trees,
weights, SelectivePolicy(rate=...))` of the clients' state dicts on the
card, closed loop, one round in flight; the round ends when the host
holds the averaged tree.

Each pool entry (clients, parameters) is laid out as one state dict a
client, views of its row under the configuration's layout
(reference/deepseek_v2.py `layout`: the Hugging Face names and shapes, in
order), with nothing copied. The program is handed a forwarding wrapper
of the helper that counts the values passed to its encrypting calls
(`fedavg_round`, `encrypt`, `encrypt_cohort`): the configuration
guarantees that ceil(rate * size) values of every leaf are encrypted, and
the plain average the rest gets is exact, so a program that encrypted
less would otherwise pass the comparison.

The check counts one format fault for each name, shape or dtype of the
averaged tree that differs from the layout, and one for a round whose
encrypting calls did not get clients x sum ceil(rate * size) values;
then the tree, flattened in layout order, is held against sum_k w_k x_k
(`avg_rel_err`)."""

import collections
import fractions
import itertools
import math
import time

import numpy as np
import torch

from fedbench import rounds
from fedbench.reference import deepseek_v2 as model


class Counting:
    """The helper, every attribute forwarded; `values` counts what its
    encrypting calls are given."""

    def __init__(self, helper):
        self.helper, self.values = helper, 0

    def __getattr__(self, name):
        return getattr(self.helper, name)

    def _count(self, x) -> None:
        for v in (x if isinstance(x, (list, tuple)) else [x]):
            self.values += int(v.numel() if torch.is_tensor(v)
                               else np.asarray(v).size)

    def fedavg_round(self, vectors, *args, **kwargs):
        self._count(vectors)
        return self.helper.fedavg_round(vectors, *args, **kwargs)

    def encrypt(self, flat, *args, **kwargs):
        self._count(flat)
        return self.helper.encrypt(flat, *args, **kwargs)

    def encrypt_cohort(self, values, *args, **kwargs):
        self._count(values)
        return self.helper.encrypt_cohort(values, *args, **kwargs)


class Surface(rounds.Runner):

    def __init__(self, helper, config, pool, device):
        self.layout = [(name, tuple(shape))
                       for name, shape in model.layout(config)]
        self.rate = float(config["selective"]["rate"])
        exact = fractions.Fraction(str(config["selective"]["rate"]))
        self.encrypted = config["clients"] * sum(
            math.ceil(exact * math.prod(shape)) for _, shape in self.layout)
        super().__init__(helper, config, pool, device)

    def prepare(self, x):
        """(x, one state dict of views of x[k] a client)."""
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
        got = np.concatenate([out[name].reshape(-1).numpy()
                              for name, _ in self.layout])
        values = [row.cpu().numpy() for row in self.flat(obs["pool"])]
        checker.average_blocks(got, values, self.weights)
