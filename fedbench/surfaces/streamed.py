"""The streamed round: `CKKS.fedavg_round` (fused, its own slices) of the
clients' host f32 vectors to the float64 average on the host, which ends
the round."""

import time

import torch

from fedbench import rounds


class Surface(rounds.Runner):

    def prepare(self, x):
        host = x.cpu().numpy()
        return [host[k] for k in range(host.shape[0])]

    def flat(self, j):
        return torch.stack([torch.as_tensor(v) for v in self.inputs[j]])

    def round(self, i: int, spans=None) -> dict:
        h, j = self.helper, i % len(self.inputs)
        t = time.perf_counter()
        with rounds.label(spans, "fedavg_round"):
            out = h.fedavg_round(self.inputs[j], self.weights)
        if spans is not None:
            spans.host("fedavg_round", time.perf_counter() - t)
        return dict(pool=j, out=out)

    def check(self, checker, obs: dict) -> None:
        checker.average_blocks(obs["out"], self.inputs[obs["pool"]],
                               self.weights)
