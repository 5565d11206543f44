"""The reference binding's bytes surface: each client's
`CKKS.encrypt(flat f32)` to bytes, `computeWeightedAverage(blobs,
weights)` to bytes, `decrypt(blob, parameters)` to float64 on the host,
which ends the round."""

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
        tick = time.perf_counter
        blobs = []
        for v in self.inputs[j]:
            t = tick()
            with rounds.label(spans, "encrypt"):
                blobs.append(h.encrypt(v))
            if spans is not None:
                spans.host("encrypt", tick() - t)
        t = tick()
        with rounds.label(spans, "computeWeightedAverage"):
            agg = h.computeWeightedAverage(blobs, self.weights)
        if spans is not None:
            spans.host("computeWeightedAverage", tick() - t)
        t = tick()
        with rounds.label(spans, "decrypt"):
            out = h.decrypt(agg, self.config["parameters"])
        if spans is not None:
            spans.host("decrypt", tick() - t)
        return dict(pool=j, blobs=blobs, agg=agg, out=out)

    def check(self, checker, obs: dict) -> None:
        j = obs["pool"]
        want = self.want(j)
        x = rounds.lay_out(self.flat(j).to(self.device), self.n, self.cap)
        cts = [checker.wire_ct(b, self.chunks, self.live)
               for b in obs["blobs"]]
        if all(d is not None for d, _ in cts):
            scales = {s for _, s in cts}
            checker.clients(torch.stack([d for d, _ in cts]), x,
                            scales.pop() if len(scales) == 1 else None,
                            self.scale)
        data, scale = checker.wire_ct(obs["agg"], self.chunks, self.live)
        if data is not None:
            checker.aggregate(data, scale,
                              rounds.lay_out(want, self.n, self.cap))
        checker.average(obs["out"], want)
