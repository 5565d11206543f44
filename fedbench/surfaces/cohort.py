"""The cohort on the card: `encrypt_cohort` of the (K, chunks, N) f32
cohort, `aggregate_cohort`, `decrypt_cohort(raw=True)`, then a
synchronise ends the round."""

from fedbench import rounds


class Surface(rounds.Runner):

    def prepare(self, x):
        return rounds.lay_out(x, self.n, self.cap)

    def flat(self, j):
        x = self.inputs[j][..., :self.cap]
        return x.reshape(x.shape[0], -1)[:, :self.config["parameters"]]

    def round(self, i: int, spans=None) -> dict:
        h, j = self.helper, i % len(self.inputs)
        x = self.inputs[j]
        if spans is None:
            ct = h.encrypt_cohort(x)
            agg = h.aggregate_cohort(ct, self.weights)
            out = h.decrypt_cohort(agg, raw=True)
            self.sync()
            return dict(pool=j, ct=ct, agg=agg, out=out)
        m0 = spans.mark()
        with rounds.label(spans, "encrypt_cohort"):
            ct = h.encrypt_cohort(x)
        m1 = spans.mark()
        with rounds.label(spans, "aggregate_cohort"):
            agg = h.aggregate_cohort(ct, self.weights)
        m2 = spans.mark()
        with rounds.label(spans, "decrypt_cohort"):
            out = h.decrypt_cohort(agg, raw=True)
        m3 = spans.mark()
        with rounds.label(spans, "synchronize"):
            self.sync()
        spans.device_span("encrypt_cohort", m0, m1)
        spans.device_span("aggregate_cohort", m1, m2)
        spans.device_span("decrypt_cohort", m2, m3)
        spans.settle()
        return dict(pool=j, ct=ct, agg=agg, out=out)

    def check(self, checker, obs: dict) -> None:
        j = obs["pool"]
        want = rounds.lay_out(self.want(j), self.n, self.cap)
        checker.clients(obs["ct"].data, self.inputs[j], obs["ct"].scale,
                        self.scale)
        checker.aggregate(obs["agg"].data, obs["agg"].scale, want)
        checker.average(obs["out"], want)
