"""Mean over the timed window of the host clock around each
`CKKS.computeWeightedAverage` call, per call (ms)."""


def read(r):
    ms = r.spans.get("computeWeightedAverage")
    return sum(ms) / len(ms) if ms else None
