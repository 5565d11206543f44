"""Mean over the timed window of the host clock around each `CKKS.encrypt`
call, per call (ms)."""


def read(r):
    ms = r.spans.get("encrypt")
    return sum(ms) / len(ms) if ms else None
