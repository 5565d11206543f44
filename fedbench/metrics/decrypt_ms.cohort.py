"""Mean over the timed window of CUDA events on the current stream around each
`CKKS.decrypt_cohort` call, per round (ms)."""


def read(r):
    ms = r.spans.get("decrypt_cohort")
    return sum(ms) / len(ms) if ms else None
