"""Host time per traced round inside the program's `fhe.key_split` spans
(utils/threefry.py `split`, which every key split of either PRNG runs
through), outermost spans only (ms). Without those spans in the trace,
as in a program that has none, it reads nothing.

`outermost` and `span_ms` also serve the other readers of the program's
`fhe.*` spans."""


def outermost(trace, names) -> list:
    """The main thread's `user_annotation` events named in `names` that no
    other such event encloses, in time order."""
    out, end = [], float("-inf")
    for e in trace.host:
        if e.cat == "user_annotation" and e.name in names and e.ts >= end:
            out.append(e)
            end = e.end
    return out


def span_ms(trace, names):
    """The host time of the outermost spans named in `names`, per traced
    round (ms), or None without a trace or such a span."""
    spans = outermost(trace, names) if trace is not None else []
    if not spans:
        return None
    return 1e-3 * sum(e.dur for e in spans) / trace.rounds


def read(r):
    return span_ms(r.trace, ("fhe.key_split",))
