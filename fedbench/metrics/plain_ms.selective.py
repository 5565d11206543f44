"""Host time per traced round inside the program's `fhe.plain_average`
span (fed/fedavg.py: the part of every leaf left in plaintext, averaged
in float64 on the host), outermost spans only (ms). Without that span in
the trace it reads nothing."""

from fedbench import spec

span_ms = spec.load_file(spec.HERE / "metrics" / "keys_ms.cohort.py"
                         ).span_ms


def read(r):
    return span_ms(r.trace, ("fhe.plain_average",))
