"""Host time per traced round inside the program's `fhe.pack` and
`fhe.unpack` spans (fed/api.py: the clients' vectors laid into chunks and
copied to the card, padded to whole slices; the slices' results joined
and unpacked to float64), outermost spans only (ms). Without those spans
in the trace it reads nothing."""

from fedbench import spec

span_ms = spec.load_file(spec.HERE / "metrics" / "keys_ms.cohort.py"
                         ).span_ms


def read(r):
    return span_ms(r.trace, ("fhe.pack", "fhe.unpack"))
