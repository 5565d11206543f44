"""Host time per traced round inside the program's `fhe.serialize` and
`fhe.deserialize` spans (ckks/serial.py: the device-to-host copy, cast,
bytes and header of each blob written; the parse, cast and host-to-device
copy of each blob read), outermost spans only (ms). Without those spans
in the trace it reads nothing."""

from fedbench import spec

span_ms = spec.load_file(spec.HERE / "metrics" / "keys_ms.cohort.py"
                         ).span_ms


def read(r):
    return span_ms(r.trace, ("fhe.serialize", "fhe.deserialize"))
