"""Host time per traced round inside the program's `fhe.encrypted_part`
span (fed/fedavg.py: the encrypted part of every leaf through the
scheme's round, fed/api.py `fedavg_round`: staging, encrypt, aggregate,
decrypt), outermost spans only (ms). Without that span in the trace it
reads nothing."""

from fedbench import spec

span_ms = spec.load_file(spec.HERE / "metrics" / "keys_ms.cohort.py"
                         ).span_ms


def read(r):
    return span_ms(r.trace, ("fhe.encrypted_part",))
