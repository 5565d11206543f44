"""Host time per traced round inside the program's `fhe.encrypted_part`
span (fed/fedavg.py: the encrypted part of every key, the tied pair's
twice, through the scheme's round; fed/api.py `fedavg_round`: the pack
on the card, encrypt, aggregate, decrypt), outermost spans only (ms).
Without that span in the trace it reads nothing."""

from fedbench import spec

span_ms = spec.load_file(spec.HERE / "metrics" / "keys_ms.cohort.py"
                         ).span_ms


def read(r):
    return span_ms(r.trace, ("fhe.encrypted_part",))
