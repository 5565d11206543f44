"""Host time per traced round inside the program's `fhe.tree_flatten`,
`fhe.tree_split` and `fhe.tree_unflatten` spans (fed/fedavg.py: the
clients' 149 bfloat16 keys, the tied pair among them, planned and tabled
where they lie, the gather and the scatter, and the averaged tree of 3.06
billion positions copied to the host and viewed), outermost spans only
(ms). Without those spans in the trace it reads nothing."""

from fedbench import spec

span_ms = spec.load_file(spec.HERE / "metrics" / "keys_ms.cohort.py"
                         ).span_ms


def read(r):
    return span_ms(r.trace, ("fhe.tree_flatten", "fhe.tree_split",
                             "fhe.tree_unflatten"))
