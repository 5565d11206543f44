"""Host time per traced round inside the program's `fhe.tree_flatten`,
`fhe.tree_split` and `fhe.tree_unflatten` spans (fed/fedavg.py: the
clients' bfloat16 leaves planned and tabled where they lie, the gather
with its copy to the host, the scatter, and the averaged tree's copy to
the host and its views), outermost spans only (ms). Without those spans
in the trace it reads nothing."""

from fedbench import spec

span_ms = spec.load_file(spec.HERE / "metrics" / "keys_ms.cohort.py"
                         ).span_ms


def read(r):
    return span_ms(r.trace, ("fhe.tree_flatten", "fhe.tree_split",
                             "fhe.tree_unflatten"))
