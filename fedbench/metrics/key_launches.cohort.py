"""Kernel launches per traced round inside the program's `fhe.key_split`
spans: the CUDA runtime's `cudaLaunchKernel*` calls on the main thread
within an outermost span, torch's launches and the program's alike
(launches). Without those spans in the trace it reads nothing."""

import bisect

from fedbench import spec

outermost = spec.load_file(spec.HERE / "metrics" / "keys_ms.cohort.py"
                           ).outermost


def read(r):
    t = r.trace
    spans = outermost(t, ("fhe.key_split",)) if t is not None else []
    if not spans:
        return None
    starts = [s.ts for s in spans]
    n = 0
    for e in t.host:
        if e.cat == "cuda_runtime" and e.name.startswith("cudaLaunchKernel"):
            i = bisect.bisect_right(starts, e.ts) - 1
            n += i >= 0 and e.ts < spans[i].end
    return n / t.rounds
