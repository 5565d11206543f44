"""Device time per traced round of every kernel that is not one of the
program's hand-written kernels (the __global__ functions of its csrc/):
the int64 elementwise glue of torch (ms)."""

from fedbench.trace import kernel_id


def read(r):
    t = r.trace
    if t is None or not t.kernels():
        return None
    us = sum(e.dur for e in t.kernels()
             if kernel_id(e.name) not in t.library_kernels)
    return 1e-3 * us / t.rounds
