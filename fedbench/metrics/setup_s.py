"""Set-up: from the start of the process to the first measured round
(imports, the kernel library, keys, inputs, the warm-up rounds)."""


def read(r):
    return r.setup_s
