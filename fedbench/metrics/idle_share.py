"""The share of the traced window in which no kernel, copy or memset runs
on the card: one less the union of their intervals over the window (%)."""

from fedbench.trace import busy_s


def read(r):
    t = r.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - busy_s(t) / t.window_s)
