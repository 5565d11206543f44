"""Named spans on torch.profiler's clock, at the program's layer
boundaries (`fhe.*`).

While a profiler runs, `span(name)` and `traced(name)` enter
`torch.profiler.record_function(name)`: a host event on the timeline that
Kineto aligns with the device's events, nested in the span that encloses
it on the same thread. With no profiler running they call straight
through after one flag read, tens of times cheaper than entering
`record_function`. Neither ever synchronises the device or records a
CUDA event. To trace a round, run it under `torch.profiler.profile` and
write the spans out with `export_chrome_trace`.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager: `with span("fhe.pack"): ...`."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


def traced(name: str):
    """A decorator: each call of the function is one span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap
