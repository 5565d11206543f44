"""The traced window: torch.profiler over a fixed number of rounds, read
back from its Chrome trace.

Device events are the trace's `kernel`, `gpu_memcpy` and `gpu_memset`
events; busy time is the union of their intervals inside the window (the
`fedbench.traced_window` annotation), idle time the rest. The breakdown
lists the device operations that took most time and the idle time by
what the host was doing: the innermost `fedbench.*` span and the
innermost operator or runtime call on the host's main thread at the
middle of each gap.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import pathlib
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
WINDOW = "fedbench.traced_window"
TOP = 10


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    cat: str
    ts: float       # microseconds
    dur: float

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Trace:
    device: list            # Event
    host: list              # Event, the main thread's
    window: tuple           # (ts, dur) in microseconds
    rounds: int
    library_kernels: frozenset = frozenset()

    @property
    def window_s(self) -> float:
        return self.window[1] * 1e-6

    def kernels(self):
        return [e for e in self.device if e.cat == "kernel"]


def kernel_id(name: str) -> str:
    """The function's own name in a kernel's trace name: 'void
    ns::f<T>(args)' -> 'f'."""
    s = name.replace("(anonymous namespace)", "")
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return s.split("::")[-1].split()[-1] if s else name


def library_kernels(csrc: pathlib.Path) -> frozenset:
    """The names of the __global__ functions in the program's hand-written
    sources (`csrc/*.cu`)."""
    names = set()
    for path in sorted(pathlib.Path(csrc).glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r"__global__", text):
            rest = text[m.end():]
            rest = re.sub(r"^\s*void\s+", "", rest)
            if rest.startswith("__launch_bounds__"):
                depth, i = 0, len("__launch_bounds__")
                for i in range(i, len(rest)):
                    depth += {"(": 1, ")": -1}.get(rest[i], 0)
                    if depth == 0 and rest[i] == ")":
                        break
                rest = rest[i + 1:]
            ident = re.match(r"\s*(?:void\s+)?([A-Za-z_]\w*)\s*[(<]", rest)
            if ident:
                names.add(ident.group(1))
    return frozenset(names)


def profile(run_round, rounds: int, device_type: str) -> Trace:
    """Run `rounds` rounds under torch.profiler and read the trace."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(rounds):
                run_round(i)
    fd, path = tempfile.mkstemp(prefix="fedbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return parse(json.load(f), rounds)
    finally:
        os.unlink(path)


def parse(doc: dict, rounds: int) -> Trace:
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    device, host, window = [], collections.defaultdict(list), None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ev = Event(e.get("name", ""), cat, float(e["ts"]),
                   float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat in HOST_CATS:
            if cat == "user_annotation" and ev.name == WINDOW:
                window = (ev.ts, ev.dur)
            host[(e.get("pid"), e.get("tid"))].append(ev)
    if window is None:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    main = max(host.values(), key=len) if host else []
    return Trace(sorted(device, key=lambda e: e.ts),
                 sorted(main, key=lambda e: (e.ts, -e.dur)), window, rounds)


def busy_intervals(trace: Trace) -> list:
    """The union of the device events' intervals, clipped to the window."""
    lo, hi = trace.window[0], trace.window[0] + trace.window[1]
    merged = []
    for e in sorted(trace.device, key=lambda e: e.ts):
        a, b = max(e.ts, lo), min(e.end, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(trace: Trace) -> float:
    return 1e-6 * sum(b - a for a, b in busy_intervals(trace))


def gaps(trace: Trace) -> list:
    """Idle intervals [a, b) of the window."""
    lo, hi = trace.window[0], trace.window[0] + trace.window[1]
    out, t = [], lo
    for a, b in busy_intervals(trace):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def _host_labels(trace: Trace, points: list) -> list:
    """What the host's main thread was in at each time of `points`
    (sorted): 'span / innermost op', by a sweep over its nested events."""
    host = trace.host
    starts = [e.ts for e in host]
    labels, stack, i = [], [], 0
    for p in points:
        i_new = bisect.bisect_right(starts, p)
        for e in host[i:i_new]:
            while stack and stack[-1].end <= e.ts:
                stack.pop()
            stack.append(e)
        i = i_new
        while stack and stack[-1].end <= p:
            stack.pop()
        live = [e for e in stack if e.ts <= p < e.end]
        span = next((e.name for e in reversed(live)
                     if e.cat == "user_annotation" and e.name != WINDOW),
                    "between calls")
        op = next((e.name for e in reversed(live)
                   if e.cat != "user_annotation"), "python")
        labels.append(f"{span.removeprefix('fedbench.')} / {op}")
    return labels


def breakdown(trace: Trace) -> dict:
    """The device operations with most time, and the idle time by what the
    host was doing: each [name, seconds], at most TOP each."""
    ops = collections.Counter()
    for e in trace.device:
        ops[e.name[:160]] += e.dur * 1e-6
    idle = collections.Counter()
    gs = gaps(trace)
    mids = [(a + b) / 2 for a, b in gs]
    for (a, b), label in zip(gs, _host_labels(trace, mids)):
        idle[label] += (b - a) * 1e-6
    return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(TOP)]}
