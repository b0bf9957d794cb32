"""Reading a ``torch.profiler`` trace of the traced pairs: the device's
busy time (the union of its activity intervals), the time of named
kernels, the device operations that took most time, and the idle gaps
labelled by what the host was doing (the benchmark's span around the
batch, and the innermost host event open at the gap's middle).
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from pathlib import Path

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def kernel_names(cu_file: Path) -> list:
    """The ``__global__`` functions a CUDA source defines."""
    return sorted(set(_GLOBAL.findall(Path(cu_file).read_text())))


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:100] or "(unnamed device activity)"


def summarize(events, spans: tuple, kernels: list) -> dict:
    """From a profiler's events (``prof.events()``): ``window_s`` (first
    span start to last span end), ``busy_s``, ``kernel_s`` (device time of
    the kernels named in ``kernels``), and the ``breakdown``."""
    from torch.autograd import DeviceType

    dev, cpu, marks = [], [], []
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        on_device = e.device_type == DeviceType.CUDA
        if e.name in spans:
            # a span's device-side annotation covers the whole batch: it
            # is no device work
            if not on_device:
                marks.append((t0, t1, e.name))
        elif on_device:
            dev.append((t0, t1, e.name))
        else:
            cpu.append((t0, t1, e.name))
    if not marks or not dev:
        return {}
    w0 = min(s for s, _, _ in marks)
    w1 = max(e for _, e, _ in marks)
    dev = sorted(d for d in dev if d[1] > w0 and d[0] < w1)
    busy, merged = 0.0, []
    for t0, t1, _ in dev:
        t0, t1 = max(t0, w0), min(t1, w1)
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy = sum(b - a for a, b in merged)
    pattern = re.compile(r"\b(" + "|".join(map(re.escape, kernels)) + r")\b")
    by_op = defaultdict(float)
    kernel_us = 0.0
    for t0, t1, name in dev:
        by_op[_short(name)] += t1 - t0
        if kernels and pattern.search(name):
            kernel_us += t1 - t0
    # idle gaps: before the first activity, between merged intervals, after
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    cpu.sort()
    starts = [c[0] for c in cpu]
    marks.sort()
    mark_starts = [m[0] for m in marks]
    by_gap = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        j = bisect.bisect_right(mark_starts, mid) - 1
        span = marks[j][2] if j >= 0 and marks[j][1] >= mid else "between"
        inner = "host"
        i = bisect.bisect_right(starts, mid) - 1
        for k in range(i, max(-1, i - 5000), -1):
            if cpu[k][1] >= mid:
                inner = _short(cpu[k][2])
                break
        by_gap[f"{span}/{inner}"] += b - a
    top = lambda d: [[k, v / 1e6] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "kernel_s": kernel_us / 1e6,
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(by_gap)}}
