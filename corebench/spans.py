"""The program's own spans in a ``torch.profiler`` trace: for each span
name ``repro_torch.trace.SPANS`` lists, how often it opened and where its
time went on the host and on the device.

``span_summary(events, names)`` reads the same ``prof.events()`` as
``tracing.summarize``. A span is a host range; spans nest, each in the
span it opened inside. A kernel counts for the innermost span open when
it was launched, through the profiler's link from a host event to the
kernels launched under it (never by overlap of device and host
intervals: the device runs behind the host). The profiler hands a
kernel to every host event that carries the launching op's correlation
id (its own bookkeeping events too), so each id's kernels count once, at
the first such event. The device's busy time is the union of its
activity intervals, as ``tracing.summarize`` takes it, with every range
named after a span and every user annotation left out.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from .tracing import _short

TOP = 5  # kernels listed a span


def program_spans() -> tuple:
    """The span names of the checkout's program; none where the program
    opens no span."""
    try:
        from repro_torch import trace
    except ImportError:
        return ()
    return tuple(trace.SPANS)


def _busy_intervals(events, names) -> list:
    """The device's activity as merged ``[start, end]`` intervals (us)."""
    from torch.autograd import DeviceType

    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA and e.name not in names
                 and not getattr(e, "is_user_annotation", False))
    merged = []
    for t0, t1 in dev:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def span_summary(events, names) -> dict:
    """``{name: {"count", "host_s", "self_s", "device_s", "idle_s",
    "kernels"}}`` for every span of ``names`` that opened: ``host_s`` the
    summed durations; ``self_s`` those less the time covered by child
    spans; ``device_s`` the device time of the kernels launched inside it
    and in no child span; ``idle_s`` the time in its host intervals in
    which the device did nothing; ``kernels`` the ``TOP`` kernels of its
    ``device_s``, ``[name, s]``."""
    from torch.autograd import DeviceType

    names = frozenset(names)
    spans, launches, seen = [], [], set()
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.device_type == DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        if e.name in names:
            spans.append((t0, -t1, e.name))
        if e.kernels and e.id not in seen:
            seen.add(e.id)
            launches += [(t0, k.duration, _short(k.name))
                         for k in e.kernels if k.name not in names]
    if not spans:
        return {}
    spans.sort()
    start = [s[0] for s in spans]
    end = [-s[1] for s in spans]
    # the profiler's clock ticks in microseconds: a span that starts in
    # the tick its sibling ends in is no child of it
    parent, stack = [], []
    for i in range(len(spans)):
        while stack and end[stack[-1]] < end[i]:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    dur = [b - a for a, b in zip(start, end)]
    self_us = list(dur)
    for i, p in enumerate(parent):
        if p >= 0:
            self_us[p] -= dur[i]
    dev_us = [0.0] * len(spans)
    kernels = [defaultdict(float) for _ in spans]
    for t, d, kname in launches:
        j = bisect.bisect_right(start, t) - 1
        while j >= 0 and end[j] < t:
            j = parent[j]
        if j >= 0:
            dev_us[j] += d
            kernels[j][kname] += d
    merged = _busy_intervals(events, names)
    m0 = [a for a, _ in merged]
    cum = [0.0]
    for a, b in merged:
        cum.append(cum[-1] + b - a)

    def busy_until(t):
        k = bisect.bisect_right(m0, t) - 1
        if k < 0:
            return 0.0
        return cum[k] + min(t, merged[k][1]) - merged[k][0]

    out = {}
    for i, (_, _, name) in enumerate(spans):
        s = out.setdefault(name, {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                  "device_s": 0.0, "idle_s": 0.0,
                                  "kernels": defaultdict(float)})
        s["count"] += 1
        s["host_s"] += dur[i] / 1e6
        s["self_s"] += self_us[i] / 1e6
        s["device_s"] += dev_us[i] / 1e6
        s["idle_s"] += (dur[i] - busy_until(end[i])
                        + busy_until(start[i])) / 1e6
        for kname, d in kernels[i].items():
            s["kernels"][kname] += d / 1e6
    for s in out.values():
        s["kernels"] = [[k, v] for k, v in sorted(
            s["kernels"].items(), key=lambda kv: -kv[1])[:TOP]]
    return out
