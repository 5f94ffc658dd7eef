"""The reduction of one profiled slice (torch.profiler's CUDA activity:
device operations and the CUDA runtime calls on the host) to what the
per-layer metrics and the breakdown read: device operations, their union
in time, the slice's length, kernel time by class, the costliest
operations and the longest idle gaps, each named by the host call running
in it (a CUDA runtime call, or "host" where none was: Python between
launches) and the device operation that ended it.

Times come from the trace itself: the slice runs from its first event's
start to its last event's end; `busy_s` is the union of the device
operations' intervals, so streams that overlap are not counted twice.
`profiler_idle_s` is the part of the slice in which the device was idle
while the host was in the profiler's own work (`PROFILER_OPS`: fetching
a new activity buffer), which an untraced run does not have.
"""

from __future__ import annotations

import bisect
import time

from torch.autograd import DeviceType

from kernel_classes import kernel_class

# host events of the profiler itself, not of the program
PROFILER_OPS = ("Activity Buffer Request",)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """The length of the intersection of two sorted, disjoint lists of
    [start, end] intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(prof, top: int = 10) -> dict:
    """A summary of `prof` (a finished torch.profiler.profile)."""
    t0 = time.perf_counter()
    events = prof.events()
    parse_s = time.perf_counter() - t0
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    if not dev:
        return {"launches": 0, "parse_s": parse_s}
    start = min([d[0] for d in dev] + [h[0] for h in host])
    end = max([d[1] for d in dev] + [h[1] for h in host])
    dev.sort()
    busy = _merge([(s, e) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in busy)
    by_name, by_class = {}, {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + (e - s)
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])]
    idle = ([[start, busy[0][0]]] + [[a, b] for _, a, b in gaps]
            + [[busy[-1][1], end]])
    own = _merge([(s, e) for s, e, n in host if n in PROFILER_OPS])
    gaps = sorted(gaps, reverse=True)[:top]
    dev_starts = [d[0] for d in dev]
    host.sort()
    starts = [h[0] for h in host]

    def host_op(t):
        """The innermost host op running at time t (latest start <= t
        whose end is after t)."""
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            if host[i][1] > t:
                return host[i][2]
            i -= 1
        return "host"

    return {
        "launches": len(dev),
        "window_s": (end - start) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "profiler_idle_s": overlap(idle, own) * 1e-6,
        "by_class_s": {k: v * 1e-6 for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "device_ops": [[n[:120], v * 1e-6] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[(host_op(a + 0.5 * (b - a)) + " -> " + dev[
            bisect.bisect_left(dev_starts, b)][2])[:120], g * 1e-6]
            for g, a, b in gaps],
        "parse_s": parse_s,
        "reduce_s": time.perf_counter() - t0,
    }
