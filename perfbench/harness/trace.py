"""The traced window: ``torch.profiler`` over it, reduced to what the metrics read.

Device time is taken from device-side events only (kernels, copies, memsets):
an operator's own row repeats the time of the kernels it launched. Busy time
is the union of those events' intervals inside the window. Idle gaps are the
holes in that union, each named by the harness span open at its middle (with
the middle's offset into that span) and by the innermost host operator the
profiler saw running there, if any.
"""

from __future__ import annotations

import bisect
from contextlib import contextmanager

SPAN_PREFIX = "perfbench."


@contextmanager
def traced():
    """Profile the block (host and device); yields a dict filled on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    out.update(reduce(prof))


def span(name: str):
    """A harness span, visible in the trace as a host annotation."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def reduce(prof) -> dict:
    """Reads the profiler's raw events (``kineto_results``): building its
    ``FunctionEvent`` tree for a window of tens of seconds takes minutes."""
    from torch.autograd import DeviceType

    return summarize(
        (e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name(), e.device_type() == DeviceType.CUDA)
        for e in prof.profiler.kineto_results.events()
    )


def summarize(events) -> dict:
    """``events``: ``(start_us, end_us, name, on_device)``. Device busy time,
    device time by name, the largest device operations and idle gaps."""
    device, host, spans = [], [], []
    for t0, t1, name, on_device in events:
        if t1 <= t0:
            continue
        if on_device:
            device.append((t0, t1, name))
        elif name.startswith(SPAN_PREFIX):
            spans.append((t0, t1, name[len(SPAN_PREFIX):]))
        else:
            host.append((t0, t1, name))
    if not device:
        raise RuntimeError("the profiler recorded no device events in the window")
    if spans:
        lo = min(s[0] for s in spans)
        hi = max(s[1] for s in spans)
    else:
        lo, hi = min(d[0] for d in device), max(d[1] for d in device)
    by_name: dict[str, float] = {}
    intervals = []
    for t0, t1, name in device:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) * 1e-6
        a, b = max(t0, lo), min(t1, hi)
        if b > a:
            intervals.append((a, b))
    intervals.sort()
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]

    def name_gap(a: float, b: float) -> str:
        mid = 0.5 * (a + b)
        open_span = next((f"{s[2]} +{(mid - s[0]) * 1e-6:.3f} s" for s in spans if s[0] <= mid <= s[1]),
                         "between requests")
        best = None
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            h = host[i]
            if mid - h[0] > 2e6:
                break
            if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                best = h
        return f"{open_span} / {best[2]}" if best else f"{open_span} / no host operator"

    return {
        "window_us": hi - lo,
        "busy_s": busy_us * 1e-6,
        "device_s_by_name": by_name,
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[name_gap(a, b), (b - a) * 1e-6] for a, b in gaps[:10]],
    }
