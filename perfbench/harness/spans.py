"""What the span readers (``metrics/<name>.py``) share: a job's record of
request-scoped spans, ``scene_timings["trace"]`` of its result (the program's
``floodsr_tpu_torch/tracing.py``).

A record is ``{"request": id, "spans": [[name, parent_index, t0_ns, t1_ns],
...], "counters": {...}}``: parents before children, -1 at the root, ``t1_ns``
0 for a span still open when the record was taken. A program without such
records gives None, and the metric is left out of the line.
"""

from __future__ import annotations


def record(result: dict) -> dict | None:
    """The job's record of spans, or None."""
    rec = (result.get("scene_timings") or {}).get("trace")
    return rec if isinstance(rec, dict) and isinstance(rec.get("spans"), list) else None


def span_ms(result: dict, name: str, self_time: bool = False) -> float | None:
    """Milliseconds of every closed span called ``name`` in the job's record,
    summed (0.0 where it has none); with ``self_time`` each less the time of
    its own children. None without a record."""
    rec = record(result)
    if rec is None:
        return None
    spans = rec["spans"]

    def ns(s) -> int:
        return s[3] - s[2] if s[3] else 0

    total = 0
    for i, s in enumerate(spans):
        if s[0] != name:
            continue
        total += ns(s)
        if self_time:
            total -= sum(ns(c) for c in spans[i + 1:] if c[1] == i)
    return total * 1e-6


def mean_ms(run, per_job) -> float | None:
    """Mean of ``per_job(result)`` over the window's completed jobs that give
    a number; None if none does."""
    vals = [v for v in (per_job(r) for _, r in run.jobs) if v is not None]
    return sum(vals) / len(vals) if vals else None
