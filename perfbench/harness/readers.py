"""What the metric readers (``metrics/<name>.py``) share: the run's jobs,
calls and trace, reduced. A reader returns None where it finds nothing to read.

``run`` carries ``calls`` (one per request: ``t0``, ``t1``, ``latency_s``,
``jobs``, ``results``), ``jobs`` (``(job, result)`` of every job that
completed), ``window_s``, ``setup_s``, ``trace`` (None without ``--trace 1``),
``cfg``, ``mix``, ``geometry``, and the family's ``arch`` and
``windows_per_job`` (None for a family without windows).
"""

from __future__ import annotations

import numpy as np


def completed_mp(run) -> float:
    h, w = run.geometry["hr_shape"]
    return len(run.jobs) * h * w / 1e6


def mean_stage_ms(run, key: str) -> float | None:
    """Mean over completed jobs of the worker's ``scene_timings[key]``, in ms."""
    vals = [r["scene_timings"][key] for _, r in run.jobs if key in r.get("scene_timings", {})]
    return 1e3 * float(np.mean(vals)) if vals else None


def device_idle_pct(run) -> float | None:
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / (run.trace["window_us"] * 1e-6))


def device_seconds(run, fragments: tuple[str, ...]) -> float:
    """Device time of the traced kernels whose name holds one of ``fragments``."""
    return sum(v for k, v in run.trace["device_s_by_name"].items() if any(f in k for f in fragments))


def peak_flops(run) -> float:
    from perfbench.harness import work  # the ResUNet's shapes: not loaded for other families

    return work.PEAK_FLOPS[run.cfg["policy"]["compute_dtype"]]
