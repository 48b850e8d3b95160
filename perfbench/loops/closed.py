"""One caller in a closed loop: the next call is sent when the last returns,
until ``seconds`` have passed; the call running then completes and closes
the window.

A loop (``traffic/<mix>.json`` ``loop``) is ``drive(send, seconds, step)``:
``send(index)`` makes the call whose first job is the window's ``index``-th
and returns its record (``t0``, ``t1``, ``latency_s``, ``jobs``,
``results``); ``step`` is the jobs a call carries. It returns the records in
the order the calls were sent.
"""

from __future__ import annotations

import time


def drive(send, seconds: float, step: int) -> list[dict]:
    deadline = time.perf_counter() + seconds
    calls, i = [], 0
    while True:
        calls.append(send(i))
        i += step
        if calls[-1]["t1"] >= deadline:
            return calls
