"""Request-scoped spans: the one timing mechanism of the ToHR path.

A request's record (:class:`Trace`) holds its integer id, its spans and their
counters (:meth:`Span.add`; :func:`count` adds to the innermost open span). A
span is ``[name, parent_index, t0_ns, t1_ns]`` (``parent_index`` -1 at the
root, ``t1_ns`` 0 while open), stamped with :func:`time.time_ns`,
the clock of ``torch.profiler``'s host events, so that a span and the device
trace around it line up. :func:`request` opens a record in the current
:mod:`contextvars` context, or joins the one already open there; :func:`span`
appends to it. A thread that works for a request runs in a copy of the
context that started it (``contextvars.copy_context().run``): its spans join
the record, their parent on the other thread.

While a profiler records in the process, a span is also a
``torch.profiler.record_function`` range named ``floodsr.<name>``; with none
recording, no ``RecordFunction`` is built. The record is always kept: a span
costs two clock reads and an append.

Device stages: :class:`StreamClock` takes CUDA event pairs on the current
stream and reads them after the synchronizes the caller already makes; on a
CPU it gives the host time of the spans it is handed. An event pair spans the
stream's wall time between two points, idle gaps between launches included:
it is not the device's busy time.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _autograd_profiler

PROFILER_PREFIX = "floodsr."

_request_ids = itertools.count(1)
#: ``(trace, innermost open span or None)`` of the request open in this context
_current: contextvars.ContextVar = contextvars.ContextVar("floodsr_trace", default=None)


class Span:
    """One timed interval of a request; ``index`` is its place in the record
    (-1 for a span opened with no request open)."""

    __slots__ = ("name", "parent", "index", "t0", "t1", "counters")

    def __init__(self, name: str, parent: int):
        self.name = name
        self.parent = parent
        self.index = -1
        self.t0 = 0
        self.t1 = 0
        self.counters: dict[str, float] | None = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9 if self.t1 else 0.0

    def add(self, name: str, value: float) -> None:
        """Add ``value`` to this span's counter ``name``."""
        if self.counters is None:
            self.counters = {}
        self.counters[name] = self.counters.get(name, 0.0) + value


class Trace:
    """The record of one request: its id and its spans, in the order opened
    (a parent always before its children)."""

    def __init__(self, request: int):
        self.request = int(request)
        self.spans: list[Span] = []
        self._lock = threading.Lock()

    def _add(self, s: Span) -> None:
        with self._lock:
            s.index = len(self.spans)
            self.spans.append(s)

    def _subtree(self, spans: list[Span], root: int) -> set[int]:
        inside = {root}
        for s in spans[root + 1:]:
            if s.parent in inside:
                inside.add(s.index)
        return inside

    def totals(self, root: Span) -> tuple[dict[str, float], dict[str, float]]:
        """Seconds by span name and counters, summed over the spans beneath
        ``root`` (``root`` itself left out of the seconds)."""
        with self._lock:
            spans = list(self.spans)
        seconds: dict[str, float] = {}
        counters: dict[str, float] = {}
        for i in sorted(self._subtree(spans, root.index)):
            s = spans[i]
            if i != root.index:
                seconds[s.name] = seconds.get(s.name, 0.0) + s.seconds
            for k, v in (s.counters or {}).items():
                counters[k] = counters.get(k, 0.0) + v
        return seconds, counters

    def export(self, root: Span) -> dict:
        """``root``'s view of the request, as plain data: every span but those
        beneath another span named as ``root`` under the same parent (a
        batch's other jobs), and the counters summed over ``root``'s subtree.
        """
        with self._lock:
            spans = list(self.spans)
        dropped: set[int] = set()
        kept: dict[int, int] = {}
        for s in spans:
            if s.index != root.index and (
                s.parent in dropped or (s.name == root.name and s.parent == root.parent)
            ):
                dropped.add(s.index)
            else:
                kept[s.index] = len(kept)
        counters: dict[str, float] = {}
        for i in sorted(self._subtree(spans, root.index)):
            for k, v in (spans[i].counters or {}).items():
                counters[k] = counters.get(k, 0.0) + float(v)
        return {
            "request": self.request,
            "spans": [
                [spans[i].name, kept.get(spans[i].parent, -1), spans[i].t0, spans[i].t1]
                for i in kept
            ],
            "counters": counters,
        }


def current() -> Trace | None:
    """The record of the request open in this context, or None."""
    cur = _current.get()
    return cur[0] if cur is not None else None


def count(name: str, value: float = 1) -> None:
    """Add ``value`` to counter ``name`` of the innermost span open in this
    context; nothing with no request open."""
    cur = _current.get()
    if cur is not None and cur[0] is not None and cur[1] is not None:
        cur[1].add(name, value)


@contextmanager
def request():
    """The record of the request open in this context; opens one with a new
    id when none is, and closes it on exit."""
    cur = _current.get()
    if cur is not None and cur[0] is not None:
        yield cur[0]
        return
    trace = Trace(next(_request_ids))
    token = _current.set((trace, None))
    try:
        yield trace
    finally:
        _current.reset(token)


@contextmanager
def span(name: str):
    """Time the block as span ``name`` of the open request (yields the
    :class:`Span`; kept by no record when no request is open)."""
    cur = _current.get()
    trace, parent = cur if cur is not None else (None, None)
    s = Span(name, parent.index if parent is not None else -1)
    if trace is not None:
        trace._add(s)
    token = _current.set((trace, s))
    rf = None
    s.t0 = time.time_ns()
    if _autograd_profiler._is_profiler_enabled:
        rf = torch.profiler.record_function(PROFILER_PREFIX + name)
        rf.__enter__()
    try:
        yield s
    finally:
        if rf is not None:
            rf.__exit__(None, None, None)
        s.t1 = time.time_ns()
        _current.reset(token)


class StreamClock:
    """The current stream's wall time between two points, from CUDA event
    pairs (``enable_timing``); host time on a CPU.

    ``mark()`` records a point on the stream; ``seconds(start, end, *spans)``
    is the stream's time between two marks, read once the stream has passed
    ``end`` (after a synchronize the caller makes anyway: the event wait then
    returns at once). Where the host launches slower than the device runs,
    or waits on the device between the marks, that time is close to the
    host's. On a CPU it is the host time of ``spans``.
    """

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def mark(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def seconds(self, start, end, *spans: Span) -> float:
        if not self.cuda:
            return sum(s.seconds for s in spans)
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
