"""Profiling helpers (counterpart of exllamav2_tpu/utils/profiling.py).

`trace(logdir)` captures a torch.profiler trace of the enclosed region, host
and card, and writes it as a Chrome trace into `logdir` (open it in Perfetto or
chrome://tracing).

`span(name)` marks a region of the program. While no torch.profiler session
runs, a span costs one check of the profiler's state and records nothing.
While one runs, the span enters `torch.profiler.record_function(name)`, so it
shows on the trace's timeline beside the card's kernels, and appends a
`Record` to a bounded ring in memory: its name, its start and end on the
`time.perf_counter_ns()` clock (the clock of the generator's job stamps),
the span it ran inside and the integer counts its caller set. `spans(t0,
t1)` returns the records that ended in an interval of that clock. The
profiler's own events read another clock (the Unix epoch, in ns);
`to_profiler_ns` maps a record's time onto it, to find the events and the
card's idle gaps that a record covers.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

import torch

__all__ = ["trace", "span", "spans", "to_profiler_ns", "Record", "RING_SIZE"]

RING_SIZE = 65_536

_enabled = torch._C._autograd._profiler_enabled
_RING: deque = deque(maxlen=RING_SIZE)
_LOCAL = threading.local()          # .stack: the open records of a thread


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed region:

        with profiling.trace("traces"):
            generator.iterate()

    Yields the torch.profiler.profile object (its key_averages() hold the
    device time by kernel); the Chrome trace lands in `logdir` on exit."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.time_ns()}.json"))


class Record:
    """One span that ran under a profiler. Times are perf_counter_ns."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "counts")
    on = True

    def __init__(self, name: str, start_ns: int = 0, end_ns: int = 0,
                 parent: "Record | None" = None, counts: dict | None = None):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.parent = parent
        self.counts = {} if counts is None else counts

    def count(self, **counts: int) -> None:
        """Set integer counts of the work this span did."""
        self.counts.update(counts)

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"counts={self.counts})")


class _Off:
    """What a span yields while no profiler runs. Its `on` is False, so a
    caller computes its counts only where they are recorded."""

    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("record", "_rf")

    def __init__(self, name: str):
        self.record = Record(name)

    def __enter__(self) -> Record:
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        rec = self.record
        if stack:
            rec.parent = stack[-1]
        self._rf = torch.profiler.record_function(rec.name)
        self._rf.__enter__()
        stack.append(rec)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> None:
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        _LOCAL.stack.pop()
        self._rf.__exit__(*exc)
        _RING.append(rec)


def span(name: str):
    """A named region (context manager) yielding its record: a `Record`
    under a profiler, on which the caller may set counts
    (`if rec.on: rec.count(rows=...)`), else an object that records
    nothing."""
    if not _enabled():
        return _OFF
    return _Span(name)


def spans(t0: float, t1: float) -> list[Record]:
    """The records in the ring that ended in [t0, t1] (seconds of
    time.perf_counter()), oldest end first."""
    lo, hi = int(t0 * 1e9), int(t1 * 1e9)
    return [r for r in list(_RING) if lo <= r.end_ns <= hi]


def to_profiler_ns(t_ns: int) -> int:
    """A perf_counter_ns reading on the clock of the profiler's events.
    The two clocks are read together at the call; they drift apart only by
    the system clock's slew (microseconds a second), so map a session's
    records soon after it."""
    return t_ns - time.perf_counter_ns() + time.time_ns()
