"""The device trace of part of the window: torch.profiler over CPU and CUDA
activity, read from its raw events (building key_averages()'s tables takes
minutes over 10^6 kernels).

The traced part lies inside the benchmark's own ``record_function`` span
``bench.traced``; the benchmark also names its client code (``client.send``,
``client.stamp``) and each ``gen.iterate`` call, so an idle gap of the card
is named by what the host was doing during it: the benchmark's span, then
the innermost host operation that covers the gap's middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["Summary", "summarize"]

WINDOW_SPAN = "bench.traced"
USER_SPANS = ("gen.iterate", "client.send", "client.stamp")
# gaps shorter than this between device operations are launch spacing
MIN_GAP_NS = 20_000
TOP = 10


@dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)     # name -> seconds
    kernel_n: dict = field(default_factory=dict)     # name -> launches
    idle_gaps: list = field(default_factory=list)    # [name, seconds]

    def seconds(self, *parts: str) -> float:
        """Device seconds of the operations whose names hold any of
        `parts`."""
        return sum(s for n, s in self.kernel_s.items()
                   if any(p in n for p in parts))

    def device_ops(self) -> list:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], s] for n, s in top]


# device activity that is work: kernels, copies and fills (a user span's
# device-side shadow, "gpu_user_annotation", is not)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _is_work(e) -> bool:
    """A device event that is work (older torch has no activity_type)."""
    if e.name() in USER_SPANS or e.name() == WINDOW_SPAN:
        return False
    at = getattr(e, "activity_type", None)
    if at is not None:
        return str(at()) in DEVICE_WORK
    ua = getattr(e, "is_user_annotation", None)
    return not (ua is not None and ua())


def summarize(prof) -> Summary:
    """The Summary of a finished torch.profiler session."""
    win = None
    dev, host, user = [], [], []
    for e in prof.profiler.kineto_results.events():
        if _is_device(e):
            if _is_work(e):
                dev.append((e.start_ns(), e.end_ns(), e.name()))
            continue
        name = e.name()
        if name == WINDOW_SPAN:
            win = (e.start_ns(), e.end_ns())
        elif name in USER_SPANS:
            user.append((e.start_ns(), e.end_ns(), name))
        else:
            host.append((e.start_ns(), e.end_ns(), name))
    out = Summary()
    if win is None:
        return out
    a, b = win
    out.window_s = (b - a) / 1e9
    ks, kn = defaultdict(float), defaultdict(int)
    spans = []
    for s, e, name in dev:
        s, e = max(s, a), min(e, b)
        if e <= s:
            continue
        ks[name] += (e - s) / 1e9
        kn[name] += 1
        spans.append((s, e))
    out.kernel_s, out.kernel_n = dict(ks), dict(kn)
    spans.sort()
    busy, gaps, cur_s, cur_e = 0, [], a, a
    for s, e in spans:
        if s > cur_e:
            busy += cur_e - cur_s
            if s - cur_e >= MIN_GAP_NS:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if b - cur_e >= MIN_GAP_NS:
        gaps.append((cur_e, b))
    out.busy_s = busy / 1e9
    out.idle_gaps = _name_gaps(gaps, host, user)
    return out


def _covering(events, starts, t, back: int = 256):
    """The event of `events` (sorted by start) covering t with the latest
    start, looking back at most `back` events."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - back, -1), -1):
        if events[j][1] >= t:
            return events[j]
    return None


def _name_gaps(gaps, host, user) -> list:
    host.sort()
    user.sort()
    hs = [e[0] for e in host]
    us = [e[0] for e in user]
    by = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:20000]:
        mid = (s + e) // 2
        u = _covering(user, us, mid)
        h = _covering(host, hs, mid)
        name = (u[2] if u else "between spans") + "/" + (h[2] if h
                                                          else "python")
        by[name] += (e - s) / 1e9
    top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return [[n[:160], s] for n, s in top]
