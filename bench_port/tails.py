"""Percentiles, rates and spreads: the arithmetic of the end-to-end metrics.

A tail is the nearest-rank percentile over every sample, never a median of
pieces. A spread is the distance between the first and third quartile (as
``statistics.quantiles(values, n=4)`` gives them) over the median.
"""

from __future__ import annotations

import math
import statistics

__all__ = ["percentile", "spread", "ttft_samples", "tpot_samples",
           "delivered"]


def percentile(values, p: float) -> float | None:
    """Nearest-rank p-th percentile (p in (0, 100]); None when empty."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def spread(values) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def ttft_samples(requests, t0: float, t1: float) -> list[float]:
    """Seconds to the first token of every request sent in [t0, t1): to the
    return of the iterate() that handed it over, or, for one still waiting
    at t1, the time it had waited by then."""
    out = []
    for r in requests:
        if t0 <= r.t_send < t1:
            first = r.t_first
            out.append((first if first is not None and first <= t1
                        else t1) - r.t_send)
    return out


def tpot_samples(requests, t0: float, t1: float) -> list[float]:
    """Seconds per output token after the first, (last - first) / (n - 1),
    of every request whose last token came in (t0, t1]."""
    out = []
    for r in requests:
        if (r.served is not None and t0 < r.t_last <= t1
                and r.tokens > 1):
            out.append((r.t_last - r.t_first) / (r.tokens - 1))
    return out


def delivered(requests, t0: float, t1: float) -> int:
    """Output tokens handed over by iterate() returns in (t0, t1]."""
    return sum(n for r in requests for t, n in r.deliveries if t0 < t <= t1)
