"""90th percentile, over every request whose last token came in the window,
of (last delivery - first delivery) / (tokens - 1)."""

from bench_port.tails import percentile, tpot_samples


def read(run):
    v = percentile(tpot_samples(run.requests, run.t0, run.t1), 90)
    return None if v is None else v * 1e3
