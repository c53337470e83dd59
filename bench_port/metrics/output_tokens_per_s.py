"""Output tokens handed to clients by iterate() returns in the window, over
the window's seconds (host clock)."""

from bench_port.tails import delivered


def read(run):
    return delivered(run.requests, run.t0, run.t1) / (run.t1 - run.t0)
