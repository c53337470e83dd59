"""Seconds from process start to the window's first request: imports, the
kernels (built in a fresh checkout), weights, cache and the pre-roll that
captures the traffic's step graphs."""


def read(run):
    return run.setup_s
