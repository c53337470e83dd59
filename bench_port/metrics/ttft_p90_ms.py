"""90th percentile, over every request sent in the window, of the time from
its send to the return of the iterate() that handed over its first token;
a request still waiting when the window closes counts at its wait."""

from bench_port.tails import percentile, ttft_samples


def read(run):
    v = percentile(ttft_samples(run.requests, run.t0, run.t1), 90)
    return None if v is None else v * 1e3
