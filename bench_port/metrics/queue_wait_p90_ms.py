"""90th percentile, over every request sent in the window, of its wait for
admission: the generator's stamps ``time_admitted - time_enqueue`` (a free
slot and free pages; utils/profiling's clock, perf_counter). A request
still waiting when the window closes counts at its wait then. None where
the program stamps no admission."""

from bench_port.tails import percentile


def read(run):
    waits = []
    for r in run.requests:
        if not run.t0 <= r.t_send < run.t1 or r.job is None:
            continue
        admitted = getattr(r.job, "time_admitted", None)
        if admitted is None:
            return None
        end = admitted if 0 < admitted <= run.t1 else run.t1
        waits.append(end - r.job.time_enqueue)
    v = percentile(waits, 90)
    return None if v is None else v * 1e3
