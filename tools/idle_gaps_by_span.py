"""Name the card's idle gaps of a traced benchmark run by the port's own
spans, with no lookback limit.

    python3 tools/idle_gaps_by_span.py --workload mistral-7b.chat \
        --seed 7 [--seconds 51] [--out gaps.jsonl]

Runs one cell of the port's benchmark (bench_port/serve.run_cell) with its
trace on. Where the benchmark summarizes the trace (bench_port/devtrace.py),
this script takes the same idle gaps of the card from the same events and
names each twice: as devtrace names it (the benchmark's span, then the
innermost host event that devtrace's lookback of 256 events finds), and by
the innermost record of the port's spans that covers the gap's middle
(utils/profiling.spans, mapped onto the profiler's clock by
to_profiler_ns; the records' parent links find it however far back it
started). Prints one JSON line, and appends it to --out: the run's
metrics, devtrace's named gaps, and for the gaps devtrace names
``gen.iterate/python`` their seconds by innermost program span
(``by_span``) and the seconds inside a ``graphs.capture.*`` record
(``in_capture_s``); ``map_error_us`` compares the mapped starts of the
records with the profiler's events of the same names.
"""

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVTRACE_NAME = "gen.iterate/python"


def _gaps(dev, a, b, min_gap):
    """devtrace.summarize's idle gaps: device work merged inside [a, b]."""
    spans = sorted((max(s, a), min(e, b)) for s, e in dev if min(e, b) >
                   max(s, a))
    gaps, cur_e = [], a
    for s, e in spans:
        if s > cur_e:
            if s - cur_e >= min_gap:
                gaps.append((cur_e, s))
            cur_e = e
        else:
            cur_e = max(cur_e, e)
    if b - cur_e >= min_gap:
        gaps.append((cur_e, b))
    return gaps


def _innermost(rows, starts, off, t):
    """The innermost record covering t: the last one started by t, or one
    of its parents (spans nest)."""
    i = bisect.bisect_right(starts, t) - 1
    r = rows[i][1] if i >= 0 else None
    while r is not None and r.end_ns + off < t:
        r = r.parent
    return r


def gaps_by_span(prof, devtrace, profiling) -> dict:
    """The named gaps of a finished torch.profiler session, as above."""
    win, dev, host, user = None, [], [], []
    starts = defaultdict(list)                # kineto starts by span name
    for e in prof.profiler.kineto_results.events():
        if devtrace._is_device(e):
            if devtrace._is_work(e):
                dev.append((e.start_ns(), e.end_ns()))
            continue
        name = e.name()
        if name == devtrace.WINDOW_SPAN:
            win = (e.start_ns(), e.end_ns())
        elif name in devtrace.USER_SPANS:
            user.append((e.start_ns(), e.end_ns(), name))
        else:
            host.append((e.start_ns(), e.end_ns(), name))
            if name.startswith(("dyn.", "graphs.")):
                starts[name].append(e.start_ns())
    if win is None:
        return {}
    a, b = win
    off = profiling.to_profiler_ns(0)
    recs = [r for r in profiling.spans(0.0, time.perf_counter())
            if r.end_ns + off >= a and r.start_ns + off <= b]
    rows = sorted(((r.start_ns + off, r) for r in recs),
                  key=lambda x: x[0])
    rstarts = [x[0] for x in rows]
    errs = []
    for name in {r.name for r in recs}:
        mine = sorted(r.start_ns + off for r in recs if r.name == name)
        theirs = sorted(t for t in starts[name] if a <= t <= b)
        if len(mine) == len(theirs):
            errs += [abs(x - y) / 1e3 for x, y in zip(mine, theirs)]
    host.sort()
    user.sort()
    hs, us = [e[0] for e in host], [e[0] for e in user]
    named, by_span, by_span_all = (defaultdict(float) for _ in range(3))
    in_capture = 0.0
    gaps = sorted(_gaps(dev, a, b, devtrace.MIN_GAP_NS),
                  key=lambda g: g[0] - g[1])[:20000]
    for s, e in gaps:
        mid, sec = (s + e) // 2, (e - s) / 1e9
        u = devtrace._covering(user, us, mid)
        h = devtrace._covering(host, hs, mid)
        dname = (u[2] if u else "between spans") + "/" + (h[2] if h
                                                           else "python")
        named[dname] += sec
        r = _innermost(rows, rstarts, off, mid)
        rname = r.name if r is not None else "none"
        by_span_all[rname] += sec
        if dname != DEVTRACE_NAME:
            continue
        by_span[rname] += sec
        p = r
        while p is not None and not p.name.startswith("graphs.capture"):
            p = p.parent
        if p is not None:
            in_capture += sec

    def top(d):
        return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])

    return {"window_s": (b - a) / 1e9, "records": len(recs),
            "map_error_us": {"n": len(errs),
                             "p50": statistics.median(errs) if errs else None,
                             "max": max(errs) if errs else None},
            "devtrace_named": top(named)[:10],
            "python_s": named.get(DEVTRACE_NAME, 0.0),
            "in_capture_s": in_capture, "by_span": top(by_span),
            "all_gaps_by_span": top(by_span_all)[:10]}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    sys.path.insert(0, ROOT)

    import torch
    from bench_port import devtrace, serve, spec
    from exllamav2_tpu_torch.utils import profiling

    found = {}
    summarize = devtrace.summarize

    def summarize_and_name(prof):
        found.update(gaps_by_span(prof, devtrace, profiling))
        return summarize(prof)

    devtrace.summarize = summarize_and_name
    torch.set_num_threads(2)
    result = serve.run_cell(args.workload, args.seed, args.seconds, True,
                            device="cuda", t_start=t_start,
                            cell_spec=spec.cell(args.workload))
    line = json.dumps({"workload": args.workload, "seed": args.seed,
                       "correct": result["correct"],
                       "metrics": {k: v["value"]
                                   for k, v in result["metrics"].items()},
                       **found})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
