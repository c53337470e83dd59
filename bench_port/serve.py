"""One run of a cell: set-up, a pre-roll to steady state, the measured
window, then the check against the plain reference.

The window drives the port's ``DynamicGenerator`` through ``enqueue`` and
``iterate`` with its defaults, as a server does. Clients are closed loops:
each sends its next request as soon as its last one is done. The client
side stamps every token when the ``iterate()`` that handed it over returns,
so queued device work is inside every time it reports.

Set-up is everything from process start to the window's first request:
imports, loading (or, in a fresh checkout, building) the kernels, drawing
the weights, the cache, and a pre-roll of the cell's own traffic to steady
state. The pre-roll ends at the first ``iterate()`` return at which every
client has joined, at least ``preroll_completions`` requests have finished,
and the last ``preroll_quiet`` of them finished with no new decode graph
captured: the batch is full and the decode keys the traffic meets are
held. Prefill keys outnumber their runner's LRU, so prefill captures go on
at their steady rate in the window; the captures of each half of the
window are printed, decode and prefill apart. The window opens at the
return of an ``iterate()`` and closes at the first return at or past its
length; rates are over that span.

With ``trace`` the first TRACE_SECONDS of the window run under
torch.profiler (devtrace.py); the program's counters are read at the
window's ends and at the traced part's.

The process must never load JAX or the JAX package: the check of
``sys.modules`` comes last, after the reference and every metric reader
have run, and a run that finds one raises instead of returning a result.

After the window the program is freed and the reference decodes the same
packed weights, runs each sampled request's prompt and served tokens, and
measures how far below its best logit each served token's logit lies.
"""

from __future__ import annotations

import copy
import gc
import subprocess
import sys
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from bench_port import devtrace, loadgen, spec, weights
from bench_port.reference import common as reference

__all__ = ["Run", "run_cell", "forbidden_modules", "FORBIDDEN"]

TRACE_SECONDS = 8.0
# the pre-roll fails past this: a cell that cannot reach steady state
PREROLL_LIMIT_S = 240.0
FORBIDDEN = ("jax", "jaxlib", "flax", "exllamav2_tpu")
KV_BYTES = {"bf16": 2, "fp8": 1}


@dataclass
class Run:
    """What the metric readers read (metrics/<name>.py)."""
    cell: str
    cfg: dict
    dims: dict
    traffic: dict
    seed: int
    requests: list = field(default_factory=list)
    t0: float = 0.0                 # window, host clock
    t1: float = 0.0
    setup_s: float = 0.0
    c0: dict = field(default_factory=dict)     # program counters at t0, t1
    c1: dict = field(default_factory=dict)
    trace: devtrace.Summary | None = None
    ta: float = 0.0                 # traced part, host clock
    tb: float = 0.0
    ca: dict = field(default_factory=dict)
    cb: dict = field(default_factory=dict)
    readings: dict = field(default_factory=dict)   # gaps, judge()

    @property
    def kv_bytes(self) -> int:
        return KV_BYTES[self.cfg["serving"]["cache_kind"]]


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the port must never load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _counters(gen) -> dict:
    from exllamav2_tpu_torch.ops import paged_attn, qmm
    caps, reps = Counter(), Counter()
    for g in (gen.step_graphs, gen.prefill_graphs):
        if g is not None:
            caps.update(g.captures)
            reps.update(g.replays)
    dec = gen.step_graphs
    return {"qmm": qmm.LAUNCHES["qmm"],
            "qmm_gated": qmm.GATED_LAUNCHES["qmm_gated"],
            "paged_attn": paged_attn.LAUNCHES["paged_decode_attn"],
            "captures": sum(caps.values()),
            "captures_decode": 0 if dec is None else sum(
                dec.captures.values()),
            "replays": dict(reps)}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def card(device) -> dict:
    """Name and power limit of the card (printed beside every number)."""
    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit": "none"}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        lim = out[0].split(",")[-1].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        lim = "unknown"
    return {"name": torch.cuda.get_device_name(device), "power_limit": lim}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _pick(requests, seed: int, want: int) -> list:
    """The finished requests the reference checks: the longest (prompt and
    served tokens), then others drawn from the seed until `want` served
    tokens are in the sample."""
    done = [r for r in requests if r.served is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.served),
                                       r.index))
    pick = [longest]
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    for i in rng.permutation(len(rest)):
        if sum(len(r.served) for r in pick) >= want:
            break
        pick.append(rest[i])
    return pick


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             overrides: dict | None = None,
             cell_spec: dict | None = None) -> dict:
    """One run of cell `name`; returns the result line's object.

    `overrides` merges into the configuration (the control's lower
    precision); `cell_spec` replaces the cell's files (the tests' tiny
    cells)."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = cell_spec or spec.cell(name)
    cfg = _merge(c["config"], overrides or {})
    traffic, limits = c["traffic"], c["limits"]
    dev = torch.device(device)

    from exllamav2_tpu_torch.cache_paged import PAGE_SIZE, PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import (
        DynamicGenerator, DynamicJob)
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.models import forward as F
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    if dev.type == "cuda":
        from exllamav2_tpu_torch import _build
        _build.build_all(("qmm", "paged_attn"))   # both at once, if missing
        torch.cuda.reset_peak_memory_stats(dev)

    serving = cfg["serving"]
    if serving.get("moe_dispatch_min_tokens"):
        F.set_moe_dispatch(min_tokens=int(serving["moe_dispatch_min_tokens"]))
    d = weights.dims(cfg)
    pages = int(traffic["cache_pages"])
    if loadgen.Traffic(traffic, 0, 2).longest_request() \
            > (pages - 1) * PAGE_SIZE:
        raise ValueError(f"{name}: {pages} pages cannot hold the longest "
                         "request")
    packed = weights.draw_packed(cfg, seed, dev)
    gen = DynamicGenerator(
        weights.program_model(cfg, packed, pages * PAGE_SIZE, dev),
        PagedKVCache.alloc(d["layers"], pages, d["kv_heads"], d["head_dim"],
                           serving["cache_kind"], device=dev),
        ByteTokenizer(256))                  # no EOS id: every job runs out
    run = Run(cell=name, cfg=cfg, dims=d, traffic=traffic, seed=seed)
    tr = loadgen.Traffic(traffic, seed, d["vocab"])
    clients = int(traffic["clients"])
    inflight: dict[int, loadgen.Request] = {}

    def send(client: int) -> None:
        req = tr.next_request(client)
        req.t_send = time.perf_counter()
        try:
            req.job = gen.enqueue(DynamicJob(
                req.prompt, max_new_tokens=req.max_new,
                settings=Settings.greedy(), identifier=req.index))
        except (ValueError, AssertionError) as e:
            req.error = f"refused: {e}"
        run.requests.append(req)
        inflight[client] = req

    # clients join `ramp_per_iterate` at a time. This works round a fault of
    # the port, not a property of the traffic: 32 prompts joining at once
    # prefill 32 x 512 rows in one forward, whose attention scores (8 GiB)
    # run the card out of memory (PERF.md, Open questions). It acts only at
    # the pre-roll's start; in the window, finished requests are replaced
    # at once.
    ramp = int(traffic.get("ramp_per_iterate", clients))
    started = min(ramp, clients)
    for cl in range(started):
        send(cl)
    completions, phase = 0, "preroll"
    quiet_need = int(traffic.get("preroll_quiet", 0))
    quiet, decode_caps = 0, _counters(gen)["captures_decode"]
    prof = span = None
    mid = None                                # counters at the window's middle
    while True:
        with record_function("gen.iterate"):
            gen.iterate()
        now = time.perf_counter()
        with record_function("client.stamp"):
            finished = []
            for cl, req in inflight.items():
                job = req.job
                if job is None:
                    finished.append(cl)
                    continue
                n = job.new_tokens
                if n > req.tokens:
                    req.deliveries.append((now, n - req.tokens))
                if job.status == "done":
                    req.served = job.sequence[job.prompt_len:].copy()
                    req.t_done = now
                    req.cached = int(job.reused_tokens)
                    if (len(req.served) != req.max_new
                            or job.eos_reason != "max_new_tokens"):
                        req.error = (f"{len(req.served)} of {req.max_new} "
                                     f"tokens ({job.eos_reason})")
                    finished.append(cl)
            for cl in finished:
                req = inflight.pop(cl)
                if req.served is not None and req.error is None:
                    tr.complete(cl, req)
                else:
                    tr.sessions.pop(cl, None)
                completions += 1
        if phase == "preroll":
            if finished:
                caps = _counters(gen)["captures_decode"]
                quiet = 0 if caps > decode_caps else quiet + len(finished)
                decode_caps = caps
            if (started == clients and quiet >= quiet_need
                    and completions >= int(traffic["preroll_completions"])):
                phase = "window"
                run.t0 = now
                run.setup_s = now - t_start
                run.c0 = _counters(gen)
                if trace:
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    prof.start()
                    span = record_function(devtrace.WINDOW_SPAN)
                    span.__enter__()
                    run.ta, run.ca = time.perf_counter(), _counters(gen)
            elif now - t_start > PREROLL_LIMIT_S:
                raise RuntimeError(f"pre-roll: {completions} requests done "
                                   f"in {PREROLL_LIMIT_S} s")
        else:
            if span is not None and now >= run.ta + TRACE_SECONDS:
                run.tb, run.cb = now, _counters(gen)
                span.__exit__(None, None, None)
                span = None
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof.stop()
            if mid is None and now >= run.t0 + seconds / 2:
                mid = _counters(gen)
            if now >= run.t0 + seconds:
                run.t1 = now
                break
        with record_function("client.send"):
            for cl in range(started):
                if cl not in inflight:
                    send(cl)
            for cl in range(started, min(started + ramp, clients)):
                send(cl)
            started = min(started + ramp, clients)
    run.c1 = _counters(gen)
    if span is not None:                      # the window ended first
        run.tb, run.cb = run.t1, run.c1
        span.__exit__(None, None, None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    mid = mid or run.c1
    halves = {k: (mid[k] - run.c0[k], run.c1[k] - mid[k])
              for k in ("captures_decode", "captures")}
    if prof is not None:
        run.trace = devtrace.summarize(prof)
        del prof

    # the program's state goes before the reference runs
    del gen
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    check = judge(run, packed, limits)
    packed.free()
    window = [r for r in run.requests if run.t0 <= r.t_send < run.t1]
    metrics = {}
    for m in spec.metrics_for(name, trace):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": card(dev)["name"], "count": c["chips"],
                "memory_peak_bytes": int(peak)}
    result = {"correct": all(v["value"] <= v["limit"]
                             for v in check.values()),
              "attempted": len(window),
              "failed": sum(r.error is not None for r in window),
              "metrics": metrics, "device": dev_info}
    if run.trace is not None:
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps}
    result["readings"] = run.readings
    result["check"] = check
    info = card(dev)
    done_in = sum(r.served is not None and run.t0 < r.t_done <= run.t1
                  for r in run.requests)
    _log(f"[bench] {name} seed {seed}: {info['name']}, power limit "
         f"{info['power_limit']}; window {run.t1 - run.t0:.3f} s, "
         f"{len(window)} requests sent in it, {done_in} finished in it; "
         f"setup {run.setup_s:.3f} s; peak {peak} bytes")
    dh, th = halves["captures_decode"], halves["captures"]
    _log(f"[bench] graph captures in the window's first / second half: "
         f"decode {dh[0]} / {dh[1]}, prefill {th[0] - dh[0]} / "
         f"{th[1] - dh[1]}")
    run.requests.clear()
    bad = forbidden_modules()      # last: the reference and readers ran
    if bad:
        raise ImportError(f"loaded in the serving process: {bad}")
    for k, v in check.items():
        _log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return result


def judge(run: Run, packed, limits: dict) -> dict:
    """The numbers compared, each beside its limit: the requests that failed
    or ran short, and the gap by which a sampled served token's logit lies
    below the reference's best logit at its position, as the cell's limits
    file names it: its widest (``max_logit_gap``) or its mean over the
    served tokens (``mean_logit_gap``, where near-ties make the widest a
    matter of chance: PERF.md). The other is printed as a reading."""
    failed = sum(r.error is not None for r in run.requests)
    sample = _pick(run.requests, run.seed, int(run.traffic[
        "check_served_tokens"]))
    vocab = run.dims["vocab"]
    bad_ids = sum(int(((r.served < 0) | (r.served >= vocab)).sum())
                  for r in sample)
    # no sample: every reading fails its limit
    gaps = dict.fromkeys(("max_logit_gap", "mean_logit_gap",
                          "p90_logit_gap", "share_not_best"), 1e30)
    n = sum(len(r.served) for r in sample)
    if sample and not bad_ids:
        t = time.perf_counter()
        g = torch.cat(reference.served_gaps(
            packed, run.dims, run.cfg["family"],
            [(r.prompt, r.served) for r in sample]))
        gaps = {"max_logit_gap": float(g.max()),
                "mean_logit_gap": float(g.mean()),
                "p90_logit_gap": float(torch.quantile(g, 0.9)),
                "share_not_best": float((g > 0).float().mean())}
        _log(f"[bench] reference: {len(sample)} requests, {n} served tokens "
             f"over {sum(len(r.prompt) for r in sample)} prompt tokens in "
             f"{time.perf_counter() - t:.3f} s; gaps: {gaps}")
    run.readings = gaps
    out = {"failed_requests": {"value": failed, "limit": 0},
           "out_of_vocab_tokens": {"value": bad_ids, "limit": 0},
           "served_tokens_short": {
               "value": max(0, int(run.traffic["check_served_tokens"]) - n),
               "limit": 0}}
    for k, v in gaps.items():
        if k in limits:
            out[k] = {"value": v, "limit": float(limits[k])}
    return out
