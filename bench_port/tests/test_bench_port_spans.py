"""The readers of the program's spans and job stamps (queue_wait_p90_ms,
prefill_pad_share, iterate_host_ms) on hand-built runs whose records and
stamps are known."""

import os
import sys
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

from bench_port import spec
from bench_port.loadgen import Request
from bench_port.serve import Run
from exllamav2_tpu_torch.utils import profiling

S = 1_000_000_000          # ns a second


def _run(**kw) -> Run:
    run = Run(cell="hand", cfg={}, dims={}, traffic={}, seed=0)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _req(t_send, job):
    r = Request(index=0, session=0, turn=0, prompt=np.zeros(4, np.int32),
                max_new=1)
    r.t_send = t_send
    r.job = job
    return r


def _job(enqueue, admitted):
    return SimpleNamespace(time_enqueue=enqueue, time_admitted=admitted)


@pytest.fixture
def ring(monkeypatch):
    r = deque(maxlen=profiling.RING_SIZE)
    monkeypatch.setattr(profiling, "_RING", r)
    return r


def test_queue_wait_counts_a_request_pending_at_the_close():
    t0, t1 = 100.0, 110.0
    waits = [0.001 * (i + 1) for i in range(8)]      # 1 .. 8 ms
    reqs = [_req(t0 + i, _job(t0 + i + 1e-4, t0 + i + 1e-4 + w))
            for i, w in enumerate(waits)]
    # still waiting at the close: counts at its wait then, 0.5 s
    reqs.append(_req(109.5, _job(109.5, 0.0)))
    # before the window, and refused at enqueue: neither counts
    reqs.append(_req(99.0, _job(99.0, 105.0)))
    reqs.append(_req(101.0, None))
    run = _run(requests=reqs, t0=t0, t1=t1)
    # nine samples: nearest rank ceil(0.9 x 9) = 9, the largest
    got = spec.reader("queue_wait_p90_ms")(run)
    assert got == pytest.approx(500.0)
    # without the pending one, the 8th of 8: ceil(7.2) = 8 -> 8 ms
    run.requests = reqs[:8]
    assert spec.reader("queue_wait_p90_ms")(run) == pytest.approx(8.0)


def test_queue_wait_is_none_without_admission_stamps():
    job = SimpleNamespace(time_enqueue=100.5)          # an older program
    run = _run(requests=[_req(100.5, job)], t0=100.0, t1=110.0)
    assert spec.reader("queue_wait_p90_ms")(run) is None
    assert spec.reader("queue_wait_p90_ms")(_run(t0=1.0, t1=2.0)) is None


def test_prefill_pad_share_over_the_traced_part(ring):
    ring.extend([
        profiling.Record("dyn.prefill", 9 * S, 9 * S + 5,
                         counts={"rows": 1, "rows_computed": 1000}),
        profiling.Record("dyn.prefill", 10 * S, 10 * S + 5,
                         counts={"rows": 59, "rows_computed": 256}),
        profiling.Record("dyn.decode", 11 * S, 11 * S + 5,
                         counts={"rows": 3, "rows_computed": 4, "steps": 1}),
        profiling.Record("dyn.prefill", 12 * S, 12 * S + 5,
                         counts={"rows": 39, "rows_computed": 64}),
    ])
    run = _run(ta=9.5, tb=12.5)
    want = 100.0 * (1 - (59 + 39) / (256 + 64))
    assert spec.reader("prefill_pad_share")(run) == pytest.approx(want)
    assert spec.reader("prefill_pad_share")(_run(ta=20.0, tb=30.0)) is None


def test_iterate_host_time_less_the_card_and_the_graph_runner(ring):
    # iterate A: 10 ms; a prefill of 2 ms holding a capture of 1.5 ms; a
    # decode holding an input load of 1 ms, a launch of 0.5 ms and two
    # readbacks of 2 and 1 ms; a span nested in the capture (never
    # subtracted twice). Iterate B: 4 ms, no wait. Iterate C ends after
    # the traced part.
    ms = 1_000_000
    t = 10 * S
    a = profiling.Record("dyn.iterate", t, t + 10 * ms)
    pre = profiling.Record("dyn.prefill", t, t + 2 * ms, parent=a)
    cap = profiling.Record("graphs.capture.prefill", t, t + 3 * ms // 2,
                           parent=pre)
    inner = profiling.Record("graphs.load", t, t + ms, parent=cap)
    dec = profiling.Record("dyn.decode", t + 2 * ms, t + 9 * ms, parent=a)
    load = profiling.Record("graphs.load", t + 2 * ms, t + 3 * ms,
                            parent=dec)
    launch = profiling.Record("graphs.replay", t + 3 * ms,
                              t + 7 * ms // 2, parent=dec)
    r1 = profiling.Record("dyn.readback", t + 4 * ms, t + 6 * ms,
                          parent=dec)
    r2 = profiling.Record("dyn.readback", t + 7 * ms, t + 8 * ms,
                          parent=dec)
    emit = profiling.Record("dyn.emit", t + 8 * ms, t + 9 * ms, parent=dec)
    b = profiling.Record("dyn.iterate", 11 * S, 11 * S + 4 * ms)
    c = profiling.Record("dyn.iterate", 12 * S, 13 * S)
    rc = profiling.Record("dyn.readback", 12 * S, 12 * S + 1_000,
                          parent=c)
    ring.extend([inner, cap, pre, load, launch, r1, r2, emit, dec, a, b,
                 rc, c])
    run = _run(ta=9.0, tb=12.5)
    # A: 10 - 1.5 - 1 - 0.5 - 2 - 1 = 4 ms; B: 4 ms
    assert spec.reader("iterate_host_ms")(run) == pytest.approx(4.0)
    assert spec.reader("iterate_host_ms")(_run(ta=20.0, tb=30.0)) is None


@pytest.mark.parametrize("metric", ["prefill_pad_share", "iterate_host_ms"])
def test_span_readers_are_none_on_a_program_without_spans(monkeypatch,
                                                          metric):
    monkeypatch.delattr(profiling, "spans")
    assert spec.reader(metric)(_run(ta=0.0, tb=1e9)) is None


def test_capture_span_found_past_devtraces_lookback():
    """A gap deep inside a graph capture: devtrace's 256-event lookback ends
    in the capture's own host events and names the gap ``python``; the
    records' parent links reach the ``graphs.capture.prefill`` record
    (tools/idle_gaps_by_span.py)."""
    sys.path.insert(0, os.path.join(os.path.dirname(spec.__file__),
                                    "..", "tools"))
    from bench_port import devtrace
    from idle_gaps_by_span import _innermost
    it = profiling.Record("dyn.iterate", 0, 10_000)
    pre = profiling.Record("dyn.prefill", 10, 9_000, parent=it)
    cap = profiling.Record("graphs.capture.prefill", 20, 8_000, parent=pre)
    # 300 short host operations of the capture, all ended before the gap
    host = [(100 + 10 * i, 105 + 10 * i, "aten::op") for i in range(300)]
    host.insert(0, (20, 8_000, "graphs.capture.prefill"))
    mid = 5_000
    assert devtrace._covering(host, [h[0] for h in host], mid) is None
    rows = [(r.start_ns, r) for r in (it, pre, cap)]
    got = _innermost(rows, [x[0] for x in rows], 0, mid)
    assert got is cap
    assert _innermost(rows, [x[0] for x in rows], 0, 8_500) is pre
