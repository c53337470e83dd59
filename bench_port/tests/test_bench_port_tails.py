"""The tail and rate arithmetic of the end-to-end metrics."""

import numpy as np

from bench_port import tails
from bench_port.loadgen import Request


def _req(t_send, deliveries, done=True):
    r = Request(index=0, session=0, turn=0,
                prompt=np.zeros(4, np.int32), max_new=sum(n for _, n in
                                                          deliveries) or 1)
    r.t_send = t_send
    r.deliveries = list(deliveries)
    if done:
        r.served = np.zeros(r.tokens, np.int32)
    return r


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert tails.percentile(v, 90) == 90
    assert tails.percentile(v, 100) == 100
    assert tails.percentile([5.0], 90) == 5.0
    assert tails.percentile([], 90) is None
    assert tails.percentile(list(range(1, 12)), 90) == 10


def test_a_stall_shows_in_the_ttft_tail():
    reqs = [_req(10.0 + i * 0.1, [(10.5 + i * 0.1, 3)]) for i in range(17)]
    base = tails.percentile(tails.ttft_samples(reqs, 10.0, 20.0), 90)
    assert abs(base - 0.5) < 1e-9
    # three requests never answered by the window's end count at their
    # wait: 3 of 20 lie past the 90th percentile, which rises to the least
    stalled = reqs + [_req(11.0, [], done=False), _req(11.5, [], done=False),
                      _req(12.0, [], done=False)]
    got = tails.percentile(tails.ttft_samples(stalled, 10.0, 20.0), 90)
    assert abs(got - 8.0) < 1e-9
    # a first token after the window's end counts at the wait until it
    late = reqs + [_req(11.0, [(25.0, 1)]), _req(11.2, [(26.0, 1)]),
                   _req(11.4, [(27.0, 1)])]
    got = tails.percentile(tails.ttft_samples(late, 10.0, 20.0), 90)
    assert abs(got - 8.6) < 1e-9
    # requests sent before the window do not count
    early = reqs + [_req(5.0, [(15.0, 1)])]
    assert tails.ttft_samples(early, 10.0, 20.0) == tails.ttft_samples(
        reqs, 10.0, 20.0)


def test_tpot_over_requests_finished_in_the_window():
    r1 = _req(10.0, [(11.0, 1), (12.0, 8), (13.0, 1)])     # 10 tokens, 2 s
    r2 = _req(9.0, [(9.5, 1), (10.5, 4)])                  # ends in window
    r3 = _req(15.0, [(19.0, 1), (21.0, 4)])                # ends after it
    r4 = _req(15.0, [(16.0, 1)])                           # one token
    got = tails.tpot_samples([r1, r2, r3, r4], 10.0, 20.0)
    assert sorted(got) == sorted([2.0 / 9, 1.0 / 4])


def test_delivered_counts_returns_inside_the_window():
    r = _req(0.0, [(9.0, 5), (10.0, 2), (15.0, 8), (20.0, 3), (20.5, 1)])
    assert tails.delivered([r], 10.0, 20.0) == 8 + 3


def test_spread_is_interquartile_over_median():
    assert abs(tails.spread([1.0, 1.0, 1.0, 1.0]) - 0.0) < 1e-12
    v = [98.0, 99.0, 100.0, 101.0, 102.0, 100.0]
    import statistics
    q = statistics.quantiles(v, n=4)
    assert tails.spread(v) == (q[2] - q[0]) / q[1]
