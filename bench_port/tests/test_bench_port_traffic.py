"""The traffic generator: the same requests for a seed, the stated sizes for
every seed (only their order differs), sessions as the mix describes."""

import numpy as np
import pytest

from bench_port import loadgen, spec


def _mix(name):
    return spec.load("traffic", name)


def _drain(tr, n, served=8):
    out = []
    for _ in range(n):
        r = tr.next_request(0)
        r.served = np.arange(served, dtype=np.int32)
        tr.complete(0, r)
        out.append(r)
    return out


@pytest.mark.parametrize("mix", ["chat", "stream"])
def test_same_seed_same_requests(mix):
    a = _drain(loadgen.Traffic(_mix(mix), 2 ** 31 + 12345, 32000), 40)
    b = _drain(loadgen.Traffic(_mix(mix), 2 ** 31 + 12345, 32000), 40)
    for x, y in zip(a, b):
        assert x.max_new == y.max_new
        np.testing.assert_array_equal(x.prompt, y.prompt)
    c = _drain(loadgen.Traffic(_mix(mix), 7, 32000), 40)
    # another seed: the same sizes in the same order, other token ids
    assert [x.max_new for x in a] == [y.max_new for y in c]
    assert [len(x.prompt) for x in a] == [len(y.prompt) for y in c]
    assert all((x.prompt != y.prompt).any() for x, y in zip(a, c))


@pytest.mark.parametrize("mix", ["chat", "stream"])
def test_every_deck_deals_the_stated_sizes(mix):
    s = _mix(mix)
    n = s["deck"]
    out = [r.max_new for r in _drain(loadgen.Traffic(s, 1, 32000), 3 * n)]
    for i in range(3):
        assert sorted(out[i * n:(i + 1) * n]) == sorted(
            loadgen.quantile_deck(s["output_tokens"], n))
    # the order is the file's, not the run's
    other = dict(s, order_seed=s["order_seed"] + 1)
    assert out != [r.max_new for r in _drain(
        loadgen.Traffic(other, 1, 32000), 3 * n)]


@pytest.mark.parametrize("key", ["user_tokens", "output_tokens"])
@pytest.mark.parametrize("mix", ["chat", "stream"])
def test_deck_follows_the_distribution(mix, key):
    dist = _mix(mix)[key]
    deck = loadgen.quantile_deck(dist, 1001)
    assert min(deck) >= dist["min"] and max(deck) <= dist["max"]
    assert abs(np.median(deck) - dist["median"]) <= 1
    # the log-normal's quartiles, clipped
    lo = dist["median"] * np.exp(-0.6745 * dist["sigma"])
    hi = dist["median"] * np.exp(0.6745 * dist["sigma"])
    q1, q3 = np.percentile(deck, [25, 75])
    assert abs(q1 - max(lo, dist["min"])) / lo < 0.02
    assert abs(q3 - min(hi, dist["max"])) / hi < 0.02


def test_zipf_prefixes():
    deck = loadgen.zipf_deck(8, 1.1, 32)
    counts = np.bincount(deck, minlength=8)
    assert counts.sum() == 32 and counts.min() >= 1
    assert all(counts[i] >= counts[i + 1] for i in range(7))
    w = np.arange(1, 9) ** -1.1
    assert np.abs(counts - 32 * w / w.sum()).max() <= 1.0


def test_chat_prompts_share_whole_pages():
    tr = loadgen.Traffic(_mix("chat"), 99, 32000)
    reqs = [tr.next_request(c) for c in range(32)]
    heads = {r.prompt[:256].tobytes() for r in reqs}
    assert len(heads) <= 8 and len(heads) > 1
    assert all(r.turn == 0 for r in reqs)
    assert all(32 <= len(r.prompt) - 256 <= 3072 for r in reqs)
    assert all(16 <= r.max_new <= 768 for r in reqs)


def test_stream_sessions_grow_and_end():
    s = _mix("stream")
    tr = loadgen.Traffic(s, 5, 32000)
    prev = None
    sessions = set()
    for _ in range(200):
        r = tr.next_request(0)
        assert len(r.prompt) + r.max_new <= tr.longest_request()
        if prev is not None and r.session == prev.session:
            hist = np.concatenate([prev.prompt, prev.served])
            np.testing.assert_array_equal(r.prompt[:len(hist)], hist)
            assert 32 <= len(r.prompt) - len(hist) <= 512
        elif prev is not None:
            assert len(prev.prompt) + len(prev.served) > s[
                "session_max_context"]
        r.served = np.full(r.max_new, 3, np.int32)
        tr.complete(0, r)
        sessions.add(r.session)
        prev = r
    assert len(sessions) > 3


def _spread_dists():
    for mix in ("chat", "stream"):
        s = _mix(mix)
        for key, dist in (("user_tokens", s["user_tokens"]),
                          ("output_tokens", s["output_tokens"]),
                          ("prefix", s["prefix"]["tokens"])):
            if dist["sigma"] > 0:
                yield pytest.param(s, dist, id=f"{mix}-{key}")


@pytest.mark.parametrize("mix,dist", list(_spread_dists()))
def test_sigma_puts_the_clips_at_the_first_and_99th_percentiles(mix, dist):
    from statistics import NormalDist
    z = NormalDist().inv_cdf(0.99)
    want = np.log(dist["max"] / dist["min"]) / (2 * z)
    assert abs(dist["sigma"] - want) < 1e-3


@pytest.mark.parametrize("mix,dist", list(_spread_dists()))
def test_every_deck_reaches_both_clips(mix, dist):
    deck = loadgen.quantile_deck(dist, mix["deck"])
    assert min(deck) == dist["min"] and max(deck) == dist["max"]
