"""The port's spans (utils/profiling.span) in DynamicGenerator, on the CPU.

Without a profiler a span checks the profiler's state once and records
nothing; under torch.profiler a round of the generator records its phases
(dyn.iterate and the spans inside it) with parent links that nest, counts
that follow the prefill's buckets, and times that map onto the profiler's
own events through `to_profiler_ns`.
"""

import os
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.tokenizer import ByteTokenizer
from exllamav2_tpu_torch.utils import profiling

TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "trained_tiny")
TOK = ByteTokenizer(384)
PHASES = {"dyn.admit": "dyn.iterate", "dyn.prefill": "dyn.iterate",
          "dyn.decode": "dyn.iterate", "dyn.reap": "dyn.iterate",
          "dyn.readback": "dyn.decode", "dyn.emit": "dyn.decode"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return Model.from_dir(TRAINED, device="cpu")


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring for the test (other tests may have filled the shared
    one)."""
    r = deque(maxlen=profiling.RING_SIZE)
    monkeypatch.setattr(profiling, "_RING", r)
    return r


def _round(model, prompt_lens=(5, 20, 37), max_new_tokens=3, graphs=False):
    """Jobs of the given prompt lengths run to the end, greedy."""
    st = model.static
    cache = PagedKVCache.alloc(st.num_layers, 16, st.num_kv_heads,
                               st.head_dim, "bf16", device="cpu")
    gen = DynamicGenerator(model, cache, TOK, max_batch_size=8,
                           graphs=graphs)
    jobs = [gen.enqueue(DynamicJob(
        [(7 * i + 3 * k) % 250 + 1 for k in range(n)],
        max_new_tokens=max_new_tokens, settings=Settings.greedy(),
        identifier=i)) for i, n in enumerate(prompt_lens)]
    while any(j.status != "done" for j in jobs):
        gen.iterate()
    return jobs


def test_no_profiler_one_check_and_no_record(model, ring, monkeypatch):
    checks, opened = [], []
    enabled, span = profiling._enabled, profiling.span

    def counted_check():
        checks.append(1)
        return enabled()

    def counted_span(name):
        opened.append(name)
        return span(name)

    def no_record_function(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(profiling, "_enabled", counted_check)
    monkeypatch.setattr(profiling, "span", counted_span)
    monkeypatch.setattr(torch.profiler, "record_function",
                        no_record_function)
    _round(model)
    assert len(ring) == 0
    assert opened and len(checks) == len(opened)
    assert {"dyn.iterate", "dyn.prefill", "dyn.decode"} <= set(opened)
    with profiling.span("x") as rec:
        assert not rec.on
    assert rec is profiling._OFF and len(ring) == 0


@pytest.fixture(scope="module")
def profiled(model):
    """One round under torch.profiler, through the step-graph runner (on the
    CPU it keeps the static buffers and calls the step): (its records,
    kineto's events of the same names, the jobs)."""
    r = deque(maxlen=profiling.RING_SIZE)
    old, profiling._RING = profiling._RING, r
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            jobs = _round(model, graphs=True)
    finally:
        profiling._RING = old
    names = {rec.name for rec in r}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in names]
    return list(r), events, jobs


def test_profiled_round_nests(profiled):
    recs, _, jobs = profiled
    by_name = {}
    for rec in recs:
        by_name.setdefault(rec.name, []).append(rec)
    assert set(PHASES) | {"dyn.iterate"} <= set(by_name)
    ids = set(map(id, recs))
    for rec in recs:
        assert rec.start_ns <= rec.end_ns
        if rec.name == "dyn.iterate":
            assert rec.parent is None
            continue
        p = rec.parent
        assert p is not None and id(p) in ids
        assert p.start_ns <= rec.start_ns and rec.end_ns <= p.end_ns
        if rec.name in PHASES:
            assert p.name == PHASES[rec.name], rec
        elif rec.name.startswith("graphs."):
            assert p.name in ("dyn.prefill", "dyn.decode"), rec
    assert {"graphs.capture.prefill", "graphs.capture.decode",
            "graphs.load"} <= set(by_name)
    # one readback and one emit a decode step; the prefill's counts alone
    n_dec = len(by_name["dyn.decode"])
    assert len(by_name["dyn.readback"]) == len(by_name["dyn.emit"]) == n_dec
    assert n_dec >= max(j.new_tokens for j in jobs) - 1
    for rec in recs:
        assert set(rec.counts) == ({"rows", "rows_computed"}
                                   if rec.name == "dyn.prefill" else set())


def test_records_map_onto_profiler_events(profiled):
    recs, events, _ = profiled
    assert events
    for name in {r.name for r in recs}:
        mine = sorted(r.start_ns for r in recs if r.name == name)
        theirs = sorted(e.start_ns() for e in events if e.name() == name)
        assert len(mine) == len(theirs), name
        for t, e in zip(mine, theirs):
            assert abs(profiling.to_profiler_ns(t) - e) < 2_000_000, name


@pytest.mark.parametrize("prompt_lens, rows, rows_computed", [
    # three rows of 4, 19 and 36 tokens (the last prompt token is decoded)
    # in one forward: 4 rows (bucket of 3) x 64 columns (bucket of 36)
    ((5, 20, 37), 4 + 19 + 36, 4 * 64),
    # a lone job takes the single-job path: 1 x 64 for 39 tokens
    ((40,), 39, 64),
    # 17 tokens round up to 32 columns; 2 rows stay 2
    ((18, 2), 17 + 1, 2 * 32),
])
def test_prefill_counts_its_buckets(model, ring, prompt_lens, rows,
                                    rows_computed):
    with profile(activities=[ProfilerActivity.CPU]):
        jobs = _round(model, prompt_lens, max_new_tokens=1)
    pre = [r for r in ring if r.name == "dyn.prefill"]
    assert len(pre) == 1
    assert pre[0].counts == {"rows": rows, "rows_computed": rows_computed}
    assert all(j.status == "done" for j in jobs)


def test_ring_stays_at_its_maxlen(ring):
    n = profiling.RING_SIZE + 5
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n):
            with profiling.span("s") as rec:
                rec.count(i=i)
    assert ring.maxlen == profiling.RING_SIZE == len(ring)
    assert ring[0].counts["i"] == 5 and ring[-1].counts["i"] == n - 1
