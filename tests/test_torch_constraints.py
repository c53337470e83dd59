"""Port vs reference: constrained generation on the CPU.

The same tiny EXL2 checkpoint (head_dim 128, a sharpened head so greedy
argmaxes are decisive) goes through the JAX package's DynamicGenerator and
the port's, job by job, with greedy settings: filters, token healing, banned
strings with their page rewinds, post-sampling hooks, filter_prefer_eos, the
streaming generator and the asyncio wrapper. Token ids and texts must be
equal. The jobs that need readable text ban every token that is not a
printable ASCII byte (`Settings.banned_tokens`), on both sides.
"""

import asyncio

import numpy as np
import pytest
import torch

from exllamav2_tpu.cache_paged import PagedKVCache as RefCache
from exllamav2_tpu.generator import dynamic as RD
from exllamav2_tpu.generator import filters as RF
from exllamav2_tpu.generator.dynamic_async import (
    DynamicGeneratorAsync as RefAsync, DynamicJobAsync as RefJobAsync)
from exllamav2_tpu.generator.filters.external import (
    CallableFilter as RefCallable)
from exllamav2_tpu.generator.sampler import Settings as RefSettings
from exllamav2_tpu.generator.streaming import (
    StreamingGenerator as RefStreaming)
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.tokenizer import ByteTokenizer as RefTok
from exllamav2_tpu.utils.testing import make_tiny_llama

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator import dynamic as TD
from exllamav2_tpu_torch.generator import filters as TF
from exllamav2_tpu_torch.generator.base import BaseGenerator
from exllamav2_tpu_torch.generator.dynamic_async import (
    DynamicGeneratorAsync, DynamicJobAsync)
from exllamav2_tpu_torch.generator.filters.external import CallableFilter
from exllamav2_tpu_torch.generator.hooks import PostSamplingResult
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.generator.streaming import StreamingGenerator
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.tokenizer import ByteTokenizer

VOCAB = 384
NOT_TEXT = [t for t in range(VOCAB) if not 32 <= t < 127]


class Side:
    """One package's classes and a generator over the shared checkpoint."""

    def __init__(self, name, model, mod, filters, settings, tok_cls, cache_cls,
                 callable_filter):
        self.name, self.model, self.mod = name, model, mod
        self.filters, self.settings = filters, settings
        self.tok = tok_cls(VOCAB)              # EOS id 257
        self.tok_plain = tok_cls(256)          # no EOS id
        self.cache_cls, self.callable_filter = cache_cls, callable_filter
        self.gen = self.new_gen()

    def new_cache(self, pages):
        st = self.model.static
        kw = {} if self.name == "ref" else {"device": "cpu"}
        return self.cache_cls.alloc(st.num_layers, pages, st.num_kv_heads,
                                    st.head_dim, "bf16", **kw)

    def new_gen(self, pages=16, tok=None, **kw):
        return self.mod.DynamicGenerator(
            self.model, self.new_cache(pages), tok or self.tok,
            max_batch_size=4, **kw)

    def greedy(self, text_only=False):
        s = self.settings.greedy()
        if text_only:
            s.banned_tokens = list(NOT_TEXT)
        return s

    def job(self, ids, **kw):
        return self.mod.DynamicJob(np.asarray(ids, np.int32), **kw)

    def run(self, job, gen=None):
        gen = gen or self.gen
        gen.enqueue(job)
        results = []
        while job.status != "done":
            results += gen.iterate()
            if self.name == "port":
                gen._validate_cache()
                _check_hist(gen)
        return results


def _check_hist(gen):
    """The device history of every active job is its sequence: what the next
    step reads at hist[slot, kv_pos], also after a rewind."""
    for job in gen.active:
        if job.status == "generating":
            n = len(job.sequence)
            assert job.kv_pos == n - 1
            np.testing.assert_array_equal(
                gen.hist[job.slot, :n].numpy(), job.sequence)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The model here is tiny: one intra-op thread, so that test workers
    running side by side do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    d = make_tiny_llama(str(tmp_path_factory.mktemp("cons") / "hd128"),
                        quant="exl2", seed=9, vocab=VOCAB, hidden=256,
                        heads=2, kv_heads=1, inter=512, max_pos=4096,
                        head_scale=6.0)
    ref = Side("ref", RefModel.from_dir(d), RD, RF, RefSettings, RefTok,
               RefCache, RefCallable)
    port = Side("port", Model.from_dir(d, device="cpu"), TD, TF, Settings,
                ByteTokenizer, PagedKVCache, CallableFilter)
    return ref, port


def _both(sides, make_job):
    """Run `make_job(side)` through both generators; -> [(job, results)]."""
    out = []
    for side in sides:
        job = make_job(side)
        out.append((job, side.run(job)))
    (rj, _), (tj, _) = out
    np.testing.assert_array_equal(tj.sequence, rj.sequence)
    assert tj.emitted_text == rj.emitted_text
    assert tj.eos_reason == rj.eos_reason
    assert tj.new_tokens == rj.new_tokens
    return out


def test_select_filter(sides):
    opts = ["apple", "banana", "cherry"]
    (rj, _), (tj, _) = _both(sides, lambda s: s.job(
        s.tok.encode("pick: "), max_new_tokens=20, settings=s.greedy(),
        filters=[s.filters.SelectFilter(s.tok, opts)]))
    assert tj.emitted_text in opts and tj.eos_reason == "end_filter"


@pytest.mark.parametrize("burst", [1, 8])
def test_prefix_filter_then_free(sides, burst):
    """The filter completes after five tokens; the rest decodes free, in
    bursts where the generator allows them."""
    def make(s):
        s.gen.decode_burst = burst
        return s.job(s.tok.encode("x"), max_new_tokens=16,
                     settings=s.greedy(),
                     filters=[s.filters.PrefixFilter(s.tok, "hello")])
    try:
        (rj, rres), (tj, tres) = _both(sides, make)
    finally:
        for s in sides:
            s.gen.decode_burst = 8
    assert tj.emitted_text.startswith("hello") and tj.new_tokens == 16
    assert len(tres) == len(rres) == 16


def test_filter_completing_opens_the_burst(sides):
    """A live filter holds the generator to one token a dispatch; once it
    has completed, bursts run and repeat the step-by-step tokens."""
    _, port = sides
    runs = {}
    for burst in (1, 8):
        gen = port.new_gen(decode_burst=burst)
        job = gen.enqueue(port.job(
            port.tok.encode("x"), max_new_tokens=21,
            settings=port.greedy(),
            filters=[TF.PrefixFilter(port.tok, "hello")]))
        per_call = []
        while job.status != "done":
            per_call.append(sum(1 for r in gen.iterate()
                                if r["stage"] == "streaming"))
        runs[burst] = (job.sequence, per_call)
    np.testing.assert_array_equal(runs[1][0], runs[8][0])
    assert set(runs[1][1]) == {1}
    # five filtered steps, then 16 free tokens in two bursts of 8
    assert runs[8][1] == [1] * 5 + [8, 8]


def test_token_healing(sides):
    (rj, _), (tj, _) = _both(sides, lambda s: s.job(
        s.tok.encode("abcq"), max_new_tokens=4, settings=s.greedy(),
        token_healing=True))
    # the healed first token extends the removed 'q': with one byte a token
    # that is 'q' itself
    assert tj.sequence[3] == ord("q") and tj.prompt_len == 3
    assert tj.healing_token == ord("q")


def test_generate_simple_token_healing(sides):
    _, port = sides
    out = BaseGenerator(port.gen, None, None).generate_simple(
        "abcq", Settings.greedy(), num_tokens=4, token_healing=True,
        completion_only=True)
    assert out.startswith("q")


def _free_text(side, prompt, n):
    job = side.job(prompt, max_new_tokens=n, settings=side.greedy(True))
    side.run(job)
    return job


@pytest.mark.parametrize("span", [(0, 2), (3, 6)])
def test_banned_strings(sides, span):
    """Ban a piece of the job's own unconstrained text: the job rewinds to
    where the piece began, blocks its first token once and writes on."""
    ref, port = sides
    prompt = port.tok.encode("abc")
    free = _free_text(port, prompt, 10)
    banned = free.emitted_text[span[0]:span[1]]
    assert len(banned) == span[1] - span[0]
    (rj, rres), (tj, tres) = _both(sides, lambda s: s.job(
        prompt, max_new_tokens=10, settings=s.greedy(True),
        banned_strings=[banned]))
    assert banned.lower() not in tj.emitted_text.lower()
    assert tj.new_tokens == 10

    def rewinds(res):
        return sum(1 for r in res if r["stage"] == "streaming"
                   and len(r["token_ids"]) == 0)
    assert rewinds(tres) == rewinds(rres) >= 1
    assert "".join(r.get("text", "") for r in tres) == tj.emitted_text


def test_post_sampling_hooks_see_every_token(sides):
    seen = {}

    def make(s):
        log = seen.setdefault(s.name, [])
        return s.job(s.tok.encode("hook"), max_new_tokens=6,
                     settings=s.greedy(True), return_top_tokens=4,
                     return_probs=True,
                     post_sampling_hooks=[lambda r: log.append(r)])
    (rj, _), (tj, tres) = _both(sides, make)
    assert len(seen["port"]) == len(seen["ref"]) == 6
    for t, r in zip(seen["port"], seen["ref"]):
        assert isinstance(t, PostSamplingResult)
        assert t.sampled_token == r.sampled_token
        assert t.candidate_tokens[0] == t.sampled_token    # greedy
        assert t.sampled_prob == pytest.approx(r.sampled_prob, abs=5e-2)
        assert len(t.candidate_tokens) == len(t.candidate_probs) == 4
    assert [int(r["token_ids"][0]) for r in tres] == \
        [t.sampled_token for t in seen["port"]]


def test_hook_can_hold_back_filter_feedback(sides):
    """feed_filters=False: the filter never advances, so every token is
    drawn from the prefix's first letter."""
    def hold(r):
        r.feed_filters = False
    (rj, _), (tj, _) = _both(sides, lambda s: s.job(
        s.tok.encode("x"), max_new_tokens=4, settings=s.greedy(),
        filters=[s.filters.PrefixFilter(s.tok, "hello")],
        post_sampling_hooks=[hold]))
    assert tj.emitted_text == "hhhh"


@pytest.mark.parametrize("prefer", [False, True])
def test_filter_prefer_eos(sides, prefer):
    eos = 257

    def make(s):
        f = s.callable_filter(
            s.tok, lambda fed: {ord("a"), ord("b"), eos}, eos_ids=[eos])
        return s.job(s.tok.encode("z"), max_new_tokens=3,
                     settings=s.greedy(), filters=[f],
                     filter_prefer_eos=prefer)
    (rj, _), (tj, _) = _both(sides, make)
    if prefer:
        assert tj.eos_reason == "stop_token" and tj.new_tokens == 1
    else:
        assert set(tj.emitted_text) <= {"a", "b"}


def _shared_page_round(side, pages, prompt_a, banned, tail):
    """Job A crosses the page boundary at 256 and publishes page 0; job B
    arrives with A's first 256 tokens as its prompt prefix and shares the
    page; then A completes the banned string, which began before the
    boundary, and rewinds across it."""
    gen = side.new_gen(pages=pages, tok=side.tok_plain)
    a = gen.enqueue(side.job(prompt_a, max_new_tokens=12,
                             settings=side.greedy(True),
                             banned_strings=[banned] if banned else None))
    b, log = None, {"deferred": False, "copied": False}
    guard = 0
    while a.status != "done" or b is None or b.status != "done":
        if b is None and len(a.sequence) >= 257:
            shared = a.pages[0]
            assert shared.phash is not None          # published when full
            b = gen.enqueue(side.job(
                np.concatenate([a.sequence[:256], tail]), max_new_tokens=6,
                settings=side.greedy(True)))
        gen.iterate()
        gen._validate_cache()
        if side.name == "port":
            _check_hist(gen)
        log["deferred"] |= a.rewind_deferred
        if b is not None and b.pages and a.pages:
            log["copied"] |= a.pages[0] is not b.pages[0] \
                and b.pages[0] is shared
        guard += 1
        assert guard < 200, "generator stuck"
    return a, b, log


@pytest.fixture(scope="module")
def boundary_case(sides):
    """A 250-token prompt, its free continuation, and the five characters
    that straddle the page boundary (sequence positions 254..258). The
    random model repeats itself, so the prompt is the first of a few seeded
    ones whose continuation holds those five characters nowhere earlier."""
    _, port = sides
    for seed in range(16):
        rng = np.random.default_rng(seed)
        prompt = rng.integers(97, 123, 250).astype(np.int32)
        gen = port.new_gen(tok=port.tok_plain)
        free = port.job(prompt, max_new_tokens=12, settings=port.greedy(True))
        port.run(free, gen)
        text = free.emitted_text
        banned = text[4:9]
        if (len(text) == 12 and text.find(banned) == 4
                and banned[0] not in text[:4]):
            break
    else:
        pytest.fail("no prompt with a usable continuation")
    assert banned == port.tok_plain.decode(free.sequence[254:259])
    tail = rng.integers(97, 123, 4).astype(np.int32)
    return prompt, banned, tail, free


@pytest.mark.parametrize("pages,deferred", [(16, False), (4, True)])
def test_banned_string_rewind_over_a_shared_page(sides, boundary_case, pages,
                                                 deferred):
    """With free pages the rewinding job gets a private copy of the shared
    page; with none (null page + the 3 the two jobs hold) the rewind is
    deferred until the other job ends. Either way the other job writes the
    tokens it writes beside a job that never rewinds (its own prefill of the
    shared rows would round their bf16 K/V elsewhere than the first job's
    decode steps did, so "alone" is not the yardstick)."""
    prompt, banned, tail, free = boundary_case
    out = [_shared_page_round(s, pages, prompt, banned, tail) for s in sides]
    (ra, rb, rlog), (ta, tb, tlog) = out
    np.testing.assert_array_equal(ta.sequence, ra.sequence)
    np.testing.assert_array_equal(tb.sequence, rb.sequence)
    assert ta.emitted_text == ra.emitted_text
    assert banned not in ta.emitted_text and ta.new_tokens == 12
    assert tlog == rlog == {"deferred": deferred, "copied": not deferred}
    assert tb.reused_tokens == rb.reused_tokens == 256
    # the same round without the banned string: no rewind, same page shared
    _, port = sides
    ca, cb, clog = _shared_page_round(port, pages, prompt, None, tail)
    assert clog == {"deferred": False, "copied": False}
    np.testing.assert_array_equal(ca.sequence, free.sequence)
    np.testing.assert_array_equal(tb.sequence, cb.sequence)


def test_rewind_page_starvation_finishes_the_youngest(sides):
    """Every active job deferred: the youngest ends at its rewound state so
    the others can go on."""
    _, port = sides
    gen = port.new_gen(tok=port.tok_plain)
    jobs = [gen.enqueue(port.job(port.tok_plain.encode(p), max_new_tokens=8,
                                 settings=port.greedy(),
                                 banned_strings=["\x00\x01"]))
            for p in ("first", "second")]
    gen.iterate()
    assert all(j.status == "generating" for j in jobs)
    never = gen._rewind_pages
    gen._rewind_pages = lambda job: False
    for j in jobs:
        j.rewind_deferred = True
    res = gen.iterate()
    gen._rewind_pages = never
    last = [r for r in res if r["eos"]]
    assert len(last) == 1 and last[0]["job"] is jobs[1]
    assert last[0]["eos_reason"] == "rewind_page_starvation"
    assert jobs[1].status == "done" and jobs[0].status == "generating"
    jobs[0].rewind_deferred = False
    while jobs[0].status != "done":
        gen.iterate()
    gen._validate_cache()
    assert jobs[0].new_tokens == 8


def test_streaming_generator(sides):
    ref, port = sides
    chunks = {}
    for side, cls in ((ref, RefStreaming), (port, StreamingGenerator)):
        sg = cls(side.model, side.new_cache(4), side.tok)
        sg.generator = side.gen                # the warm generator
        sg.set_stop_conditions([])
        sg.begin_stream_ex(side.tok.encode("stream"),
                           side.greedy(True), max_new_tokens=8,
                           return_top_tokens=4, token_healing=True)
        got = []
        while True:
            r = sg.stream_ex()
            got.append((r["chunk"], r["chunk_token_ids"].tolist()))
            if r["eos"]:
                break
        assert "top_k_tokens" in r
        chunk, eos, ids = sg.stream()          # past the end
        assert (chunk, eos, len(ids)) == ("", True, 0)
        chunks[side.name] = got
    assert chunks["port"] == chunks["ref"]
    assert "".join(c for c, _ in chunks["port"]).startswith("m")


def test_async_wrapper(sides):
    ref, port = sides
    texts = {}
    for side, gcls, jcls in ((ref, RefAsync, RefJobAsync),
                             (port, DynamicGeneratorAsync, DynamicJobAsync)):
        async def main():
            agen = gcls(side.gen)
            jobs = [jcls(agen, side.tok.encode(p), max_new_tokens=5,
                         settings=side.greedy(True))
                    for p in ("async one", "async two")]
            for j in jobs:
                await agen.enqueue(j)
            out = []
            for j in jobs:
                text = ""
                async for r in j:
                    text += r.get("text", "")
                out.append((text, j.job.sequence.tolist()))
            await agen.close()
            return out
        texts[side.name] = asyncio.run(main())
    assert texts["port"] == texts["ref"]
    assert all(len(t) == 5 for t, _ in texts["port"])
