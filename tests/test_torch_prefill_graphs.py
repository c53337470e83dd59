"""The prefill steps as graphs (utils/graphs.py), on the CPU.

The reference compiles every prefill: ``models/model.py _prefill_step`` by
the shape of ``ids``, the generator's ``_get_prefill_fn(t, p)``,
``_get_prefill_mm_fn(t, p, with_rope)`` and ``_get_draft_prefill_fn(t, p)``.
The port replays one graph a key. On the CPU there is no graph to capture:
a runner keeps the static buffers, runs the warm-up and calls the step
function on the buffers, so these tests hold exactly what a card replays
(static inputs, pad rows, buffers left by a longer chunk of the same key,
the warm-up's cache writes written again) to the eager prefill, bit for
bit, and to the reference's compiled prefill: the same jobs on the same
numpy prompts, the K / V rows the prefill wrote (pool rows through each
job's pages) within POOL_TOL of their max |reference|. Only the prefill
rounds run (``_prefill_rounds``, iterate's prefill block), so no decode step
compiles. The prefill keys equal the reference's compiled prefill keys
with the batch bucket, which jax.jit keys by shape, appended.
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

from exllamav2_tpu.cache_paged import PagedKVCache as RefPaged
from exllamav2_tpu.generator.dynamic import (
    DynamicGenerator as RefGen, DynamicJob as RefJob)
from exllamav2_tpu.generator.sampler import Settings as RefSettings
from exllamav2_tpu.models import forward as RF
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.tokenizer import ByteTokenizer as RefTok
from exllamav2_tpu.utils.testing import make_tiny_llama

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import (
    MAX_GRAPHS, DynamicGenerator, DynamicJob)
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.models import forward as F
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.tokenizer import ByteTokenizer
from exllamav2_tpu_torch.utils.graphs import StepGraphs

TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "trained_tiny")
# max |port - reference| / max |reference| of the K or V rows a prefill
# wrote: both round K and V to bf16, and a sum in another f32 order moves a
# value by a bf16 step (2^-8 = 3.9e-3 of the largest); measured <= 2.8e-3
POOL_TOL = 5e-3
PAGE = 16
TOK = ByteTokenizer(384)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that test workers running side
    by side do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefill_rounds(gen, jobs):
    """Admit `jobs` and run the prefill rounds of iterate (the same code
    in both packages) until every job is ready to decode."""
    for j in jobs:
        gen.enqueue(j)
    for j in jobs:
        assert gen._try_start(j)
    gen.pending = []
    while True:
        pre = [j for j in gen.active if j.status == "prefill"]
        if not pre:
            return
        plain = [j for j in pre if not (j.embeddings or j.is_cfg
                                        or j.mrope_rows is not None)]
        batched = set(map(id, plain)) if len(plain) >= 2 else set()
        if batched:
            gen._prefill_chunk_batch(plain)
        for j in pre:
            if id(j) not in batched:
                gen._prefill_chunk(j)
                if j.is_cfg and j.kv_pos2 < len(j.negative_ids) - 1:
                    gen._prefill_chunk(j, stream2=True)
            if j.kv_pos >= j.prompt_len - 1 and (
                    not j.is_cfg or j.kv_pos2 >= len(j.negative_ids) - 1):
                j.status = "generating"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _rows(job, stream2=False) -> np.ndarray:
    """The pool rows of a job's cached positions (its CFG stream's)."""
    pages, n = (job.pages2, job.kv_pos2) if stream2 else (job.pages,
                                                          job.kv_pos)
    pos = np.arange(n)
    return np.asarray([pages[p].index for p in pos // PAGE]) * PAGE \
        + pos % PAGE


def _kv(cache, rows) -> list[np.ndarray]:
    """K and V of `rows`, every layer and head, f32."""
    return [_np(d)[:, :, rows] for d in (cache.k_data, cache.v_data)]


def _check_job(caches, jobs, i, stream2=False):
    """Job i's rows: graphed equal eager bit for bit, and the reference's
    within POOL_TOL. caches / jobs: (graphed, eager, reference)."""
    got, eager, ref = (_kv(c, _rows(js[i], stream2))
                       for c, js in zip(caches, jobs))
    for a, b, r in zip(got, eager, ref):
        assert a.size and np.array_equal(a, b)
        assert np.abs(a - r).max() <= POOL_TOL * np.abs(r).max()


def _pool_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in ((a.k_data, b.k_data),
                                              (a.v_data, b.v_data)))


def _prefill_keys(gen) -> set:
    """The reference's names of a port generator's prefill keys: the key
    less its batch bucket."""
    return {k[:-1] for k in gen.prefill_graphs.captures}


def _ref_prefill_keys(rgen) -> set:
    return {k for k in rgen._compiled
            if k[0] in ("prefill", "prefill_mm", "dprefill")}


# ---------------------------------------------------------------------------
# text prefills with a draft model: one generator each, four stages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("prefill_graphs")
    return make_tiny_llama(str(root / "exl2"), quant="exl2", seed=5,
                           vocab=384, max_pos=4096)


def _stages():
    """Four stages of jobs over 16-row pages and 32-token chunks, every
    job's block table in the bucket of 16 pages: an 80-token prompt alone
    (chunks of 32, 32 and 15 rows: two chunks of one key); three jobs
    batched (t 32, b 4: a pad row and pad columns); a 10-token prompt and
    one whose first three pages are the first job's (prompt reuse), each
    alone in the key of the first job's last chunk with other rows."""
    rng = np.random.default_rng(11)
    p1 = rng.integers(3, 250, 80).astype(np.int32)
    return [[(p1, 60)],
            [(rng.integers(3, 250, n).astype(np.int32), 100)
             for n in (20, 33, 10)],
            [(rng.integers(3, 250, 10).astype(np.int32), 130)],
            [(np.concatenate([p1[:48], rng.integers(3, 250, 17).astype(
                np.int32)]), 75)]]


@pytest.fixture(scope="module")
def text_runs(tiny_dir):
    """(graphed, eager, reference) generators after the four stages and
    their jobs; the port's two with the main model as their draft model
    (the reference's draft prefill is its prefill's twin: the same (t, p),
    the draft model's forward)."""
    model = Model.from_dir(tiny_dir, device="cpu")
    st = model.static

    def cache(alloc, **kw):
        return alloc(st.num_layers, 64, st.num_kv_heads, st.head_dim,
                     page_size=PAGE, **kw)

    gens = [DynamicGenerator(model, cache(PagedKVCache.alloc, device="cpu"),
                             TOK, max_batch_size=8, max_chunk_size=32,
                             draft_model=model, draft_cache=cache(
                                 PagedKVCache.alloc, device="cpu"),
                             num_draft_tokens=4, graphs=graphs)
            for graphs in (True, False)]
    # the reference keeps the same draft margin of pages (n-gram drafts)
    gens.append(RefGen(RefModel.from_dir(tiny_dir), cache(RefPaged.alloc),
                       RefTok(384), max_batch_size=8, max_chunk_size=32,
                       use_ngram_draft=True, num_draft_tokens=4))
    jobs = [[], [], []]
    for stage in _stages():
        for gen, js, (job, settings) in zip(
                gens, jobs, ((DynamicJob, Settings), (DynamicJob, Settings),
                             (RefJob, RefSettings))):
            new = [job(p, max_new_tokens=n, settings=settings.greedy())
                   for p, n in stage]
            _prefill_rounds(gen, new)
            js += new
    return gens, jobs


def test_one_job_chunks_replay_one_key(text_runs):
    """An 80-token prompt alone: its two 32-token chunks replay one graph
    (the position is data), the last chunk another; its rows equal the
    eager prefill's bit for bit and the reference's within POOL_TOL."""
    gens, jobs = text_runs
    _check_job([g.cache for g in gens], jobs, 0)
    runner = gens[0].prefill_graphs
    assert runner.captures[("prefill", 32, 16, 1)] == 1
    assert runner.replays[("prefill", 32, 16, 1)] == 2
    assert gens[1].prefill_graphs is None and gens[1].step_graphs is None


def test_batched_prefill_with_pad_rows(text_runs):
    """Three jobs in one batched prefill (b bucket 4: a pad row on the
    null page; pad columns): every job's rows as eager and the reference,
    and the whole pool, null page included, bit for bit the eager one."""
    gens, jobs = text_runs
    for i in (1, 2, 3):
        _check_job([g.cache for g in gens], jobs, i)
    assert gens[0].prefill_graphs.replays[("prefill", 32, 16, 4)] == 1
    assert _pool_equal(gens[0].cache, gens[1].cache)


def test_shorter_chunk_after_longer_in_one_key(text_runs):
    """The first job's 15-row last chunk, then a 9-row prompt and a reused
    prompt's 16 rows after its three shared pages, through one key (t 16,
    p 16) whose static buffers held the earlier chunk's ids, positions and
    lens: their rows equal the eager prefill's and the reference's."""
    gens, jobs = text_runs
    _check_job([g.cache for g in gens], jobs, 4)
    _check_job([g.cache for g in gens], jobs, 5)
    runner = gens[0].prefill_graphs
    assert runner.captures[("prefill", 16, 16, 1)] == 1
    assert runner.replays[("prefill", 16, 16, 1)] == 3
    assert jobs[0][5].reused_tokens == jobs[2][5].reused_tokens == 48
    assert jobs[0][5].pages[:3] == jobs[0][0].pages[:3]


def test_draft_prefill_is_its_own_graph(text_runs):
    """The draft model's prefill is its own graph, ("dprefill", t, p, b),
    replayed beside each main prefill on the same inputs: with the main
    model as the draft model, the draft pool equals the main pool bit for
    bit, graphed and eager alike."""
    gens, jobs = text_runs
    for g in gens[:2]:
        assert _pool_equal(g.draft_cache, g.cache)
    runner = gens[0].prefill_graphs
    main = {k[1:]: n for k, n in runner.replays.items()
            if k[0] == "prefill"}
    assert main == {k[1:]: n for k, n in runner.replays.items()
                    if k[0] == "dprefill"}


def test_prefill_keys_equal_reference(text_runs):
    """The prefill keys the port captured, less the batch bucket, are the
    keys the reference compiled for the same jobs, verbatim, and each
    draft key the twin of one."""
    gens, _ = text_runs
    want = _ref_prefill_keys(gens[2])
    got = _prefill_keys(gens[0])
    assert {k for k in got if k[0] == "prefill"} == want and len(want) == 2
    assert {k for k in got if k[0] == "dprefill"} == {
        ("dprefill", *k[1:]) for k in want}
    assert all(n == 1 for n in gens[0].prefill_graphs.captures.values())
    assert not gens[0].step_graphs.captures     # no decode step ran


# ---------------------------------------------------------------------------
# CFG, MoE, an image job with MRoPE rows
# ---------------------------------------------------------------------------

def test_cfg_second_stream_takes_the_prefill_graph(tiny_dir):
    """A CFG job: its negative prompt's stream prefills through the same
    graph over its own pages (one capture, two replays); both streams'
    rows as eager and the reference. (The reference's admission gives the
    first stream the second's page count on top of its own, so its first
    block table takes a wider bucket: the keys are held to the reference
    on the text jobs.)"""
    rng = np.random.default_rng(6)
    prompt, neg = (rng.integers(3, 250, 40).astype(np.int32)
                   for _ in range(2))
    model = Model.from_dir(tiny_dir, device="cpu")
    st = model.static
    gens = [DynamicGenerator(model, PagedKVCache.alloc(
        st.num_layers, 16, st.num_kv_heads, st.head_dim, page_size=PAGE,
        device="cpu"), TOK, max_batch_size=4, graphs=graphs)
        for graphs in (True, False)]
    rm = RefModel.from_dir(tiny_dir)
    gens.append(RefGen(rm, RefPaged.alloc(st.num_layers, 16,
                                          st.num_kv_heads, st.head_dim,
                                          page_size=PAGE), RefTok(384),
                       max_batch_size=4))
    jobs = []
    for gen, job, settings in ((gens[0], DynamicJob, Settings),
                               (gens[1], DynamicJob, Settings),
                               (gens[2], RefJob, RefSettings)):
        s = settings.greedy()
        s.cfg_scale = 1.5
        jobs.append([job(prompt, max_new_tokens=4, settings=s,
                         negative_prompt_ids=neg)])
        _prefill_rounds(gen, jobs[-1])
    caches = [g.cache for g in gens]
    _check_job(caches, jobs, 0)
    _check_job(caches, jobs, 0, stream2=True)
    runner = gens[0].prefill_graphs
    assert dict(runner.captures) == {("prefill", 64, 4, 1): 1}
    assert runner.replays[("prefill", 64, 4, 1)] == 2


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("prefill_moe") / "mixtral")
    return make_tiny_llama(d, quant="exl2", seed=13, vocab=256, hidden=128,
                           layers=2, heads=2, kv_heads=2, inter=256,
                           max_pos=512, arch="MixtralForCausalLM",
                           extra_config={"num_local_experts": 4,
                                         "num_experts_per_tok": 2})


def test_moe_prefill_drops_equal_reference(mixtral):
    """A tiny Mixtral at capacity factor 0.3 in both packages: a batched
    prefill of two jobs (128 rows: the capacity dispatch, its pad columns
    masked out of the routing by the validity mask the step makes from
    lens) and a lone job's: the dropped-route counts, a static output of
    each graph, equal the eager prefill's and the reference's, and so do
    the rows."""
    prompts = [np.random.default_rng(i).integers(3, 250, n).astype(np.int32)
               for i, n in enumerate((40, 57, 90))]
    model = Model.from_dir(mixtral, device="cpu")
    st = model.static
    rm = RefModel.from_dir(mixtral)
    F.set_moe_dispatch(capacity_factor=0.3)
    RF.set_moe_dispatch(capacity_factor=0.3)
    try:
        gens = [DynamicGenerator(model, PagedKVCache.alloc(
            st.num_layers, 32, st.num_kv_heads, st.head_dim, page_size=PAGE,
            device="cpu"), ByteTokenizer(256), max_batch_size=4,
            graphs=graphs) for graphs in (True, False)]
        gens.append(RefGen(rm, RefPaged.alloc(
            st.num_layers, 32, st.num_kv_heads, st.head_dim,
            page_size=PAGE), RefTok(256), max_batch_size=4))
        jobs = []
        for gen, job, settings in ((gens[0], DynamicJob, Settings),
                                   (gens[1], DynamicJob, Settings),
                                   (gens[2], RefJob, RefSettings)):
            js = [job(p, max_new_tokens=4, settings=settings.greedy())
                  for p in prompts]
            _prefill_rounds(gen, js[:2])
            _prefill_rounds(gen, js[2:])
            jobs.append(js)
    finally:
        F.set_moe_dispatch(capacity_factor=2.0)
        RF.set_moe_dispatch(capacity_factor=2.0)
    batch = [g.moe_dropped_tokens for g in gens]
    alone = [int(sum(int(d) for d in js[2]._moe_drop_parts)) for js in jobs]
    assert batch[0] == batch[1] == batch[2] > 0
    assert alone[0] == alone[1] == alone[2] > 0
    for i in range(3):
        _check_job([g.cache for g in gens], jobs, i)
    assert _prefill_keys(gens[0]) == _ref_prefill_keys(gens[2])


def test_mrope_image_prefill_graphed_equals_eager_and_reference(tmp_path):
    """A Qwen2-VL image job and a text job on the tiny checkpoint: each
    prefills one job at a time through ("prefill_mm", t, p, True, 1), its
    embedding rows and MRoPE sin / cos rows static inputs of the graph;
    the image prompt's two chunks replay one key. Rows as eager and the
    reference (whose tower gives the embeddings on its side)."""
    from exllamav2_tpu.vlm import VisionTower as RefTower
    from exllamav2_tpu_torch.utils.testing import make_tiny_vlm
    from exllamav2_tpu_torch.vlm import VisionTower
    d = make_tiny_vlm(str(tmp_path / "qwen2"), "qwen2")
    img = (np.random.default_rng(2).random((16, 16, 3)) * 255).astype(
        np.uint8)
    text = "a long caption before the image " * 4 + "<img> and after it"
    model = Model.from_dir(d, device="cpu")
    emb = VisionTower(model.config, device="cpu").get_image_embeddings(
        model, TOK, img, "<img>")
    rm = RefModel.from_dir(d)
    remb = RefTower(rm.config).get_image_embeddings(rm, RefTok(384), img,
                                                    "<img>")
    st = model.static
    gens = [DynamicGenerator(model, PagedKVCache.alloc(
        st.num_layers, 16, st.num_kv_heads, st.head_dim, page_size=PAGE,
        device="cpu"), TOK, max_batch_size=4, max_chunk_size=64,
        graphs=graphs) for graphs in (True, False)]
    gens.append(RefGen(rm, RefPaged.alloc(st.num_layers, 16,
                                          st.num_kv_heads, st.head_dim,
                                          page_size=PAGE), RefTok(384),
                       max_batch_size=4, max_chunk_size=64))
    jobs = []
    for gen, e, job, settings in ((gens[0], emb, DynamicJob, Settings),
                                  (gens[1], emb, DynamicJob, Settings),
                                  (gens[2], remb, RefJob, RefSettings)):
        js = [job(gen.encode_with_embeddings(text, [e]), max_new_tokens=4,
                  settings=settings.greedy(), embeddings=[e]),
              job(TOK.encode("only words"), max_new_tokens=4,
                  settings=settings.greedy())]
        _prefill_rounds(gen, js)
        jobs.append(js)
    assert jobs[0][0].prompt_len > 64 and jobs[0][1].mrope_rows is not None
    for i in range(2):
        _check_job([g.cache for g in gens], jobs, i)
    runner = gens[0].prefill_graphs
    assert {k[0] for k in runner.captures} == {"prefill_mm"}
    assert all(k[3] is True and k[4] == 1 for k in runner.captures)
    assert max(runner.replays.values()) == 2
    assert _prefill_keys(gens[0]) == _ref_prefill_keys(gens[2])


# ---------------------------------------------------------------------------
# Model.forward: generate_greedy through its chunks
# ---------------------------------------------------------------------------

def test_greedy_prefill_chunks_graphed_equal_eager_and_reference():
    """generate_greedy with max_input_len 16: a 40-token prompt goes
    through Model.forward in chunks of 16, 16 and 8 rows. A prefill key
    (the decode key plus T and last_token_only) runs eagerly at its first
    call and is captured at its second: the first call's second 16-row
    chunk captures, the second call captures the 8-row key and replays
    the rest. The tokens of both calls equal eager and the reference's,
    and a full-logits forward (last_token_only False) equals eager bit
    for bit."""
    prompt = np.random.default_rng(3).integers(3, 250, (2, 40)).astype(
        np.int32)
    ref = RefModel.from_dir(TRAINED, max_input_len=16).generate_greedy(
        prompt, 6, max_seq=64)
    eager = Model.from_dir(TRAINED, device="cpu", max_input_len=16)
    graphed = Model.from_dir(TRAINED, device="cpu", graphs=True,
                             max_input_len=16)
    e = eager.generate_greedy(prompt, 6, max_seq=64)
    np.testing.assert_array_equal(e, ref)
    for _ in range(2):
        np.testing.assert_array_equal(
            graphed.generate_greedy(prompt, 6, max_seq=64), e)
    runner = graphed.prefill_graphs
    assert {k[5:]: n for k, n in runner.captures.items()} == {
        (16, True): 1, (8, True): 1}
    assert {k[5:]: n for k, n in runner.replays.items()} == {
        (16, True): 3, (8, True): 1}
    assert eager.prefill_graphs is None
    outs = []
    for m in (graphed, eager):
        cache = m.new_cache(2, 64)
        lg, _ = m.forward(prompt[:, :33], cache, 0)
        outs.append((lg, cache.k.clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert (16, False) in {k[5:] for k in runner.captures}


# ---------------------------------------------------------------------------
# what drops the prefill graphs, and the runners' caps
# ---------------------------------------------------------------------------

def test_set_loras_and_weight_swap_drop_prefill_graphs(tiny_dir, tmp_path):
    """set_loras, a replaced generator model and new Model weights drop the
    prefill graphs with the decode graphs: the tokens after each equal an
    eager run's on the new weights."""
    from exllamav2_tpu_torch.lora import Lora
    from exllamav2_tpu_torch.utils.testing import (
        random_model_weights, write_random_lora)
    model = Model.from_dir(tiny_dir, device="cpu")
    lora = Lora(write_random_lora(str(tmp_path / "lora"), model.weights,
                                  rank=4, scale=0.3, seed=2))
    st = model.static

    def gen(graphs):
        return DynamicGenerator(model, PagedKVCache.alloc(
            st.num_layers, 16, st.num_kv_heads, st.head_dim, device="cpu"),
            TOK, graphs=graphs, decode_burst=1)

    def run(g):
        return g.generate("prefill graphs and adapters", max_new_tokens=6,
                          settings=Settings.greedy())

    g, e = gen(True), gen(False)
    assert run(g) == run(e) and g.prefill_graphs.entries
    for x in (g, e):
        x.set_loras([lora])
    assert not g.prefill_graphs.entries and not g.step_graphs.entries
    assert run(g) == run(e)
    g.model = Model(model.weights, st, model.config)    # the base again
    assert run(g) == run(gen(False))
    # one key, captured anew after each drop
    assert list(g.prefill_graphs.captures.values()) == [3]

    def weights(seed):
        return random_model_weights(vocab=512, hidden=256, layers=2,
                                    heads=4, kv_heads=4, inter=512,
                                    max_seq=64, bits=4, seed=seed,
                                    device="cpu")
    (w0, wst), (w1, _) = weights(0), weights(1)
    prompt = np.array([[1, 50, 99, 7, 8, 9]], np.int32)
    m = Model(w0, wst, graphs=True)
    first = m.generate_greedy(prompt, 5)
    assert m.generate_greedy(prompt, 5).tolist() == first.tolist()
    assert m.prefill_graphs.entries             # captured at its 2nd call
    m.weights = w1
    assert not m.prefill_graphs.entries and not m.step_graphs.entries
    want = Model(w1, wst, graphs=False).generate_greedy(prompt, 5)
    assert not np.array_equal(want, first)
    for _ in range(2):                          # the prefill graphed anew
        np.testing.assert_array_equal(m.generate_greedy(prompt, 5), want)
    assert m.prefill_graphs.entries


def test_prefill_keys_never_push_out_decode_keys():
    """Two runners on one pool, each with its own cap: filling the
    prefill runner past its cap drops its own least recently used key and
    none of the decode runner's; a collected cache of a Model takes its
    prefill graphs (a chunk's key, captured at its second chunk) along with
    its decode graphs."""
    decode = StepGraphs("cpu", MAX_GRAPHS)
    prefill = StepGraphs("cpu", 2, share_pool=decode)
    assert prefill._pool is decode._pool
    for i in range(3):
        decode(("decode", i), lambda x: x + 1, torch.zeros(2))
    for i in range(4):
        prefill(("prefill", i), lambda x: x * 2, torch.ones(2))
    assert list(decode.entries) == [("decode", i) for i in range(3)]
    assert list(prefill.entries) == [("prefill", 2), ("prefill", 3)]
    prefill.drop(lambda k: True)
    assert not prefill.entries and len(decode.entries) == 3

    from exllamav2_tpu_torch.utils.testing import random_model_weights
    w, st = random_model_weights(vocab=512, hidden=256, layers=2, heads=4,
                                 kv_heads=4, inter=512, max_seq=64, bits=4,
                                 seed=0, device="cpu")
    m = Model(w, st, graphs=True)
    refs = []
    for i in range(3):
        cache = m.new_cache(1, 64)
        m.forward(np.array([[3 + i, 4, 5]], np.int32), cache, 0)
        m.forward(np.array([[6, 7, 8]], np.int32), cache, 3)
        m.forward(np.array([[9]], np.int32), cache, 6)
        refs.append(weakref.ref(cache))
        del cache
    gc.collect()
    assert [r() for r in refs] == [None] * 3
    assert not m.prefill_graphs.entries and not m.step_graphs.entries
    assert sum(m.prefill_graphs.captures.values()) == 3
