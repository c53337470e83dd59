"""Port vs reference: the serving path (generator/dynamic.py) on the CPU.

The port's DynamicGenerator over its PagedKVCache must emit exactly the
reference's greedy tokens (Model.generate_greedy of the JAX package) on
checkpoints with decisive argmaxes (the trained fixture, and a random
head_dim-128 model with a sharpened head); its paged logits must follow the
port's own linear-cache forward; and the scheduler (bursts, prompt dedup,
stop handling, admission, cancellation) must keep its page-table invariants.
"""

import os

import numpy as np
import pytest
import torch

from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.utils.testing import make_tiny_llama

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.base import BaseGenerator
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.tokenizer import ByteTokenizer

TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "trained_tiny")
TOK = ByteTokenizer(384)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread, so that test workers
    running side by side do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_gen")
    return {
        "trained": TRAINED,
        # hidden 256 / 2 heads -> head_dim 128, GQA 2:1, sharpened head
        "hd128": make_tiny_llama(str(root / "hd128"), quant="exl2", seed=9,
                                 vocab=384, hidden=256, heads=2, kv_heads=1,
                                 inter=512, max_pos=4096, head_scale=6.0),
        # the reference generator suite's model
        "exl2": make_tiny_llama(str(root / "exl2"), quant="exl2", seed=5,
                                vocab=384, max_pos=4096),
    }


@pytest.fixture(scope="module")
def model(dirs):
    return Model.from_dir(dirs["exl2"], device="cpu")


@pytest.fixture(scope="module")
def trained():
    """Writes text (the random models write arbitrary bytes)."""
    return Model.from_dir(TRAINED, device="cpu")


def _gen(model, pages=32, max_batch=8, kind="bf16", tokenizer=TOK, **kw):
    st = model.static
    cache = PagedKVCache.alloc(st.num_layers, pages, st.num_kv_heads,
                               st.head_dim, kind, device="cpu")
    return DynamicGenerator(model, cache, tokenizer,
                            max_batch_size=max_batch, **kw)


def _run(gen, jobs, check=False):
    while any(j.status != "done" for j in jobs):
        gen.iterate()
        if check:
            gen._validate_cache()


@pytest.mark.parametrize("name", ["trained", "hd128"])
def test_greedy_batch_matches_reference_generate_greedy(dirs, name):
    d = dirs[name]
    tm = Model.from_dir(d, device="cpu")
    ref = RefModel.from_dir(d)
    tok = ByteTokenizer(256)                 # no EOS id: all 6 tokens run
    # equal lengths, so one batched reference call serves all three
    prompts = ["The quick brown fox", "hello there, friend",
               "In the beginning of"]
    gen = _gen(tm, pages=16, max_batch=4, tokenizer=tok, decode_burst=1)
    jobs = [gen.enqueue(DynamicJob(tok.encode(p), max_new_tokens=6,
                                   settings=Settings.greedy()))
            for p in prompts]
    _run(gen, jobs, check=True)
    ids = np.stack([tok.encode(p) for p in prompts])
    want = ref.generate_greedy(ids, 6, max_seq=32)[:, ids.shape[1]:]
    for job, w in zip(jobs, want):
        np.testing.assert_array_equal(job.sequence[ids.shape[1]:], w)
        assert job.emitted_text == tok.decode(w)
        assert job.eos_reason == "max_new_tokens"


def test_paged_logits_follow_linear_forward(model):
    """Teacher-forced: every step's paged logits within 0.05 of the port's
    linear-cache forward on the same tokens (bf16 K/V rounding apart)."""
    gen = _gen(model)
    ids = TOK.encode("hello world")
    job = gen.enqueue(DynamicJob(ids, max_new_tokens=12,
                                 settings=Settings.greedy(),
                                 return_logits=True))
    paged = []
    while job.status != "done":
        for r in gen.iterate():
            if r.get("logits") is not None:
                paged.append(r["logits"][0])
    toks = job.sequence[len(ids):]
    assert len(paged) == len(toks) == 12
    cache = model.new_cache(1, 64)
    lg, cache = model.forward(ids[None], cache, 0, last_token_only=True)
    pos = len(ids)
    for t, pl in zip(toks, paged):
        ref = lg[0, -1].numpy()
        assert np.abs(pl - ref).max() < 0.05
        lg, cache = model.forward(np.asarray([[t]], np.int32), cache, pos)
        pos += 1


def test_burst_decode_matches_single_step(model):
    prompt = "burst decode check"
    base = _gen(model, decode_burst=1).generate(
        prompt, max_new_tokens=24, settings=Settings.greedy())
    got = _gen(model, decode_burst=8).generate(
        prompt, max_new_tokens=24, settings=Settings.greedy())
    assert got == base and len(base) > 0
    stop = base[3:6]                           # a stop string mid-burst
    b1 = _gen(model, decode_burst=1).generate(
        prompt, max_new_tokens=24, settings=Settings.greedy(),
        stop_conditions=[stop])
    b8 = _gen(model, decode_burst=8).generate(
        prompt, max_new_tokens=24, settings=Settings.greedy(),
        stop_conditions=[stop])
    assert b8 == b1 == base[:base.find(stop)]
    # sampled bursts run, respect max_new_tokens and carry mirostat state
    gen = _gen(model, decode_burst=8)
    job = gen.enqueue(DynamicJob(np.asarray([5, 9, 100], np.int32),
                                 max_new_tokens=11,
                                 settings=Settings(temperature=0.9, top_k=20,
                                                   mirostat=True)))
    _run(gen, [job])
    assert job.new_tokens == 11 and job.mirostat_mu != 0.0


def test_prompt_dedup_reuses_pages(model):
    gen = _gen(model, pages=64)
    long_prompt = "z" * 600                    # > 2 pages of 256
    first = gen.generate(long_prompt, max_new_tokens=4,
                         settings=Settings.greedy())
    job = gen.enqueue(DynamicJob(TOK.encode(long_prompt), max_new_tokens=4,
                                 settings=Settings.greedy()))
    _run(gen, [job], check=True)
    assert job.reused_tokens == 512
    fresh = _gen(model, pages=64).generate(long_prompt, max_new_tokens=4,
                                           settings=Settings.greedy())
    assert job.emitted_text == fresh == first


def test_partial_page_reuse_copies_a_page(model):
    gen = _gen(model, pages=16, decode_burst=1)
    a = "q" * 300 + "r" * 300                  # fills and hashes 2 pages
    b = "q" * 300 + "r" * 100 + "s" * 200
    gen.generate(a, max_new_tokens=3, settings=Settings.greedy())
    job = gen.enqueue(DynamicJob(TOK.encode(b), max_new_tokens=3,
                                 settings=Settings.greedy()))
    _run(gen, [job], check=True)
    assert job.reused_tokens == 400            # 256 shared + 144 copied
    fresh = _gen(model, pages=16).generate(b, max_new_tokens=3,
                                           settings=Settings.greedy())
    assert job.emitted_text == fresh


def test_stop_conditions_and_result_schema(trained):
    ref = _gen(trained).generate("The ", max_new_tokens=10,
                                 settings=Settings.greedy())
    assert len(ref) == 10 and ref[2] not in ref[:2]
    gen = _gen(trained)
    tok_id = ord(ref[2])
    jobs = [gen.enqueue(DynamicJob(TOK.encode("The "), max_new_tokens=10,
                                   settings=Settings.greedy(),
                                   stop_conditions=sc, identifier=i))
            for i, sc in enumerate([[tok_id], [ref[1:3]], None])]
    finals = {}
    while any(j.status != "done" for j in jobs):
        for r in gen.iterate():
            if r.get("eos"):
                finals[r["identifier"]] = r
    assert [finals[i]["eos_reason"] for i in range(3)] == \
        ["stop_token", "stop_string", "max_new_tokens"]
    assert finals[0]["full_completion"] == ref[:2]
    assert finals[1]["full_completion"] == ref[:1]
    assert finals[2]["full_completion"] == ref
    for k in ("full_completion", "new_tokens", "prompt_tokens",
              "cached_tokens", "time_enqueued", "time_prefill",
              "time_generate", "tokens_per_second", "eos_reason", "text",
              "token_ids", "identifier", "serial", "job", "stage"):
        assert k in finals[2], k
    assert finals[2]["new_tokens"] == 10 and finals[2]["prompt_tokens"] == 4
    for job, r in zip(jobs, (finals[i] for i in range(3))):
        assert 0 < job.time_enqueue <= job.time_admitted \
            <= job.time_first_token <= job.time_last_token
        assert r["time_enqueued"] == job.time_admitted - job.time_enqueue
        assert r["time_prefill"] == job.time_first_token - job.time_admitted
        assert r["time_enqueued"] + r["time_prefill"] == pytest.approx(
            job.time_first_token - job.time_enqueue, rel=0, abs=1e-9)


def test_result_extras(model):
    gen = _gen(model)
    job = gen.enqueue(DynamicJob(
        TOK.encode("xy"), max_new_tokens=4, return_probs=True,
        return_top_tokens=3, min_new_tokens=4, stop_conditions=[ord("e")],
        settings=Settings.greedy(banned_tokens=[32, 101],
                                 token_bias=np.full(384, 0.1))))
    rs = []
    while job.status != "done":
        rs += [r for r in gen.iterate() if r["stage"] == "streaming"]
    assert len(rs) == 4 and job.eos_reason == "max_new_tokens"
    for r in rs:
        assert r["token_ids"][0] not in (32, 101)
        assert r["token_probs"].shape == (1,)
        assert r["top_k_tokens"].shape == r["top_k_probs"].shape == (1, 3)


def test_enqueue_rejects_unservable_job(model):
    gen = _gen(model, pages=4)                 # 3 usable pages = 768 tokens
    ids = (np.arange(700) % 250).astype(np.int32)
    with pytest.raises(ValueError, match="usable pages"):
        gen.enqueue(DynamicJob(ids, max_new_tokens=100))
    out = gen.generate("ok", max_new_tokens=6, settings=Settings.greedy())
    assert isinstance(out, str)


@pytest.mark.parametrize("seed,burst", [(0, 1), (1, 1), (2, 8)])
def test_scheduler_fuzz_invariants(model, seed, burst):
    """Mixed prompt lengths with shared prefixes, stop strings and
    mid-flight cancels; the page-table invariants hold after every
    iterate and the pool is fully reclaimed."""
    gen = _gen(model, pages=12, max_batch=4, decode_burst=burst)
    rng = np.random.default_rng(seed)
    words = ["alpha ", "beta ", "gamma ", "delta "]
    common = "shared prefix " * 20
    jobs = []
    for _ in range(12):
        plen = int(rng.integers(4, 600))
        body = "".join(rng.choice(words, 120))
        prompt = (common + body if rng.random() < 0.5 else body)[:plen] \
            or "x"
        kw = {"stop_conditions": ["ga"]} if rng.random() < 0.3 else {}
        jobs.append(DynamicJob(TOK.encode(prompt),
                               max_new_tokens=int(rng.integers(1, 24)),
                               settings=Settings.greedy(), **kw))
    queue = list(jobs)
    guard = 0
    while queue or gen.num_remaining_jobs():
        while queue and gen.num_remaining_jobs() < 6:
            gen.enqueue(queue.pop(0))
        gen.iterate()
        gen._validate_cache()
        if rng.random() < 0.05 and gen.active:
            gen.cancel(gen.active[int(rng.integers(len(gen.active)))])
            gen._validate_cache()
        guard += 1
        assert guard < 3000, "fuzz workload did not converge"
    assert all(j.status == "done" for j in jobs)
    for j in jobs:
        assert j.eos_reason in ("max_new_tokens", "stop_token",
                                "stop_string", "cancelled"), j.eos_reason
    assert len(gen.free_pages) + len(gen.unreferenced) == len(gen.pages) - 1


@pytest.mark.parametrize("kind", ["q8", "q4", "q6", "fp8"])
def test_quantized_cache_generation(model, kind):
    gen = _gen(model, kind=kind)
    job = gen.enqueue(DynamicJob(TOK.encode("hello"), max_new_tokens=6,
                                 settings=Settings.greedy(),
                                 return_logits=True))
    lgs = []
    while job.status != "done":
        lgs += [r["logits"] for r in gen.iterate() if "logits" in r]
    assert job.new_tokens == 6 and np.isfinite(np.stack(lgs)).all()


def test_api_methods(model):
    gen = _gen(model, pages=8, max_batch=4)
    gen.warmup()
    assert len(gen.free_pages) == len(gen.pages) - 1
    assert gen.num_remaining_jobs() == 0
    base = "shared prefix " * 24               # 336 tokens > one page
    jobs = [gen.enqueue(DynamicJob(TOK.encode(p), max_new_tokens=8,
                                   settings=Settings.greedy()))
            for p in (base + "one", base + "two", "short")]
    assert gen.num_remaining_jobs() == 3
    _run(gen, jobs, check=True)
    assert gen.referenced or gen.unreferenced
    gen.defrag()
    gen._validate_cache()
    again = gen.generate(base + "one", max_new_tokens=8,
                         settings=Settings.greedy())
    assert again == jobs[0].emitted_text       # reused page after defrag
    gen.reset_page_table()
    assert not gen.referenced and not gen.unreferenced
    pending = gen.enqueue(DynamicJob(TOK.encode("later"), max_new_tokens=4))
    gen.clear_queue()
    assert pending.eos_reason == "cancelled" and not gen.num_remaining_jobs()
    gen.validate_cache()
    gen.print_page_list()


def test_base_generator(model):
    gen = BaseGenerator(model, PagedKVCache.alloc(
        model.static.num_layers, 16, model.static.num_kv_heads,
        model.static.head_dim, device="cpu"), TOK)
    outs = gen.generate_simple(["ab", "cd"], Settings.greedy(), num_tokens=5,
                               completion_only=True)
    assert len(outs) == 2 and all(isinstance(o, str) for o in outs)
    healed = gen.generate_simple("ab", Settings.greedy(), num_tokens=5,
                                 token_healing=True, completion_only=True)
    # the healed first token extends the removed "b": with one byte a
    # token, that is "b" itself
    assert healed.startswith("b")


@pytest.mark.parametrize("arg", [
    "filters", "token_healing", "banned_strings", "negative_prompt_ids",
    "embeddings", "post_sampling_hooks"])
def test_unported_job_arguments_raise(arg):
    """Every job argument is ported: the constrained-generation arguments
    and the embeddings land on the job, and negative_prompt_ids makes a CFG
    job when the settings carry a cfg_scale (and none without)."""
    val = {"token_healing": True, "negative_prompt_ids": np.array([1, 2])}
    if arg == "negative_prompt_ids":
        assert not DynamicJob([1, 2, 3], **{arg: val[arg]}).is_cfg
        job = DynamicJob([1, 2, 3], settings=Settings(cfg_scale=1.5),
                         **{arg: val[arg]})
        assert job.is_cfg and job.negative_ids.tolist() == [1, 2]
    else:
        job = DynamicJob([1, 2, 3], **{arg: val.get(arg, ["x"])})
        assert getattr(job, arg) == val.get(arg, ["x"])


@pytest.mark.parametrize("arg", [
    "draft_model", "draft_cache", "use_ngram_draft", "mesh"])
def test_unported_generator_arguments_raise(model, arg):
    """Every one of these is ported now. mesh= takes a
    parallel/sharding.Mesh (anything else raises); a one-rank mesh serves
    the plain tokens (tests/test_torch_sharding.py runs real ranks). The
    speculative options: a draft model needs a draft cache over the main
    cache's pages, the n-gram drafter needs nothing."""
    if arg == "mesh":
        from exllamav2_tpu_torch.parallel.sharding import Mesh
        with pytest.raises(TypeError, match=arg):
            _gen(model, mesh=True)
        one = Mesh(tp=1, dp=1, rank=0, tp_rank=0, dp_rank=0, tp_group=None,
                   dp_group=None, backend="gloo", device=torch.device("cpu"))
        gen = _gen(model, mesh=one)
        assert not gen._tp_fused and gen.step_graphs is None
        kw = dict(max_new_tokens=6, settings=Settings.greedy())
        assert gen.generate("hello", **kw) == _gen(model).generate(
            "hello", **kw)
    elif arg == "draft_model":
        with pytest.raises(ValueError, match="draft_cache"):
            _gen(model, draft_model=model)
        st = model.static
        small = PagedKVCache.alloc(st.num_layers, 8, st.num_kv_heads,
                                   st.head_dim, device="cpu")
        with pytest.raises(ValueError, match="draft_cache"):
            _gen(model, draft_model=model, draft_cache=small)
    else:
        gen = _gen(model, **{arg: True})
        assert (gen.ngram is not None) == (arg == "use_ngram_draft")


@pytest.mark.parametrize("arg", ["merged_weights", "w4a8"])
def test_ported_generator_arguments_work(model, arg):
    """merged_weights= and w4a8= serve from new weight modules and leave
    the model they were given alone."""
    gen = _gen(model, **{arg: True})
    lw = gen.model.weights.layers[0]
    if arg == "merged_weights":
        assert lw.attn.qkv is not None and lw.mlp.gate_up is not None
    else:
        assert all(s.act8 for s in lw.attn.q.segments)
    assert model.weights.layers[0].attn.qkv is None
    assert not any(s.act8 for s in model.weights.layers[0].attn.q.segments)
    out = gen.generate("hello", max_new_tokens=6, settings=Settings.greedy())
    assert isinstance(out, str) and gen.num_remaining_jobs() == 0


def test_unported_generator_methods_raise(model):
    """Every generator method is ported: set_loras (a detach with nothing
    attached leaves the weights as they are), the MoE drop counters (a
    dense model drops nothing) and the embeddings: an alias becomes its
    embedding's ids, and a job with embedding rows runs to its end."""
    from exllamav2_tpu_torch.vlm import MMEmbedding
    gen = _gen(model)
    w = gen.model.weights
    gen.set_loras(None)
    assert gen.model.weights is w
    assert gen.moe_dropped_tokens == 0
    assert gen.encode_with_embeddings("xy", []).tolist() == \
        TOK.encode("xy").tolist()
    mme = MMEmbedding(np.random.default_rng(0).standard_normal(
        (3, model.static.hidden_size)) * 0.02, text_alias="<e>",
                      device="cpu")
    ids = gen.encode_with_embeddings("a<e>b", [mme])
    assert ids.tolist() == [*TOK.encode("a").tolist(), *mme.get_ids(),
                            *TOK.encode("b").tolist()]
    out = gen.generate("a<e>b", max_new_tokens=4, settings=Settings.greedy(),
                       embeddings=[mme])
    assert isinstance(out, str) and gen.num_remaining_jobs() == 0


def test_generator_device_follows_model(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = _gen(model)
    assert gen.device.type == "cpu" and gen.hist.device.type == "cpu"
    st = model.static
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynamicGenerator(model, PagedKVCache.alloc(
            st.num_layers, 4, st.num_kv_heads, st.head_dim), TOK)


def test_prescale_leaves_the_callers_model_alone(dirs):
    """DynamicGenerator(prescale=True) serves from a prescaled copy: none
    of the caller's segments gains scale_f (all did, in place)."""
    model = Model.from_dir(dirs["exl2"], device="cpu", prescale=False)

    def segs(w):
        return [s for lw in w.layers for lin in (
            lw.attn.q, lw.attn.k, lw.attn.v, lw.attn.o, lw.mlp.gate,
            lw.mlp.up, lw.mlp.down) for s in lin.segments]
    assert not any(s.scale_f is not None for s in segs(model.weights))
    gen = _gen(model, prescale=True)
    assert not any(s.scale_f is not None for s in segs(model.weights))
    assert all(s.scale_f is not None for s in segs(gen.model.weights))
    assert gen.model.weights is not model.weights
