"""The step graphs (utils/graphs.py) and the device position of the linear
step.

On the CPU there is no graph to capture: a runner built for the CPU keeps
the static buffers, runs the warm-up and calls the step function on the
buffers, so these tests hold exactly what a card replays -- static inputs
in, static outputs out, pad rows, buffers left from an earlier step -- to
the eager step, bitwise (the same ops on the same values). The linear step
with its position in a tensor equals the host-int step bitwise, and the JAX
reference within the tolerances of tests/test_torch_model.py. The tests
marked `cuda` capture and replay on a card and skip here; the card's
machine has no JAX, so the reference is imported by the tests that use it
(`python -m pytest tests/test_torch_graphs.py -m cuda` runs there).
"""

import gc
import os
import types
import weakref

import numpy as np
import pytest
import torch

from exllamav2_tpu_torch.cache import KVCache
from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.interop import to_tensor, weights_from_reference
from exllamav2_tpu_torch.models.forward import model_forward
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.ops import decode_attn as TA
from exllamav2_tpu_torch.ops import qmm as Q
from exllamav2_tpu_torch.tokenizer import ByteTokenizer
from exllamav2_tpu_torch.utils.graphs import StepGraphs

TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "trained_tiny")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that test workers running side
    by side do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


# ---------------------------------------------------------------------------
# kernel 2's plain version with past_len in a tensor
# ---------------------------------------------------------------------------

L, B, HQ, HKV, S, D = 2, 3, 8, 2, 512, 64
LIMIT = 256


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 17)])
def test_decode_attention_tensor_past_len_matches_reference(per_row, softcap,
                                                            window):
    """0-d and [B] positions against the reference's kernel (interpret
    mode), row by row at that row's position: 1e-5 of max |ref|."""
    import jax.numpy as jnp
    import ml_dtypes
    from exllamav2_tpu.ops.decode_attn import decode_attention as ref_attn
    rng = np.random.default_rng(7 + per_row)

    def bf16(shape):
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)

    q, k, v = bf16((B, HQ, D)), bf16((L, B, HKV, S, D)), \
        bf16((L, B, HKV, S, D))
    past = [0, 100, LIMIT - 1] if per_row else [77] * B
    pl = torch.tensor(past, dtype=torch.int32) if per_row \
        else torch.tensor(past[0], dtype=torch.int32)
    got = TA.decode_attention(*(to_tensor(a, "cpu") for a in (q, k, v)), 1,
                              pl, LIMIT, D ** -0.5, softcap, window).numpy()
    for i, p in enumerate(past):
        ref = np.asarray(ref_attn(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1, jnp.int32(p),
            LIMIT, D ** -0.5, softcap, window))[i]
        assert np.abs(got[i] - ref).max() <= 1e-5 * np.abs(ref).max(), i


# ---------------------------------------------------------------------------
# the linear step with a device position
# ---------------------------------------------------------------------------

def test_linear_step_tensor_position_equals_int_and_reference():
    """Random weights drawn by the reference: after an 8-token prefill,
    four decode steps with the position as a host int, a 0-d tensor and a
    [B] tensor: the three equal bitwise (logits and caches), and the
    reference within 1e-2 relative (tests/test_torch_model.py)."""
    import jax
    import jax.numpy as jnp
    from exllamav2_tpu.cache import KVCache as RefCache
    from exllamav2_tpu.models import forward as RF
    from exllamav2_tpu.utils.testing import random_model_weights as ref_weights
    w, st = ref_weights(vocab=512, hidden=256, layers=2, heads=8, kv_heads=4,
                        inter=512, max_seq=64, bits=4, seed=3)
    tw, tst = weights_from_reference(jax.tree_util.tree_map(np.asarray, w),
                                     st, device="cpu")
    ids = np.random.default_rng(0).integers(3, 500, (2, 12)).astype(np.int32)
    step = jax.jit(RF.model_forward, static_argnums=(1, 5, 6))
    rc = RefCache.alloc(2, 2, 64, 4, 32)
    caches = [KVCache.alloc(2, 2, 64, 4, 32, device="cpu") for _ in range(3)]
    pre = 8
    ref, rc = step(w, st, jnp.asarray(ids[:, :pre]), rc, jnp.int32(0),
                   False, 256)
    for c in caches:
        model_forward(tw, tst, torch.from_numpy(ids[:, :pre]), c, 0,
                      attn_limit=64)
    for pos in range(pre, 12):
        ref, rc = step(w, st, jnp.asarray(ids[:, pos:pos + 1]), rc,
                       jnp.int32(pos), False, 256)
        x = torch.from_numpy(ids[:, pos:pos + 1])
        outs = [model_forward(tw, tst, x, c, p, attn_limit=64)[0]
                for c, p in zip(caches, (
                    pos, torch.tensor(pos, dtype=torch.int32),
                    torch.full((2,), pos, dtype=torch.int32)))]
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
        assert _rel(outs[1], ref) < 1e-2, pos
    for c in caches[1:]:
        assert torch.equal(c.k, caches[0].k) and torch.equal(c.v, caches[0].v)


def test_linear_step_per_row_positions():
    """[B] positions write each row at its own position and attend to its
    own prefix: row i of a batch step equals a batch-1 step at position
    p_i on that row's cache, within f32 sum order (1e-4 relative)."""
    import jax
    from exllamav2_tpu.utils.testing import random_model_weights as ref_weights
    w, st = ref_weights(vocab=256, hidden=128, layers=2, heads=4, kv_heads=2,
                        inter=256, max_seq=64, bits=4, seed=5)
    tw, tst = weights_from_reference(jax.tree_util.tree_map(np.asarray, w),
                                     st, device="cpu")
    rng = np.random.default_rng(1)
    lens = [5, 9]
    batch = KVCache.alloc(2, 2, 64, 2, 32, device="cpu")
    singles = [KVCache.alloc(2, 1, 64, 2, 32, device="cpu") for _ in lens]
    for i, n in enumerate(lens):
        p = torch.from_numpy(rng.integers(3, 250, (1, n)).astype(np.int32))
        model_forward(tw, tst, p, singles[i], 0, attn_limit=64)
        # the batch cache's row i gets the same prompt rows
        one = KVCache(batch.k[:, i:i + 1], batch.v[:, i:i + 1])
        model_forward(tw, tst, p, one, 0, attn_limit=64)
    tok = torch.tensor([[17], [33]], dtype=torch.int32)
    got, _ = model_forward(tw, tst, tok, batch,
                           torch.tensor(lens, dtype=torch.int32),
                           attn_limit=64)
    for i, n in enumerate(lens):
        ref, _ = model_forward(tw, tst, tok[i:i + 1], singles[i], n,
                               attn_limit=64)
        assert _rel(got[i], ref[0]) < 1e-4
        assert batch.k[:, i, :, n].abs().sum() > 0          # written here
        assert batch.k[:, i, :, n + 1:].abs().sum() == 0    # and only here


# ---------------------------------------------------------------------------
# the runner itself
# ---------------------------------------------------------------------------

def test_runner_first_call_counts_one_step():
    """The warm-up's launch counts and random draws are set back: the first
    call of a key leaves what one step leaves, and so does every replay."""
    g = torch.Generator()
    g.manual_seed(3)
    ref = torch.Generator()
    ref.manual_seed(3)
    runner = StepGraphs("cpu", max_graphs=2, generators=[g])

    def step(x):
        Q.LAUNCHES["qmm"] += 1
        return torch.rand((3,), generator=g) + x

    before = Q.LAUNCHES["qmm"]
    for i in range(3):
        x = torch.full((3,), float(i))
        out = runner(("k", 4), step, x)
        assert torch.equal(out, torch.rand((3,), generator=ref) + i)
        assert Q.LAUNCHES["qmm"] == before + i + 1
    assert runner.captures == {("k", 4): 1} and runner.replays[("k", 4)] == 3
    with pytest.raises(ValueError, match="buffer"):
        runner(("k", 4), step, torch.zeros(5))
    runner(("a",), step, 1)
    runner(("b",), step, 1)
    assert list(runner.entries) == [("a",), ("b",)]     # at most 2 kept


# ---------------------------------------------------------------------------
# the greedy decode step
# ---------------------------------------------------------------------------

def test_greedy_graph_step_equals_eager_and_reference():
    from exllamav2_tpu.models.model import Model as RefModel
    prompt = np.array([[1, 50, 99, 7], [5, 6, 7, 8]], np.int32)
    ref = RefModel.from_dir(TRAINED).generate_greedy(prompt, 10, max_seq=32)
    eager = Model.from_dir(TRAINED, device="cpu")
    graphed = Model.from_dir(TRAINED, device="cpu", graphs=True)
    assert not eager.graphs and eager.step_graphs is None
    e = eager.generate_greedy(prompt, 10, max_seq=32)
    g = graphed.generate_greedy(prompt, 10, max_seq=32)
    np.testing.assert_array_equal(g, e)
    np.testing.assert_array_equal(g, ref)
    runner = graphed.step_graphs
    (key,) = runner.captures
    assert key[:2] == (2, 32) and runner.replays[key] == 9
    # a second call reuses the cache and its graph: buffers hold the last
    # call's inputs, which must not leak into this one
    g2 = graphed.generate_greedy(prompt[::-1], 10, max_seq=32)
    np.testing.assert_array_equal(g2, e[::-1])
    assert runner.captures == {key: 1} and runner.replays[key] == 18
    # the public forward at t = 1 returns a copy, not the static output
    cache = graphed.new_cache(1, 32)
    a, _ = graphed.forward(prompt[:1, :1], cache, 0)
    b, _ = graphed.forward(prompt[:1, 1:2], cache, 1)
    assert not torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    with pytest.raises(ValueError, match="max_seq"):
        graphed.forward(prompt[:1, :1], cache, 32)


# ---------------------------------------------------------------------------
# the serving step and burst
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    from exllamav2_tpu.utils.testing import make_tiny_llama
    root = tmp_path_factory.mktemp("torch_graphs")
    return make_tiny_llama(str(root / "exl2"), quant="exl2", seed=5,
                           vocab=384, max_pos=4096)


def _round(model, jobs_fn, graphs, page=16, pages=48, tok=None, **kw):
    st = model.static
    cache = PagedKVCache.alloc(st.num_layers, pages, st.num_kv_heads,
                               st.head_dim, page_size=page, device="cpu")
    gen = DynamicGenerator(model, cache, tok or ByteTokenizer(384),
                           max_batch_size=8, max_chunk_size=64,
                           graphs=graphs, **kw)
    jobs = jobs_fn()
    for j in jobs:
        gen.enqueue(j)
    while any(j.status != "done" for j in jobs):
        gen.iterate()
        gen._validate_cache()
    return gen, jobs


def _mixed_jobs():
    """Five jobs over 16-row pages: prompts of 1-5 pages, lengths that end
    the jobs at different steps (batch buckets 8 -> 1, page buckets 8 -> 2),
    greedy and sampled settings (penalties, DRY, mirostat), one job masked
    on its first two steps (an EOS floor)."""
    rng = np.random.default_rng(2)
    sets = [Settings.greedy(),
            Settings(temperature=0.9, top_k=20),
            Settings(temperature=0.7, mirostat=True),
            Settings.greedy(dry_multiplier=0.8,
                            token_repetition_penalty=1.2),
            Settings(temperature=1.1, top_p=0.9)]
    out = []
    for i, (plen, new) in enumerate(((70, 21), (12, 6), (40, 13), (5, 9),
                                     (25, 4))):
        kw = {"min_new_tokens": 2} if i == 4 else {}
        out.append(DynamicJob(rng.integers(3, 250, plen).astype(np.int32),
                              max_new_tokens=new, settings=sets[i], **kw))
    return out


def test_serving_graph_steps_equal_eager(tiny_dir):
    model = Model.from_dir(tiny_dir, device="cpu")
    g, gj = _round(model, _mixed_jobs, True, decode_burst=4)
    e, ej = _round(model, _mixed_jobs, False, decode_burst=4)
    assert e.step_graphs is None
    for a, b in zip(gj, ej):
        np.testing.assert_array_equal(a.sequence, b.sequence)
        assert a.last_prob == b.last_prob
        assert a.mirostat_mu == b.mirostat_mu and a.eos_reason == b.eos_reason
    keys = set(g.step_graphs.captures)
    assert all(n == 1 for n in g.step_graphs.captures.values())
    steps = {k for k in keys if k[0] == "decode"}
    bursts = {k for k in keys if k[0] == "decode_burst"}
    assert all(len(k) == 9 for k in steps) and all(len(k) == 7
                                                   for k in bursts)
    assert len({k[1] for k in keys}) >= 3            # batch buckets moved
    assert len({k[2] for k in keys}) >= 2            # page buckets moved
    assert any(k[3] == 4 for k in bursts)            # a burst of 4
    assert any(k[3] for k in steps)                  # a masked step
    assert any(k[-1] for k in keys) and any(k[4] for k in keys)  # pen, DRY
    assert sum(g.step_graphs.replays.values()) > len(keys)
    # the generator and its graphs go with its last reference, not at a
    # later cyclic collection (which may fall inside another capture)
    gone = weakref.ref(g)
    gc.disable()
    try:
        del g
        assert gone() is None
    finally:
        gc.enable()


def test_serving_graph_keys_equal_reference(tiny_dir):
    """The same greedy round through the reference's generator compiles
    the keys the port captures: ("decode", ...) and ("decode_burst", ...)
    tuples, verbatim."""
    from exllamav2_tpu.cache_paged import PagedKVCache as RefPagedCache
    from exllamav2_tpu.generator.dynamic import DynamicGenerator as RefGen
    from exllamav2_tpu.generator.dynamic import DynamicJob as RefJob
    from exllamav2_tpu.generator.sampler import Settings as RefSettings
    from exllamav2_tpu.models.model import Model as RefModel
    tok = ByteTokenizer(256)                       # no EOS id

    def jobs(job=DynamicJob, settings=Settings):
        rng = np.random.default_rng(4)
        out = []
        for i, (plen, new) in enumerate(((40, 9), (12, 5), (20, 3))):
            s = settings.greedy(token_repetition_penalty=1.2) if i == 1 \
                else settings.greedy()
            out.append(job(rng.integers(3, 250, plen).astype(np.int32),
                           max_new_tokens=new, settings=s,
                           token_healing=i == 2))
        return out

    model = Model.from_dir(tiny_dir, device="cpu")
    gen, _ = _round(model, jobs, True, tok=tok, decode_burst=4)
    st = model.static
    ref = RefGen(RefModel.from_dir(tiny_dir), RefPagedCache.alloc(
        st.num_layers, 48, st.num_kv_heads, st.head_dim, page_size=16), tok,
        max_batch_size=8, max_chunk_size=64, decode_burst=4)
    rjobs = jobs(RefJob, RefSettings)
    for j in rjobs:
        ref.enqueue(j)
    while any(j.status != "done" for j in rjobs):
        ref.iterate()
    want = {k for k in ref._compiled if k[0] in ("decode", "decode_burst")}
    assert set(gen.step_graphs.captures) == want and len(want) >= 3


# ---------------------------------------------------------------------------
# what a graph reads: the weights and the cache of its capture
# ---------------------------------------------------------------------------

def _small_weights(seed, device="cpu"):
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    return random_model_weights(vocab=512, hidden=256, layers=2, heads=4,
                                kv_heads=4, inter=512, max_seq=64, bits=4,
                                seed=seed, device=device)


def test_weight_swap_drops_the_step_graphs():
    """generate_greedy, then model.weights set to another seed's weights:
    the graphed tokens equal a fresh model's eager tokens on those weights
    (a graph that kept its capture's weights parted at the second new
    token)."""
    w0, st = _small_weights(0)
    w1, _ = _small_weights(1)
    prompt = np.array([[1, 50, 99, 7]], np.int32)
    model = Model(w0, st, graphs=True)
    first = model.generate_greedy(prompt, 8)
    np.testing.assert_array_equal(
        first, Model(w0, st, graphs=False).generate_greedy(prompt, 8))
    model.weights = w1
    got = model.generate_greedy(prompt, 8)
    want = Model(w1, st, graphs=False).generate_greedy(prompt, 8)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, first)
    model.weights = w0
    assert not model.step_graphs.entries


def test_dropped_cache_frees_its_graphs():
    """20 caches, each used for one graphed step and dropped: every one is
    collected, and its graphs go with it (the runner held 16 before)."""
    w, st = _small_weights(0)
    model = Model(w, st, graphs=True)
    refs = []
    for i in range(20):
        cache = model.new_cache(1, 64)
        model.forward(np.array([[3 + i]], np.int32), cache, 0)
        refs.append(weakref.ref(cache))
        del cache
    gc.collect()
    assert [r() for r in refs] == [None] * 20
    assert not model.step_graphs.entries
    assert sum(model.step_graphs.captures.values()) == 20


def _cfg_jobs():
    """Three CFG jobs (greedy, sampled with penalties, mirostat) and one
    plain job, negative prompts of 1-3 pages of 16 rows."""
    rng = np.random.default_rng(6)
    sets = [Settings.greedy(), Settings(temperature=0.9, top_k=20,
                                        token_repetition_penalty=1.2),
            Settings(temperature=0.7, mirostat=True), Settings.greedy()]
    out = []
    for i, (plen, nlen, new) in enumerate(((30, 20, 9), (12, 40, 6),
                                           (50, 5, 11), (20, 0, 7))):
        s = sets[i]
        if nlen:
            s.cfg_scale = 1.5 + 0.5 * i
        out.append(DynamicJob(
            rng.integers(3, 250, plen).astype(np.int32), max_new_tokens=new,
            settings=s, negative_prompt_ids=rng.integers(
                3, 250, nlen).astype(np.int32) if nlen else None))
    return out


def test_cfg_graph_step_equals_eager(tiny_dir):
    model = Model.from_dir(tiny_dir, device="cpu")
    g, gj = _round(model, _cfg_jobs, True, decode_burst=1)
    e, ej = _round(model, _cfg_jobs, False, decode_burst=1)
    for a, b in zip(gj, ej):
        np.testing.assert_array_equal(a.sequence, b.sequence)
        assert (a.kv_pos2, a.mirostat_mu) == (b.kv_pos2, b.mirostat_mu)
    keys = set(g.step_graphs.captures)
    cfg = {k for k in keys if k[0] == "decode_cfg"}
    assert len({k[1] for k in cfg}) >= 2 and all(len(k) == 3 for k in cfg)
    assert any(k[0] == "decode" for k in keys)          # the plain job
    assert [j.kv_pos2 for j in gj[:3]] == [
        len(j.negative_ids) + j.max_new_tokens - 1 for j in gj[:3]]


def _spec_jobs():
    """Four jobs for speculative rounds: a repeating prompt (drafts get
    accepted), greedy and sampled settings with penalties."""
    rng = np.random.default_rng(8)
    pat = rng.integers(3, 250, 6).astype(np.int32)
    sets = [Settings.greedy(), Settings(temperature=0.8, top_k=30),
            Settings.greedy(token_repetition_penalty=1.3),
            Settings(temperature=1.0, top_p=0.9)]
    prompts = [np.tile(pat, 5), rng.integers(3, 250, 20).astype(np.int32),
               np.tile(pat[:3], 9), rng.integers(3, 250, 40).astype(np.int32)]
    return [DynamicJob(p, max_new_tokens=n, settings=s)
            for p, n, s in zip(prompts, (17, 9, 13, 6), sets)]


@pytest.mark.parametrize("drafter", ["ngram", "draft_model"])
def test_spec_graph_steps_equal_eager(tiny_dir, drafter):
    """The draft and verify steps graphed against eager: the same tokens,
    accepted counts and keys ("draft", b, p, k) / ("verify", b, p, d)."""
    model = Model.from_dir(tiny_dir, device="cpu")
    st = model.static

    def kw():
        if drafter == "ngram":
            return {"use_ngram_draft": True}
        return {"draft_model": model, "draft_cache": PagedKVCache.alloc(
            st.num_layers, 48, st.num_kv_heads, st.head_dim, page_size=16,
            device="cpu")}

    g, gj = _round(model, _spec_jobs, True, decode_burst=4, **kw())
    e, ej = _round(model, _spec_jobs, False, decode_burst=4, **kw())
    for a, b in zip(gj, ej):
        np.testing.assert_array_equal(a.sequence, b.sequence)
        assert a.draft_accepted == b.draft_accepted
    assert sum(j.draft_accepted for j in gj) > 0
    keys = set(g.step_graphs.captures)
    assert {k[0] for k in keys} == ({"verify"} if drafter == "ngram"
                                    else {"draft", "verify"})
    assert all(len(k) == 4 and k[3] == 4 for k in keys)
    assert len({k[1] for k in keys}) >= 2


def test_set_loras_drops_the_graphs(tiny_dir, tmp_path):
    """A graphed generator: base tokens, then an adapter attached (every
    graph dropped, other tokens), then detached (the base tokens again);
    attaching the same adapter objects twice drops nothing."""
    from exllamav2_tpu_torch.lora import Lora
    from exllamav2_tpu_torch.utils.testing import write_random_lora
    model = Model.from_dir(tiny_dir, device="cpu")
    lora = Lora(write_random_lora(str(tmp_path / "lora"), model.weights,
                                  rank=4, scale=0.3, seed=2))
    st = model.static
    gen = DynamicGenerator(model, PagedKVCache.alloc(
        st.num_layers, 16, st.num_kv_heads, st.head_dim, device="cpu"),
        ByteTokenizer(384), graphs=True, decode_burst=1)

    def run():
        return gen.generate("set loras", max_new_tokens=8,
                            settings=Settings.greedy())

    base = run()
    assert gen.step_graphs.entries
    gen.set_loras([lora])
    assert not gen.step_graphs.entries
    adapted = run()
    kept = dict(gen.step_graphs.entries)
    gen.set_loras([lora])                         # the same objects
    assert gen.step_graphs.entries == kept
    assert run() == adapted
    gen.set_loras(None)
    assert not gen.step_graphs.entries
    assert run() == base and adapted != base
    eager = DynamicGenerator(model, PagedKVCache.alloc(
        st.num_layers, 16, st.num_kv_heads, st.head_dim, device="cpu"),
        ByteTokenizer(384), graphs=False, decode_burst=1)
    eager.set_loras([lora])
    assert eager.generate("set loras", max_new_tokens=8,
                          settings=Settings.greedy()) == adapted


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _card_model(dev, layers=3):
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    w, st = random_model_weights(vocab=1024, hidden=512, layers=layers,
                                 heads=4, kv_heads=4, inter=1024,
                                 max_seq=512, bits=4, seed=1, device=dev)
    from exllamav2_tpu_torch.ops.dequant import precompute_model_scales
    return precompute_model_scales(w), st


def _counts():
    from exllamav2_tpu_torch.ops import paged_attn as P
    return {**Q.LAUNCHES, **TA.LAUNCHES, **P.LAUNCHES}


@pytest.mark.cuda
def test_card_greedy_graphed_equals_eager_and_credits_launches(dev):
    w, st = _card_model(dev)
    prompt = np.random.default_rng(0).integers(3, 1000, (3, 9)).astype(
        np.int32)
    runs = {}
    for graphs in (False, True):
        m = Model(w, st, graphs=graphs)
        for b in (1, 3):
            before = _counts()
            seq = m.generate_greedy(prompt[:b], 12)
            torch.cuda.synchronize()
            after = _counts()
            runs[graphs, b] = (seq, {k: after[k] - before[k] for k in after})
        if graphs:
            assert sum(m.step_graphs.captures.values()) == 2
    for b in (1, 3):
        np.testing.assert_array_equal(runs[True, b][0], runs[False, b][0])
        assert runs[True, b][1] == runs[False, b][1]
        assert runs[True, b][1]["decode_attn"] == st.num_layers * 11


@pytest.mark.cuda
def test_card_serving_graphed_equals_eager(dev):
    w, st = _card_model(dev)
    tok = ByteTokenizer(256)

    def jobs():
        rng = np.random.default_rng(3)
        sets = [Settings.greedy(), Settings(temperature=0.9, top_k=20),
                Settings(temperature=0.7, mirostat=True),
                Settings.greedy(token_repetition_penalty=1.2)]
        return [DynamicJob(rng.integers(3, 250, n).astype(np.int32),
                           max_new_tokens=m, settings=s,
                           token_healing=i == 3)
                for i, (n, m, s) in enumerate(zip((300, 20, 60, 9),
                                                  (19, 7, 12, 10), sets))]

    out = {}
    for graphs in (False, True):
        cache = PagedKVCache.alloc(st.num_layers, 16, st.num_kv_heads,
                                   st.head_dim, device=dev)
        gen = DynamicGenerator(Model(w, st), cache, tok, max_batch_size=4,
                               decode_burst=4, graphs=graphs)
        js = jobs()
        for j in js:
            gen.enqueue(j)
        before = _counts()
        while any(j.status != "done" for j in js):
            gen.iterate()
        torch.cuda.synchronize()
        after = _counts()
        out[graphs] = ([j.sequence.tolist() for j in js],
                       [j.mirostat_mu for j in js],
                       {k: after[k] - before[k] for k in after})
    assert out[True] == out[False]


@pytest.mark.cuda
def test_card_failed_capture_raises(dev):
    runner = StepGraphs(dev, max_graphs=4)
    x = torch.ones(8, device=dev)
    before = _counts()

    def bad(x):
        Q.LAUNCHES["qmm"] += 1
        y = x * 2
        if torch.cuda.is_current_stream_capturing():
            y.sum().item()                 # a host sync: not capturable
        return y

    with pytest.raises(RuntimeError):
        runner(("bad",), bad, x)
    assert ("bad",) not in runner and _counts() == before
    torch.cuda.synchronize()
    out = runner(("good",), lambda x: x * 3, x)      # the runner still works
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full((8,), 3.0, device=dev))
    assert runner.replays == {("good",): 1}


@pytest.mark.cuda
def test_card_weight_swap_and_dropped_caches(dev):
    """On the card: a weight swap recaptures (graphed tokens equal a fresh
    eager model's), and dropped caches are collected with their graphs."""
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    w0, st = _card_model(dev, layers=2)
    w1, _ = random_model_weights(vocab=1024, hidden=512, layers=2, heads=4,
                                 kv_heads=4, inter=1024, max_seq=512, bits=4,
                                 seed=2, device=dev)
    prompt = np.array([[1, 50, 99, 7]], np.int32)
    model = Model(w0, st, graphs=True)
    model.generate_greedy(prompt, 8)
    model.weights = w1
    np.testing.assert_array_equal(
        model.generate_greedy(prompt, 8),
        Model(w1, st, graphs=False).generate_greedy(prompt, 8))
    kept = set(model.step_graphs.entries)
    refs = []
    for i in range(20):
        cache = model.new_cache(1, 256)
        model.forward(np.array([[3 + i]], np.int32), cache, 0)
        refs.append(weakref.ref(cache))
        del cache
    gc.collect()
    torch.cuda.synchronize()
    assert [r() for r in refs] == [None] * 20
    assert set(model.step_graphs.entries) <= kept


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["cfg", "ngram", "draft_model", "lora"])
def test_card_feature_steps_graphed_equal_eager(dev, path, tmp_path):
    """CFG, n-gram and draft-model speculative rounds and an adapted round
    on the card: graphed tokens equal eager, bitwise."""
    from exllamav2_tpu_torch.lora import Lora
    from exllamav2_tpu_torch.utils.testing import write_random_lora
    w, st = _card_model(dev, layers=2)
    tok = ByteTokenizer(256)
    lora = Lora(write_random_lora(str(tmp_path / "lora"), w, rank=8,
                                  scale=0.1)) if path == "lora" else None

    def cache():
        return PagedKVCache.alloc(st.num_layers, 24, st.num_kv_heads,
                                  st.head_dim, device=dev)

    def jobs():
        rng = np.random.default_rng(5)
        pat = rng.integers(3, 250, 8).astype(np.int32)
        out = []
        for i, s in enumerate((Settings.greedy(),
                               Settings(temperature=0.9, top_k=20))):
            neg = None
            if path == "cfg":
                s.cfg_scale = 1.5
                neg = rng.integers(3, 250, 40 + 30 * i).astype(np.int32)
            out.append(DynamicJob(np.tile(pat, 10 + 10 * i),
                                  max_new_tokens=17 + 4 * i, settings=s,
                                  negative_prompt_ids=neg))
        return out

    out = {}
    for graphs in (False, True):
        kw = {}
        if path == "ngram":
            kw = {"use_ngram_draft": True}
        elif path == "draft_model":
            kw = {"draft_model": Model(w, st), "draft_cache": cache()}
        gen = DynamicGenerator(Model(w, st), cache(), tok, max_batch_size=4,
                               decode_burst=4, graphs=graphs, **kw)
        if lora is not None:
            gen.set_loras([lora])
        js = jobs()
        for j in js:
            gen.enqueue(j)
        while any(j.status != "done" for j in js):
            gen.iterate()
        torch.cuda.synchronize()
        out[graphs] = [(j.sequence.tolist(), j.draft_accepted, j.kv_pos2)
                       for j in js]
    assert out[True] == out[False]


@pytest.mark.cuda
def test_card_moe_steps_graphed_equal_eager(dev):
    """An MoE model on the card: the gated decode (every expert's kernel-1
    launches read a device flag computed from the routing) replays in one
    graph a step with the eager tokens bitwise and the same launches, its
    logits within 0.02 of the forced-dense formulation's, and a serving
    round (the prefill's capacity dispatch, gated decode steps) graphed
    equals eager."""
    from exllamav2_tpu_torch.models import forward as F
    from exllamav2_tpu_torch.ops.dequant import precompute_model_scales
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    w, st = random_model_weights(vocab=1024, hidden=512, layers=2, heads=4,
                                 kv_heads=2, inter=1024, max_seq=512, bits=4,
                                 seed=4, moe=4, moe_topk=2, device=dev)
    w = precompute_model_scales(w)
    prompt = np.random.default_rng(1).integers(3, 1000, (2, 9)).astype(
        np.int32)
    runs = {}
    for graphs in (False, True):
        m = Model(w, st, graphs=graphs)
        before, g0 = _counts(), Q.GATED_LAUNCHES["qmm_gated"]
        seq = m.generate_greedy(prompt, 10)
        torch.cuda.synchronize()
        after = _counts()
        runs[graphs] = (seq, {k: after[k] - before[k] for k in after},
                        Q.GATED_LAUNCHES["qmm_gated"] - g0)
    assert np.array_equal(runs[True][0], runs[False][0])
    assert runs[True][1:] == runs[False][1:]
    # the 18-row prefill and 9 steps: every expert's three linears, gated
    assert runs[True][2] == 10 * st.num_layers * 3 * 4
    m = Model(w, st, graphs=False)
    cache = m.new_cache(2, 64)
    gated, _ = m.forward(prompt, cache, 0)
    F._FORCE_DENSE_MOE[0] = True
    try:
        dense, _ = m.forward(prompt, m.new_cache(2, 64), 0)
    finally:
        F._FORCE_DENSE_MOE[0] = False
    assert ((gated - dense).abs().max() / dense.abs().max()).item() < 0.02
    tok = ByteTokenizer(256)
    out = {}
    for graphs in (False, True):
        gen = DynamicGenerator(
            Model(w, st), PagedKVCache.alloc(st.num_layers, 16,
                                             st.num_kv_heads, st.head_dim,
                                             device=dev),
            tok, max_batch_size=4, decode_burst=4, graphs=graphs)
        js = [gen.enqueue(DynamicJob(
            np.random.default_rng(i).integers(3, 250, 70).astype(np.int32),
            max_new_tokens=9, settings=Settings.greedy())) for i in range(3)]
        while any(j.status != "done" for j in js):
            gen.iterate()
        out[graphs] = ([j.sequence.tolist() for j in js],
                       gen.moe_dropped_tokens)
    assert out[True] == out[False]


@pytest.mark.cuda
def test_card_mrope_mixed_offsets_graphed_equal_eager(dev, tmp_path):
    """A Qwen2-VL model on the card (the tiny checkpoint, its tower too):
    image jobs (MRoPE offsets < 0) and a text job (offset 0) decode in one
    batch through one step graph per key, single steps and bursts, with
    the eager round's tokens bitwise; the keys are those of a text-only
    round."""
    from exllamav2_tpu_torch.utils.testing import make_tiny_vlm
    from exllamav2_tpu_torch.vlm import VisionTower
    d = make_tiny_vlm(str(tmp_path / "qwen2"), "qwen2")
    model = Model.from_dir(d, device=dev)
    tower = VisionTower(model.config, device=dev)
    tok = ByteTokenizer(384)
    rng = np.random.default_rng(3)
    embs = [tower.get_image_embeddings(
        model, tok, (rng.random(s) * 255).astype(np.uint8), f"<i{i}>")
        for i, s in enumerate([(16, 16, 3), (32, 32, 3), (24, 32, 3)])]
    st = model.static
    out, keys = {}, {}
    for graphs in (False, True):
        gen = DynamicGenerator(model, PagedKVCache.alloc(
            st.num_layers, 16, st.num_kv_heads, st.head_dim, device=dev),
            tok, max_batch_size=4, decode_burst=4, graphs=graphs)
        js = [gen.enqueue(DynamicJob(
            gen.encode_with_embeddings(f"x <i{i}> y", [e]), max_new_tokens=11,
            settings=Settings.greedy(), embeddings=[e]))
            for i, e in enumerate(embs)]
        js.append(gen.enqueue(DynamicJob(tok.encode("text only"),
                                         max_new_tokens=11,
                                         settings=Settings.greedy())))
        while any(j.status != "done" for j in js):
            gen.iterate()
        torch.cuda.synchronize()
        out[graphs] = [j.sequence.tolist() for j in js]
        if graphs:
            assert len({j.mrope_offset for j in js}) == 4
            keys = dict(gen.step_graphs.captures)
    assert out[True] == out[False]
    assert keys and all(n == 1 for n in keys.values())
    assert {k[0] for k in keys} <= {"decode", "decode_burst"}


def _prefill_jobs(path, rng, emb=None, gen=None):
    """The jobs of test_card_prefill_graphed_equals_eager's `path`."""
    out = []
    if path in ("serving", "draft", "moe"):
        # five prompts batched (b 8: pad rows and columns), the longest's
        # later chunks of 128 and 43 rows alone
        for n in (300, 40, 90, 70, 9):
            out.append(DynamicJob(rng.integers(3, 250, n).astype(np.int32),
                                  max_new_tokens=6,
                                  settings=Settings.greedy()))
    elif path == "cfg":
        for n, neg in ((60, 60), (20, 130)):
            s = Settings.greedy()
            s.cfg_scale = 1.5
            out.append(DynamicJob(
                rng.integers(3, 250, n).astype(np.int32), max_new_tokens=6,
                settings=s, negative_prompt_ids=rng.integers(
                    3, 250, neg).astype(np.int32)))
    else:       # "mm": an image job of 200 text tokens and a text job
        text = "".join(chr(97 + c) for c in rng.integers(0, 26, 200))
        ids = gen.encode_with_embeddings(text + "<img> after", [emb])
        out = [DynamicJob(ids, max_new_tokens=6, settings=Settings.greedy(),
                          embeddings=[emb]),
               DynamicJob(rng.integers(3, 250, 37).astype(np.int32),
                          max_new_tokens=6, settings=Settings.greedy())]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["serving", "draft", "cfg", "moe", "mm",
                                  "greedy"])
def test_card_prefill_graphed_equals_eager(dev, path, tmp_path):
    """Every prefill path replays its graphs on the card with the eager
    round's tokens bit for bit and the same kernel launches: the text
    prefill alone, in chunks and batched; beside the draft model's own
    graph; CFG's second stream; an MoE model's capacity dispatch (its
    dropped-route count a static output); a Qwen2-VL image job and a text
    job (embedding and MRoPE rows as static inputs); generate_greedy
    through Model.forward's chunks. Each key is captured once; a second
    round replays them all and captures nothing."""
    from exllamav2_tpu_torch.models import forward as F
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    tok = ByteTokenizer(384)
    emb = config = None
    if path == "mm":
        from exllamav2_tpu_torch.utils.testing import make_tiny_vlm
        from exllamav2_tpu_torch.vlm import VisionTower
        base = Model.from_dir(make_tiny_vlm(str(tmp_path / "q"), "qwen2"),
                              device=dev)
        w, st, config = base.weights, base.static, base.config
        emb = VisionTower(base.config, device=dev).get_image_embeddings(
            base, tok, (np.random.default_rng(1).random((32, 32, 3)) * 255)
            .astype(np.uint8), "<img>")
    elif path == "moe":
        w, st = random_model_weights(vocab=1024, hidden=512, layers=2,
                                     heads=4, kv_heads=2, inter=1024,
                                     max_seq=512, bits=4, seed=4, moe=4,
                                     moe_topk=2, device=dev)
    else:
        w, st = _card_model(dev, layers=2)
    if path == "greedy":
        prompt = np.random.default_rng(2).integers(3, 1000, (2, 40)).astype(
            np.int32)
        runs = {}
        for graphs in (False, True):
            m = Model(w, st, graphs=graphs)
            m.config = types.SimpleNamespace(max_input_len=16,
                                             max_attention_size=2048 ** 2,
                                             max_seq_len=256)
            before = _counts()
            seqs = [m.generate_greedy(prompt, 8) for _ in range(2)]
            torch.cuda.synchronize()
            after = _counts()
            runs[graphs] = (seqs, {k: after[k] - before[k] for k in after})
            if graphs:
                keys = dict(m.prefill_graphs.captures)
        np.testing.assert_array_equal(runs[True][0], runs[False][0])
        assert runs[True][1] == runs[False][1]
        assert {k[5:] for k in keys} == {(16, True), (8, True)}
        assert all(n == 1 for n in keys.values())
        return
    out, moe = {}, 0
    if path == "moe":
        F.set_moe_dispatch(capacity_factor=0.5)
    try:
        for graphs in (False, True):
            cache = PagedKVCache.alloc(st.num_layers, 24, st.num_kv_heads,
                                       st.head_dim, page_size=64, device=dev)
            kw = {}
            if path == "draft":
                kw = {"draft_model": Model(w, st),
                      "draft_cache": PagedKVCache.alloc(
                          st.num_layers, 24, st.num_kv_heads, st.head_dim,
                          page_size=64, device=dev)}
            gen = DynamicGenerator(Model(w, st, config), cache, tok,
                                   max_batch_size=8,
                                   max_chunk_size=128, decode_burst=4,
                                   graphs=graphs, **kw)
            rounds, before = [], _counts()
            for i in range(2):
                js = [gen.enqueue(j) for j in _prefill_jobs(
                    path, np.random.default_rng(i), emb, gen)]
                if graphs and i == 1:
                    c0 = sum(gen.prefill_graphs.captures.values())
                while any(j.status != "done" for j in js):
                    gen.iterate()
                rounds.append([(j.sequence.tolist(), j.kv_pos2) for j in js])
            torch.cuda.synchronize()
            after = _counts()
            out[graphs] = (rounds, {k: after[k] - before[k] for k in after},
                           gen.moe_dropped_tokens)
            if graphs:
                runner = gen.prefill_graphs
                assert sum(runner.captures.values()) == c0     # round 2
                assert all(n == 1 for n in runner.captures.values())
                names = {k[0] for k in runner.captures}
                moe = out[True][2]
    finally:
        F.set_moe_dispatch(capacity_factor=2.0)
    assert out[True] == out[False]
    want = {"draft": {"prefill", "dprefill"}, "mm": {"prefill_mm"}}
    assert names == want.get(path, {"prefill"})
    assert (moe > 0) == (path == "moe")


@pytest.mark.cuda
def test_card_failed_prefill_capture_raises(dev, monkeypatch):
    """A prefill step that syncs with the host inside its capture: the
    prefill raises, no graph of its key is kept, nothing carries on
    eagerly in its place (the job's position does not move), and the
    runners still capture the next keys."""
    w, st = _card_model(dev, layers=2)
    gen = DynamicGenerator(Model(w, st), PagedKVCache.alloc(
        st.num_layers, 8, st.num_kv_heads, st.head_dim, page_size=64,
        device=dev), ByteTokenizer(256), max_batch_size=4, graphs=True)
    body = DynamicGenerator._prefill_body

    def bad(self, *a, **kw):
        out = body(self, *a, **kw)
        if torch.cuda.is_current_stream_capturing():
            a[0].sum().item()              # a host sync: not capturable
        return out

    monkeypatch.setattr(DynamicGenerator, "_prefill_body", bad)
    job = gen.enqueue(DynamicJob(np.arange(3, 43, dtype=np.int32),
                                 max_new_tokens=4,
                                 settings=Settings.greedy()))
    with pytest.raises(RuntimeError):
        gen.iterate()
    torch.cuda.synchronize()
    assert not gen.prefill_graphs.entries and not gen.prefill_graphs.replays
    assert job.kv_pos == 0
    gen.cancel(job)
    monkeypatch.setattr(DynamicGenerator, "_prefill_body", body)
    out = gen.generate("the runner still works", max_new_tokens=4,
                       settings=Settings.greedy())
    assert isinstance(out, str) and gen.prefill_graphs.entries
