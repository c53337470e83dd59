"""The vision-language path, port against reference (CPU).

Tiny random checkpoints of the four tower families (make_tiny_vlm: pixtral
under Llava, qwen2 under Qwen2-VL, qwen2.5 under Qwen2.5-VL with a window
smaller than the grid and one full-attention block, SigLIP under Gemma 3),
each written once and loaded by both packages; images and video frames are
numpy draws from a seed.

* MRoPE position ids and rows, and the image preprocessing, bit for bit.
* The tower output (``process``) of every family, loaded from the same
  directory and also carried over by interop.vision_tower_from_reference:
  within TOWER_TOL of max |reference| (both round to bf16 at the same
  points and sum the CPU products in f32, in another order: measured
  6e-8 to 3.6e-7). The marker rows of ``postprocess`` equal the
  reference's.
* model_forward_paged with input_embeds, MRoPE rope_rows and per-row
  pos_offsets against the reference's on Qwen2-VL's language model, per
  logit: the prefill within PREFILL_TOL of max |reference| (measured
  5.9e-4), each offset decode step within DECODE_TOL (measured 3.75e-3
  to 4.04e-3: the port's one-token step runs kernel 3's plain version,
  which rounds the probabilities to bf16 as the kernel does, where the
  reference's CPU step takes its many-row path; with that path on both
  sides the steps read 4.3e-4 to 8.2e-4).
* The generator: a Qwen2-VL image job, a video job and a text job in one
  generator give the reference generator's greedy tokens (a parting only
  at a near-tie, as tests/test_torch_moe.py allows), equal MRoPE offsets
  and equal prompt ids less each embedding's first_index; a pixtral image
  job run twice reuses its pages; text and image jobs share one step graph.
* The CFG step passes the offsets: at cfg_scale 1.0 an MRoPE image job's
  tokens equal its plain decode's on the port; the reference's paired step
  passes none (exllamav2_tpu/generator/dynamic.py:1783-1796) and parts
  from its plain decode (ROADMAP.md, section 3).
"""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.cache_paged import PagedKVCache as RefPaged
from exllamav2_tpu.config import ModelConfig as RefConfig
from exllamav2_tpu.generator.dynamic import (
    DynamicGenerator as RefGen, DynamicJob as RefJob)
from exllamav2_tpu.generator.sampler import Settings as RefSettings
from exllamav2_tpu.models.forward import model_forward_paged as ref_forward
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.ops import mrope as RM
from exllamav2_tpu.ops.rope import rope_params as ref_rope_params
from exllamav2_tpu.tokenizer import ByteTokenizer as RefTok
from exllamav2_tpu.vlm import VisionTower as RefTower
from exllamav2_tpu.vlm import processing as RP

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.config import ModelConfig
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.interop import vision_tower_from_reference
from exllamav2_tpu_torch.models.forward import model_forward_paged
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.ops import mrope as TM
from exllamav2_tpu_torch.ops.rope import rope_params
from exllamav2_tpu_torch.tokenizer import ByteTokenizer
from exllamav2_tpu_torch.utils.testing import make_tiny_vlm
from exllamav2_tpu_torch.vlm import MMEmbedding, VisionTower
from exllamav2_tpu_torch.vlm import processing as TP
from exllamav2_tpu_torch.vlm.mm_embedding import EMBEDDING_INDEX

# max |port - reference| / max |reference|, each just above its reading
TOWER_TOL = 1e-4    # the towers and their embeddings: measured <= 3.6e-7
PREFILL_TOL = 1e-3  # a paged prefill with input_embeds: measured <= 5.9e-4
DECODE_TOL = 5e-3   # an offset decode step: measured <= 4.04e-3
NEAR_TIE = 0.02     # top-2 gap / max |logit| under which two paths may part
TOK = ByteTokenizer(384)
KINDS = ("pixtral", "qwen2", "qwen2.5", "siglip")
# an image of each family: 4x6 patches; a 4x4 grid (2x2 merged rows); a
# 10x12 grid, whose 5x6 merged units pad into 3x3 windows of 2x2; 16x16 px
# resized to the 4x4 patches SigLIP pools into 2x2 rows
IMAGE_SHAPES = {"pixtral": (16, 24, 3), "qwen2": (16, 16, 3),
                "qwen2.5": (40, 48, 3), "siglip": (20, 18, 3)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that test workers running side
    by side do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {k: make_tiny_vlm(str(tmp_path_factory.mktemp(k)), k)
            for k in KINDS}


def _image(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


def _frames(n=4, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.random((16, 16, 3)) * 255).astype(np.uint8)
            for _ in range(n)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


# ---------------------------------------------------------------------------
# host numpy: MRoPE and preprocessing, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["image", "video", "text"])
def test_mrope_ids_and_rows_bitwise(case):
    base = 10 ** 9
    text = [5, 6, 7]
    if case == "image":        # the 24 rows of an 8x12 grid at merge 2
        grids, span = [(1, 8, 12)], 24
    elif case == "video":
        grids, span = [(2, 4, 4)], 8
    else:
        grids, span = [], 0
    ids = np.array(text + list(range(base, base + span)) + [8, 9], np.int64)
    spans = [(base, base + span)] if span else []
    inv = 1.0 / 1e6 ** (np.arange(0, 64, 2) / 64.0)
    for max_len in (len(ids), len(ids) + 5):
        rp, rn = RM.gen_mrope_pos_ids(ids, 2, spans, grids, max_len)
        tp, tn = TM.gen_mrope_pos_ids(ids, 2, spans, grids, max_len)
        assert rn == tn and np.array_equal(rp, tp) and rp.dtype == tp.dtype
        for sec, scale in (([8, 12, 12], 1.0), ([16, 8, 8], 0.5)):
            rs, rc = RM.mrope_rows(rp, inv, sec, scale)
            ts, tc = TM.mrope_rows(tp, inv, sec, scale)
            assert ts.dtype == rs.dtype == np.float32
            assert ts.tobytes() == rs.tobytes() and tc.tobytes() == rc.tobytes()
        if case == "text" and max_len == len(ids):
            assert tn == len(ids)


@pytest.mark.parametrize("case", ["pixtral", "qwen2", "qwen2_video",
                                  "qwen2.5", "siglip"])
def test_preprocess_bitwise(dirs, case):
    kind = case.split("_")[0]
    d = dirs[kind]
    inp = _frames() if case.endswith("video") else \
        _image(IMAGE_SHAPES[kind], 3)
    ref = RP.preprocess(RefConfig.from_dir(d), inp)
    got = TP.preprocess(ModelConfig.from_dir(d), inp)
    assert got[0].dtype == ref[0].dtype
    assert got[0].tobytes() == ref[0].tobytes() and got[1:] == ref[1:]
    assert TP.smart_resize((1024, 768)) == RP.smart_resize((1024, 768)) \
        == (1036, 756)


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_tower_matches_reference(dirs, kind):
    d = dirs[kind]
    rc = RefConfig.from_dir(d)
    rt = RefTower(rc)
    tower = VisionTower(ModelConfig.from_dir(d), device="cpu")
    carried = vision_tower_from_reference(rt, device="cpu")
    assert isinstance(tower.layers, torch.nn.ModuleList)
    inputs = [_image(IMAGE_SHAPES[kind], 4)]
    if kind == "qwen2":
        inputs.append(_frames())
    for inp in inputs:
        px, _, thw = RP.preprocess(rc, inp)
        ref = np.asarray(rt.process(px, None, thw), np.float32)
        for t in (tower, carried):
            got = t.process(px, None, thw)
            assert got.dtype == torch.float32 and got.shape == ref.shape
            assert _rel(got, ref) < TOWER_TOL, kind
    if kind == "qwen2.5":
        # the window mask is live: more than one window, block 1 full
        order, cu = tower._window_order(thw)
        assert len(cu) > 2 and tower.cfg.vision_fullatt_block_indexes == [1]
        assert sorted(order.tolist()) == list(range(len(order)))


class _Pieces:
    """A tokenizer that knows the marker pieces of every family."""
    IDS = {"[IMG_BREAK]": 10, "[IMG_END]": 11, "<|vision_start|>": 12,
           "<|vision_end|>": 13, "<start_of_image>": 14, "<end_of_image>": 15}

    def piece_to_id(self, piece):
        return self.IDS.get(piece)


@pytest.mark.parametrize("kind", ["pixtral", "qwen2", "siglip"])
def test_postprocess_marker_rows_match_reference(dirs, kind):
    cfg_r = RefConfig.from_dir(dirs[kind])
    cfg_t = ModelConfig.from_dir(dirs[kind])
    rng = np.random.default_rng(6)
    embed = rng.standard_normal((32, 8)).astype(np.float32)
    feats = rng.standard_normal((4 * 6, 8)).astype(np.float32)
    ref, rpre, rpost = RP.postprocess(
        cfg_r, types.SimpleNamespace(embed=jnp.asarray(embed, jnp.bfloat16)),
        _Pieces(), jnp.asarray(feats), 4, 6)
    got, tpre, tpost = TP.postprocess(
        cfg_t, types.SimpleNamespace(embed=torch.from_numpy(embed).to(
            torch.bfloat16)), _Pieces(), torch.from_numpy(feats), 4, 6)
    assert (tpre, tpost) == (rpre, rpost)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.array_equal(got.numpy(), ref)
    assert got.shape[0] == {"pixtral": 4 * 7 + 1}.get(kind, 26)


def test_mm_embedding_ids_and_device():
    rows = np.random.default_rng(0).standard_normal((5, 8))
    a = MMEmbedding(rows, device="cpu", pre_tokens=1, post_tokens=1)
    b = MMEmbedding(torch.ones((3, 8)), text_alias="<b>")
    assert a.first_index >= EMBEDDING_INDEX
    assert b.first_index == a.first_index + 5 and b.text_alias == "<b>"
    assert a.embeddings.dtype == torch.bfloat16 and a.embeddings.is_cpu
    assert b.embeddings.is_cpu and b.get_size_in_bytes() == 48
    assert a.get_vision_token_range() == (a.first_index + 1,
                                          a.first_index + 4)
    assert a.get_ids_array().tolist() == a.get_ids()


# ---------------------------------------------------------------------------
# the paged forward with embeddings, rope rows and offsets
# ---------------------------------------------------------------------------

def test_paged_forward_multimodal_inputs_match_reference(dirs):
    """Two rows: an image prompt (4 embedding rows in a 2x2 merged grid)
    and a text prompt; the prefill takes input_embeds and the MRoPE rows of
    each, then three decode steps take ids and the offsets [-2, 0]."""
    d = dirs["qwen2"]
    rm = RefModel.from_dir(d)
    model = Model.from_dir(d, device="cpu")
    cfg = model.config
    st, rst = model.static, rm.static
    rng = np.random.default_rng(7)
    t = 13
    base = EMBEDDING_INDEX
    ids = rng.integers(3, 300, (2, t)).astype(np.int64)
    ids[0, 4:8] = np.arange(base, base + 4)
    embeds = np.asarray(rm.weights.embed, np.float32)[np.where(
        ids >= base, 0, ids)]
    embeds[0, 4:8] = rng.standard_normal((4, st.hidden_size)) * 0.05
    embeds = embeds.astype(jnp.bfloat16)
    inv, scale = rope_params(cfg)
    assert np.array_equal(inv, ref_rope_params(rm.config)[0])
    sins, coss, nexts = [], [], []
    for row, spans, grids in ((ids[0], [(base, base + 4)], [(1, 4, 4)]),
                              (ids[1], [], [])):
        pos, nxt = TM.gen_mrope_pos_ids(row, 2, spans, grids, t)
        s, c = TM.mrope_rows(pos, inv, cfg.mrope_section, scale)
        sins.append(s)
        coss.append(c)
        nexts.append(nxt)
    offs = np.asarray(nexts, np.int32) - t
    assert offs.tolist() == [-2, 0]
    sin, cos = np.stack(sins), np.stack(coss)

    rc = RefPaged.alloc(st.num_layers, 3, st.num_kv_heads, st.head_dim)
    tc = PagedKVCache.alloc(st.num_layers, 3, st.num_kv_heads, st.head_dim,
                            device="cpu")
    bt = np.array([[1, 0], [2, 0]], np.int32)
    zeros = np.zeros((2, t), np.int32)
    ref, rc = jax.jit(ref_forward, static_argnums=(1, 6))(
        rm.weights, rst, jnp.asarray(zeros), rc, jnp.asarray(bt),
        jnp.zeros((2,), jnp.int32), False, input_embeds=jnp.asarray(embeds),
        rope_rows=(jnp.asarray(sin), jnp.asarray(cos)))
    tw = model.weights
    got, _ = model_forward_paged(
        tw, st, torch.from_numpy(zeros), tc, torch.from_numpy(bt),
        torch.zeros((2,), dtype=torch.int32),
        input_embeds=torch.from_numpy(embeds.view(np.int16)).view(
            torch.bfloat16),
        rope_rows=(torch.from_numpy(sin), torch.from_numpy(cos)))
    assert got.shape == ref.shape and _rel(got, ref) < PREFILL_TOL
    step = jax.jit(ref_forward, static_argnums=(1, 6))
    for i in range(3):
        tok = rng.integers(3, 300, (2, 1)).astype(np.int32)
        seqlens = np.full((2,), t + i, np.int32)
        ref, rc = step(rm.weights, rst, jnp.asarray(tok), rc,
                       jnp.asarray(bt), jnp.asarray(seqlens), True,
                       pos_offsets=jnp.asarray(offs))
        got, _ = model_forward_paged(
            tw, st, torch.from_numpy(tok), tc, torch.from_numpy(bt),
            torch.from_numpy(seqlens), True,
            pos_offsets=torch.from_numpy(offs))
        assert got.shape == ref.shape and _rel(got, ref) < DECODE_TOL, i
    # the offsets reach the rope: the last step again without them (its K
    # rows written anew) moves row 0 and leaves the text row as it was
    moved, _ = model_forward_paged(
        tw, st, torch.from_numpy(tok), tc, torch.from_numpy(bt),
        torch.from_numpy(seqlens), True)
    assert _rel(moved[0], got[0]) > 1e-3 and torch.equal(moved[1], got[1])


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def _ref_gen(rm):
    st = rm.static
    return RefGen(rm, RefPaged.alloc(st.num_layers, 32, st.num_kv_heads,
                                     st.head_dim), RefTok(384),
                  max_batch_size=4, decode_burst=1)


def _ref_run(gen, prompts, new, kinds):
    """The reference generator's greedy jobs -> (jobs, per-step logits)."""
    jobs = [gen.enqueue(RefJob(ids, max_new_tokens=new, return_logits=True,
                               settings=RefSettings.greedy(), **kw))
            for (ids, kw) in zip(prompts, kinds)]
    logits = {id(j): [] for j in jobs}
    while any(j.status != "done" for j in jobs):
        for r in gen.iterate():
            if r.get("logits") is not None:
                logits[id(r["job"])].append(np.asarray(r["logits"][0]))
    return jobs, logits


def _parts_at_near_tie(got, want, logits, plen):
    """got equals want, or the first parting is at a near-tie of `logits`."""
    if got == want:
        return True
    i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    top = np.sort(logits[i - plen])[::-1]
    return top[0] - top[1] < NEAR_TIE * np.abs(top).max()


def _gen(model, pages=32, **kw):
    st = model.static
    return DynamicGenerator(model, PagedKVCache.alloc(
        st.num_layers, pages, st.num_kv_heads, st.head_dim, device="cpu"),
        TOK, max_batch_size=4, **kw)


def _mm_mask(ids, embs):
    """Prompt ids less each embedding's first_index on its rows."""
    ids = np.asarray(ids, np.int64).copy()
    for e in embs:
        sel = (ids >= e.first_index) & (ids < e.first_index + e.length)
        ids[sel] -= e.first_index
    return ids


def test_generator_tokens_match_reference(dirs):
    d = dirs["qwen2"]
    rm = RefModel.from_dir(d)
    rt = RefTower(rm.config)
    model = Model.from_dir(d, device="cpu")
    tower = VisionTower(model.config, device="cpu")
    img, vid = _image((16, 16, 3), 2), _frames()
    r_img = rt.get_image_embeddings(rm, RefTok(384), img, "<img>")
    r_vid = rt.get_video_embeddings(rm, RefTok(384), vid, "<vid>")
    t_img = tower.get_image_embeddings(model, TOK, img, "<img>")
    t_vid = tower.get_video_embeddings(model, TOK, vid, "<vid>")
    assert t_vid.thw_grid == r_vid.thw_grid == (2, 4, 4)
    for a, b in ((t_img, r_img), (t_vid, r_vid)):
        assert _rel(a.embeddings.float(), b.embeddings) < TOWER_TOL
    gen, rg = _gen(model), _ref_gen(rm)
    ids, want_ids = [], []
    for text, te, re_ in (("scene <img> is", t_img, r_img),
                          ("clip <vid> shows", t_vid, r_vid)):
        ids.append(gen.encode_with_embeddings(text, [te]))
        want_ids.append(rg.encode_with_embeddings(text, [re_]))
        assert np.array_equal(_mm_mask(ids[-1], [te]),
                              _mm_mask(want_ids[-1], [re_]))
    text = TOK.encode("plain words here")
    new = 8
    rjobs, logits = _ref_run(rg, want_ids + [text], new,
                             [{"embeddings": [r_img]},
                              {"embeddings": [r_vid]}, {}])
    jobs = [gen.enqueue(DynamicJob(i, max_new_tokens=new,
                                   settings=Settings.greedy(), **kw))
            for i, kw in zip(ids + [text], [{"embeddings": [t_img]},
                                            {"embeddings": [t_vid]}, {}])]
    while any(j.status != "done" for j in jobs):
        gen.iterate()
    assert [j.mrope_offset for j in jobs] == \
        [j.mrope_offset for j in rjobs]
    assert jobs[0].mrope_offset < 0 and jobs[2].mrope_offset == 0
    for j, rj in zip(jobs, rjobs):
        plen = rj.prompt_len
        got, want = j.sequence[plen:].tolist(), rj.sequence[plen:].tolist()
        assert len(got) == new
        assert _parts_at_near_tie(got, want, logits[id(rj)], 0), (got, want)
        np.testing.assert_array_equal(j.mrope_rows[0], rj.mrope_rows[0])


def test_pixtral_prompt_reuse(dirs):
    """A second identical image job reuses the first one's pages: the
    embedding ids are part of the page hashes (the reference's
    tests/test_vlm.py::test_pixtral_generate_e2e)."""
    model = Model.from_dir(dirs["pixtral"], device="cpu")
    tower = VisionTower(model.config, device="cpu")
    # 44x44 px fits 32 px: 32x32, 8x8 patches, 64 rows: with the text the
    # prompt spans a full 64-token page
    mme = tower.get_image_embeddings(model, TOK, _image((44, 44, 3), 1),
                                     "<img>")
    assert mme.embeddings.shape == (64, model.static.hidden_size)
    st = model.static
    gen = DynamicGenerator(model, PagedKVCache.alloc(
        st.num_layers, 16, st.num_kv_heads, st.head_dim, page_size=16,
        device="cpu"), TOK, max_batch_size=4)
    outs = []
    for _ in range(2):
        ids = gen.encode_with_embeddings("look <img> here", [mme])
        job = gen.enqueue(DynamicJob(ids, max_new_tokens=6,
                                     settings=Settings.greedy(),
                                     embeddings=[mme]))
        while job.status != "done":
            gen.iterate()
        outs.append((job.sequence.tolist(), job.reused_tokens))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == 0 and outs[1][1] >= 64
    out = gen.generate("look <img> here", max_new_tokens=6,
                       settings=Settings.greedy(), embeddings=[mme])
    assert isinstance(out, str)


def test_cfg_step_passes_mrope_offsets(dirs):
    """cfg_scale 1.0 mixes the conditional stream alone, so the tokens are
    the plain decode's: on the port (its paired step passes the image job's
    offset), not on the reference (its paired step passes none)."""
    d = dirs["qwen2"]
    rm = RefModel.from_dir(d)
    model = Model.from_dir(d, device="cpu")
    img = _image((32, 32, 3), 8)        # 8x8 grid: 16 rows, offset -12
    r_emb = RefTower(rm.config).get_image_embeddings(rm, RefTok(384), img,
                                                     "<img>")
    t_emb = VisionTower(model.config, device="cpu").get_image_embeddings(
        model, TOK, img, "<img>")
    neg = TOK.encode("bad")
    new = 10
    rg = _ref_gen(rm)
    r_ids = rg.encode_with_embeddings("a <img> b", [r_emb])
    t_ids = _gen(model).encode_with_embeddings("a <img> b", [t_emb])

    def run(gen, job_cls, settings_cls, ids, emb, cfg):
        kw = {"negative_prompt_ids": neg} if cfg else {}
        s = settings_cls.greedy(cfg_scale=1.0) if cfg \
            else settings_cls.greedy()
        j = gen.enqueue(job_cls(ids, max_new_tokens=new, settings=s,
                                embeddings=[emb], **kw))
        while j.status != "done":
            gen.iterate()
        assert j.mrope_offset == -12
        return j.sequence[len(ids):].tolist()

    plain = run(_gen(model), DynamicJob, Settings, t_ids, t_emb, False)
    cfg = run(_gen(model), DynamicJob, Settings, t_ids, t_emb, True)
    assert cfg == plain
    r_plain = run(rg, RefJob, RefSettings, r_ids, r_emb, False)
    r_cfg = run(rg, RefJob, RefSettings, r_ids, r_emb, True)
    assert r_cfg != r_plain
    assert r_plain[:3] == plain[:3]


def test_mixed_offsets_share_one_step_graph(dirs):
    """Text jobs (offset 0) and image jobs (offsets < 0) decode in one
    batch through one step graph per key (the step functions run on their
    static buffers, as a card replays them); the graphed round equals the
    eager one, and the number of captures does not grow with the number
    of distinct offsets."""
    d = dirs["qwen2"]
    model = Model.from_dir(d, device="cpu")
    tower = VisionTower(model.config, device="cpu")
    embs = [tower.get_image_embeddings(model, TOK, _image(s, 9 + i),
                                       f"<i{i}>")
            for i, s in enumerate([(16, 16, 3), (32, 32, 3), (24, 32, 3)])]
    runs = {}
    for graphs in (True, False):
        gen = _gen(model, graphs=graphs, decode_burst=4)
        jobs = []
        for i, e in enumerate(embs):
            ids = gen.encode_with_embeddings(f"x <i{i}> y", [e])
            jobs.append(gen.enqueue(DynamicJob(
                ids, max_new_tokens=9, settings=Settings.greedy(),
                embeddings=[e])))
        jobs.append(gen.enqueue(DynamicJob(
            TOK.encode("text only"), max_new_tokens=9,
            settings=Settings.greedy())))
        while any(j.status != "done" for j in jobs):
            gen.iterate()
        runs[graphs] = [j.sequence.tolist() for j in jobs]
        if graphs:
            offs = {j.mrope_offset for j in jobs}
            assert len(offs) == 4 and max(offs) == 0
            caps = gen.step_graphs.captures
            assert all(n == 1 for n in caps.values())
            assert {k[0] for k in caps} <= {"decode", "decode_burst"}
            assert len(caps) <= 3, caps
    assert runs[True] == runs[False]


def test_image_rows_take_the_embedding_scale():
    """Gemma 3's embedding scale (normalize_embeddings, x sqrt(hidden)):
    the reference applies it to the whole input_embeds, image rows
    included (exllamav2_tpu/models/forward.py:262-263), where Hugging
    Face's Gemma 3 puts the image features in after the scaled lookup. The
    port keeps the reference's function (within PREFILL_TOL of it; measured
    0); the rows as Hugging Face would use them give other logits
    (ROADMAP.md, section 3: open until a trained Gemma 3 checkpoint is in
    the repository)."""
    import dataclasses
    from exllamav2_tpu.utils.testing import random_model_weights as ref_rw
    from exllamav2_tpu_torch.interop import weights_from_reference
    w, st = ref_rw(vocab=64, hidden=256, layers=2, heads=2, kv_heads=1,
                   inter=512, max_seq=64, bits=4, seed=9)
    st = dataclasses.replace(st, normalize_embeddings=True)
    tw, tst = weights_from_reference(jax.tree_util.tree_map(np.asarray, w),
                                     st, device="cpu")
    rows = (np.random.default_rng(10).standard_normal((1, 12, 256))
            * 0.05).astype(jnp.bfloat16)
    zeros = np.zeros((1, 12), np.int32)
    bt = np.array([[1]], np.int32)
    ref, _ = ref_forward(w, st, jnp.asarray(zeros),
                         RefPaged.alloc(2, 2, 1, 128), jnp.asarray(bt),
                         jnp.zeros((1,), jnp.int32),
                         input_embeds=jnp.asarray(rows))

    def port(x):
        return model_forward_paged(
            tw, tst, torch.from_numpy(zeros),
            PagedKVCache.alloc(2, 2, 1, 128, device="cpu"),
            torch.from_numpy(bt), torch.zeros((1,), dtype=torch.int32),
            input_embeds=torch.from_numpy(x.view(np.int16)).view(
                torch.bfloat16))[0]

    got = port(rows)
    assert _rel(got, ref) < PREFILL_TOL
    # on random weights the RMS norms absorb most of the scale: 5.9e-3 of
    # max |logit| apart on this model
    hf = port((rows.astype(np.float32) / 16.0).astype(jnp.bfloat16))
    assert _rel(hf, got) > 1e-3
