"""Port vs reference: merged q|k|v / gate|up weight streams on the CPU.

  * merge_linears, merge_serving_weights, strip_merged_weights and
    precompute_model_scales on merged trees build the reference's buffers
    bit for bit (carried over by interop);
  * the merged qmm gives each source's columns: bit for bit on the fused
    path (a column's arithmetic does not depend on its neighbours), and
    within 1e-4 of max |ref| against the reference (f32 sums in another
    order);
  * a merged model's logits equal the unmerged model's within 1e-5 of their
    max on the CPU (the port's plain versions take the same sums per column;
    the wider matrix product may block them otherwise) and the reference's
    merged logits within 1e-2 (as the unmerged forward,
    tests/test_torch_model.py);
  * DynamicGenerator(merged_weights=True) writes the unmerged generator's
    greedy text, with and without prescale; with w4a8=True it runs and
    writes the reference generator's tokens on checkpoints with a
    sharpened head.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.cache import KVCache as RefCache
from exllamav2_tpu.cache_paged import PagedKVCache as RefPagedCache
from exllamav2_tpu.generator.dynamic import (
    DynamicGenerator as RefGenerator, DynamicJob as RefJob)
from exllamav2_tpu.generator.sampler import Settings as RefSettings
from exllamav2_tpu.models import forward as RF
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.ops import dequant as D
from exllamav2_tpu.ops import qmm as M
from exllamav2_tpu.quant import formats as F
from exllamav2_tpu.quant import qtensor as Q
from exllamav2_tpu.tokenizer import ByteTokenizer as RefTokenizer
from exllamav2_tpu.utils.testing import make_tiny_llama
from exllamav2_tpu.utils.testing import random_model_weights as ref_weights

from exllamav2_tpu_torch.cache import KVCache
from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.interop import (
    linear_from_reference, weights_from_reference)
from exllamav2_tpu_torch.models.forward import model_forward
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.ops import dequant as TD
from exllamav2_tpu_torch.ops import qmm as TM
from exllamav2_tpu_torch.quant.qtensor import gather_columns, slice_columns
from exllamav2_tpu_torch.tokenizer import ByteTokenizer

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The matrices here are tiny: one intra-op thread, so that test workers
    running side by side do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(ql):
    return linear_from_reference(_np(ql), "cpu")


def _exl2(rng, k, n, pattern, perm=None, bias=False):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    if perm is not None:
        t = F.exl2_pack(w[perm], pattern, group_rows=32,
                        invperm=np.argsort(perm))
    else:
        t = F.exl2_pack(w, pattern, group_rows=32)
    if bias:
        t.bias = (rng.standard_normal(n) * 0.1).astype(np.float16)
    return Q.from_exl2(t)


def _gptq(rng, k, n, gs=128):
    g = k // gs
    qv = rng.integers(0, 16, size=(k, n)).astype(np.uint16)
    zeros = rng.integers(0, 15, size=(g, n)).astype(np.uint16)
    scales = rng.random((g, n)).astype(np.float32) * 0.02 + 0.001
    return Q.from_gptq(F.gptq_pack(qv, zeros, scales, bits=4))


def _same_module(got, want):
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name
    flags = [[(type(s).__name__, s.act8, getattr(s, "src_cols", None),
               s.rows, s.rows_pad, s.group_rows)
              for s in m.modules() if hasattr(s, "act8")]
             for m in (got, want)]
    assert flags[0] == flags[1]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _sources(kind, rng):
    """Reference linears that merge, by kind."""
    if kind == "exl2_qkv":            # three sources of unequal width
        return [_exl2(rng, 256, n, [4, 4, 5, 3] * 2) for n in (256, 128, 128)]
    if kind == "exl2_act_order_bias":
        perm = rng.permutation(256)
        return [_exl2(rng, 256, 128, [4] * 8, perm=perm, bias=b)
                for b in (True, False)]
    if kind == "exl2_prescaled":
        return [D.precompute_scales_linear(_exl2(rng, 256, 128, [6, 2] * 4))
                for _ in range(2)]
    if kind == "gptq":
        return [_gptq(rng, 512, 128) for _ in range(2)]
    if kind == "gptq_w4a8":
        return [D.enable_w4a8_linear(_gptq(rng, 512, 128)) for _ in range(2)]
    raise ValueError(kind)


KINDS = ["exl2_qkv", "exl2_act_order_bias", "exl2_prescaled", "gptq",
         "gptq_w4a8"]


@pytest.mark.parametrize("kind", KINDS)
def test_merge_linears_matches_reference(kind):
    rng = np.random.default_rng(len(kind))
    refs = _sources(kind, rng)
    ports = [_port(q) for q in refs]
    qm, tm = D.merge_linears(refs), TD.merge_linears(ports)
    assert qm is not None and tm is not None
    _same_module(tm, _port(qm))
    assert tm.n == tm.n_orig == sum(p.n for p in ports)
    seg = tm.segments[0]
    if kind == "exl2_qkv":
        assert seg.src_cols == (0, 256, 384) and seg.smax.shape[1] == 3
        assert seg.scale_f is None
    if kind == "exl2_prescaled":
        assert seg.scale_f is not None        # prescaled again after merging
    if kind == "gptq_w4a8":
        assert seg.act8 and seg.zs_bf is not None

    x = rng.standard_normal((3, tm.k)).astype(np.float32) * 0.1
    xt = torch.from_numpy(x)
    for fused in (True, False):
        got = TM.qmm(xt, tm, fused=fused)
        ref = np.asarray(M.qmm(jnp.asarray(x), qm, fused=fused))
        assert _rel(got, ref) <= TOL
        col = 0
        for p in ports:                        # each source's own columns
            own = TM.qmm(xt, p, fused=fused)[:, :p.n_orig]
            part = got[:, col:col + p.n]
            if fused:
                assert torch.equal(part, own)
            else:
                assert _rel(part, own) <= 1e-6
            col += p.n
    # prescaling a merged linear expands smax by source
    _same_module(TD.precompute_scales_linear(tm),
                 _port(D.precompute_scales_linear(qm)))


def test_merge_linears_refuses_what_does_not_merge():
    rng = np.random.default_rng(1)
    a = _port(_exl2(rng, 256, 128, [4] * 8))
    perm = rng.permutation(256)
    cases = {
        "k differs": _port(_exl2(rng, 320, 128, [4] * 10)),
        "one has a perm": _port(_exl2(rng, 256, 128, [4] * 8, perm=perm)),
        "segments differ": _port(_exl2(rng, 256, 128, [4, 4, 5, 3] * 2)),
        "lane-padded width": _port(_exl2(rng, 256, 96, [4] * 8)),
        "another format": _port(_gptq(rng, 256, 128)),
        "dense": linear_from_reference(_np(Q.from_dense(
            rng.standard_normal((256, 128)).astype(np.float32))), "cpu"),
    }
    for why, b in cases.items():
        assert TD.merge_linears([a, b]) is None, why
    other = _port(_exl2(rng, 256, 128, [4] * 8,
                        perm=rng.permutation(256)))
    assert TD.merge_linears([cases["one has a perm"], other]) is None


def test_column_selection_of_merged_segments():
    """GPTQ segments carry their W4A8 meta through a column slice; a merged
    EXL2 segment (smax per source) refuses."""
    rng = np.random.default_rng(2)
    g = TD.enable_w4a8_linear(_port(_gptq(rng, 512, 256)))
    part = slice_columns(g, 128, 256)
    seg = part.segments[0]
    assert seg.act8 and seg.zs_bf.shape == (seg.scale.shape[0], 128)
    assert torch.equal(seg.zs_bf, g.segments[0].zs_bf[:, 128:256])
    x = torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32))
    assert torch.equal(TM.qmm(x, part, fused=True),
                       TM.qmm(x, g, fused=True)[:, 128:256])
    picked = gather_columns(g, np.arange(0, 256, 2))
    assert picked.segments[0].scale_bf.shape[1] == 128
    merged = TD.merge_linears([_port(_exl2(rng, 256, 128, [4] * 8))
                               for _ in range(2)])
    with pytest.raises(ValueError, match="column-merged"):
        slice_columns(merged, 0, 128)


@pytest.fixture(scope="module")
def weights():
    w, st = ref_weights(vocab=512, hidden=256, layers=2, heads=8, kv_heads=4,
                        inter=512, max_seq=64, bits=4, seed=9)
    tw, tst = weights_from_reference(_np(w), st, device="cpu")
    return w, st, tw, tst


def test_merge_serving_weights_matches_reference(weights):
    w, st, tw, _ = weights
    wm, tm = D.merge_serving_weights(w), TD.merge_serving_weights(tw)
    assert tm.layers[0].attn.qkv is not None
    assert tm.layers[0].mlp.gate_up is not None
    assert tw.layers[0].attn.qkv is None              # input left alone
    assert tm.layers[0].attn.q is tw.layers[0].attn.q
    _same_module(tm, weights_from_reference(_np(wm), st, device="cpu")[0])
    # merged, then prescaled (the serving default)
    _same_module(
        TD.precompute_model_scales(TD.merge_serving_weights(tw)),
        weights_from_reference(_np(D.precompute_model_scales(wm)), st,
                               device="cpu")[0])
    # and stripped again
    ts = TD.strip_merged_weights(tm)
    assert ts.layers[1].attn.qkv is None and ts.layers[1].mlp.gate_up is None
    assert tm.layers[1].attn.qkv is not None          # input left alone
    _same_module(ts, weights_from_reference(
        _np(D.strip_merged_weights(wm)), st, device="cpu")[0])
    _same_module(ts, tw)


def test_merged_serving_weights_match(weights):
    """The merged forward against the unmerged one and against the
    reference's merged forward: one prefill and two decode steps."""
    w, st, tw, tst = weights
    wm, tm = D.merge_serving_weights(w), TD.merge_serving_weights(tw)
    ids = np.random.default_rng(0).integers(3, 500, (1, 10)).astype(np.int32)
    step = jax.jit(RF.model_forward, static_argnums=(1, 5, 6))

    def run_port(wv):
        cache = KVCache.alloc(2, 1, 64, st.num_kv_heads, st.head_dim,
                              device="cpu")
        outs, pos = [], 0
        for chunk in (ids[:, :8], ids[:, 8:9], ids[:, 9:10]):
            lg, cache = model_forward(wv, tst, torch.from_numpy(chunk), cache,
                                      pos, attn_limit=64)
            outs.append(lg[0].numpy())
            pos += chunk.shape[1]
        return np.concatenate(outs)

    rc = RefCache.alloc(2, 1, 64, st.num_kv_heads, st.head_dim)
    ref, pos = [], 0
    for chunk in (ids[:, :8], ids[:, 8:9], ids[:, 9:10]):
        lg, rc = step(wm, st, jnp.asarray(chunk), rc, jnp.int32(pos), False,
                      64)
        ref.append(np.asarray(lg[0]))
        pos += chunk.shape[1]
    merged, plain = run_port(tm), run_port(tw)
    assert _rel(merged, plain) < 1e-5
    assert _rel(merged, np.concatenate(ref)) < 1e-2


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_merged")
    return make_tiny_llama(str(root / "exl2"), quant="exl2", seed=5,
                           vocab=384, max_pos=4096)


def _gen(model, tok, **kw):
    st = model.static
    cache = PagedKVCache.alloc(st.num_layers, 16, st.num_kv_heads,
                               st.head_dim, "bf16", device="cpu")
    return DynamicGenerator(model, cache, tok, max_batch_size=4, **kw)


@pytest.mark.parametrize("prescale", [True, False])
def test_merged_generator_equivalence(tiny_dir, prescale):
    """merged_weights=True writes what the unmerged generator writes, on
    prescaled and on sqrt-encoded scales, and leaves the model alone."""
    model = Model.from_dir(tiny_dir, prescale=prescale, device="cpu")
    tok = ByteTokenizer(384)
    prompt = "equivalence check"
    base = _gen(model, tok).generate(prompt, max_new_tokens=8,
                                     settings=Settings.greedy())
    gen = _gen(model, tok, merged_weights=True)
    seg = gen.model.weights.layers[0].attn.qkv.segments[0]
    assert (seg.scale_f is not None) == prescale and seg.src_cols
    assert model.weights.layers[0].attn.qkv is None
    fast = gen.generate(prompt, max_new_tokens=8, settings=Settings.greedy())
    assert fast == base and len(base) > 0


@pytest.mark.parametrize("quant", ["exl2", "gptq"])
def test_merged_w4a8_generator_matches_reference(tmp_path, quant):
    """DynamicGenerator(merged_weights=True, w4a8=True) on a quantized
    checkpoint with a sharpened head (decisive argmaxes): the reference
    generator's tokens."""
    d = make_tiny_llama(str(tmp_path / quant), quant=quant, seed=9,
                        vocab=384, hidden=256, heads=2, kv_heads=1,
                        inter=512, max_pos=4096, head_scale=6.0)
    prompts = ["The quick brown fox", "hello there, friend"]
    tok, rtok = ByteTokenizer(256), RefTokenizer(256)
    model = Model.from_dir(d, device="cpu")
    gen = _gen(model, tok, merged_weights=True, w4a8=True, decode_burst=1)
    lw = gen.model.weights.layers[0]
    assert all(s.act8 for s in lw.attn.qkv.segments)
    assert all(s.act8 for s in lw.mlp.down.segments)
    # (the head of these checkpoints is dense; a quantized head stays
    # exact: tests/test_torch_w4a8.py::test_enable_w4a8_model_tree)
    assert not any(s.act8 for s in model.weights.layers[0].attn.o.segments)
    jobs = [gen.enqueue(DynamicJob(tok.encode(p), max_new_tokens=6,
                                   settings=Settings.greedy()))
            for p in prompts]
    while any(j.status != "done" for j in jobs):
        gen.iterate()

    ref = RefModel.from_dir(d)
    rst = ref.static
    rgen = RefGenerator(
        ref, RefPagedCache.alloc(rst.num_layers, 16, rst.num_kv_heads,
                                 rst.head_dim, "bf16"), rtok,
        max_batch_size=4, merged_weights=True, w4a8=True, decode_burst=1)
    rjobs = [RefJob(rtok.encode(p), max_new_tokens=6,
                    settings=RefSettings.greedy()) for p in prompts]
    for j in rjobs:
        rgen.enqueue(j)
    while any(j.status != "done" for j in rjobs):
        rgen.iterate()
    for j, r in zip(jobs, rjobs):
        assert j.new_tokens == 6
        np.testing.assert_array_equal(j.sequence, r.sequence)
