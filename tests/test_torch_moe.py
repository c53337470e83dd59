"""Block-sparse MoE, port against reference (CPU).

* moe_forward in its three regimes against the reference's moe_forward on
  the same layer (the reference's random_model_weights, 4 experts, top 2,
  EXL2 4-bit, handed over by interop.weights_from_reference): the dense mix
  (48 rows), the gated sparse decode (4 rows, _FORCE_SPARSE_MOE set in both
  packages: the reference's lax.cond, the port's gated kernel-1 launches
  through their plain version) and the capacity dispatch (128 rows), then a
  forced drop (capacity factor 0.25, 512 rows) and a padded prefill whose
  pad rows the validity mask takes out of the routing: equal dropped-route
  counts and outputs within 1e-3 of max |reference| (the same bf16 rounding
  points, f32 sums in another order). The reference runs jitted with XLA's
  excess precision off, as in tests/test_torch_archs.py.
* On the port alone: the gated sparse decode equals the dense mix bitwise
  (an unrouted expert adds exact zeros either way), and the step graphs
  (run on their static buffers, as a card replays them) equal the eager
  steps bitwise, for Model and DynamicGenerator.
* The generator: the dropped-route metric of a job and the generator's
  counter (tests/test_generator_features.py::test_moe_dropped_routes_metric
  on the port), and the reference generator's greedy tokens over a tiny
  EXL2 Mixtral, prescaled, and merged with W4A8 (up to a near-tie).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.models import forward as RF
from exllamav2_tpu.utils.testing import random_model_weights as ref_weights

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.interop import weights_from_reference
from exllamav2_tpu_torch.models import forward as F
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.ops import qmm as Q
from exllamav2_tpu_torch.tokenizer import ByteTokenizer
from exllamav2_tpu_torch.utils.testing import make_tiny_llama

TOL = 1e-3          # max |port - reference| / max |reference| of a layer
TOK = ByteTokenizer(256)
MOE4 = {"num_local_experts": 4, "num_experts_per_tok": 2}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that test workers running side
    by side do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def force_sparse():
    F._FORCE_SPARSE_MOE[0] = True
    yield
    F._FORCE_SPARSE_MOE[0] = False


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


# ---------------------------------------------------------------------------
# one MoE layer against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer():
    w, st = ref_weights(vocab=64, hidden=256, layers=1, heads=4, kv_heads=2,
                        inter=512, max_seq=16, bits=4, seed=5, moe=4,
                        moe_topk=2)
    tw, tst = weights_from_reference(jax.tree_util.tree_map(np.asarray, w),
                                     st, device="cpu")
    return w.layers[0].mlp, st, tw.layers[0].mlp, tst


def _ref_moe(mw, st, x, valid=None, sparse=False):
    """The reference's moe_forward (jitted, excess precision off) -> (out,
    dropped routes)."""
    def fn(mw, x, valid):
        RF._MOE_STATS[0] = []
        RF._MOE_VALID[0] = valid
        RF._FORCE_SPARSE_MOE[0] = sparse
        try:
            out = RF.moe_forward(x, mw, st)
            parts = RF._MOE_STATS[0]
            dropped = sum(parts) if parts else jnp.zeros((), jnp.int32)
        finally:
            RF._MOE_STATS[0] = None
            RF._MOE_VALID[0] = None
            RF._FORCE_SPARSE_MOE[0] = False
        return out, dropped

    xj = jnp.asarray(x)
    vj = None if valid is None else jnp.asarray(valid)
    f = jax.jit(fn).lower(mw, xj, vj).compile(
        compiler_options={"xla_allow_excess_precision": False})
    out, dropped = f(mw, xj, vj)
    return np.asarray(out), int(dropped)


def _port_moe(mw, st, x, valid=None):
    F._MOE_STATS[0] = []
    F._MOE_VALID[0] = None if valid is None else torch.from_numpy(valid)
    try:
        with torch.inference_mode():
            out = F.moe_forward(torch.from_numpy(x), mw, st)
        dropped = int(sum(F._MOE_STATS[0])) if F._MOE_STATS[0] else 0
    finally:
        F._MOE_STATS[0] = None
        F._MOE_VALID[0] = None
    return out.numpy(), dropped


def _x(b, t, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, t, 256)).astype(np.float32)


@pytest.mark.parametrize("regime,b,t", [("dense", 3, 16), ("sparse", 2, 2),
                                        ("dispatch", 2, 64)])
def test_moe_regimes_match_reference(layer, regime, b, t, monkeypatch):
    rw, rst, tw, tst = layer
    monkeypatch.setattr(F, "_FORCE_SPARSE_MOE", [regime == "sparse"])
    x = _x(b, t)
    ref, ref_drop = _ref_moe(rw, rst, x, sparse=regime == "sparse")
    before = Q.LAUNCHES["qmm"]
    got, drop = _port_moe(tw, tst, x)
    assert Q.LAUNCHES["qmm"] == before            # the CPU runs no kernel
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _rel(got, ref) < TOL, _rel(got, ref)
    assert drop == ref_drop
    if regime == "dispatch":
        assert drop == 0                          # CF 2 holds every route


def test_moe_forced_drops_match_reference(layer):
    """A starved capacity (CF 0.25: 64 slots an expert for 256 routes)
    drops routes: the same count and the same output in both packages."""
    rw, rst, tw, tst = layer
    x = _x(4, 128, seed=1)
    RF.set_moe_dispatch(capacity_factor=0.25)
    F.set_moe_dispatch(capacity_factor=0.25)
    try:
        ref, ref_drop = _ref_moe(rw, rst, x)
        got, drop = _port_moe(tw, tst, x)
    finally:
        RF.set_moe_dispatch(capacity_factor=2.0)
        F.set_moe_dispatch(capacity_factor=2.0)
    assert ref_drop > 0 and drop == ref_drop
    assert _rel(got, ref) < TOL, _rel(got, ref)


def test_moe_padded_prefill_mask_matches_reference(layer):
    """Bucketed prefill pads rows and columns; the validity mask takes them
    out of the routing (no capacity taken, no drop counted), as the
    reference's review fix does: same output and count as the reference,
    and the pad rows' output is zero."""
    rw, rst, tw, tst = layer
    x = _x(2, 64, seed=2)
    lens = np.array([50, 23])
    valid = (np.arange(64)[None, :] < lens[:, None]).reshape(-1)
    ref, ref_drop = _ref_moe(rw, rst, x, valid=valid)
    got, drop = _port_moe(tw, tst, x, valid=valid)
    assert _rel(got, ref) < TOL, _rel(got, ref)
    assert drop == ref_drop
    assert np.all(got.reshape(128, -1)[~valid] == 0)


def test_sparse_decode_equals_dense_bitwise(layer):
    """The gated decode against the dense mix on the same rows: unrouted
    experts give exact zeros either way, so the sums are the same."""
    _, _, tw, tst = layer
    x = torch.from_numpy(_x(4, 1, seed=3))
    with torch.inference_mode():
        dense = F.moe_forward(x, tw, tst)
        F._FORCE_SPARSE_MOE[0] = True
        try:
            sparse = F.moe_forward(x, tw, tst)
        finally:
            F._FORCE_SPARSE_MOE[0] = False
    assert torch.equal(sparse, dense)


def test_sparse_decode_gates_what_kernel_one_serves(layer, monkeypatch):
    """The gate reaches every expert launch of kernel 1's path, and a W4A8
    or QMM_PARTIALS model falls back to the dense formulation (those
    kernels take no gate in this package)."""
    from exllamav2_tpu_torch.ops.dequant import enable_w4a8
    _, _, tw, tst = layer
    x = torch.from_numpy(_x(1, 1, seed=4))
    seen = []
    real = Q.qmm_gated_plain

    def spy(xs, seg, gate):
        seen.append(int(gate))
        return real(xs, seg, gate)

    monkeypatch.setattr(Q, "qmm_gated_plain", spy)
    monkeypatch.setattr(F, "_FORCE_SPARSE_MOE", [True])
    with torch.inference_mode():
        F.moe_forward(x, tw, tst)
        assert len(seen) == 3 * 4 and sorted(seen).count(1) == 3 * 2
        seen.clear()
        F.moe_forward(x, enable_w4a8(tw), tst)
    assert seen == []
    assert Q.gate_capable(list(tw.w1)) and not Q.gate_capable(
        list(enable_w4a8(tw).w1))


# ---------------------------------------------------------------------------
# whole models and the generator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    """A tiny EXL2 Mixtral with a sharpened head (decisive argmaxes)."""
    d = str(tmp_path_factory.mktemp("moe") / "mixtral")
    return make_tiny_llama(d, quant="exl2", seed=13, vocab=256, hidden=128,
                           layers=2, heads=2, kv_heads=2, inter=256,
                           max_pos=512, arch="MixtralForCausalLM",
                           head_scale=6.0, extra_config=MOE4)


def _gen(model, graphs=False, **kw):
    st = model.static
    cache = PagedKVCache.alloc(st.num_layers, 8, st.num_kv_heads,
                               st.head_dim, "bf16", device="cpu")
    return DynamicGenerator(model, cache, TOK, max_batch_size=4,
                            decode_burst=1, graphs=graphs, **kw)


def _serve(gen, prompts, new=6):
    jobs = [gen.enqueue(DynamicJob(p, max_new_tokens=new,
                                   settings=Settings.greedy()))
            for p in prompts]
    finals = {}
    while any(j.status != "done" for j in jobs):
        for r in gen.iterate():
            if r.get("eos"):
                finals[id(r["job"])] = r
    return [j.sequence.tolist() for j in jobs], [finals[id(j)] for j in jobs]


PROMPTS = [np.random.default_rng(i).integers(3, 250, n).astype(np.int32)
           for i, n in enumerate((40, 57))]


def test_graphed_moe_steps_equal_eager(mixtral, force_sparse):
    """The gated decode inside the step graphs (run on their static
    buffers) against the eager steps: generate_greedy and a generator
    round, bitwise the same tokens."""
    prompt = np.stack([PROMPTS[0][:12], PROMPTS[1][:12]])
    eager = Model.from_dir(mixtral, device="cpu")
    graphed = Model.from_dir(mixtral, device="cpu", graphs=True)
    e = eager.generate_greedy(prompt, 8)
    g = graphed.generate_greedy(prompt, 8)
    np.testing.assert_array_equal(g, e)
    assert sum(graphed.step_graphs.replays.values()) == 7
    se, _ = _serve(_gen(eager), PROMPTS)
    sg, _ = _serve(_gen(eager, graphs=True), PROMPTS)
    assert sg == se


NEAR_TIE = 0.02     # top-2 gap / max |logit| under which two paths may part


@pytest.mark.parametrize("kw", [{}, {"merged_weights": True, "w4a8": True}],
                         ids=["prescaled", "merged_w4a8"])
def test_generator_tokens_match_reference(mixtral, kw):
    """The reference generator's greedy tokens, or a parting at a near-tie
    only: the port's t = 1 paged attention on the CPU is its kernel's plain
    version (bf16 probabilities, as the card computes them), the
    reference's off its TPU the f32 gather path, so their logits differ by
    a few 1e-3 of max |logit| (on dense models as on MoE ones); where a
    job's tokens part, the reference's logits at that step must have a
    top-2 gap under NEAR_TIE of their max (the rule of PERF.md, section
    2)."""
    from exllamav2_tpu.cache_paged import PagedKVCache as RefCache
    from exllamav2_tpu.generator.dynamic import (
        DynamicGenerator as RefGen, DynamicJob as RefJob)
    from exllamav2_tpu.generator.sampler import Settings as RefSettings
    from exllamav2_tpu.models.model import Model as RefModel
    from exllamav2_tpu.tokenizer import ByteTokenizer as RefTok
    rm = RefModel.from_dir(mixtral)
    st = rm.static
    rgen = RefGen(rm, RefCache.alloc(st.num_layers, 8, st.num_kv_heads,
                                     st.head_dim, "bf16"), RefTok(256),
                  max_batch_size=4, decode_burst=1, prescale=True, **kw)
    rjobs = [rgen.enqueue(RefJob(p, max_new_tokens=6, return_logits=True,
                                 settings=RefSettings.greedy()))
             for p in PROMPTS]
    logits = {id(j): [] for j in rjobs}
    while any(j.status != "done" for j in rjobs):
        for r in rgen.iterate():
            if r.get("logits") is not None:
                logits[id(r["job"])].append(np.asarray(r["logits"][0]))
    gen = _gen(Model.from_dir(mixtral, device="cpu"), prescale=True, **kw)
    got, finals = _serve(gen, PROMPTS)
    for seq, rj, p in zip(got, rjobs, PROMPTS):
        want = rj.sequence.tolist()
        if seq == want:
            continue
        i = next(i for i, (a, b) in enumerate(zip(seq, want)) if a != b)
        top = np.sort(logits[id(rj)][i - len(p)])[::-1]
        assert top[0] - top[1] < NEAR_TIE * np.abs(top).max(), (i, top[:2])
    assert all(r.get("moe_dropped_tokens", 0) == 0 for r in finals)
    assert gen.moe_dropped_tokens == rgen.moe_dropped_tokens == 0


def test_moe_dropped_routes_metric(mixtral):
    """Capacity-overflow drops surface as a job metric and the generator's
    counter; the dense fallback (set_moe_dispatch(min_tokens=1 << 30))
    drops nothing."""
    model = Model.from_dir(mixtral, device="cpu")
    prompt = np.random.default_rng(0).integers(3, 250, 96).astype(np.int32)
    F.set_moe_dispatch(capacity_factor=0.3)
    try:
        gen = _gen(model)
        _, (m,) = _serve(gen, [prompt], new=2)
        assert m.get("moe_dropped_tokens", 0) > 0, m
        assert gen.moe_dropped_tokens == m["moe_dropped_tokens"]
        F.set_moe_dispatch(capacity_factor=0.3, min_tokens=1 << 30)
        gen2 = _gen(model)
        _, (m2,) = _serve(gen2, [prompt], new=2)
        assert m2.get("moe_dropped_tokens", 0) == 0, m2
        assert gen2.moe_dropped_tokens == 0
    finally:
        F.set_moe_dispatch(capacity_factor=2.0, min_tokens=64)


def test_batched_prefill_drops_fold_when_read(mixtral):
    """A batched prefill's count is the batch's, not a job's: it waits on
    the device until moe_dropped_tokens is read, and a cancelled job's
    counts are folded too."""
    model = Model.from_dir(mixtral, device="cpu")
    F.set_moe_dispatch(capacity_factor=0.3)
    try:
        gen = _gen(model)
        jobs = [gen.enqueue(DynamicJob(p, max_new_tokens=3,
                                       settings=Settings.greedy()))
                for p in PROMPTS]
        gen.iterate()                       # one batched prefill of both
        assert gen._moe_drop_batch and all(
            isinstance(d, torch.Tensor) for d in gen._moe_drop_batch)
        for j in jobs:
            gen.cancel(j)
        n = gen.moe_dropped_tokens
        assert n > 0 and not gen._moe_drop_batch
        assert gen.moe_dropped_tokens == n
    finally:
        F.set_moe_dispatch(capacity_factor=2.0)
