"""The architectures beyond plain Llama, port against reference (CPU).

* Twelve text-only architectures whose quirks the port serves (QK-norm,
  post-norms, alternate rope tables, parallel blocks, NoPE layers, learned
  positions, block-sparse MoE) written by the reference's make_tiny_llama
  (plus the per-head norm tensors, as tests/test_archs.py adds them) and
  loaded by both packages: prefill logits and four greedy decode steps.
  The reference runs its own model_forward, jitted with XLA's excess
  precision off: otherwise XLA's CPU compiler keeps some bf16 values (the
  embedding plus the learned positions, a norm's bf16 output) in f32 inside
  a fusion, where the reference's functions, run as written, and the port
  round them; that alone moves GPT2's logits by 6e-3 of max |logit|.
  Tolerance: 1e-2 of max |logit|, as tests/test_torch_model.py holds the
  reference's random weights: both packages take the CPU products in f32
  (ops/qmm.dot_dtype) and round to bf16 at the same points, but their f32
  sums run in another order, so an activation rounded to bf16 lands one
  ulp apart now and then and the difference grows through the layers
  (measured up to 4.5e-3; 3e-7 where no rounding flipped). The greedy
  tokens must be equal.
* One case per quirk through interop.weights_from_reference: the
  reference's numpy-seeded random_model_weights with the quirk's weights
  and flags set on the reference tree; prefill and four decode steps of
  the port's model_forward against the reference's, 1e-2 of max |logit|.
* The port's make_tiny_llama writes the reference's files byte for byte.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.cache import KVCache as RefCache
from exllamav2_tpu.models import forward as RF
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.stloader import TensorFileMap, write_safetensors
from exllamav2_tpu.utils.testing import make_tiny_llama as ref_make_tiny
from exllamav2_tpu.utils.testing import random_model_weights as ref_weights

from exllamav2_tpu_torch.cache import KVCache
from exllamav2_tpu_torch.config import ModelConfig
from exllamav2_tpu_torch.interop import weights_from_reference
from exllamav2_tpu_torch.models.forward import model_forward
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.utils.testing import make_tiny_llama

TOL = 1e-2          # max |port - reference| / max |reference| of the logits
# a 40-token prompt: its prefill takes the many-row (dequant + product) path
# of both packages, the decode steps their fused paths
IDS = np.random.default_rng(0).integers(3, 250, (1, 40)).astype(np.int32)
NEW = 4             # greedy decode steps after the prefill
MAX_SEQ = 64


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


def _exact_jit(fn, *args):
    """fn jitted for args with XLA's excess precision off (every bf16 value
    rounded where the function rounds it)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _ref_greedy(w, st, ids, new):
    """The reference's prefill logits and `new` greedy steps (tokens and
    each step's logits), through its model_forward."""
    b, t = ids.shape
    cache = RefCache.alloc(st.num_layers, b, MAX_SEQ, st.num_kv_heads,
                           st.head_dim)

    def fwd(w, i, c, p):
        return RF.model_forward(w, st, i, c, p, attn_limit=MAX_SEQ)

    pre = _exact_jit(fwd, w, jnp.asarray(ids), cache, jnp.int32(0))
    logits, cache = pre(w, jnp.asarray(ids), cache, jnp.int32(0))
    first = np.asarray(logits)
    tok = np.argmax(first[:, -1], axis=-1).astype(np.int32)[:, None]
    step = _exact_jit(fwd, w, jnp.asarray(tok), cache, jnp.int32(t))
    toks, steps = [tok], []
    for i in range(new):
        lg, cache = step(w, jnp.asarray(tok), cache, jnp.int32(t + i))
        steps.append(np.asarray(lg)[:, 0])
        tok = np.argmax(steps[-1], axis=-1).astype(np.int32)[:, None]
        toks.append(tok)
    return first, np.concatenate(toks, axis=1), steps


def _port_greedy(w, st, ids, new):
    """The same through the port's model_forward on the CPU."""
    b, t = ids.shape
    cache = KVCache.alloc(st.num_layers, b, MAX_SEQ, st.num_kv_heads,
                          st.head_dim, device="cpu")
    with torch.inference_mode():
        logits, cache = model_forward(w, st, torch.from_numpy(ids), cache, 0,
                                      attn_limit=MAX_SEQ)
        first = logits.numpy()
        tok = np.argmax(first[:, -1], axis=-1).astype(np.int32)[:, None]
        toks, steps = [tok], []
        for i in range(new):
            lg, cache = model_forward(
                w, st, torch.from_numpy(tok), cache,
                torch.tensor(t + i, dtype=torch.int32), attn_limit=MAX_SEQ)
            steps.append(lg.numpy()[:, 0])
            tok = np.argmax(steps[-1], axis=-1).astype(np.int32)[:, None]
            toks.append(tok)
    return first, np.concatenate(toks, axis=1), steps


def _layers(st):
    return [dataclasses.astuple(ls) for ls in st.layers]


def _agree(ref, got):
    (rf, rt, rs), (gf, gt, gs) = ref, got
    assert np.isfinite(gf).all() and gf.shape == rf.shape
    assert _rel(gf, rf) < TOL, _rel(gf, rf)
    for i, (a, b) in enumerate(zip(gs, rs)):
        assert _rel(a, b) < TOL, (i, _rel(a, b))
    np.testing.assert_array_equal(gt, rt)


# ---------------------------------------------------------------------------
# the twelve architectures from disk
# ---------------------------------------------------------------------------

MOE4 = {"num_local_experts": 4, "num_experts": 4, "num_experts_per_tok": 2}
ARCHS = {
    "Qwen3ForCausalLM": ("exl2", {}),
    "Qwen3MoeForCausalLM": (None, MOE4),
    "MixtralForCausalLM": ("exl2", MOE4),
    "GemmoeForCausalLM": ("gptq", MOE4),
    "DbrxForCausalLM": (None, MOE4),
    "Gemma2ForCausalLM": (None, {"sliding_window": 4}),
    "Gemma3ForCausalLM": ("exl2", {"sliding_window": 4, "head_dim": 64,
                                   "sliding_window_pattern": 2}),
    "Glm4ForCausalLM": ("exl2", {}),
    "CohereForCausalLM": (None, {"logit_scale": 0.5}),
    "Cohere2ForCausalLM": ("exl2", {"sliding_window": 4,
                                    "sliding_window_pattern": 2}),
    "GPT2LMHeadModel": (None, {}),
    "GPTBigCodeForCausalLM": (None, {}),
}


def _with_head_norms(d: str) -> None:
    """Add the per-head q/k norm tensors an architecture with QK-norm
    expects (make_tiny_llama writes none), drawn near 1."""
    cfg = ModelConfig.from_dir(d)
    if not cfg.use_qk_norm:
        return
    tfm = TensorFileMap(d)
    tensors = {k: tfm.get_tensor(k).copy() for k in tfm.keys()}
    tfm.close()
    rng = np.random.default_rng(5)
    ap = cfg.arch
    for l in range(cfg.num_hidden_layers):
        for key in (ap.key_attn_q_norm, ap.key_attn_k_norm):
            tensors[ap.lm_prefix + key.format(l=l) + ".weight"] = (
                1 + 0.1 * rng.standard_normal(cfg.head_dim)).astype(
                np.float16)
    write_safetensors(os.path.join(d, "model.safetensors"), tensors)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_architecture_matches_reference(tmp_path, arch):
    quant, extra = ARCHS[arch]
    d = ref_make_tiny(str(tmp_path / "m"), quant=quant, seed=1, arch=arch,
                      extra_config=extra)
    _with_head_norms(d)
    rm = RefModel.from_dir(d)
    tm = Model.from_dir(d, device="cpu")
    st = tm.static
    # the architecture's quirks reached the port's model
    ap = tm.config.arch
    assert st.use_qk_norm == rm.static.use_qk_norm
    assert st.parallel_blocks == ap.parallel_decoder_blocks
    assert st.learned_pos_emb == (tm.weights.pos_emb is not None)
    assert (tm.weights.sin_alt is not None) == any(
        ls.alt_rope for ls in st.layers)
    assert _layers(st) == _layers(rm.static)
    lw = tm.weights.layers[0]
    assert (lw.attn.norm_post is not None) == bool(ap.key_norm_1_post)
    if ap.is_moe:
        assert st.num_experts == 4 and len(lw.mlp.w1) == 4
    _agree(_ref_greedy(rm.weights, rm.static, IDS, NEW),
           _port_greedy(tm.weights, st, IDS, NEW))


def test_dbrx_fused_expert_blocks(tmp_path):
    """DBRX's fused expert storage (one raw [E * ffn, d] tensor a projection,
    sliced per expert at load) gives what the per-expert keys give."""
    d = ref_make_tiny(str(tmp_path / "m"), quant=None, seed=4,
                      arch="DbrxForCausalLM", extra_config=MOE4)
    per_key = Model.from_dir(d, device="cpu")
    ap = per_key.config.arch
    tfm = TensorFileMap(d)
    tensors = {k: tfm.get_tensor(k).copy() for k in tfm.keys()}
    tfm.close()
    for l in range(2):
        for key, fused, transpose in ((ap.key_moe_w1, ap.key_moe_fused_w1,
                                       False),
                                      (ap.key_moe_w2, ap.key_moe_fused_w2,
                                       True),
                                      (ap.key_moe_w3, ap.key_moe_fused_w3,
                                       False)):
            blocks = [tensors.pop(key.format(l=l, e=e) + ".weight")
                      for e in range(4)]
            tensors[fused.format(l=l)] = np.concatenate(
                [b.T if transpose else b for b in blocks], axis=0)
    write_safetensors(os.path.join(d, "model.safetensors"), tensors)
    fused_m = Model.from_dir(d, device="cpu")
    rm = RefModel.from_dir(d)
    for e in range(4):
        for name in ("w1", "w2", "w3"):
            assert torch.equal(
                getattr(fused_m.weights.layers[1].mlp, name)[e].weight,
                getattr(per_key.weights.layers[1].mlp, name)[e].weight)
    _agree(_ref_greedy(rm.weights, rm.static, IDS, NEW),
           _port_greedy(fused_m.weights, fused_m.static, IDS, NEW))


@pytest.mark.parametrize("arch,quant", [("MixtralForCausalLM", "exl2"),
                                        ("Gemma3ForCausalLM", "gptq"),
                                        ("GPT2LMHeadModel", None)])
def test_make_tiny_llama_writes_the_reference_files(tmp_path, arch, quant):
    a = ref_make_tiny(str(tmp_path / "ref"), quant=quant, seed=7, arch=arch,
                      extra_config=MOE4 if "Mixtral" in arch else None)
    b = make_tiny_llama(str(tmp_path / "port"), quant=quant, seed=7,
                        arch=arch,
                        extra_config=MOE4 if "Mixtral" in arch else None)
    for name in ("config.json", "model.safetensors"):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


# ---------------------------------------------------------------------------
# one quirk at a time through interop.weights_from_reference
# ---------------------------------------------------------------------------

def _norm(rng, width, bias=False):
    from exllamav2_tpu.models.modules import NormWeights
    w = (1 + 0.1 * rng.standard_normal(width)).astype(np.float32)
    b = (0.05 * rng.standard_normal(width)).astype(np.float32) \
        if bias else None
    return NormWeights(weight=jnp.asarray(w),
                       bias=None if b is None else jnp.asarray(b))


def _quirk_model(quirk):
    """The reference's random_model_weights (2 layers, hidden 256, dense
    weights of a numpy seed) with one quirk's weights and flags set on the
    reference tree."""
    from exllamav2_tpu.ops.rope import build_sincos
    from types import SimpleNamespace
    w, st = ref_weights(vocab=384, hidden=256, layers=2, heads=4,
                        kv_heads=2, inter=512, max_seq=MAX_SEQ, bits=4,
                        seed=9, dense=True, moe=4 if quirk == "moe" else 0,
                        moe_topk=2)
    rng = np.random.default_rng(11)
    hd = st.head_dim
    rep = dataclasses.replace
    layers = list(w.layers)
    if quirk == "qk_norm":
        st = rep(st, use_qk_norm=True)
        layers = [rep(lw, attn=rep(lw.attn, q_norm=_norm(rng, hd),
                                   k_norm=_norm(rng, hd))) for lw in layers]
    elif quirk == "post_norms":
        layers = [rep(lw, attn=rep(lw.attn, norm_post=_norm(rng, 256)),
                      mlp=rep(lw.mlp, norm_post=_norm(rng, 256)))
                  for lw in layers]
    elif quirk == "parallel":
        st = rep(st, parallel_blocks=True, norm_type="layernorm")
        layers = [rep(lw, attn=rep(lw.attn, norm=_norm(rng, 256, True)),
                      mlp=rep(lw.mlp, norm=_norm(rng, 256, True)))
                  for lw in layers]
    elif quirk == "nope":
        st = rep(st, layers=tuple(
            rep(ls, sliding_window=0 if l % 2 else 5, rope_enabled=l % 2 == 0)
            for l, ls in enumerate(st.layers)))
    elif quirk == "learned_pos":
        st = rep(st, learned_pos_emb=True, rope_style="none")
        w = rep(w, pos_emb=jnp.asarray(
            (0.5 * rng.standard_normal((MAX_SEQ, 256))).astype(np.float32),
            dtype=jnp.bfloat16))
    elif quirk == "alt_rope":
        sin_a, cos_a = build_sincos(SimpleNamespace(
            rotary_dim=hd, rotary_embedding_base=37.0, rope_scaling=None,
            max_seq_len=MAX_SEQ, max_position_embeddings=MAX_SEQ,
            original_max_position_embeddings=None, head_dim=hd))
        w = rep(w, sin_alt=sin_a, cos_alt=cos_a)
        st = rep(st, layers=tuple(
            rep(ls, sliding_window=0 if l % 2 else 5, alt_rope=l % 2 == 0)
            for l, ls in enumerate(st.layers)))
    w = rep(w, layers=tuple(layers))
    return w, st


QUIRKS = ["qk_norm", "post_norms", "parallel", "nope", "learned_pos",
          "alt_rope", "moe"]


@pytest.mark.parametrize("quirk", QUIRKS)
def test_quirk_through_interop_matches_reference(quirk):
    w, st = _quirk_model(quirk)
    tw, tst = weights_from_reference(jax.tree_util.tree_map(np.asarray, w),
                                     st, device="cpu")
    assert _layers(tst) == _layers(st)
    if quirk == "moe":
        assert isinstance(tw.layers[0].mlp.w1, torch.nn.ModuleList)
    ids = np.random.default_rng(2).integers(3, 380, (2, 40)).astype(
        np.int32)
    _agree(_ref_greedy(w, st, ids, NEW), _port_greedy(tw, tst, ids, NEW))


def test_interop_refuses_expert_parallel_moe():
    """An expert-parallel layer (the reference's EPMoEWeights, arrays
    stacked on a leading expert axis) is no longer refused: it comes
    through as the port's EPMoEWeights with every expert, and the port's
    moe_ep_forward on one process equals the reference's within 1e-3 of
    max |reference|."""
    from exllamav2_tpu.models.modules import EPMoEWeights
    from exllamav2_tpu_torch.models import forward as F
    from exllamav2_tpu_torch.models.modules import EPMoEWeights as PortEP
    w, st = ref_weights(vocab=128, hidden=128, layers=1, heads=2, kv_heads=2,
                        inter=128, max_seq=16, seed=1, moe=2, moe_topk=1)
    mw = w.layers[0].mlp

    def stack(lins):
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *lins)

    ep = EPMoEWeights(norm=mw.norm, router=mw.router, w1=stack(mw.w1),
                      w2=stack(mw.w2), w3=stack(mw.w3))
    w = dataclasses.replace(w, layers=(dataclasses.replace(w.layers[0],
                                                           mlp=ep),))
    tw, tst = weights_from_reference(jax.tree_util.tree_map(np.asarray, w),
                                     st, device="cpu")
    got = tw.layers[0].mlp
    assert isinstance(got, PortEP) and len(got.w1) == 2 and got.first == 0
    x = np.random.default_rng(3).standard_normal((2, 3, 128)).astype(
        np.float32)
    ref = np.asarray(RF.moe_ep_forward(jnp.asarray(x), ep, st))
    out = F.moe_ep_forward(torch.from_numpy(x), got, tst).numpy()
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("arch", ["GPT2LMHeadModel", "Gemma3ForCausalLM"])
def test_forward_with_hooks_keeps_the_quirks(tmp_path, arch):
    """Model.forward_with_hooks without hooks is the forward: it adds the
    learned positions and takes the sliding layers' rope table (the
    reference's adds neither: 0.28 of max |logit| off on GPT2, 4.7e-3 on
    Gemma3; ROADMAP.md section 3)."""
    quant, extra = ARCHS[arch]
    d = make_tiny_llama(str(tmp_path / "m"), quant=quant, seed=2, arch=arch,
                        extra_config=extra)
    _with_head_norms(d)
    tm = Model.from_dir(d, device="cpu")
    ids = IDS[:, :12]
    a, _ = tm.forward(ids, tm.new_cache(1, MAX_SEQ), 0)
    b, _ = tm.forward_with_hooks(ids, tm.new_cache(1, MAX_SEQ), 0)
    assert torch.equal(a, b)
