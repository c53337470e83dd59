"""Tensor-parallel serving over torch.distributed, port against reference.

Mirrors the reference's tests/test_sharding.py (its twelve cases over a
virtual CPU mesh, marked slow there) and the tensor-parallel cases of
tests/test_vlm.py (Pixtral, Qwen2-VL MRoPE), on two real ranks: one launch
(parallel/launch.py, 300 s deadline, every rank killed when one fails)
starts two gloo CPU processes running tests/torch_tp_cases.py, which serve
every case on a tp = 2 mesh and save what they saw. The checkpoints are
make_tiny_llama / make_tiny_vlm directories in tmp_path that both packages
load (head_scale 6: decisive argmaxes); the quantized-router model is
carried over by interop and saved with torch.save.

Each case asserts:
* the two ranks' tokens are equal, and their per-step logits bitwise;
* every greedy token is the JAX package's single-device choice at that
  point: the reference's paged forward over the prompt and the ranks'
  tokens (teacher-forced, one jitted call a case; the reference's
  generator compiles for tens of seconds a model on the CPU) has its
  argmax there, or a near-tie (top-2 gap under NEAR_TIE of max |logit|:
  the port's t = 1 paged attention on the CPU is its kernel's plain
  version, with bf16 probabilities). CFG mixes the two streams' log-probs
  as the reference's CFG step does; the multimodal cases run the
  reference's generator (its fp16 models compile fast);
* where the case records one, a paged forward's logits equal the port's
  one-process forward within 1e-5 of max |logit| (the port's one-process
  forward is held to the reference's within 1e-3 by
  tests/test_torch_paged_attn.py), and on the llama and capacity-dispatch
  cases the reference's fused-TP forward on 2 virtual CPU devices within
  its own test's 2e-2 (that forward is 5.4e-3 of max |logit| off the
  reference's single-device one on the llama case; the port's is 2.2e-7
  off it).
The JAX references run in this process while the ranks run.
"""

import dataclasses
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllamav2_tpu.cache_paged import PagedKVCache as RefCache
from exllamav2_tpu.generator.dynamic import DynamicGenerator as RefGen
from exllamav2_tpu.generator.dynamic import DynamicJob as RefJob
from exllamav2_tpu.generator.sampler import Settings as RefSettings
from exllamav2_tpu.models.forward import model_forward_paged as ref_fwd
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.parallel import sharding as RS
from exllamav2_tpu.tokenizer import ByteTokenizer as RefTok

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.interop import linear_from_reference
from exllamav2_tpu_torch.models.forward import model_forward_paged
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.parallel.launch import launch
from exllamav2_tpu_torch.utils.testing import (
    make_tiny_llama, make_tiny_vlm, write_random_lora)

import torch_tp_cases as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE = 0.02     # top-2 gap / max |logit| under which two paths may part
SHARD_TOL = 1e-5    # the ranks' logits against the port on one process
REF_TP_TOL = 2e-2   # the reference's own bound on its fused-TP forward
RTOK = RefTok(384)
MOE4 = {"num_local_experts": 4, "num_experts_per_tok": 2}
MOE8 = {"num_local_experts": 8, "num_experts_per_tok": 2}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that this process leaves the
    cores to the ranks beside it and to other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checkpoints(work):
    kw = dict(quant="exl2", vocab=384, heads=8, kv_heads=4, max_pos=2048,
              head_scale=6.0)
    make_tiny_llama(os.path.join(work, "llama"), seed=5, **kw)
    make_tiny_llama(os.path.join(work, "act_order"), seed=23, inter=320,
                    act_order=True, **kw)
    make_tiny_llama(os.path.join(work, "mqa"), seed=9,
                    **dict(kw, kv_heads=1))
    make_tiny_llama(os.path.join(work, "mixtral"), seed=29,
                    arch="MixtralForCausalLM", extra_config=MOE4, **kw)
    make_tiny_llama(os.path.join(work, "mixtral8"), seed=31, inter=256,
                    arch="MixtralForCausalLM", extra_config=MOE8, **kw)
    for kind in ("pixtral", "qwen2"):
        make_tiny_vlm(os.path.join(work, kind), kind)
    llama = Model.from_dir(os.path.join(work, "llama"), device="cpu")
    write_random_lora(os.path.join(work, "lora"), llama.weights, rank=4,
                      scale=0.1, seed=3)
    # a quantized router on every layer of the Mixtral, the same bits in
    # both packages (the reference's test_tp_fused_moe_quantized_router)
    rm, routers = _ref_qrouter(work)
    model = Model.from_dir(os.path.join(work, "mixtral"), device="cpu")
    for lw, r in zip(model.weights.layers, routers):
        lw.mlp.router = linear_from_reference(
            jax.tree_util.tree_map(np.asarray, r), "cpu")
    torch.save((model.weights, model.static),
               os.path.join(work, "qrouter.pt"))


def _ref_qrouter(work):
    from exllamav2_tpu.utils.testing import random_quant_linear
    rm = RefModel.from_dir(os.path.join(work, "mixtral"))
    rng = np.random.default_rng(77)
    routers = [random_quant_linear(rng, 256, 4, bits=4)
               for _ in rm.weights.layers]
    w = dataclasses.replace(rm.weights, layers=tuple(
        dataclasses.replace(lw, mlp=dataclasses.replace(lw.mlp, router=r))
        for lw, r in zip(rm.weights.layers, routers)))
    return RefModel(w, rm.static, rm.config), routers


class _World:
    """The ranks' launch, run on a thread while this process computes the
    references; `result(case)` waits for it."""

    def __init__(self, work):
        self.work, self.error = work, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        try:
            launch([os.path.join(REPO, "tests", "torch_tp_cases.py"),
                    self.work], 2, timeout=300, env=env, cwd=REPO)
        except Exception as e:          # surfaced by result()
            self.error = e

    def result(self, case):
        self.thread.join()
        if self.error is not None:
            raise self.error
        a, b = (torch.load(os.path.join(self.work, f"{case}.{r}.pt"),
                           weights_only=False) for r in (0, 1))
        assert a.get("tokens") == b.get("tokens")
        for key in ("steps", "logits"):
            if key in a:
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              np.asarray(b[key]))
        return a


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tp"))
    _checkpoints(work)
    return _World(work)


@functools.lru_cache(maxsize=None)
def _ref(work, name):
    return RefModel.from_dir(os.path.join(work, name))


_REF_STEP = jax.jit(ref_fwd, static_argnums=(1,))
_ROWS = 32          # forced forwards pad to this: one compile a model


def _forced(rm, ids, kind="bf16", weights=None):
    """The reference's single-device paged forward over `ids` (dequant and
    XLA matmuls; causal, so the padding past `ids` changes nothing before
    it) -> logits [len(ids), vocab] f64."""
    st = dataclasses.replace(rm.static, fused_matmul=False)
    t = len(ids)
    ids = np.pad(np.asarray(ids, np.int32), (0, max(_ROWS - t, 0)))
    cache = RefCache.alloc(st.num_layers, 4, st.num_kv_heads, st.head_dim,
                           kind)
    logits, _ = _REF_STEP(rm.weights if weights is None else weights, st,
                          jnp.asarray(ids[None]), cache,
                          jnp.asarray([[1]], jnp.int32),
                          jnp.zeros((1,), jnp.int32))
    return np.asarray(logits[0, :t], np.float64)


def _port_logits(work, name, ids):
    """The port's one-process paged forward (the ranks' shards put
    together) -> last-token logits."""
    model = C._model(work, name)
    st = model.static
    cache = PagedKVCache.alloc(st.num_layers, 4, st.num_kv_heads,
                               st.head_dim, device="cpu")
    from exllamav2_tpu_torch.ops.dequant import precompute_model_scales
    logits, _ = model_forward_paged(
        precompute_model_scales(model.weights), st, torch.from_numpy(ids),
        cache, torch.tensor([[1]], dtype=torch.int32),
        torch.zeros((1,), dtype=torch.int32), last_token_only=True)
    return logits[0, -1].numpy()


def _steps(rm, prompt, tokens, **kw):
    """The reference's logits at each of `tokens`' steps, teacher-forced."""
    lg = _forced(rm, list(prompt) + list(tokens[:-1]), **kw)
    return lg[len(prompt) - 1:]


def _agree(tokens, steps):
    """Each token is the reference's argmax at its step, or a near-tie."""
    assert len(tokens) == len(steps) > 0
    for i, (tok, lg) in enumerate(zip(tokens, steps)):
        gap = lg.max() - lg[tok]
        assert gap < NEAR_TIE * np.abs(lg).max(), (i, tokens, gap)


def _ref_logits(rm, ids, tp=2):
    """Last-token logits of the reference's fused-TP paged forward on tp
    virtual CPU devices."""
    w, st = rm.weights, rm.static
    cache = RefCache.alloc(st.num_layers, 4, st.num_kv_heads, st.head_dim,
                           "bf16")
    mesh = RS.make_mesh(tp, dp=1, devices=jax.devices("cpu")[:tp])
    with mesh:
        w_tp, w_specs = RS.shard_model_tp_fused(w, st, mesh, tp)
        cache_s = RS.shard_paged_cache(cache, mesh)
        fwd, _ = RS.make_tp_paged_forward(
            mesh, RS.local_static(st, tp), w_specs,
            RS.paged_cache_pspecs(cache_s))
        logits, _ = jax.jit(fwd)(w_tp, jnp.asarray(ids), cache_s,
                                 jnp.asarray([[1]], jnp.int32),
                                 jnp.zeros((1,), jnp.int32),
                                 jnp.zeros((1,), jnp.int32))
    return np.asarray(logits)


def _close(got, want, tol):
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _served(world, case, rm, prompt=C.PROMPT, **kw):
    """The ranks' result of a serving case, its tokens held to the
    reference's choices."""
    got = world.result(case)
    ids = RTOK.encode(prompt)
    _agree(got["tokens"], _steps(rm, ids, got["tokens"], **kw))
    return got


@pytest.mark.parametrize("case,name,fused", [
    ("serve", "llama", True), ("act_order", "act_order", True),
    ("fallback_heads", "mqa", False), ("moe_ep", "mixtral", True)])
def test_serving_and_forward_match_reference(world, case, name, fused):
    """Greedy serving on the mesh (reference test_tp_fused_generator_serving,
    test_tp_fused_act_order_mixed_bitrate_serving: act-order perms, mixed
    bitrates and a lane-padded MLP; test_tp_fused_moe_generator_serving and
    test_tp_fused_moe_expert_parallel: whole experts a rank; and the
    fallback of test_sharded_generator_serving: a single KV head keeps
    attention whole on each rank) and one paged forward's logits
    (test_tp_fused_forward_matches_single: the port's one-process forward,
    and on the llama case the reference's fused-TP forward)."""
    rm = _ref(world.work, name)
    got = _served(world, case, rm)
    assert got["fused"] == fused == RS.tp_fusable(rm.weights, rm.static, 2)
    _close(got["logits"], _port_logits(world.work, name, C.FWD_IDS),
           SHARD_TOL)
    if case == "serve":
        _close(got["logits"], _ref_logits(rm, C.FWD_IDS), REF_TP_TOL)
    if case == "moe_ep":
        assert got["ep"] == "EPMoEWeights"


def test_linear_cache_forward(world):
    """Reference test_tp_dp_forward_matches_single and
    test_sharded_decode_steps: Model.forward of the rank's shard over the
    linear cache (a prefill, two decode steps) against one process's."""
    got = world.result("linear")
    model = C._model(world.work, "llama")
    want = C.linear_steps(Model(model.weights, model.static, graphs=False))
    _close(got["logits"], want, SHARD_TOL)


def test_ep_prefill_capacity_dispatch(world):
    """Reference test_ep_prefill_capacity_dispatch: 128 prefill rows of 8
    experts, top 2, four local experts a rank, through the capacity
    dispatch; logits against the port's one-process forward (which takes
    the dispatch too) and the reference's fused EP forward."""
    rm = _ref(world.work, "mixtral8")
    got = world.result("moe_ep_dispatch")
    assert got["fused"]
    _close(got["logits"], _port_logits(world.work, "mixtral8",
                                       C.DISPATCH_IDS), SHARD_TOL)
    _close(got["logits"], _ref_logits(rm, C.DISPATCH_IDS), REF_TP_TOL)


@pytest.mark.parametrize("kind", ["q4", "q8"])
def test_quantized_cache_serving(world, kind):
    """Reference test_tp_fused_quantized_cache_serving: q4 / q8 pools split
    on KV heads with their scale pools."""
    got = _served(world, f"{kind}_cache", _ref(world.work, "llama"),
                  kind=kind)
    assert got["fused"]


def test_moe_quantized_router_serving(world):
    """Reference test_tp_fused_moe_quantized_router_serving: a quantized
    router (made dense for the EP layers) does not stop the fused path."""
    rm, _ = _ref_qrouter(world.work)
    assert _served(world, "moe_quantized_router", rm)["fused"]


@pytest.mark.parametrize("case,prompt", [
    ("spec_draft", C.PROMPT), ("spec_ngram", "abcabcabcabc"),
    ("dp2", C.PROMPT)])
def test_plain_tokens_on_the_mesh(world, case, prompt):
    """Reference test_spec_decode_on_mesh (a self-draft, replicated, and
    n-gram drafts: speculation leaves greedy tokens as they are) and the
    dp = 2 fallback of test_sharded_generator_serving (not fused)."""
    got = _served(world, case, _ref(world.work, "llama"), prompt)
    assert got["fused"] == (case != "dp2")
    if case == "spec_draft":
        assert got["draft_whole"]


def test_cfg_on_the_mesh(world):
    """Reference test_cfg_on_fused_mesh: a CFG job's paired streams, held
    to the reference's mix of the two streams' log-probabilities."""
    rm = _ref(world.work, "llama")
    got = world.result("cfg")
    assert got["fused"]
    toks = got["tokens"]

    def lsm(prompt):                      # log_softmax of each step
        lg = _steps(rm, RTOK.encode(prompt), toks)
        m = lg.max(-1, keepdims=True)
        return lg - m - np.log(np.exp(lg - m).sum(-1, keepdims=True))

    _agree(toks, 1.5 * lsm(C.PROMPT) - 0.5 * lsm("goodbye"))


def test_lora_on_the_mesh(world):
    """LoRA on the fused path (reference lora_wrap_tp_fused): A replicated,
    B split with the base columns; detaching restores plain serving."""
    from exllamav2_tpu.lora import Lora as RefLora, apply_lora
    rm = _ref(world.work, "llama")
    got = world.result("lora")
    assert got["fused"] and got["tokens"] != got["plain"]
    ids = RTOK.encode(C.PROMPT)
    lw = apply_lora(rm.weights, RefLora(os.path.join(world.work, "lora")))
    _agree(got["tokens"], _steps(rm, ids, got["tokens"], weights=lw))
    _agree(got["plain"], _steps(rm, ids, got["plain"]))


def test_model_init_tensor_parallel(world):
    """model_init -tp 2 inside a world of two ranks builds the mesh and
    serves the reference's greedy tokens."""
    got = world.result("model_init")
    assert got["tp"] == 2 and got["fused"]
    _agree(got["tokens"], _steps(_ref(world.work, "llama"),
                                 RTOK.encode(C.PROMPT), got["tokens"]))


@pytest.mark.parametrize("kind,text", [("pixtral", "look <img> here"),
                                       ("qwen2", "scene <img> is")])
def test_vlm_on_the_mesh(world, kind, text):
    """Reference tests/test_vlm.py::test_pixtral_fused_tp_serving and
    ::test_qwen2vl_fused_tp_serving_mrope: image rows (and MRoPE rows and
    offsets) are replicated operands of every rank's forward."""
    from exllamav2_tpu.vlm import VisionTower as RefTower
    rm = _ref(world.work, kind)
    img = (np.random.default_rng(3).random((16, 16, 3)) * 255).astype(
        np.uint8)
    mme = RefTower(rm.config).get_image_embeddings(rm, RTOK, img,
                                                   text_alias="<img>")
    st = rm.static
    gen = RefGen(rm, RefCache.alloc(st.num_layers, 32, st.num_kv_heads,
                                    st.head_dim), RTOK, max_batch_size=4)
    job = gen.enqueue(RefJob(gen.encode_with_embeddings(text, [mme]),
                             max_new_tokens=C.NEW, return_logits=True,
                             settings=RefSettings.greedy(),
                             embeddings=[mme]))
    steps = []
    while job.status != "done":
        for r in gen.iterate():
            if r.get("logits") is not None:
                steps.append(np.asarray(r["logits"], np.float64).ravel())
    got = world.result("pixtral" if kind == "pixtral" else "qwen2vl")
    assert got["fused"]
    want = job.sequence[job.prompt_len:].tolist()
    if got["tokens"] != want:      # parts at a near-tie only
        i = next(i for i, (a, b) in enumerate(zip(got["tokens"], want))
                 if a != b)
        _agree([got["tokens"][i]], steps[i:i + 1])
