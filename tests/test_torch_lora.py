"""Port vs reference: LoRA adapters and CFG on the CPU.

The reference's tests/test_lora_cfg.py and test_generator.py's
set_loras round trip, on both packages: the bypass of one linear
(lora.LoraLinear through ops/qmm.linear_apply), adapted logits of a whole
model (within 1e-2 relative, as tests/test_torch_model.py holds logits),
adapted greedy tokens (exact), set_loras on a live and on a merged
generator, and a CFG job's tokens and second-stream position (exact). The
checkpoint is the reference suite's tiny EXL2 model with a sharpened head,
so that greedy choices are decisive in both packages.
"""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from exllamav2_tpu.cache_paged import PagedKVCache as RefPagedCache
from exllamav2_tpu.generator.dynamic import DynamicGenerator as RefGen
from exllamav2_tpu.generator.dynamic import DynamicJob as RefJob
from exllamav2_tpu.generator.sampler import Settings as RefSettings
from exllamav2_tpu.lora import Lora as RefLora
from exllamav2_tpu.lora import LoraLinear as RefLoraLinear
from exllamav2_tpu.lora import apply_lora as ref_apply_lora
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.ops.qmm import linear_apply as ref_linear_apply
from exllamav2_tpu.stloader import write_safetensors
from exllamav2_tpu.utils.testing import make_tiny_llama

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.interop import to_tensor, weights_from_reference
from exllamav2_tpu_torch.lora import Lora, LoraLinear, apply_lora, remove_lora
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.ops.qmm import linear_apply
from exllamav2_tpu_torch.tokenizer import ByteTokenizer

TOK = ByteTokenizer(384)


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


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("lora_model")),
                           quant="exl2", seed=5, vocab=384, max_pos=4096,
                           hidden=128, heads=2, kv_heads=1, inter=256,
                           head_scale=6.0)


@pytest.fixture(scope="module")
def model(model_dir):
    return Model.from_dir(model_dir, device="cpu")


@pytest.fixture(scope="module")
def ref_model(model_dir):
    return RefModel.from_dir(model_dir)


def _mk_adapter(path, hidden=128, r=4, alpha=8, layers=2, seed=0,
                weight_scale=0.1, outs=None):
    """The reference suite's PEFT adapter: f32 A / B of q_proj and v_proj
    (GQA: v is half as wide) drawn with numpy."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    outs = outs or {"self_attn.q_proj": hidden, "self_attn.v_proj":
                    hidden // 2}
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha,
                   "target_modules": [k.split(".")[-1] for k in outs]}, f)
    tensors = {}
    for l in range(layers):
        for tgt, out in outs.items():
            p = f"base_model.model.model.layers.{l}.{tgt}"
            tensors[f"{p}.lora_A.weight"] = (rng.standard_normal(
                (r, hidden)) * weight_scale).astype(np.float32)
            tensors[f"{p}.lora_B.weight"] = (rng.standard_normal(
                (out, r)) * weight_scale).astype(np.float32)
    write_safetensors(os.path.join(path, "adapter_model.safetensors"),
                      tensors)
    return path


def _cache(model, pages=16):
    st = model.static
    return PagedKVCache.alloc(st.num_layers, pages, st.num_kv_heads,
                              st.head_dim, "bf16", device="cpu")


def test_lora_math_exact(model, ref_model):
    """The bypass of one linear: within the reference test's 0.05 of the
    plain A / B computation, and within 1e-2 relative of the reference's
    linear_apply on the same wrapped linear."""
    rng = np.random.default_rng(1)
    x, a, b = ((rng.standard_normal(shape) * 0.1).astype(ml_dtypes.bfloat16)
               for shape in ((3, 128), (128, 4), (4, 128)))
    wrapped = LoraLinear(model.weights.layers[0].attn.q,
                         *(to_tensor(t, "cpu") for t in (a, b)), 2.0)
    xt = to_tensor(x, "cpu")
    y = linear_apply(xt, wrapped).numpy()
    manual = linear_apply(xt, wrapped.base).numpy() + 2.0 * (
        x.astype(np.float32) @ a.astype(np.float32) @ b.astype(np.float32))
    assert np.abs(y - manual).max() < 0.05
    ref = RefLoraLinear(base=ref_model.weights.layers[0].attn.q,
                        a=jax.numpy.asarray(a), b=jax.numpy.asarray(b),
                        scaling=2.0)
    assert _rel(y, np.asarray(ref_linear_apply(jax.numpy.asarray(x), ref))) \
        < 1e-2


# one prompt length for the reference's whole-model forwards of this file,
# so that its compiled step is reused
T_REF = 17


def _ref_logits(ref_model, ref_lora, ids):
    """The reference's adapted logits over ids [1, T_REF]."""
    rw = ref_apply_lora(ref_model.weights, ref_lora)
    out, _ = RefModel(rw, ref_model.static).forward(
        ids, ref_model.new_cache(batch=1, max_seq=32), 0)
    return rw, np.asarray(out)


def test_lora_changes_output(model, ref_model, tmp_path):
    """Adapted logits against the reference's (1e-2 relative), the
    reference's adapted tree carried over by interop against the port's
    adapter on the reference's base weights (bitwise); the adapter moves
    the logits, and unwrapping restores them bitwise."""
    adapter = _mk_adapter(str(tmp_path / "adapter"), weight_scale=0.6)
    lora, ref_lora = Lora(adapter), RefLora(adapter)
    assert len(lora.targets) == 4 and lora.scaling == ref_lora.scaling
    ids = np.random.default_rng(3).integers(3, 380, (1, T_REF)).astype(
        np.int32)

    def logits(w):
        return Model(w, model.static).forward(
            ids, model.new_cache(1, 32), 0)[0]

    base = logits(model.weights)
    adapted_w = apply_lora(model.weights, lora)
    adapted = logits(adapted_w)
    assert not np.allclose(base.numpy(), adapted.numpy(), atol=1e-3)
    assert torch.equal(logits(remove_lora(adapted_w)), base)
    assert model.weights.layers[0].attn.q is not adapted_w.layers[0].attn.q
    assert not isinstance(model.weights.layers[0].attn.q, LoraLinear)

    rw, want = _ref_logits(ref_model, ref_lora, ids)
    assert _rel(adapted, want) < 1e-2

    def carried(tree):
        return weights_from_reference(jax.tree_util.tree_map(np.asarray,
                                                             tree),
                                      ref_model.static, device="cpu")[0]
    tw = carried(rw)
    assert isinstance(tw.layers[1].attn.v, LoraLinear)
    assert torch.equal(logits(tw),
                       logits(apply_lora(carried(ref_model.weights), lora)))


def test_set_loras_on_merged_generator(model, ref_model, tmp_path):
    """set_loras on merged_weights: the merged streams are stripped while
    the adapter is attached (the tokens equal the unmerged adapted
    generator's, and each is the reference's adapted argmax after the
    tokens before it: its greedy tokens) and merged again on detach (the
    base tokens)."""
    adapter = _mk_adapter(str(tmp_path / "adapter"), weight_scale=0.6)
    lora = Lora(adapter)
    ids = TOK.encode("merged lora")
    new = T_REF - len(ids)

    def run(gen):
        job = gen.enqueue(DynamicJob(ids, max_new_tokens=new,
                                     settings=Settings.greedy()))
        while job.status != "done":
            gen.iterate()
        return job.sequence[len(ids):]

    base = run(DynamicGenerator(model, _cache(model), TOK))
    unmerged = DynamicGenerator(model, _cache(model), TOK)
    unmerged.set_loras([lora])
    with_lora = run(unmerged)
    assert not np.array_equal(with_lora, base)
    seq = np.concatenate([ids, with_lora])[None]
    _, want = _ref_logits(ref_model, RefLora(adapter), seq)
    np.testing.assert_array_equal(
        with_lora, want[0, len(ids) - 1:-1].argmax(-1))

    def merged(w):
        return [(lw.attn.qkv is not None, lw.mlp.gate_up is not None)
                for lw in w.layers]

    gen = DynamicGenerator(model, _cache(model), TOK, merged_weights=True)
    streams = merged(gen.model.weights)
    assert any(map(any, streams))
    gen.set_loras([lora])
    assert not any(map(any, merged(gen.model.weights)))
    np.testing.assert_array_equal(run(gen), with_lora)
    gen.set_loras(None)
    assert merged(gen.model.weights) == streams
    np.testing.assert_array_equal(run(gen), base)


def test_set_loras_roundtrip(model, tmp_path):
    """The reference's round trip (tests/test_generator.py): a large q_proj
    adapter moves the greedy text of a live generator and detaching
    restores it; attaching the same adapter objects again rebuilds
    nothing; two adapters at once detach together (every wrap unwrapped,
    where the reference's remove_lora unwraps one)."""
    st = model.static
    adapter = _mk_adapter(str(tmp_path / "q"), r=4, alpha=8, seed=0,
                          weight_scale=2.0,
                          outs={"self_attn.q_proj": st.num_heads
                                * st.head_dim})
    gen = DynamicGenerator(model, _cache(model), TOK)
    base = gen.generate("lora test", max_new_tokens=8,
                        settings=Settings.greedy())
    loras = [Lora(adapter)]
    gen.set_loras(loras)
    served = gen.model
    adapted = gen.generate("lora test", max_new_tokens=8,
                           settings=Settings.greedy())
    gen.set_loras(list(loras))
    assert gen.model is served
    gen.set_loras(None)
    restored = gen.generate("lora test", max_new_tokens=8,
                            settings=Settings.greedy())
    assert adapted != base and restored == base
    gen.set_loras([Lora(adapter), Lora(adapter)])
    assert isinstance(gen.model.weights.layers[0].attn.q.base, LoraLinear)
    gen.set_loras([])
    assert gen.generate("lora test", max_new_tokens=8,
                        settings=Settings.greedy()) == base


def test_cfg_generation(model, ref_model):
    """A CFG job (scale 1.5): the reference's tokens and second-stream
    position; at scale 1.0 the text of the plain generator."""
    neg = TOK.encode("goodbye")

    def cfg_job(job_cls, settings_cls, scale):
        s = settings_cls.greedy()
        s.cfg_scale = scale
        return job_cls(TOK.encode("hello world"), max_new_tokens=8,
                       settings=s, negative_prompt_ids=neg)

    st = ref_model.static
    ref = RefGen(ref_model, RefPagedCache.alloc(
        st.num_layers, 32, st.num_kv_heads, st.head_dim, "bf16"), TOK,
        max_batch_size=8)
    rjob = ref.enqueue(cfg_job(RefJob, RefSettings, 1.5))
    while rjob.status != "done":
        ref.iterate()
    gen = DynamicGenerator(model, _cache(model, 32), TOK, max_batch_size=8)
    job = gen.enqueue(cfg_job(DynamicJob, Settings, 1.5))
    gen.iterate()
    # each stream holds its own pages (the reference also hands the main
    # stream the second stream's count)
    assert len(job.pages) == job.pages_needed(gen.page_size)
    assert len(job.pages2) == job.pages2_needed(gen.page_size) == 1
    while job.status != "done":
        gen.iterate()
        gen._validate_cache()
    assert job.new_tokens == 8
    assert job.kv_pos2 == rjob.kv_pos2 == len(neg) + 8 - 1
    np.testing.assert_array_equal(job.sequence, rjob.sequence)
    assert len(gen.free_slots) == 8
    s = Settings.greedy()
    s.cfg_scale = 1.5
    assert gen.generate("hello world", max_new_tokens=8, settings=s,
                        negative_prompt_ids=neg) == job.emitted_text

    gen2 = DynamicGenerator(model, _cache(model, 32), TOK)
    job2 = gen2.enqueue(cfg_job(DynamicJob, Settings, 1.0))
    while job2.status != "done":
        gen2.iterate()
    plain = gen2.generate("hello world", max_new_tokens=8,
                          settings=Settings.greedy())
    assert job2.emitted_text == plain
