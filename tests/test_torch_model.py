"""Port vs reference: whole-model forward and greedy generation (CPU).

* random weights drawn by the reference, handed to the port through
  interop.weights_from_reference: one prefill + four decode steps agree
  within 1e-2 relative (bf16 roundings of activations fall in different
  places once f32 sums are taken in another order);
* on-disk checkpoints (EXL2 mixed 4/4/5/3 bits, GPTQ, fp16, and the trained
  fixture) loaded by both packages give identical greedy tokens;
* the port's own decode-vs-prefill consistency, and its device default.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.cache import KVCache as RefCache
from exllamav2_tpu.models import forward as RF
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.utils.testing import make_tiny_llama
from exllamav2_tpu.utils.testing import random_model_weights as ref_weights

from exllamav2_tpu_torch.cache import KVCache
from exllamav2_tpu_torch.interop import to_tensor, weights_from_reference
from exllamav2_tpu_torch.models.forward import model_forward
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.utils.testing import random_model_weights

TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "trained_tiny")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def test_weights_from_reference_logits():
    w, st = ref_weights(vocab=512, hidden=256, layers=2, heads=8, kv_heads=4,
                        inter=512, max_seq=64, bits=4, seed=3)
    tw, tst = weights_from_reference(jax.tree_util.tree_map(np.asarray, w),
                                     st, device="cpu")
    assert (tst.num_layers, tst.num_heads, tst.num_kv_heads, tst.head_dim) \
        == (st.num_layers, st.num_heads, st.num_kv_heads, st.head_dim)
    ids = np.random.default_rng(0).integers(3, 500, (1, 12)).astype(np.int32)
    step = jax.jit(RF.model_forward, static_argnums=(1, 5, 6))

    rc = RefCache.alloc(2, 1, 64, 4, 32)
    tc = KVCache.alloc(2, 1, 64, 4, 32, device="cpu")
    pre = 8
    ref, rc = step(w, st, jnp.asarray(ids[:, :pre]), rc, jnp.int32(0),
                   False, 256)
    got, tc = model_forward(tw, tst, torch.from_numpy(ids[:, :pre]), tc, 0,
                            attn_limit=256)
    assert _rel(got, ref) < 1e-2
    for pos in range(pre, 12):
        ref, rc = step(w, st, jnp.asarray(ids[:, pos:pos + 1]), rc,
                       jnp.int32(pos), False, 256)
        got, tc = model_forward(tw, tst, torch.from_numpy(
            ids[:, pos:pos + 1]), tc, pos, attn_limit=256)
        assert got.shape == ref.shape == (1, 1, 512)
        assert _rel(got, ref) < 1e-2, pos
    # the caches hold the same rows (bf16 values one rounding apart at most)
    assert _rel(tc.k.float(), rc.k) < 1e-2 and _rel(tc.v.float(), rc.v) < 1e-2


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fixtures")
    return {
        "exl2": make_tiny_llama(str(root / "exl2"), quant="exl2", seed=2,
                                head_scale=4.0),
        "gptq": make_tiny_llama(str(root / "gptq"), quant="gptq", seed=3,
                                head_scale=4.0),
        "fp16": make_tiny_llama(str(root / "fp16"), quant=None, seed=1,
                                head_scale=4.0),
        "trained": TRAINED,
        # sliding window 5 < prompt + new tokens: masks both attention paths
        "mistral_swa": make_tiny_llama(
            str(root / "mistral"), quant=None, seed=4, head_scale=4.0,
            arch="MistralForCausalLM", extra_config={"sliding_window": 5}),
        # q/k/v biases on quantized linears
        "qwen2_gptq_bias": make_tiny_llama(
            str(root / "qwen2"), quant="gptq", seed=5, head_scale=4.0,
            arch="Qwen2ForCausalLM"),
    }


@pytest.mark.parametrize("name", ["exl2", "gptq", "fp16", "trained",
                                  "mistral_swa", "qwen2_gptq_bias"])
def test_from_dir_greedy_tokens_match_reference(fixtures, name):
    d = fixtures[name]
    prompt = np.array([[1, 50, 99, 7]], np.int32)
    ref = RefModel.from_dir(d).generate_greedy(prompt, 8, max_seq=32)
    got = Model.from_dir(d, device="cpu").generate_greedy(prompt, 8,
                                                          max_seq=32)
    assert got.shape == (1, 12)
    np.testing.assert_array_equal(got, ref)


def test_decode_matches_prefill(fixtures):
    """Token-by-token decode through the cache == full-sequence forward."""
    model = Model.from_dir(fixtures["fp16"], device="cpu")
    ids = np.array([[5, 99, 180, 7, 31, 64]], np.int32)
    full, _ = model.forward(ids, model.new_cache(1, 16), 0)
    cache = model.new_cache(1, 16)
    steps = []
    for i in range(ids.shape[1]):
        lg, cache = model.forward(ids[:, i:i + 1], cache, i)
        steps.append(lg[:, 0])
    assert _rel(torch.stack(steps, 1), full) < 0.02


def test_cache_update_in_place_and_bounds():
    cache = KVCache.alloc(1, 1, 4, 2, 32, device="cpu")
    k0 = cache.k
    new = torch.ones((1, 2, 2, 32), dtype=torch.bfloat16)
    assert cache.update(0, new, new, 2) is cache and cache.k is k0
    assert cache.k[0, 0, :, 2:].eq(1).all() and cache.k[0, 0, :, :2].eq(0).all()
    with pytest.raises(ValueError):
        cache.update(0, new, new, 3)


def test_default_device_is_the_card(fixtures, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model.from_dir(fixtures["fp16"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_model_weights(vocab=64, hidden=64, layers=1, heads=2,
                             kv_heads=2, inter=64, max_seq=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_tensor(np.zeros(4, np.float32))


def test_unported_architecture_features_raise(tmp_path):
    """Post-norms and softcaps (Gemma2) have no forward here yet: loading
    fails loudly instead of computing something else."""
    d = make_tiny_llama(str(tmp_path / "g2"), quant=None,
                        arch="Gemma2ForCausalLM")
    with pytest.raises(NotImplementedError, match="post-norms"):
        Model.from_dir(d, device="cpu")


def test_random_model_weights_on_cpu():
    w, st = random_model_weights(vocab=128, hidden=128, layers=1, heads=4,
                                 kv_heads=2, inter=256, max_seq=32,
                                 device="cpu")
    words = w.layers[0].mlp.up.segments[0].plane0
    assert words.dtype == torch.int32 and (words < 0).any()
    out = Model(w, st).generate_greedy([[1, 2, 3]], 4)
    assert out.shape == (1, 7) and (out >= 0).all() and (out < 128).all()


def test_chunked_forward_matches_single_shot(fixtures):
    """Inputs beyond max_input_len stream through in chunks."""
    model = Model.from_dir(fixtures["fp16"], device="cpu")
    ids = np.random.default_rng(0).integers(3, 250, (1, 40)).astype(np.int32)
    ref, _ = model.forward(ids, model.new_cache(1, 64), 0)
    model.config.max_input_len = 16                     # three chunks
    got, _ = model.forward(ids, model.new_cache(1, 64), 0)
    assert got.shape == ref.shape and _rel(got, ref) < 0.02
    last, _ = model.forward(ids, model.new_cache(1, 64), 0,
                            last_token_only=True)
    assert last.shape == (1, 1, ref.shape[-1])
    assert _rel(last[:, 0], ref[:, -1]) < 0.02
