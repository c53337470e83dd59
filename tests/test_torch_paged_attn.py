"""Port vs reference: paged attention and the paged forward (CPU).

* the port's paged_decode_attention on a CPU tensor (its plain version, the
  CPU counterpart of csrc/paged_attn.cu) against the reference's Pallas
  kernel called directly in interpret mode, on bit-identical pools: every
  kind pair, GQA 4:2 and 4:1, valid lengths 1 / 255 / 256 / 257, a pad row on
  the null page, softcap and window -- within 1e-5 of max |ref| (f32 sums
  in another order; p rounds to bf16 at the same point in both);
* the t > 1 branch of paged_attention against the reference's (both f32 on
  the CPU) within 1e-5 relative;
* model_forward_paged against the reference's on the same weights, one
  prefill and 3 decode steps, within 1e-2 relative, against both of the
  reference's t = 1 branches: its f32 gather path (what it takes off the TPU)
  and its kernel branch (interpreted).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.cache_paged import PagedKVCache as RefPaged
from exllamav2_tpu.cache_paged import _kinds
from exllamav2_tpu.models.forward import model_forward_paged as ref_forward
from exllamav2_tpu.ops import paged_attn as RP
from exllamav2_tpu.ops import qmm as RQ
from exllamav2_tpu.utils.testing import random_model_weights as ref_weights

from exllamav2_tpu_torch.interop import (
    paged_cache_from_reference, weights_from_reference)
from exllamav2_tpu_torch.models.forward import model_forward_paged
from exllamav2_tpu_torch.ops import paged_attn as TP

D = 128


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


@functools.lru_cache(maxsize=None)
def _pools(kind: str, hkv: int):
    """Reference pool filled through its own append (3 sequences of 600
    rows over shuffled pages), and the port's copy of it."""
    rng = np.random.default_rng(hkv)
    rc = RefPaged.alloc(2, 8, hkv, D, kind)
    bt = jnp.asarray([[5, 2, 7], [3, 6, 1], [4, 0, 0]], jnp.int32)
    kv = rng.standard_normal((2, 3, 600, hkv, D)).astype(np.float32)
    rc = rc.append(1, bt, jnp.zeros(3, jnp.int32),
                   jnp.asarray(kv[0], jnp.bfloat16),
                   jnp.asarray(kv[1], jnp.bfloat16))
    rc = jax.tree_util.tree_map(np.asarray, rc)
    return rc, paged_cache_from_reference(rc, device="cpu")


def _case(kind, hq, hkv, vl, cap, win):
    rc, tc = _pools(kind, hkv)
    # rows 0..3 are live sequences on shuffled pages; row 4 is a pad row
    # (seqlen 0 -> one valid row) whose table is all null page
    bt = np.array([[5, 2, 7, 0], [3, 6, 1, 0], [5, 2, 7, 0], [3, 6, 1, 0],
                   [0, 0, 0, 0]], np.int32)
    q = np.random.default_rng(len(vl)).standard_normal(
        (5, hq, D)).astype(np.float32)
    qj = jnp.asarray(q, jnp.bfloat16)
    qt = torch.from_numpy(np.asarray(qj).view(np.int16).copy()).view(
        torch.bfloat16)
    kinds = _kinds(kind)
    ref = RP.paged_decode_attention(
        qj, jnp.asarray(rc.k_data), jnp.asarray(rc.v_data), 1,
        jnp.asarray(bt), jnp.asarray(vl, jnp.int32),
        None if rc.k_scales is None else jnp.asarray(rc.k_scales),
        None if rc.v_scales is None else jnp.asarray(rc.v_scales),
        0.09, 256, hq, kinds, cap, win)
    got = TP.paged_decode_attention(
        qt, tc.k_data, tc.v_data, 1, torch.from_numpy(bt),
        torch.tensor(vl, dtype=torch.int32), tc.k_scales, tc.v_scales, 0.09,
        256, hq, kinds, cap, win)
    return got, np.asarray(ref)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1)])
@pytest.mark.parametrize("kind", ["bf16", "fp8", "q8", "q4", "q6"])
def test_decode_kernel_plain_matches_reference(kind, hq, hkv):
    got, ref = _case(kind, hq, hkv, [1, 255, 256, 257, 1], 0.0, 0)
    assert got.shape == ref.shape == (5, 1, hq, D)
    assert np.isfinite(ref).all()
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["bf16", "q6"])
@pytest.mark.parametrize("cap,win", [(20.0, 0), (0.0, 100), (15.0, 300)])
def test_decode_kernel_plain_softcap_window(kind, cap, win):
    got, ref = _case(kind, 4, 2, [600, 255, 257, 130, 1], cap, win)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["bf16", "q4"])
def test_decode_plain_f64_evaluation(kind):
    """dtype=torch.float64 evaluates the plain version's rounding points
    (bf16 K/V, p rounded to bf16 against the running page max) with f64
    scores and state, chip_smoke's yardstick for kernel 3 on a served
    model's inputs: an f32 result of the f32 evaluation's shape, within
    1e-5 of its max (measured 3.0e-8 at bf16, 3.9e-7 at q4: here no p
    lands near a rounding boundary)."""
    rc, tc = _pools(kind, 2)
    bt = torch.tensor([[5, 2, 7, 0], [3, 6, 1, 0], [0, 0, 0, 0]],
                      dtype=torch.int32)
    q = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 4, D)).astype(np.float32)).to(torch.bfloat16)
    args = (q, tc.k_data, tc.v_data, 1, bt,
            torch.tensor([600, 257, 1], dtype=torch.int32), tc.k_scales,
            tc.v_scales, 0.09, 256, 4, _kinds(kind))
    f32 = TP.paged_decode_attention_plain(*args)
    f64 = TP.paged_decode_attention_plain(*args, dtype=torch.float64)
    assert f64.dtype == f32.dtype == torch.float32
    assert f64.shape == f32.shape == (3, 1, 4, D)
    assert _rel(f64, f32) < 1e-5


@pytest.mark.parametrize("kind", ["bf16", "q4", "q6"])
def test_prefill_branch_matches_reference(kind):
    """t > 1: gather + dequant + masked softmax, f32 on both sides."""
    rc, tc = _pools(kind, 2)
    bt = np.array([[5, 2, 7], [3, 6, 1]], np.int32)
    seqlens = np.array([200, 250], np.int32)
    q = np.random.default_rng(3).standard_normal((2, 9, 4, D)).astype(
        np.float32)
    ref = RP.paged_attention(
        jnp.asarray(q), jax.tree_util.tree_map(jnp.asarray, rc), 1,
        jnp.asarray(bt), jnp.asarray(seqlens), scale=0.09, window=40,
        softcap=10.0)
    got = TP.paged_attention(
        torch.from_numpy(q), tc, 1, torch.from_numpy(bt),
        torch.from_numpy(seqlens), scale=0.09, window=40, softcap=10.0)
    assert got.shape == (2, 9, 4, D)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("kind", ["bf16", "q6"])
def test_model_forward_paged_matches_reference(kind, kernel, monkeypatch):
    """kernel=False: the reference's f32 gather path off the TPU;
    kernel=True: its Pallas kernel branch (interpreted), which rounds q, the
    dequantized K/V and p to bf16 where the port's t = 1 path does.

    The q6 pools take codes of K/V rows whose projections already differ by
    an ulp here and there (f32 sums in another order): after the prefill 29
    of 393,216 K codes and one group scale differ, which moves the prefill
    logits by 1.8 % of their max. So the q6 prefill is held at 5e-2, and the
    port's pool is then reset to the reference's bits so that the decode
    steps compare the t = 1 path on identical caches, at 1e-2."""
    if kernel:
        monkeypatch.setattr(RQ, "_INTERPRET_OVERRIDE", [True])
    w, st = ref_weights(vocab=512, hidden=256, layers=2, heads=2,
                        kv_heads=1, inter=512, max_seq=1024, bits=4, seed=4)
    tw, tst = weights_from_reference(jax.tree_util.tree_map(np.asarray, w),
                                     st, device="cpu")
    assert tst.head_dim == 128
    rc = RefPaged.alloc(2, 6, 1, 128, kind)
    tc = paged_cache_from_reference(jax.tree_util.tree_map(np.asarray, rc),
                                    device="cpu")
    step = jax.jit(ref_forward, static_argnums=(1, 6))
    bt = np.array([[4, 1], [2, 5]], np.int32)
    ids = np.random.default_rng(1).integers(3, 500, (2, 40)).astype(np.int32)

    def both(chunk, pos, last):
        nonlocal rc
        ref, rc = step(w, st, jnp.asarray(chunk), rc, jnp.asarray(bt),
                       jnp.asarray(pos), last)
        got, _ = model_forward_paged(tw, tst, torch.from_numpy(chunk), tc,
                                     torch.from_numpy(bt),
                                     torch.from_numpy(pos),
                                     last_token_only=last)
        return got, np.asarray(ref)

    got, ref = both(ids[:, :37], np.array([0, 0], np.int32), False)
    assert got.shape == ref.shape == (2, 37, 512)
    assert _rel(got, ref) < (1e-2 if kind == "bf16" else 5e-2)
    tc = paged_cache_from_reference(jax.tree_util.tree_map(np.asarray, rc),
                                    device="cpu")
    for i in range(37, 40):                         # t = 1 decode steps
        got, ref = both(ids[:, i:i + 1], np.array([i, i], np.int32), True)
        assert got.shape == ref.shape == (2, 1, 512)
        assert _rel(got, ref) < 1e-2, i


def test_unported_forward_arguments_raise():
    """The multimodal arguments are ported (tests/test_torch_vlm.py holds
    them against the reference): the embedding rows of the ids as
    input_embeds, the table's rows as rope_rows and zero pos_offsets give
    the plain forward's logits bitwise; an offset reads the rope rows of
    the offset positions."""
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    w, st = random_model_weights(vocab=64, hidden=128, layers=1, heads=1,
                                 kv_heads=1, inter=128, max_seq=512,
                                 device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        3, 60, (2, 5)).astype(np.int32))
    bt = torch.tensor([[1], [2]], dtype=torch.int32)
    lens = torch.tensor([0, 3], dtype=torch.int32)
    pos = lens.long()[:, None] + torch.arange(5)

    def run(**kw):
        return model_forward_paged(w, st, ids, _tiny_pool(st), bt, lens,
                                   **kw)[0]

    def step(**kw):
        # a prefill, then one token
        pool = _tiny_pool(st)
        model_forward_paged(w, st, ids, pool, bt, lens)
        return model_forward_paged(w, st, ids[:, :1], pool, bt, lens + 5,
                                   **kw)[0]

    plain = run()
    for kw in ({"input_embeds": w.embed[ids.long()]},
               {"rope_rows": (w.sin[pos], w.cos[pos])},
               {"pos_offsets": torch.zeros(2, dtype=torch.int32)}):
        assert torch.equal(run(**kw), plain), list(kw)
    # an offset takes the rope rows of seqlen + offset
    offs = torch.tensor([0, -2], dtype=torch.int32)
    at = (lens + 5 + offs).long()[:, None]
    assert torch.equal(step(pos_offsets=offs),
                       step(rope_rows=(w.sin[at], w.cos[at])))


def _tiny_pool(st):
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    return PagedKVCache.alloc(st.num_layers, 3, st.num_kv_heads, st.head_dim,
                              device="cpu")
