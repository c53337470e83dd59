"""The converter's parts, port against reference (CPU).

The same numpy inputs go through exllamav2_tpu/convert and
exllamav2_tpu_torch/convert:

* QParams: groups and exact bit totals of every option of the attention,
  MLP and head grids, equal, at K of 128, 4096 and 11008.
* AdaptiveQuantizer.find_params: scale, qscale and qscale_max bit for bit
  at 2-8 bits (the p grid is the reference's jnp.linspace bit for bit:
  torch.linspace rounds some of its 49 points to the neighbouring f32).
* The GPTQ row recursion (gptq_quant_range_plain, the plain version of
  kernel G1) against _gptq_quant_range on the same w, U and scale: codes
  equal, dq and the updated w within 1e-6 of max |reference| (the
  reference's compiler may fuse a product into the difference; measured
  0.0 and 3.7e-8).
* AdaptiveGPTQ from the same activations: the act-order permutation equal;
  U within U_TOL of max |U| (the Hessian product, the factorizations and
  the solve sum in another order: measured 8e-6); codes that differ
  counted and at most CODE_FLIPS of them (measured 0); the output error
  within 1e-4 relative. quantize_rtn equal.
* optimize_allocation: the same choices with the native annealers (both
  C++ copies draw the same std::mt19937_64 stream) and with both numpy
  fallbacks; sim_anneal is None where g++ cannot build it.
* calibration_rows bit for bit; the parquet reader's error without pyarrow
  or pandas.
* _layer_forward_capture's captures and output for dense Llama, Mixtral
  (MoE), Phi-3 (fused qkv / gate_up), Gemma 2 (post-norms) and Command R
  (parallel blocks), within CAP_TOL of max |reference| (bf16 roundings of
  activations land one ulp apart where f32 sums run in another order, as
  tests/test_torch_archs.py holds whole models); on a NoPE layer the port
  skips the rotation that the reference applies (ROADMAP.md, section 3).
* prepare's re-damping: a singular Hessian retried to the same attempt as
  the reference's, or refused after ten in both.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from exllamav2_tpu.config import ModelConfig as RefConfig
from exllamav2_tpu.convert import gptq as RG
from exllamav2_tpu.convert import pipeline as RP
from exllamav2_tpu.convert import qparams as RQ
from exllamav2_tpu.models.loader import load_model as ref_load
from exllamav2_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from exllamav2_tpu.utils.testing import make_tiny_llama as ref_make_tiny

from exllamav2_tpu_torch import native
from exllamav2_tpu_torch.config import ModelConfig
from exllamav2_tpu_torch.convert import gptq as G
from exllamav2_tpu_torch.convert import pipeline as P
from exllamav2_tpu_torch.convert import qparams as Q
from exllamav2_tpu_torch.models.loader import load_model
from exllamav2_tpu_torch.tokenizer import ByteTokenizer

U_TOL = 1e-4
CODE_FLIPS = 0.01       # share of codes that may differ from the reference
CAP_TOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _options(mod):
    return (mod.qparams_attn(32) + mod.qparams_attn(128)
            + mod.qparams_mlp(32) + mod.qparams_mlp(128)
            + mod.qparams_head() + list(mod._HEAD_OPTIONS.values()))


@pytest.mark.parametrize("k", [128, 4096, 11008])
def test_qparams_match_reference(k):
    for rq, tq in zip(_options(RQ), _options(Q), strict=True):
        assert rq.desc == tq.desc
        assert rq.groups(k) == tq.groups(k)
        assert rq.total_bits(k, 4096) == tq.total_bits(k, 4096)
        assert rq.bpw(k, 4096) == tq.bpw(k, 4096)
    assert Q.qparams_head_for(16) is None
    assert Q.qparams_head_for(6) == Q._HEAD_OPTIONS[6]


@pytest.mark.parametrize("num", [17, 49])
def test_p_grid_is_the_references(num):
    ref = np.asarray(jnp.linspace(0.75, 1.25, num))
    got = G.p_grid(0.75, 1.25, num, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
def test_find_params_bitwise(bits):
    rng = np.random.default_rng(bits)
    for p_grid, rows in ((48, 32), (16, 128)):
        x = (rng.standard_normal((rows, 96)) * 0.1).astype(np.float32)
        x[:, 5] *= 20                     # a wide column: qscale spreads
        rs, rq, rm = RG.AdaptiveQuantizer(bits=bits, p_grid=p_grid
                                          ).find_params(jnp.asarray(x))
        ts, tq, tm = G.AdaptiveQuantizer(bits=bits, p_grid=p_grid
                                         ).find_params(torch.from_numpy(x))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        assert tq.dtype == torch.int16 and ts.dtype == torch.float32
        assert np.float32(tm) == np.float32(rm)
    # leading dimensions batch independent groups
    xb = (rng.standard_normal((3, 32, 64)) * 0.1).astype(np.float32)
    qz = G.AdaptiveQuantizer(bits=bits)
    bs, bq, bm = qz.find_params(torch.from_numpy(xb))
    for i in range(3):
        s, q, m = qz.find_params(torch.from_numpy(xb[i]))
        assert torch.equal(bs[i], s) and torch.equal(bq[i], q)
        assert torch.equal(bm[i], m)


def _correlated(rng, m, k):
    base = rng.standard_normal((m, 8))
    return (base @ rng.standard_normal((8, k))
            + rng.standard_normal((m, k)) * 0.1).astype(np.float32)


def _hinv(rng, k):
    g = RG.AdaptiveGPTQ(np.zeros((k, 8), np.float32))
    g.add_batch(_correlated(rng, 4 * k, k))
    g.prepare()
    return np.array(g.hessian_inv)


@pytest.mark.parametrize("bits,a,blk", [(4, 32, 32), (3, 0, 128),
                                        (8, 96, 32), (2, 64, 64)])
def test_gptq_quant_range_plain_matches_reference(bits, a, blk):
    rng = np.random.default_rng(bits)
    k, n = 192, 80
    u = _hinv(rng, k)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    quantizer = RG.AdaptiveQuantizer(bits=bits)
    scale = np.array(quantizer.find_params(jnp.asarray(w[a:a + blk]))[0])
    rq, rdq, rw = RG._gptq_quant_range(
        jnp.asarray(w), jnp.asarray(u), jnp.asarray(scale),
        jnp.float32(quantizer.qzero), jnp.float32(quantizer.maxq),
        jnp.int32(a), blk)
    tw = torch.from_numpy(w.copy())
    tq, tdq, tw2 = G.gptq_quant_range_plain(
        tw, torch.from_numpy(u), torch.from_numpy(scale), quantizer.qzero,
        quantizer.maxq, a, blk)
    assert tq.dtype == torch.uint16 and tw2 is tw        # w in place
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert _rel(tdq, rdq) <= 1e-6
    assert _rel(tw2, rw) <= 1e-6
    # gptq_rows is the plain loop on a CPU tensor, and leaves w alone
    w0 = torch.from_numpy(w.copy())
    q, dq, err = G.gptq_rows(w0, torch.from_numpy(u),
                             torch.from_numpy(scale), quantizer.qzero,
                             quantizer.maxq, a, blk)
    assert torch.equal(w0, torch.from_numpy(w))
    assert torch.equal(q, tq) and torch.equal(dq, tdq)
    assert err.shape == (blk, n)


def test_adaptive_gptq_matches_reference():
    rng = np.random.default_rng(1)
    k, n, m = 256, 64, 1024
    x = _correlated(rng, m, k)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    groups = Q.QParams(32, (5, 4, 3), (0.25, 0.25, 0.5)).groups(k)

    rg = RG.AdaptiveGPTQ(w.copy())
    rg.add_batch(x[:512])
    rg.add_batch(x[512:])
    rg.prepare()
    res = rg.quantize(groups)
    tg = G.AdaptiveGPTQ(torch.from_numpy(w.copy()))
    tg.add_batch(torch.from_numpy(x[:512]))
    tg.add_batch(x[512:])                      # numpy input works too
    tg.prepare()
    got = tg.quantize(groups)

    np.testing.assert_array_equal(tg.perm.numpy(), np.asarray(rg.perm))
    np.testing.assert_array_equal(got["invperm"].numpy(),
                                  res["invperm"])
    assert _rel(tg.hessian_inv, rg.hessian_inv) < U_TOL
    flips = int((got["q"].numpy() != res["q"]).sum())
    assert flips <= CODE_FLIPS * res["q"].size, flips
    assert got["q"].dtype == torch.uint16
    assert got["bits"] == res["bits"]
    np.testing.assert_array_equal(got["qscale"].numpy(), res["qscale"])

    def out_err(dq_perm, invperm):
        dq = np.asarray(dq_perm)[np.asarray(invperm)]
        return np.linalg.norm(x @ dq - x @ w)

    e_ref = out_err(res["dq"], res["invperm"])
    e_got = out_err(got["dq"], got["invperm"])
    assert abs(e_got - e_ref) <= 1e-4 * e_ref, (e_got, e_ref)

    # q/k/v share one prepared Hessian: the same tensors, not copies
    other = G.AdaptiveGPTQ(torch.from_numpy(w.copy() * 2))
    other.reuse_h(tg)
    assert other.hessian_inv is tg.hessian_inv and other.perm is tg.perm
    assert torch.equal(other.w, tg.w * 2)


def test_gptq_beats_rtn():
    """The property of tests/test_convert.py:31 on the port."""
    rng = np.random.default_rng(1)
    k, n, m = 128, 64, 512
    x = _correlated(rng, m, k)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.1
    groups = Q.QParams(32, (3,), (1.0,)).groups(k)
    g = G.AdaptiveGPTQ(torch.from_numpy(w.copy()))
    g.add_batch(torch.from_numpy(x))
    g.prepare()
    res = g.quantize(groups)
    dq_gptq = res["dq"][res["invperm"]].numpy()
    dq_rtn = G.AdaptiveGPTQ(torch.from_numpy(w.copy())).quantize_rtn(
        groups).numpy()
    assert (np.linalg.norm(x @ dq_gptq - x @ w)
            < np.linalg.norm(x @ dq_rtn - x @ w))


def _dependent(rng, scale):
    """Activations whose Hessian is singular: 4 random columns, 4 exact
    multiples of them, the rest zero."""
    x = np.zeros((16, 64), np.float32)
    x[:, :4] = rng.standard_normal((16, 4))
    x[:, 4:8] = x[:, :4] * 1.5
    return (x * scale).astype(np.float32)


def test_prepare_redamps_a_singular_hessian(monkeypatch):
    """A singular Hessian under the least damping fails a factorization
    (NaN in the reference, info != 0 here) and is retried with the damping
    doubled: at scale 10 both packages succeed after retries (a failing
    attempt of the second factorization among them) with the same
    permutation and U; at scale 100 all ten attempts fail in both."""
    rng = np.random.default_rng(4)
    infos = []
    chol = torch.linalg.cholesky_ex

    def counted(a):
        out = chol(a)
        infos.append(int(out[1]))
        return out

    monkeypatch.setattr(torch.linalg, "cholesky_ex", counted)
    for scale, fails in ((10, False), (100, True)):
        x = _dependent(rng, scale)
        w = rng.standard_normal((64, 32)).astype(np.float32)
        rg = RG.AdaptiveGPTQ(w)
        rg.add_batch(x)
        rg.percdamp = 0.0
        tg = G.AdaptiveGPTQ(torch.from_numpy(w))
        tg.add_batch(torch.from_numpy(x))
        tg.percdamp = 0.0
        infos.clear()
        if fails:
            for g in (rg, tg):
                with pytest.raises(ValueError, match="not invertible"):
                    g.prepare()
            assert len(infos) == 10 and all(infos)
            continue
        rg.prepare()
        tg.prepare()
        assert infos[0] != 0 and len(infos) > 2 and infos[-1] == 0
        assert torch.isfinite(tg.hessian_inv).all()
        np.testing.assert_array_equal(tg.perm.numpy(), np.asarray(rg.perm))
        # the same attempt succeeded: a zero column's factor entry is
        # 1 / sqrt(damp * 2^attempt) (1e-5 * 2^6 here)
        u_t, u_r = tg.hessian_inv.numpy(), np.asarray(rg.hessian_inv)
        assert abs(u_t[-1, -1] - 1 / np.sqrt(1e-5 * 64)) < 1e-4
        assert u_t[-1, -1] == u_r[-1, -1]
        # condition ~1e7: the rest of the factors part in the second digit
        assert _rel(u_t, u_r) < 0.1


@pytest.mark.parametrize("gs", [32, 128])
def test_quantize_rtn_matches_reference(gs):
    rng = np.random.default_rng(gs)
    k, n = 512, 96
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    for qp in Q.qparams_attn(gs) + Q.qparams_mlp(gs):
        ref = RG.AdaptiveGPTQ(w.copy()).quantize_rtn(qp.groups(k))
        got = G.AdaptiveGPTQ(torch.from_numpy(w.copy())).quantize_rtn(
            qp.groups(k), max_elems=1 << 18)          # several chunks
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=qp.desc)


def _slots(seed, n=24):
    rng = np.random.default_rng(seed)
    slots = []
    for _ in range(n):
        slots.append([(int(b * 1000 + rng.integers(200)),
                       float(np.exp(-b) + rng.random() * 0.01))
                      for b in (8, 2, 5, 3, 6, 4)])
    return slots


@pytest.mark.parametrize("budget_per_slot", [2500, 4000, 6000])
def test_optimize_allocation_matches_reference(monkeypatch,
                                               budget_per_slot):
    slots = _slots(budget_per_slot)
    budget = budget_per_slot * len(slots)
    assert native.host_library() is not None      # g++ is here
    ref = RP.optimize_allocation([list(s) for s in slots], budget, seed=3)
    got = P.optimize_allocation([list(s) for s in slots], budget, seed=3)
    assert got == ref
    assert sum(slots[i][c][0] for i, c in enumerate(got)) <= budget
    # both packages' numpy annealers
    import exllamav2_tpu.native as ref_native
    monkeypatch.setattr(ref_native, "sim_anneal", lambda *a: None)
    monkeypatch.setattr(native, "sim_anneal", lambda *a: None)
    ref_np = RP.optimize_allocation([list(s) for s in slots], budget, seed=3)
    got_np = P.optimize_allocation([list(s) for s in slots], budget, seed=3)
    assert got_np == ref_np
    assert sum(slots[i][c][0] for i, c in enumerate(got_np)) <= budget


def test_sim_anneal_without_a_host_compiler(monkeypatch, tmp_path):
    def no_gxx(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_BUILD", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", no_gxx)
    assert native._compile() is None
    monkeypatch.setattr(native, "_LIB", [None])
    assert native.sim_anneal(_slots(0), 10 ** 6) is None


def test_calibration_rows_bitwise(tmp_path):
    rtok, ttok = RefByteTokenizer(), ByteTokenizer()
    np.testing.assert_array_equal(
        P.calibration_rows(ttok, 16, 256), RP.calibration_rows(rtok, 16, 256))
    np.testing.assert_array_equal(
        P.calibration_rows(ttok, 3, 100, "short text", seed=5, noise_rows=2),
        RP.calibration_rows(rtok, 3, 100, "short text", seed=5,
                            noise_rows=2))
    path = tmp_path / "cal.txt"
    path.write_text("calibration from a file\n" * 40)
    got = P.calibration_rows(ttok, 4, 64, str(path))
    np.testing.assert_array_equal(got, RP.calibration_rows(rtok, 4, 64,
                                                           str(path)))
    assert got.dtype == np.int32 and got.shape == (4, 64)


def test_parquet_needs_pyarrow_or_pandas(monkeypatch, tmp_path):
    path = tmp_path / "cal.parquet"
    path.write_bytes(b"PAR1")
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    monkeypatch.setitem(sys.modules, "pandas", None)
    for mod in (RP, P):
        with pytest.raises(RuntimeError, match="pyarrow or pandas"):
            mod.calibration_rows(ByteTokenizer(), 2, 8, str(path))


CAPTURE_ARCHS = {
    "LlamaForCausalLM": {},
    "MixtralForCausalLM": {"num_local_experts": 4,
                           "num_experts_per_tok": 2},
    "Phi3ForCausalLM": {},
    "Gemma2ForCausalLM": {},
    "CohereForCausalLM": {"logit_scale": 0.5},
}


@pytest.mark.parametrize("arch", list(CAPTURE_ARCHS))
def test_layer_forward_capture_matches_reference(tmp_path, arch):
    d = ref_make_tiny(str(tmp_path / "m"), quant=None, seed=7, arch=arch,
                      vocab=256, hidden=128, layers=2, heads=4, kv_heads=2,
                      inter=256, extra_config=CAPTURE_ARCHS[arch])
    rw, rst = ref_load(RefConfig.from_dir(d))
    tw, tst = load_model(ModelConfig.from_dir(d), device="cpu")
    assert tst.parallel_blocks == rst.parallel_blocks
    rows = np.clip(P.calibration_rows(ByteTokenizer(), 2, 48), 0, 255)
    t = rows.shape[1]
    rx = jnp.take(rw.embed, jnp.asarray(rows), axis=0).astype(jnp.float32)
    if rst.normalize_embeddings:
        rx = rx * (rst.hidden_size ** 0.5)
    rx = rx.astype(jnp.bfloat16)
    tx = P.embed_rows(tw, tst, rows)
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(rx, np.float32))
    for layer in range(2):
        rout, rcap = RP._layer_forward_capture(
            rw.layers[layer], rst, rx, rw.sin[:t], rw.cos[:t])
        tout, tcap = P._layer_forward_capture(
            tw.layers[layer], tst, tx, tw.sin[:t], tw.cos[:t], layer)
        assert sorted(tcap) == sorted(rcap)
        for key in rcap:
            assert str(tcap[key].dtype) == "torch." + str(rcap[key].dtype)
            assert _rel(tcap[key].float(), rcap[key]) < CAP_TOL, key
        assert tout.dtype == torch.float32
        assert _rel(tout, rout) < CAP_TOL
        # the next layer takes the reference's state on both sides
        rx = rout
        tx = torch.from_numpy(np.array(rout))


def test_calibration_forward_skips_rope_on_nope_layers(tmp_path):
    """A reference fault the port does not copy: the reference's
    _layer_forward_capture calls _attn_qkv without the layer, so it rotates
    q and k on a NoPE layer (Cohere2's full-attention layers), where the
    model itself does not. The port's captures of such a layer equal the
    reference's under an identity rope table (sin 0, cos 1), and part from
    the reference's own o_in (measured 8.6e-2 of max |o_in| here); a rope
    layer agrees with the reference as in the test above."""
    d = ref_make_tiny(str(tmp_path / "m"), quant=None, seed=7,
                      arch="Cohere2ForCausalLM", vocab=256, hidden=128,
                      layers=2, heads=4, kv_heads=2, inter=256,
                      extra_config={"sliding_window": 4,
                                    "sliding_window_pattern": 2})
    rw, rst = ref_load(RefConfig.from_dir(d))
    tw, tst = load_model(ModelConfig.from_dir(d), device="cpu")
    assert [ls.rope_enabled for ls in tst.layers] == [True, False]
    rows = np.clip(P.calibration_rows(ByteTokenizer(), 2, 48), 0, 255)
    t = rows.shape[1]
    x = P.embed_rows(tw, tst, rows)
    rx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    _, c0 = P._layer_forward_capture(tw.layers[0], tst, x, tw.sin[:t],
                                     tw.cos[:t], 0)
    _, r0 = RP._layer_forward_capture(rw.layers[0], rst, rx, rw.sin[:t],
                                      rw.cos[:t])
    assert _rel(c0["o_in"].float(), r0["o_in"]) < CAP_TOL
    _, c1 = P._layer_forward_capture(tw.layers[1], tst, x, tw.sin[:t],
                                     tw.cos[:t], 1)
    _, r1 = RP._layer_forward_capture(rw.layers[1], rst, rx, rw.sin[:t],
                                      rw.cos[:t])
    _, r1_nope = RP._layer_forward_capture(
        rw.layers[1], rst, rx, jnp.zeros_like(rw.sin[:t]),
        jnp.ones_like(rw.cos[:t]))
    for key in r1_nope:
        assert _rel(c1[key].float(), r1_nope[key]) < CAP_TOL, key
    assert _rel(c1["o_in"].float(), r1["o_in"]) > 2e-2


def test_replace_lin_leaves_the_original(tmp_path):
    d = ref_make_tiny(str(tmp_path / "m"), quant=None, seed=2,
                      arch="MixtralForCausalLM", vocab=256, hidden=64,
                      layers=1, heads=4, kv_heads=2, inter=128,
                      extra_config=CAPTURE_ARCHS["MixtralForCausalLM"])
    cfg = ModelConfig.from_dir(d)
    w, _ = load_model(cfg, device="cpu")
    lw = w.layers[0]
    subs = P._layer_subs(cfg, lw, 0)
    assert [s.name for s in subs][:4] == [
        f"model.layers.0.self_attn.{p}_proj" for p in "qkvo"]
    assert len(subs) == 4 + 3 * 4
    new = P._dense(torch.zeros_like(lw.attn.q.weight), lw.attn.q)
    lw2 = P._replace_lin(lw, "attn.q", new)
    lw3 = P._replace_lin(lw2, "mlp.w2.3", new)
    assert lw2.attn.q is new and lw.attn.q is not new
    assert lw2.attn.k is lw.attn.k and lw2.mlp is lw.mlp
    assert lw3.mlp.w2[3] is new and lw2.mlp.w2[3] is lw.mlp.w2[3]
    assert lw3.mlp.w2[0] is lw.mlp.w2[0] and lw3.attn is lw2.attn


def test_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.convert_model(str(tmp_path / "none"), str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")
