"""Port vs reference: the W4A8 decode path on the CPU.

The cases of tests/test_w4a8.py, each run through both packages on the same
numpy-seeded inputs. The reference runs its Pallas kernel in interpret mode;
the port runs the kernel's plain version (ops/qmm.qmm_w4a8_plain).

Tolerances:
  * weight preparation (enable_w4a8_linear, _pad_w4a8_rows, merge_linears,
    enable_w4a8): every buffer and flag bit for bit;
  * the W4A8 matmul: the activation quantization and each group's integer
    dot are exact in both packages, so only the f32 sum over groups is taken
    in another order: max |diff| <= 1e-4 * max |ref| (measured 1e-7 .. 2e-7);
  * the flagship chain through model_forward: an ulp of difference upstream
    can flip the int8 rounding of an activation, so the packages are held to
    5e-3 of max |logit| (measured 6e-4), and the port to the reference
    test's envelope around its own exact forward (mean relative deviation
    < 0.05, same greedy tokens).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.cache import KVCache as RefCache
from exllamav2_tpu.models import forward as RF
from exllamav2_tpu.ops import dequant as D
from exllamav2_tpu.ops import qmm as M
from exllamav2_tpu.quant import formats as F
from exllamav2_tpu.quant import qtensor as Q
from exllamav2_tpu.utils.testing import random_model_weights as ref_weights

from exllamav2_tpu_torch.cache import KVCache
from exllamav2_tpu_torch.interop import (
    linear_from_reference, weights_from_reference)
from exllamav2_tpu_torch.models.forward import model_forward
from exllamav2_tpu_torch.ops import dequant as TD
from exllamav2_tpu_torch.ops import qmm as TM

TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(ql):
    return linear_from_reference(_np(ql), "cpu")


def _exl2(rng, k, n, bits_per_group, gs=32, act_order=False):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    if act_order:
        perm = rng.permutation(k)
        t = F.exl2_pack(w[perm], bits_per_group, group_rows=gs,
                        invperm=np.argsort(perm))
    else:
        t = F.exl2_pack(w, bits_per_group, group_rows=gs)
    return Q.from_exl2(t)


def _gptq(rng, k, n, gs):
    g = k // gs
    qv = rng.integers(0, 16, size=(k, n)).astype(np.uint16)
    zeros = rng.integers(4, 12, size=(g, n)).astype(np.uint16)
    scales = rng.random((g, n)).astype(np.float32) * 0.02 + 0.001
    return Q.from_gptq(F.gptq_pack(qv, zeros, scales, bits=4))


def _same_module(got, want):
    """Two module trees of the port hold the same buffers, bit for bit, and
    their segments the same flags."""
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


def _same_linear(tl, ql):
    """The port's linear equals the reference's, carried over by interop."""
    _same_module(tl, _port(ql))


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = got.numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err / np.abs(ref).max()


def _both(x, ql, tl, fused=True):
    """qmm of both packages on the same activations."""
    return (TM.qmm(torch.from_numpy(x), tl, fused=fused),
            M.qmm(jnp.asarray(x), ql, fused=fused))


@pytest.mark.parametrize("m", [1, 4, 17])
@pytest.mark.parametrize("bits", [2, 4, 5])
def test_w4a8_matches_reference(m, bits):
    rng = np.random.default_rng(bits * 100 + m)
    k, n = 256, 128
    ql = _exl2(rng, k, n, [bits] * (k // 32))
    q8, t8 = D.enable_w4a8_linear(ql), TD.enable_w4a8_linear(_port(ql))
    assert all(s.act8 and s.scale_f is not None for s in t8.segments)
    _same_linear(t8, q8)
    x = rng.standard_normal((m, k)).astype(np.float32) * 0.1
    _close(*_both(x, q8, t8))


def test_w4a8_mixed_segments_with_8bit():
    """8-bit values sit in [0, 255]: shifted by 128 into int8 range, the
    shift cancelled in the zero term."""
    rng = np.random.default_rng(7)
    ql = _exl2(rng, 256, 128, [8, 8, 4, 4, 3, 3, 2, 2])
    q8, t8 = D.enable_w4a8_linear(ql), TD.enable_w4a8_linear(_port(ql))
    _same_linear(t8, q8)
    x = rng.standard_normal((3, 256)).astype(np.float32) * 0.1
    _close(*_both(x, q8, t8))


def test_w4a8_act_order():
    rng = np.random.default_rng(3)
    ql = _exl2(rng, 256, 128, [4] * 8, act_order=True)
    q8, t8 = D.enable_w4a8_linear(ql), TD.enable_w4a8_linear(_port(ql))
    assert t8.perm is not None
    x = rng.standard_normal((2, 256)).astype(np.float32) * 0.1
    _close(*_both(x, q8, t8))


@pytest.mark.parametrize("compressed", [True, False])
def test_w4a8_gptq_meta_forms(compressed):
    """GPTQ with the compressed bf16 meta (scale_bf + zs_bf, subtracting
    after the scale multiply) and with the plain f32 / int32 meta."""
    rng = np.random.default_rng(4)
    ql = _gptq(rng, 256, 128, 64)
    if compressed:
        q8, t8 = D.enable_w4a8_linear(ql), TD.enable_w4a8_linear(_port(ql))
        assert t8.segments[0].zs_bf is not None
        assert t8.segments[0].zs_bf.dtype == torch.bfloat16
    else:
        import dataclasses
        q8 = dataclasses.replace(ql, segments=tuple(
            dataclasses.replace(s, act8=True) for s in ql.segments))
        t8 = _port(q8)
        assert t8.segments[0].act8 and t8.segments[0].zs_bf is None
    _same_linear(t8, q8)
    x = rng.standard_normal((2, 256)).astype(np.float32) * 0.1
    _close(*_both(x, q8, t8))


def test_w4a8_close_to_exact():
    """The port's own deviation from its exact path stays inside the int8
    quantization envelope of the reference test."""
    rng = np.random.default_rng(5)
    tl = _port(_exl2(rng, 512, 256, [4] * 16))
    x = torch.from_numpy(
        rng.standard_normal((4, 512)).astype(np.float32) * 0.1)
    exact = TM.qmm(x, TD.precompute_scales_linear(tl), fused=True)
    got = TM.qmm(x, TD.enable_w4a8_linear(tl), fused=True)
    rel = (got - exact).abs().mean() / (exact.abs().mean() + 1e-6)
    assert 0 < rel < 0.02, rel


def test_w4a8_prefill_path_stays_exact():
    """The unfused (prefill) path ignores act8."""
    rng = np.random.default_rng(6)
    ql = _exl2(rng, 256, 128, [4] * 8)
    q8, t8 = D.enable_w4a8_linear(ql), TD.enable_w4a8_linear(_port(ql))
    x = rng.standard_normal((64, 256)).astype(np.float32) * 0.1
    got, ref = _both(x, q8, t8, fused=False)
    _close(got, ref)
    exact = TM.qmm(torch.from_numpy(x), TD.precompute_scales_linear(
        _port(ql)), fused=False)
    assert torch.equal(got, exact)


def test_w4a8_merge_roundtrip():
    """merge_linears on act8 sources prescales the merged segment again, and
    the merged W4A8 matmul gives the per-source results."""
    rng = np.random.default_rng(8)
    qa, qb = (_exl2(rng, 256, 128, [4] * 8) for _ in range(2))
    ta, tb = (TD.enable_w4a8_linear(_port(q)) for q in (qa, qb))
    qa, qb = D.enable_w4a8_linear(qa), D.enable_w4a8_linear(qb)
    qm, tm = D.merge_linears([qa, qb]), TD.merge_linears([ta, tb])
    assert all(s.act8 and s.scale_f is not None for s in tm.segments)
    _same_linear(tm, qm)
    x = rng.standard_normal((2, 256)).astype(np.float32) * 0.1
    got, ref = _both(x, qm, tm)
    _close(got, ref)
    xt = torch.from_numpy(x)
    # columns are independent: each source's columns come out bit for bit
    assert torch.equal(got[:, :128], TM.qmm(xt, ta, fused=True))
    assert torch.equal(got[:, 128:], TM.qmm(xt, tb, fused=True))


def test_enable_w4a8_model_tree():
    """enable_w4a8 flags every layer linear, keeps the head exact, builds
    the reference's buffers and leaves its input alone."""
    w, st = ref_weights(max_seq=64, bits=4, seed=0, vocab=256, hidden=256,
                        layers=2, heads=4, kv_heads=4, inter=512)
    tw, _ = weights_from_reference(_np(w), st, device="cpu")
    t8 = TD.enable_w4a8(tw)
    q = t8.layers[0].attn.q
    assert all(s.act8 and s.scale_f is not None for s in q.segments)
    assert not any(s.act8 for s in t8.head.segments)
    assert all(s.scale_f is not None for s in t8.head.segments)
    want, _ = weights_from_reference(_np(D.enable_w4a8(w)), st, device="cpu")
    _same_module(t8, want)
    # the source tree is untouched
    assert not any(s.act8 or s.scale_f is not None
                   for s in tw.layers[0].attn.q.segments)
    assert t8.embed is tw.embed and t8.layers[0].attn.norm.weight is \
        tw.layers[0].attn.norm.weight


def test_w4a8_row_padding_exact():
    """_pad_w4a8_rows zero-pads 8960 rows to 9216 (a multiple of
    lcm(256, 8 * 128) = 1024); the padded matmul equals the unpadded one,
    and a small K is left alone."""
    rng = np.random.default_rng(9)
    k, n, gs = 8960, 128, 128
    base = _gptq(rng, k, n, gs)
    tbase = _port(base)
    q8, t8 = D.enable_w4a8_linear(base), TD.enable_w4a8_linear(tbase)
    seg = t8.segments[0]
    assert seg.rows_pad == 9216 and seg.rows == k
    assert tbase.segments[0].rows_pad == 8960          # input left alone
    _same_linear(t8, q8)
    groups = tbase.segments[0].scale.shape[0]
    unpadded = type(t8)(
        [seg.replace(tbase.segments[0].planes, scale=tbase.segments[0].scale,
                     zero=tbase.segments[0].zero,
                     scale_bf=seg.scale_bf[:groups],
                     zs_bf=seg.zs_bf[:groups])],
        None, None, k, t8.n, t8.n_orig)
    x = rng.standard_normal((2, k)).astype(np.float32) * 0.1
    got, ref = _both(x, q8, t8)
    _close(got, ref)
    _close(TM.qmm(torch.from_numpy(x), unpadded, fused=True), got.numpy(),
           tol=1e-5)
    small = _port(_exl2(rng, 256, 128, [4] * 2, gs=128))
    assert TD.enable_w4a8_linear(small).segments[0].rows_pad == 256


def test_w4a8_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(10)
    tl = _port(_exl2(rng, 256, 128, [4] * 8))
    seg = tl.segments[0].replace(act8=True)            # no scale_f
    x = torch.zeros((1, 256))
    with pytest.raises(ValueError, match="scale_f"):
        TM.w4a8_segment_matmul(x, seg)
    big = _port(_gptq(rng, 1024, 128, 1024)).segments[0].replace(act8=True)
    with pytest.raises(NotImplementedError, match="group size"):
        TM.w4a8_segment_matmul(torch.zeros((1, 1024)), big)


def test_w4a8_cpu_wrapper_is_plain():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch."""
    rng = np.random.default_rng(11)
    seg = TD.enable_w4a8_linear(_port(_gptq(rng, 256, 128, 128))).segments[0]
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    before = dict(TM.LAUNCHES)
    got = TM.fused_segment_matmul(x, seg)
    assert TM.LAUNCHES == before
    assert torch.equal(got, TM.qmm_w4a8_plain(x, seg))


def test_w4a8_flagship_chain_gptq_merged():
    """GPTQ gs128 -> merge_serving_weights -> precompute_model_scales ->
    enable_w4a8, then four decode steps through model_forward."""
    w, st = ref_weights(max_seq=64, bits=4, seed=3, fmt="gptq", vocab=512,
                        hidden=256, layers=2, heads=4, kv_heads=4, inter=512)
    tw, tst = weights_from_reference(_np(w), st, device="cpu")
    wf = D.enable_w4a8(D.precompute_model_scales(D.merge_serving_weights(w)))
    tf = TD.enable_w4a8(TD.precompute_model_scales(
        TD.merge_serving_weights(tw)))
    assert all(s.act8 for s in tf.layers[0].attn.qkv.segments)
    _same_module(tf, weights_from_reference(_np(wf), st, device="cpu")[0])

    step = jax.jit(RF.model_forward, static_argnums=(1, 5, 6))

    def run_ref(wv, toks):
        cache = RefCache.alloc(st.num_layers, 1, 64, st.num_kv_heads,
                               st.head_dim)
        outs = []
        for i, t in enumerate(toks):
            lg, cache = step(wv, st, jnp.full((1, 1), t, jnp.int32), cache,
                             jnp.int32(8 + i), False, 64)
            outs.append(np.asarray(lg[0, -1]))
        return np.stack(outs)

    def run_port(wv, toks=None):
        cache = KVCache.alloc(st.num_layers, 1, 64, st.num_kv_heads,
                              st.head_dim, device="cpu")
        tok, outs, fed = 1, [], []
        for i in range(4):
            tok = tok if toks is None else toks[i]
            fed.append(int(tok))
            lg, cache = model_forward(wv, tst, torch.full(
                (1, 1), tok, dtype=torch.int32), cache, 8 + i, attn_limit=64)
            outs.append(lg[0, -1].numpy())
            tok = int(lg[0, -1].argmax())
        return np.stack(outs), fed

    got, fed = run_port(tf)
    exact, fed_exact = run_port(TD.precompute_model_scales(tw))
    rel = np.abs(got - exact).mean() / (np.abs(exact).mean() + 1e-6)
    assert rel < 0.05, rel
    assert fed == fed_exact                       # same greedy tokens
    ref = run_ref(wf, fed)                        # teacher-forced
    assert np.abs(got - ref).max() <= 5e-3 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# The B fragment of the kernel's int8 mma template (csrc/qmm_w4a8.cu), on
# the CPU: lane l = 4g + t of an mma.m16n8k32 holds column g and k values
# 16hf + 4t + i (register hf, byte i). k-step ks covers natural rows
# 32ks..32ks+31 of a 256-row sub-block; the lane's four values of a register
# sit in words (32ks + 16hf + 4t) % Q + i, Q = 8 * plane bits, at one slot,
# gathered as one byte of each word, then one shift and one mask.
# ---------------------------------------------------------------------------

from exllamav2_tpu_torch.quant.qtensor import pack_planes, plane_split


def _fragment_source(bp, ks, hf, t, i):
    """(word, bit offset) of the plane of width bp holding the value that
    lane (g, t) puts in byte i of B register hf at k-step ks."""
    q = 8 * bp
    base = 32 * ks + 16 * hf + 4 * t
    return base % q + i, (base // q) * bp


def _gather(words, bp, ks, hf, t, col):
    """The kernel's prmt gather on column `col`: byte `bit // 8` of the four
    words, shifted by `bit % 8`, masked to bp bits, as four values."""
    vals = []
    for i in range(4):
        w, bit = _fragment_source(bp, ks, hf, t, i)
        byte = (int(words[w, col]) >> (8 * (bit // 8))) & 0xFF
        vals.append((byte >> (bit % 8)) & ((1 << bp) - 1))
    return vals


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
def test_mma_fragment_map_covers_each_row_once(bits):
    """Every (lane, register, byte) of the 8 k-steps of a sub-block names a
    (word, slot) that holds natural row 32ks + k: each of the 256 rows comes
    out once per column, in k order, for every plane of the value."""
    rng = np.random.default_rng(bits)
    values = rng.integers(0, 2 ** bits, size=(256, 8), dtype=np.uint32)
    planes = pack_planes(values, bits)
    seen = np.zeros(256, np.int64)
    for ks in range(8):
        for t in range(4):
            for hf in range(2):
                for g in range(8):
                    got = [0] * 4
                    shift = 0
                    for bp, words in zip(plane_split(bits), planes):
                        got = [v | (p << shift) for v, p in zip(
                            got, _gather(words, bp, ks, hf, t, g))]
                        shift += bp
                    rows = [32 * ks + 16 * hf + 4 * t + i for i in range(4)]
                    assert got == [int(values[r, g]) for r in rows]
                    if g == 0:
                        seen[rows] += 1
                for bp in plane_split(bits):
                    # one slot for the four words, no wrap past the sub-block
                    srcs = [_fragment_source(bp, ks, hf, t, i)
                            for i in range(4)]
                    assert len({b for _, b in srcs}) == 1
                    assert [w for w, _ in srcs] == list(
                        range(srcs[0][0], srcs[0][0] + 4))
                    assert srcs[3][0] < 8 * bp and srcs[0][1] < 32
    assert (seen == 1).all()


@pytest.mark.parametrize("gs", [16, 32, 64, 128, 256, 512])
def test_mma_k_step_stays_inside_a_group(gs):
    """A k-step's 32 rows lie in one group for every group size the mma
    template takes; 16-row groups go to the dp4a template."""
    for sb in range(4):
        for ks in range(8):
            first = sb * 256 + 32 * ks
            inside = first // gs == (first + 31) // gs
            assert inside == (gs % 32 == 0)
    want = "mma" if gs % 32 == 0 else "dp4a"
    assert TM.w4a8_template(16, gs, 4096) == want
    assert TM.w4a8_template(32, gs, 4096) == want
    assert TM.w4a8_template(4, gs, 4096) == "dp4a"
    assert TM.w4a8_template(16, gs, 4100) == "dp4a"      # n % 8 != 0


@pytest.mark.parametrize("bp", [1, 2, 4, 8])
def test_mma_plane_tile_loads_have_no_bank_conflict(bp):
    """The swizzled plane tile ([Q words][128 columns], word w, column c at
    w * 128 + (c ^ 8 * ((w >> 2) & 3))): each 16-byte load of a lane's four
    n-tiles (words of _fragment_source, columns 4g..4g+3 of the warp's 32)
    keeps the eight lanes of a quarter warp on distinct banks, or on one
    address (a broadcast)."""
    def swz(w, c):
        return w * 128 + (c ^ (((w >> 2) & 3) << 3))

    for warp in range(4):
        for ks in range(8):
            for hf in range(2):
                for i in range(4):
                    for quarter in range(4):
                        addrs = set()
                        for lane in range(8 * quarter, 8 * quarter + 8):
                            g, t = lane >> 2, lane & 3
                            w, _ = _fragment_source(bp, ks, hf, t, i)
                            addrs.add(swz(w, warp * 32 + 4 * g))
                        banks = [(a + e) % 32 for a in addrs for e in range(4)]
                        assert all(a % 4 == 0 for a in addrs)
                        assert len(banks) == len(set(banks))
