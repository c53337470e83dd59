"""The tile order of the mma templates of kernels 2 and 3, emulated (CPU).

csrc/decode_attn.cu and csrc/paged_attn.cu hold a KV head's G query heads
as the rows of bf16 tensor-core tiles (mma.sync.m16n8k16): ceil(G / 16)
m16 tiles with zero pad rows, k16 steps over D, n8 tiles of cache rows.
The card is not here, so the order of that arithmetic is written out in
torch below and held to the plain versions and to the reference's Pallas
kernels in interpret mode:

* kernel 2 (decode over the linear cache): TR = 32-row tiles, each warp
  scoring its 8 rows (one n8 tile), the tile's row max over the four warps,
  p = exp(s - m) split into hi = bf16(p) and lo = bf16(p - hi) for P.V,
  per-warp row sums added in warp order, splits merged in split order.
  Each rounding keeps 8 significant bits, so |p - hi - lo| <= 2^-16 p
  (2^-18 p on average): the output moves by at most 2^-16 = 1.5e-5 of
  max |v| from the hi / lo residue, so the emulation is held to the plain
  version and to the reference at 2e-5 of max |v| (the residue and f32
  sums in another order).
* kernel 3 (paged): scores by k16 steps, each split's maxima T (all rows)
  and F (its first page) exchanged over the cluster into the reference's
  running page maximum M_j, p rounded to bf16 against M_j, P.V a 16-row
  group at a time with the accumulator rescaled where M_j changes
  (exp(M_j - M_j') <= 1) and by exp(M_jl - M_last) at the end, the live
  splits summed in rank order. Evaluated in f64 it matches the plain
  version's f64 evaluation of the same rounding points within 1e-9 of
  max |v| (only f64 summation order differs, so no p can round the other
  way); in f32 it matches the reference within 1e-5 of max |ref| but in
  the query-head rows where an f32 p lies within summation noise of a bf16
  rounding boundary (test_paged_tiles_match_reference says how far).
"""

import ml_dtypes
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from exllamav2_tpu.ops.decode_attn import decode_attention as ref_decode
from exllamav2_tpu.ops import paged_attn as RP

from exllamav2_tpu_torch.cache_paged import PagedKVCache, _kinds, _raw
from exllamav2_tpu_torch.ops import decode_attn as TA
from exllamav2_tpu_torch.ops import paged_attn as TP
from exllamav2_tpu_torch.ops.kvquant import kv_quant

SMS = 132                       # SMs of an H100 SXM
TR = 32                         # kernel 2's rows a tile
WARPS = 4
GS = [2, 4, 7, 8, 16, 17, 22, 48]
DS = [64, 128, 256]


def _bf16(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to bf16 (through f32, as the kernels round their f32
    values), held in `dtype`."""
    return x.float().to(torch.bfloat16).to(dtype)


def _kdot(qt: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """Q.K^T as the mma tiles take it: a sum over the k16 steps of D in
    order, each step one product of a 16-wide slice."""
    s = torch.zeros((qt.shape[0], kt.shape[0]), dtype=qt.dtype)
    for k0 in range(0, qt.shape[1], 16):
        s = s + qt[:, k0:k0 + 16] @ kt[:, k0:k0 + 16].T
    return s


def _qtile(q_rows: torch.Tensor, mt: int, dtype) -> torch.Tensor:
    """The block's query rows as MT m16 tiles, rows past G zero."""
    g, d = q_rows.shape
    t = torch.zeros((16 * mt, d), dtype=dtype)
    t[:g] = q_rows.to(dtype)
    return t


# ------------------------------------------------------------- the planner

@pytest.mark.parametrize("g,d", [(g, d) for g in GS + [1, 64, 65, 71, 128]
                                 for d in DS + [32]])
def test_tile_plan_covers_every_query_head_once(g, d):
    """Each (batch, KV head, head block) of the grid, as the kernels index
    it, attends for heads c * heads .. of its KV head: every query head
    exactly once, under its own KV head, and the q / out elements the
    blocks address at head_dim d (head0 * d onwards) cover [B, Hq, d] once;
    the mma template's blocks hold at most 16 * MAX_MT heads in
    ceil(heads / 16) m-tiles, the CUDA-core template's one block all G."""
    heads, blocks, mt = TA.tile_plan(g)
    if g < TA.MMA_MIN_G:
        assert (heads, blocks, mt) == (g, 1, 0)
    else:
        assert 1 <= mt <= TA.MAX_MT and 16 * (mt - 1) < heads <= 16 * mt
        assert blocks == -(-g // (16 * TA.MAX_MT))
    assert (blocks - 1) * heads < g <= blocks * heads
    b, hkv = 2, 3
    hq = hkv * g
    seen, elems = [], []
    for bh in range(b * hkv * blocks):
        bb, h, c = bh // (hkv * blocks), bh // blocks % hkv, bh % blocks
        n = min(heads, g - c * heads)
        head0 = bb * hq + h * g + c * heads
        seen += [(head0 + i, h) for i in range(n)]
        elems += range(head0 * d, (head0 + n) * d)
    assert sorted(i for i, _ in seen) == list(range(b * hq))
    assert all(i % hq // g == h for i, h in seen)
    assert sorted(elems) == list(range(b * hq * d))


def test_tile_plan_template_switches():
    """Kernel 2 takes the mma template from MMA_MIN_G query heads a KV head,
    kernel 3 from its own (measured) MMA_MIN_G; one head a KV head stays on
    the CUDA-core template in both."""
    assert TA.tile_plan(1)[2] == 0
    assert TA.tile_plan(TA.MMA_MIN_G)[2] == 1
    assert TA.tile_plan(TP.MMA_MIN_G - 1, TP.MMA_MIN_G) == (4, 1, 0)
    assert TA.tile_plan(TP.MMA_MIN_G, TP.MMA_MIN_G)[2] == 1
    assert TA.tile_plan(48) == (48, 1, 3)
    assert TA.tile_plan(71) == (36, 2, 3)


def test_hi_lo_split_error_bound():
    """Kernel 2 enters P.V with p as hi = bf16(p) and lo = bf16(p - hi):
    each rounding keeps 8 significant bits (relative error <= 2^-8, and
    p - hi is exact in f32), so |p - hi - lo| <= 2^-16 p, 2^-18 p on
    average; hi alone is off by up to 2^-8 p."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.exp(-rng.exponential(4.0, 1 << 20))
                         .astype(np.float32))
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    rel = (p - hi - lo).abs() / p
    assert rel.max().item() <= 2.0 ** -16
    assert rel.mean().item() <= 2.0 ** -18
    assert ((p - hi).abs() / p).max().item() > 2.0 ** -10   # lo is needed


# --------------------------------------------------------------- kernel 2

def emulate_decode(q, k, v, layer, past_len, limit, scale, softcap=0.0,
                   window=0, dtype=torch.float32):
    """csrc/decode_attn.cu's mma template in torch: the grid of
    ops/decode_attn.py (tile_plan, split_count with mma_split_rows), TR-row
    tiles, each warp's n8 tile of scores, the tile max over the warps,
    hi / lo P.V, per-warp row sums, the split merge in split order."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    heads, blocks, mt, splits, per = TA.grid(b, hkv, g, limit, SMS)
    assert mt, "the mma template"
    hi_pos = min(limit, past_len + 1)
    lo_pos = max(0, past_len - window + 1) if window > 0 else 0
    out = torch.zeros((b, hq, d), dtype=dtype)
    for bb in range(b):
        for h in range(hkv):
            kk = k[layer, bb, h].to(dtype)
            vv = v[layer, bb, h].to(dtype)
            for c in range(blocks):
                n = min(heads, g - c * heads)
                h0 = h * g + c * heads
                qt = _qtile(q[bb, h0:h0 + n], mt, dtype)
                parts = []
                for s in range(splits):
                    r_lo, r_hi = max(lo_pos, s * per), min(hi_pos,
                                                           (s + 1) * per)
                    if r_lo >= r_hi:
                        parts.append(None)
                        continue
                    m = torch.full((16 * mt,), -torch.inf, dtype=dtype)
                    lw = torch.zeros((WARPS, 16 * mt), dtype=dtype)
                    o = torch.zeros((16 * mt, d), dtype=dtype)
                    for t0 in range(r_lo, r_hi, TR):
                        live = min(TR, r_hi - t0)
                        kt = torch.zeros((TR, d), dtype=dtype)
                        vt = torch.zeros((TR, d), dtype=dtype)
                        kt[:live], vt[:live] = kk[t0:t0 + live], \
                            vv[t0:t0 + live]
                        sc = torch.cat([_kdot(qt, kt[8 * w:8 * w + 8])
                                        for w in range(WARPS)], 1) * scale
                        if softcap > 0.0:
                            sc = torch.tanh(sc * (1.0 / softcap)) * softcap
                        sc[:, live:] = -torch.inf
                        m_new = torch.maximum(m, sc.amax(1))
                        al = torch.exp(m - m_new)
                        p = torch.exp(sc - m_new[:, None])
                        lw = lw * al + p.reshape(16 * mt, WARPS, 8).sum(
                            2).T
                        hi = _bf16(p, dtype)
                        lo = _bf16(p - hi, dtype)
                        o = o * al[:, None]
                        for k0 in range(0, TR, 16):
                            o = o + hi[:, k0:k0 + 16] @ vt[k0:k0 + 16]
                            o = o + lo[:, k0:k0 + 16] @ vt[k0:k0 + 16]
                        m = m_new
                    l = lw[0]
                    for w in range(1, WARPS):
                        l = l + lw[w]
                    parts.append((m[:n], l[:n], o[:n]))
                if splits == 1:
                    mm, l, o = parts[0]
                    out[bb, h0:h0 + n] = o / l[:, None]
                    continue
                big = torch.stack([p[0] for p in parts if p]).amax(0)
                acc = torch.zeros((n, d), dtype=dtype)
                big_l = torch.zeros((n,), dtype=dtype)
                for p in parts:
                    if p is None:
                        continue
                    e = torch.exp(p[0] - big)
                    big_l = big_l + p[1] * e
                    acc = acc + p[2] * e[:, None]
                out[bb, h0:h0 + n] = acc / big_l[:, None]
    return out


def _decode_inputs(seed, b, hq, hkv, d, s_max=1024):
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)

    q, k, v = bf16((b, hq, d)), bf16((2, b, hkv, s_max, d)), \
        bf16((2, b, hkv, s_max, d))

    def t(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)

    return (q, k, v), (t(q), t(k), t(v))


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("g", GS)
def test_decode_tiles_match_plain_and_reference(g, d):
    """Batch 2 over 2 KV heads at past 700 of a 1024-row bucket (several
    splits, a last tile past the attended end): the emulation against the
    plain version and the reference at 2e-5 of max |v|."""
    hkv, b, past, limit = 2, 2, 700, 1024
    (qn, kn, vn), (q, k, v) = _decode_inputs(g * 7 + d, b, hkv * g, hkv, d)
    scale = d ** -0.5
    assert TA.grid(b, hkv, g, limit, SMS)[3] > 1
    got = emulate_decode(q, k, v, 1, past, limit, scale)
    plain = TA.decode_attention_plain(q, k, v, 1, past, limit, scale)
    ref = np.asarray(ref_decode(jnp.asarray(qn), jnp.asarray(kn),
                                jnp.asarray(vn), 1, jnp.int32(past), limit,
                                scale))
    vmax = v[1].float().abs().max().item()
    assert (got - plain).abs().max().item() <= 2e-5 * vmax
    assert np.abs(got.numpy() - ref).max() <= 2e-5 * vmax


@pytest.mark.parametrize("g,d,past,cap,win", [
    (4, 128, 300, 20.0, 0), (7, 64, 900, 0.0, 100), (22, 256, 511, 15.0, 64),
    (48, 128, 0, 0.0, 0), (17, 128, 40, 0.0, 0), (8, 256, 1000, 0.0, 333)])
def test_decode_tiles_softcap_window_edges(g, d, past, cap, win):
    """Softcap, a window whose first row lies inside a split and a tile,
    past_len 0 (every split but the first empty), a split of one partial
    tile: the emulation against the plain version and the reference."""
    hkv, b, limit = 2, 1, 1024
    (qn, kn, vn), (q, k, v) = _decode_inputs(past + g, b, hkv * g, hkv, d)
    got = emulate_decode(q, k, v, 0, past, limit, 0.1, cap, win)
    plain = TA.decode_attention_plain(q, k, v, 0, past, limit, 0.1, cap,
                                      win)
    ref = np.asarray(ref_decode(jnp.asarray(qn), jnp.asarray(kn),
                                jnp.asarray(vn), 0, jnp.int32(past), limit,
                                0.1, cap, win))
    vmax = v[0].float().abs().max().item()
    assert (got - plain).abs().max().item() <= 2e-5 * vmax
    assert np.abs(got.numpy() - ref).max() <= 2e-5 * vmax


# --------------------------------------------------------------- kernel 3

NEG = -1e30


def emulate_paged(q, cache, layer, bt, vl, scale, hq, softcap=0.0,
                  window=0, dtype=torch.float64):
    """csrc/paged_attn.cu's mma template in torch: the grid of
    ops/paged_attn.py (tile_plan, split_count for the mma template), each
    split's scores by k16 steps, T and F exchanged over the cluster into
    M_j, bf16(p) against M_j, P.V by 16-row groups with the accumulator
    rescaled where M_j changes, the live splits summed in rank order."""
    b, _, d = q.shape
    hkv = cache.k_data.shape[1]
    g = hq // hkv
    ps = cache.page_size
    pw = bt.shape[1]
    kk, vk = _kinds(cache.kind)
    heads, blocks, mt = TA.tile_plan(g, 2)
    splits, per = TP.split_count(b, hkv * blocks, pw, ps, SMS, heads, True)

    def rows(data, scales, kind, h):
        raw = _raw(data)[layer, h].view(data.dtype)
        s = None if scales is None else scales[layer, h]
        return _bf16(TP._dq_page(raw, s, kind), dtype)      # [rows, D]

    out = torch.zeros((b, hq, d), dtype=dtype)
    for bb in range(b):
        n = int(vl[bb])
        lo_abs = max(n - window, 0) if window > 0 else 0
        n_end = min(n, pw * ps)
        r_lo = lo_abs // per
        r_hi = (n_end - 1) // per + 1 if lo_abs < n_end else r_lo
        for h in range(hkv):
            kr = rows(cache.k_data, cache.k_scales, kk, h)
            vr = rows(cache.v_data, cache.v_scales, vk, h)
            for c in range(blocks):
                ng = min(heads, g - c * heads)
                h0 = h * g + c * heads
                qt = _qtile(q[bb, h0:h0 + ng], mt, dtype)
                st = {}
                for r in range(r_lo, r_hi):         # pass 0: live splits
                    s0, s1 = r * per, min(r * per + per, pw * ps)
                    a0, a1 = max(s0, lo_abs), min(s1, n)
                    a0a, a1a = a0 & ~15, (a1 + 15) & ~15
                    pos = torch.arange(a0a, a1a)
                    phys = bt[bb, pos // ps].long() * ps + pos % ps
                    sc = _kdot(qt, kr[phys]) * scale
                    if softcap > 0.0:
                        sc = torch.tanh(sc * (1.0 / softcap)) * softcap
                    live = (pos >= a0) & (pos < a1)
                    sc = torch.where(live, sc, torch.full_like(sc, NEG))
                    first = pos // ps == s0 // ps
                    st[r] = dict(pos=pos, phys=phys, sc=sc, live=live,
                                 t=sc.amax(1), f=sc[:, first].amax(1),
                                 jl=(s1 - 1) // ps)
                if not st:
                    continue                        # zero output
                ml = torch.stack([x["t"] for x in st.values()]).amax(0)
                acc_all = torch.zeros((16 * mt, d), dtype=dtype)
                l_all = torch.zeros((16 * mt,), dtype=dtype)
                for r, x in st.items():             # pass 1, rank order
                    e = torch.full((16 * mt,), NEG, dtype=dtype)
                    xf = torch.full((16 * mt,), NEG, dtype=dtype)
                    for r2, y in st.items():
                        if r2 < r:
                            e = torch.maximum(e, y["t"])
                        if r2 > r and r2 * per // ps == x["jl"]:
                            xf = torch.maximum(xf, y["f"])
                    pos, sc = x["pos"], x["sc"]
                    run = torch.full((16 * mt,), NEG, dtype=dtype)
                    acc = torch.zeros((16 * mt, d), dtype=dtype)
                    mcur = torch.full((16 * mt,), NEG, dtype=dtype)
                    l = torch.zeros((16 * mt,), dtype=dtype)
                    pages = pos // ps
                    for page in torch.unique(pages).tolist():
                        sel = pages == page
                        run = torch.maximum(run, sc[:, sel].amax(1))
                        mj = torch.maximum(e, run)
                        if page == x["jl"]:
                            mj = torch.maximum(mj, xf)
                        fac = torch.exp(mj - ml)
                        p = torch.where(x["live"][sel],
                                        torch.exp(sc[:, sel] - mj[:, None]),
                                        torch.zeros_like(sc[:, sel]))
                        l = l + (p * fac[:, None]).sum(1)
                        pb = _bf16(p, dtype)
                        vp = vr[x["phys"][sel]] * x["live"][sel][:, None]
                        acc = acc * torch.exp(mcur - mj)[:, None]
                        mcur = mj
                        for k0 in range(0, int(sel.sum()), 16):
                            acc = acc + pb[:, k0:k0 + 16] @ vp[k0:k0 + 16]
                    acc_all = acc_all + acc * torch.exp(mcur - ml)[:, None]
                    l_all = l_all + l
                l_all = torch.where(l_all == 0, torch.ones_like(l_all),
                                    l_all)
                out[bb, h0:h0 + ng] = (acc_all / l_all[:, None])[:ng]
    return out.reshape(b, 1, hq, d)


def _pool(kind, hkv, d, npages, page, seed):
    """A port pool of `npages` pages whose every row holds random K/V
    stored by the cache's own codec, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    cache = PagedKVCache.alloc(2, npages, hkv, d, kind, page_size=page,
                               device="cpu")
    for data, scales, k in ((cache.k_data, cache.k_scales, _kinds(kind)[0]),
                            (cache.v_data, cache.v_scales, _kinds(kind)[1])):
        x = torch.randn((2, hkv, data.shape[2], d), generator=gen)
        qd, qs = kv_quant(x, k)
        _raw(data)[:] = _raw(qd)
        if scales is not None:
            scales[:] = qs
    return cache


@pytest.mark.parametrize("d", DS)
def test_paged_q4_fragments_from_nibbles(d):
    """Kernel 3's q4 K scoring takes its B fragments straight from the
    staged nibbles (score_tiles_q4): lane (gq, tq) of an n8 tile reads row
    gq, the 16-bit words at bytes kb + 2 tq and kb + 8 + 2 tq of each
    16-byte step kb; their low nibbles are the fragment of k step kb, their
    high nibbles that of k step D / 2 + kb, each (nibble - 8) * s rounded to
    bf16 with the scale of its 32-element group. Rebuilt in numpy from a
    pool's bytes, every fragment equals the bf16 row the CUDA-core
    template's dequant gives at the fragment's k indices (2 tq, 2 tq + 1,
    2 tq + 8, 2 tq + 9 of the step), bit for bit."""
    cache = _pool("q4", 1, d, 1, 16, seed=d)
    raw = _raw(cache.k_data)[0, 0].numpy()[:8]             # [8, D / 2] u8
    scl = cache.k_scales[0, 0, :8].float().numpy()         # [8, D / 32]
    want = _bf16(TP._dq_page(_raw(cache.k_data)[0, 0][:8],
                             cache.k_scales[0, 0, :8], "q4"), torch.float32)
    h = d // 2
    for lane in range(32):
        gq, tq = lane >> 2, lane & 3
        for kb in range(0, h, 16):
            lo = raw[gq, kb + 2 * tq:kb + 2 * tq + 2].astype(np.uint32)
            hi = raw[gq, kb + 8 + 2 * tq:kb + 10 + 2 * tq].astype(np.uint32)
            w = lo[0] | lo[1] << 8 | hi[0] << 16 | hi[1] << 24
            for hf in range(2):
                k0 = kb + hf * h
                x = w >> 4 if hf else w
                s = np.float32(scl[gq, k0 >> 5])
                vals = [np.float32(int((x >> sh) & 15) - 8) * s
                        for sh in (0, 8, 16, 24)]
                got = _bf16(torch.tensor(vals), torch.float32)
                ks = [k0 + 2 * tq, k0 + 2 * tq + 1, k0 + 8 + 2 * tq,
                      k0 + 9 + 2 * tq]
                assert torch.equal(got, want[gq, ks]), (lane, kb, hf)


def _paged_case(kind, g, d, page, pw, lens, seed):
    hkv, b = 2, len(lens)
    cache = _pool(kind, hkv, d, b * pw + 1, page, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    bt = (torch.randperm(b * pw, generator=gen).to(torch.int32) + 1
          ).reshape(b, pw)
    bt[-1] = 0                                  # a pad row on the null page
    q = torch.randn((b, hkv * g, d), generator=gen).to(torch.bfloat16)
    vl = torch.tensor(lens, dtype=torch.int32)
    scale = d ** -0.5 / (32 if _kinds(kind)[0] in ("q4", "q8") else 1)
    return cache, bt, vl, q, scale


def _vmax(cache):
    vd = _raw(cache.v_data)[1].view(cache.v_data.dtype)
    vs = None if cache.v_scales is None else cache.v_scales[1]
    return TP._dq_page(vd, vs, _kinds(cache.kind)[1]).abs().max().item()


def _plain64(cache, layer, bt, vl, q, scale, hq, cap=0.0, win=0):
    return TP.paged_decode_attention_plain(
        q, cache.k_data, cache.v_data, layer, bt, vl, cache.k_scales,
        cache.v_scales, scale, cache.page_size, hq, _kinds(cache.kind), cap,
        win, dtype=torch.float64)


@pytest.mark.parametrize("kind", ["bf16", "fp8", "q8", "q4", "q6"])
@pytest.mark.parametrize("g", GS)
def test_paged_tiles_every_kind_match_plain(kind, g):
    """D = 128, 8 pages of 64 rows (a cluster of splits inside pages),
    lengths ending at a page edge, inside a page and at 1, a pad row: the
    f64 emulation against the plain version's f64 evaluation at 1e-9 of
    max |v|."""
    cache, bt, vl, q, scale = _paged_case(kind, g, 128, 64, 8,
                                          [512 - 7, 128, 1], g)
    got = emulate_paged(q, cache, 1, bt, vl, scale, 2 * g)
    want = _plain64(cache, 1, bt, vl, q, scale, 2 * g)
    assert (got.float() - want).abs().max().item() <= 1e-9 * _vmax(cache)


@pytest.mark.parametrize("kind", ["bf16", "q4"])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("g", GS)
def test_paged_tiles_head_dims_match_plain(kind, g, d):
    """D = 64 and 256 over 24 pages of 16 rows: splits of 32 rows straddle
    every page edge. f64 emulation against the plain f64 evaluation."""
    cache, bt, vl, q, scale = _paged_case(kind, g, d, 16, 24,
                                          [384 - 5, 33, 1], g + d)
    b, pw = bt.shape
    splits, per = TP.split_count(b, 2 * TA.tile_plan(g, 2)[1], pw, 16,
                                 SMS, TA.tile_plan(g, 2)[0], True)
    assert splits > 1 and per % 16 == 0 and per > 16    # rows cross pages
    got = emulate_paged(q, cache, 1, bt, vl, scale, 2 * g)
    want = _plain64(cache, 1, bt, vl, q, scale, 2 * g)
    assert (got.float() - want).abs().max().item() <= 1e-9 * _vmax(cache)


@pytest.mark.parametrize("kind,g,cap,win", [
    ("bf16", 4, 20.0, 0), ("q6", 7, 0.0, 100), ("q8", 17, 15.0, 300),
    ("fp8", 48, 0.0, 64), ("q4", 22, 0.0, 1)])
def test_paged_tiles_softcap_window_match_plain(kind, g, cap, win):
    """Softcap and windows that start inside a page and a split (and a
    window of one row): f64 emulation against the plain f64 evaluation."""
    cache, bt, vl, q, scale = _paged_case(kind, g, 128, 64, 8,
                                          [512 - 3, 300, 1], g * 3)
    got = emulate_paged(q, cache, 1, bt, vl, scale, 2 * g, cap, win)
    want = _plain64(cache, 1, bt, vl, q, scale, 2 * g, cap, win)
    assert (got.float() - want).abs().max().item() <= 1e-9 * _vmax(cache)


def _np(t: torch.Tensor):
    """A pool tensor's bits as the numpy array the reference takes."""
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.float8_e5m2:
        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e5m2)
    return t.numpy()


@pytest.mark.parametrize("kind,g,d", [
    ("bf16", 2, 256), ("fp8", 4, 128), ("q8", 7, 128), ("q4", 8, 64),
    ("q6", 16, 128), ("bf16", 17, 64), ("q8", 22, 128), ("bf16", 48, 128)])
def test_paged_tiles_match_reference(kind, g, d):
    """The f32 emulation against the reference's Pallas kernel in interpret
    mode on the same pool bits (pages of 256, lengths 1 / 255 / 256 / 257
    and a pad row, as tests/test_torch_paged_attn.py takes them). Both
    round p to bf16 at the same point from f32 scores summed in another
    order, so a p within that noise of a rounding boundary may round the
    other way: one bf16 step of one weight, in at most two query-head rows.
    Every other row agrees within 1e-5 of max |ref|, and every row within
    1e-4 of max |v| (measured: 1e-8 to 1.5e-7 where no p flips, 3.2e-5
    and 3.4e-5 of max |ref| in the one row of the 16- and 48-head cases
    where one does)."""
    cache, bt, vl, q, scale = _paged_case(kind, g, d, 256, 3,
                                          [255, 256, 257, 1, 1], g + d)
    got = emulate_paged(q, cache, 1, bt, vl, scale, 2 * g,
                        dtype=torch.float32)
    kinds = _kinds(kind)
    ref = np.asarray(RP.paged_decode_attention(
        jnp.asarray(_np(q)), jnp.asarray(_np(cache.k_data)),
        jnp.asarray(_np(cache.v_data)), 1, jnp.asarray(bt.numpy()),
        jnp.asarray(vl.numpy()),
        None if cache.k_scales is None else jnp.asarray(_np(cache.k_scales)),
        None if cache.v_scales is None else jnp.asarray(_np(cache.v_scales)),
        scale, 256, 2 * g, kinds))
    assert np.isfinite(ref).all()
    diff = np.abs(got.numpy() - ref)
    assert diff.max() <= 1e-4 * _vmax(cache)
    assert (diff.max(-1) > 1e-5 * np.abs(ref).max()).sum() <= 2
