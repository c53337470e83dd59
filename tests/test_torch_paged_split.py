"""The paged flash-decode kernel's split over the sequence, on the CPU.

csrc/paged_attn.cu splits the positions of a sequence's block table into
`split_count` ranges of `per` rows (a multiple of 16, crossing page
boundaries), one block of a thread-block cluster each. A block scores its
live rows and publishes T (the max of its scores) and F (the max of its rows
in its first page) per query head; after a cluster barrier it forms, for
each of its pages j, M_j = max(E, its own scores of pages <= j, and for its
last page the F of later blocks starting there), E being the T of every
earlier block -- the reference's running max over the pages so far -- and
weighs its rows by bf16(exp(s - M_j)) * exp(M_j - M_last); the blocks' acc
and l are summed in rank order. Splits with no live row leave at once: the
live ones are the contiguous ranks [r_lo, r_hi) that every block computes
from the valid length, and only they take part.

These tests emulate that algorithm in torch (f32, the kernel's rounding
points) and hold it against the port's plain version (the unsplit page
recurrence) at 1e-5 of max |v|, and against the reference's Pallas kernel
in interpret mode at 1e-5 of max |v| beyond the plain version's own
difference from it (zero below 1500 rows; at 1500 rows the f32 order of the
score sums flips one bf16 rounding of p, 1.6e-5 / 5.4e-5 of max |v| for
bf16 / q4): every cache kind, 1, 2 and 4 query heads per KV head, valid
lengths around the 16-row and page boundaries, softcap, window and a pad
row on the null page; and the split picker.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.cache_paged import PagedKVCache as RefPaged
from exllamav2_tpu.ops import paged_attn as RP

from exllamav2_tpu_torch.cache_paged import _kinds, _raw
from exllamav2_tpu_torch.interop import paged_cache_from_reference
from exllamav2_tpu_torch.ops import paged_attn as TP

D = 128
LENS = [1, 15, 16, 17, 152, 255, 256, 257, 1500]
NEG = -1e30


def emulate_split(q, k_data, v_data, layer, block_table, valid_lens,
                  k_scales, v_scales, scale, page, hq, kinds, softcap,
                  window, splits, per):
    """The kernel's arithmetic, block by block: q [B, Hq, D] bf16 ->
    f32 [B, 1, Hq, D]."""
    b, _, d = q.shape
    hkv = k_data.shape[1]
    g = hq // hkv
    kk, vk = kinds
    positions = block_table.shape[1] * page
    assert (splits - 1) * per < positions <= splits * per and per % 16 == 0
    out = torch.zeros((b, hkv, g, d))
    qf = q.to(torch.bfloat16).float().reshape(b, hkv, g, d)
    for bi in range(b):
        n = int(valid_lens[bi])
        lo = max(n - window, 0) if window > 0 else 0
        pos = torch.arange(positions)
        rows = block_table[bi].long()[pos // page] * page + pos % page

        def rows_of(data, scales, kind):
            raw = _raw(data)[layer][:, rows].view(data.dtype)
            s = None if scales is None else scales[layer][:, rows]
            return TP._dq_page(raw, s, kind).to(torch.bfloat16).float()
        kx = rows_of(k_data, k_scales, kk)
        vx = rows_of(v_data, v_scales, vk)
        s = torch.einsum("hgd,hpd->hgp", qf[bi], kx) * scale
        if softcap > 0.0:
            s = torch.tanh(s * (1.0 / softcap)) * softcap
        valid = (pos >= lo) & (pos < n)
        s = torch.where(valid, s, torch.full_like(s, NEG))
        # the kernel's live ranks
        n_end = min(n, positions)
        r_lo = lo // per
        r_hi = (n_end - 1) // per + 1 if lo < n_end else r_lo
        # pass 0: T and F of every block
        ranges = []
        t_pub, f_pub = [], []
        for r in range(splits):
            s0, s1 = r * per, min((r + 1) * per, positions)
            a0, a1 = max(s0, lo), min(s1, n)
            ranges.append((s0, s1, a0, a1))
            t = torch.full((hkv, g), NEG)
            f = torch.full((hkv, g), NEG)
            if a0 < a1:
                t = s[:, :, a0:a1].amax(-1)
                first = min(a1, (s0 // page + 1) * page)
                if a0 < first:
                    f = s[:, :, a0:first].amax(-1)
            t_pub.append(t)
            f_pub.append(f)
            assert (a0 < a1) == (r_lo <= r < r_hi)
        if r_lo == r_hi:                     # no live row: rank 0 writes 0
            continue
        ml = torch.stack(t_pub[r_lo:r_hi]).amax(0)
        # pass 1: weights, l and P.V of every block; the merge in rank order
        acc_sum = torch.zeros((hkv, g, d))
        l_sum = torch.zeros((hkv, g))
        for r in range(r_lo, r_hi):
            s0, s1, a0, a1 = ranges[r]
            acc = torch.zeros((hkv, g, d))
            lr = torch.zeros((hkv, g))
            if a0 < a1:
                e = torch.stack(t_pub[r_lo:r] or [torch.full((hkv, g), NEG)]) \
                    .amax(0)
                jl = (s1 - 1) // page
                x = torch.full((hkv, g), NEG)
                for r2 in range(r + 1, r_hi):
                    if r2 * per // page == jl:
                        x = torch.maximum(x, f_pub[r2])
                run = torch.full((hkv, g), NEG)
                p0 = a0
                while p0 < a1:
                    j = p0 // page
                    pe = min(a1, (j + 1) * page)
                    seg = s[:, :, p0:pe]
                    run = torch.maximum(run, seg.amax(-1))
                    mj = torch.maximum(e, run)
                    if j == jl:
                        mj = torch.maximum(mj, x)
                    fac = torch.exp(mj - ml)
                    p = torch.exp(seg - mj[..., None])
                    lr = lr + (p * fac[..., None]).sum(-1)
                    w = p.to(torch.bfloat16).float() * fac[..., None]
                    acc = acc + torch.einsum("hgp,hpd->hgd", w,
                                             vx[:, p0:pe])
                    p0 = pe
            acc_sum = acc_sum + acc
            l_sum = l_sum + lr
        out[bi] = acc_sum / torch.where(l_sum == 0, torch.ones_like(l_sum),
                                        l_sum)[..., None]
    return out.reshape(b, 1, hq, d)


@functools.lru_cache(maxsize=None)
def _pools(kind: str, hkv: int, page: int):
    """Reference pool of (1536 + page) / page + 1 pages holding one
    sequence of random rows through its own append, and the port's copy;
    the sequence's block table (page 0, the null page, left out)."""
    npages = 1536 // page + 2
    rng = np.random.default_rng(hkv * 1000 + page)
    rc = RefPaged.alloc(2, npages, hkv, D, kind, page_size=page)
    table = rng.permutation(np.arange(1, npages)).astype(np.int32)
    nrow = (npages - 1) * page
    kv = rng.standard_normal((2, 1, nrow, hkv, D)).astype(np.float32)
    rc = rc.append(1, jnp.asarray(table[None]), jnp.zeros(1, jnp.int32),
                   jnp.asarray(kv[0], jnp.bfloat16),
                   jnp.asarray(kv[1], jnp.bfloat16))
    rc = jax.tree_util.tree_map(np.asarray, rc)
    return rc, paged_cache_from_reference(rc, device="cpu"), table


def _inputs(kind, hq, hkv, page, lens, seed):
    """Rows of the given valid lengths on the shared table, then a pad row
    (valid length 1, all null page); q in bf16."""
    rc, tc, table = _pools(kind, hkv, page)
    pw = -(-max(lens) // page)
    bt = np.zeros((len(lens) + 1, pw), np.int32)
    bt[:-1] = table[:pw]
    vl = np.array(list(lens) + [1], np.int32)
    q = np.random.default_rng(seed).standard_normal(
        (len(vl), hq, D)).astype(np.float32)
    qj = jnp.asarray(q, jnp.bfloat16)
    qt = torch.from_numpy(np.asarray(qj).view(np.int16).copy()).view(
        torch.bfloat16)
    return rc, tc, bt, vl, qj, qt


def _vmax(tc, kind):
    vk = _kinds(kind)[1]
    vdata = _raw(tc.v_data)[1].view(tc.v_data.dtype)
    return TP._dq_page(vdata, None if tc.v_scales is None
                       else tc.v_scales[1], vk).abs().max().item()


def _check(kind, hq, hkv, page, lens, cap, win, sms, reference):
    rc, tc, bt, vl, qj, qt = _inputs(kind, hq, hkv, page, lens, len(lens))
    kinds = _kinds(kind)
    args = (qt, tc.k_data, tc.v_data, 1, torch.from_numpy(bt),
            torch.from_numpy(vl), tc.k_scales, tc.v_scales, 0.09, page, hq,
            kinds, cap, win)
    splits, per = TP.split_count(len(vl), hkv, bt.shape[1], page, sms,
                                 hq // hkv)
    got = emulate_split(*args, splits, per)
    plain = TP.paged_decode_attention_plain(*args)
    tol = 1e-5 * _vmax(tc, kind)
    assert got.shape == plain.shape == (len(vl), 1, hq, D)
    assert torch.isfinite(got).all()
    assert (got - plain).abs().max().item() <= tol
    if reference:
        ref = RP.paged_decode_attention(
            qj, jnp.asarray(rc.k_data), jnp.asarray(rc.v_data), 1,
            jnp.asarray(bt), jnp.asarray(vl),
            None if rc.k_scales is None else jnp.asarray(rc.k_scales),
            None if rc.v_scales is None else jnp.asarray(rc.v_scales),
            0.09, page, hq, kinds, cap, win)
        # the plain version's own difference from the reference: one bf16
        # rounding of p flipped by the f32 order of the score sums (torch's
        # einsum against XLA's dot: scores 7e-7 apart) at 1500 rows
        gap = np.abs(plain.numpy() - np.asarray(ref)).max()
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= gap + tol
    return splits, per


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (4, 1)])
@pytest.mark.parametrize("kind", ["bf16", "fp8", "q8", "q4", "q6"])
def test_split_matches_plain_and_reference(kind, hq, hkv):
    """Every kind, G = 1, 2, 4, the lengths around 16-row and page edges
    and 1500 rows, at the split of a 132-SM card for 10 sequences (14
    splits of 112 rows: several splits share a page) against the plain
    version and the reference's Pallas kernel in interpret mode."""
    splits, per = _check(kind, hq, hkv, 256, LENS, 0.0, 0, 132, True)
    assert splits > 8 and per < 256


@pytest.mark.parametrize("kind", ["bf16", "q6"])
@pytest.mark.parametrize("cap,win", [(20.0, 0), (0.0, 100), (15.0, 300)])
def test_split_softcap_window(kind, cap, win):
    """Softcap and window: the window's first row inside a split and inside
    a page; splits wholly before the window stay empty."""
    _check(kind, 4, 2, 256, LENS, cap, win, 132, True)


@pytest.mark.parametrize("sms", [2, 8, 20, 132])
@pytest.mark.parametrize("page,kind", [(16, "bf16"), (64, "q4"),
                                       (128, "q6"), (256, "fp8")])
def test_split_boundaries_match_plain(page, kind, sms):
    """Page sizes 16-256 against the split counts of smaller and larger
    cards: splits of one page or several, splits crossing page edges."""
    splits, per = _check(kind, 4, 2, page, LENS, 0.0, 0, sms, False)
    assert 1 <= splits <= TP.MAX_SPLITS


@pytest.mark.parametrize("batch,hkv,pw,page,g", [
    (16, 32, 2, 256, 1), (1, 32, 8, 256, 1), (1, 8, 8, 256, 4),
    (4, 32, 2, 256, 1), (16, 8, 2, 256, 4), (1, 8, 64, 256, 16),
    (64, 8, 256, 256, 16), (1, 1, 1, 16, 1), (3, 4, 5, 48, 2)])
@pytest.mark.parametrize("sms", [132, 114])
def test_split_count(batch, hkv, pw, page, g, sms):
    """split_count: a function of the bucket (batch, KV heads, block-table
    width, page) and the card, never of the valid lengths; per a multiple
    of 16 covering the bucket with no empty tail split; within one cluster;
    enough blocks to fill the card where the cluster allows; more splits
    where a split would pass its longest range or its scores would outgrow
    the block."""
    splits, per = TP.split_count(batch, hkv, pw, page, sms, g)
    positions = pw * page
    assert per % 16 == 0 and per >= 16
    assert (splits - 1) * per < positions <= splits * per
    assert 1 <= splits <= TP.MAX_SPLITS
    fill = TP._BLOCKS_PER_SM * sms
    assert batch * hkv * splits >= fill or splits == min(
        TP.MAX_SPLITS, -(-positions // 16))
    keep = max(page, TP.SCORE_FLOATS // g // 16 * 16)
    longest = max(TP.SPLIT_ROWS, TP.SPLIT_WORK // g)
    assert per <= min(keep, longest) or splits == TP.MAX_SPLITS
    if (batch, hkv, pw, page) == (16, 32, 2, 256):
        assert splits == 1      # the serving16 step: its pairs fill the card
    if batch == 1 and positions >= 2048:
        assert splits > 1                      # batch 1, long bucket
