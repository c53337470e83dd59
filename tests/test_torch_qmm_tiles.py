"""The fused dequant-matmul kernel's tile map and dequant, emulated on the CPU.

csrc/qmm.cu builds the B fragments of bf16 m16n8k16 tensor-core tiles from
the plane words in registers. Lane (g, t) owns words R*t .. R*t+R-1 (R = 2 *
bp0) of a 256-row sub-block; slot S of those words holds natural rows
Qsb*S + R*t + i, and k-step h of the slot gives the mma's k indices 2t, 2t+1
rows 4h, 4h+1 and k indices 2t+8, 2t+9 rows 4h+2, 4h+3. Two values are
dequantized at once from a prmt of two words, a shift and a mask (plane 1:
prmt, rotate, mask); prescaled EXL2 segments of <= 7 bits use bf16x2
arithmetic (128 + q by OR 0x4300, minus 128 + z, times (s, s)), the other
kinds an f32 product and one bf16 rounding.

These tests emulate that map and arithmetic bit for bit in numpy / torch
and hold them against the port's dequant (ops/dequant.dequant_segment), the
fused kernel's plain version, and the JAX reference's fused kernel in
interpret mode, for every plane pair; and the kernel's split picker.

csrc/qmm_partials.cu (GPTQ scales-on-partials) runs on the same tile: its B
fragments are the exact integers q (bf16 128 + q less 128 below 8 bits, an
f32 path at 8 bits), one more mma against ones sums the activations of the
group, and where a group ends on a slot boundary the epilogue adds
(pg - xs*z)*s into a running f32 tile; K splits (whole groups) are summed
in rank order. The tests below emulate that and hold it against
qmm_partials_plain and the reference's partials kernel.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.ops import qmm as M

from exllamav2_tpu_torch.interop import linear_from_reference
from exllamav2_tpu_torch.ops import dequant as D
from exllamav2_tpu_torch.ops import qmm as Q
from exllamav2_tpu_torch.quant.qtensor import (
    GptqSegment, QuantSegment, SUB_BLOCK, plane_split)
from exllamav2_tpu_torch.utils.testing import (
    random_gptq_linear, random_quant_linear)

PAIRS = {2: (2,), 3: (2, 1), 4: (4,), 5: (4, 1), 6: (4, 2), 8: (8,)}
MASK32 = 0xFFFFFFFF


def _prmt(x, y, sel):
    """__byte_perm(x, y, sel) on uint64 arrays holding 32-bit words."""
    src = [(x >> (8 * k)) & 0xFF for k in range(4)] + \
          [(y >> (8 * k)) & 0xFF for k in range(4)]
    out = np.zeros_like(x)
    for k in range(4):
        out |= src[(sel >> (4 * k)) & 7] << (8 * k)
    return out


def _rotr(p, r):
    """__funnelshift_r(p, p, r): rotate right by r mod 32."""
    r &= 31
    return ((p >> r) | (p << ((32 - r) & 31))) & MASK32 if r else p


def _bf16_bits_to_f32(b):
    return (b.astype(np.uint32) << 16).view(np.float32)


def _round_bf16(f32):
    """Round-to-nearest-even f32 -> bf16 bits (torch's conversion)."""
    t = torch.from_numpy(np.ascontiguousarray(f32, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _meta(seg, grp, cols):
    """(scale f32, zero f32) of group grp at columns cols, as the kernel
    loads them; scale_f stays bf16-valued."""
    if isinstance(seg, GptqSegment):
        return (seg.scale[grp, cols].numpy(),
                seg.zero[grp, cols].numpy().astype(np.float32))
    z = np.full(len(cols), 2.0 ** (seg.bits - 1), np.float32)
    if seg.scale_f is not None:
        return seg.scale_f[grp, cols].float().numpy(), z
    qs = seg.qscale[grp, cols].numpy().astype(np.int32)
    if seg.src_cols:
        bounds = np.asarray(seg.src_cols[1:])
        src = (cols[:, None] >= bounds[None, :]).sum(1)
        sm = seg.smax[grp, src].numpy()
    else:
        sm = np.full(len(cols), seg.smax[grp, 0].item(), np.float32)
    s = (qs * qs).astype(np.float32) * sm
    return s.astype(np.float16).astype(np.float32), z


def fast_path(seg) -> bool:
    """The kernel's bf16x2 dequant: prescaled EXL2 of at most 7 bits."""
    return (not isinstance(seg, GptqSegment) and seg.scale_f is not None
            and seg.bits <= 7)


def q_halves(seg, sb, s, t, i, cols):
    """The values q (uint64 arrays) of the two rows of word pair (i, i + 1)
    of lane t at slot s of sub-block sb, for columns cols, low half first:
    qmm_tile.cuh's pair_bits (OR constant 0)."""
    bp = seg.plane_bits
    bp0, bp1 = bp[0], bp[1] if len(bp) > 1 else 0
    r, q0 = 2 * bp0, 8 * bp0
    w0 = seg.planes[0].numpy().view(np.uint32).astype(np.uint64)
    wa = w0[sb * q0 + r * t + i, cols]
    wb = w0[sb * q0 + r * t + i + 1, cols]
    p0 = _prmt(wa, wb, 0x5410 if bp0 * s < 16 else 0x7632)
    q = (p0 >> ((bp0 * s) & 15)) & (((1 << bp0) - 1) * 0x10001)
    if bp1:
        q1 = 8 * bp1
        w1 = seg.planes[1].numpy().view(np.uint32).astype(np.uint64)
        base = sb * q1 + (r * t) % q1
        sh1 = bp1 * ((q0 * s + r * t) // q1)
        p1 = _prmt(w1[base + i, cols], w1[base + i + 1, cols],
                   0x7632 if sh1 >= 16 else 0x5410)
        rot1 = ((sh1 & 15) - bp0) & 31
        q |= _rotr(p1, rot1) & ((((1 << bp1) - 1) << bp0) * 0x10001)
    return [q & 0xFFFF, q >> 16]


def b_register(seg, sb, s, t, i, cols):
    """The B register (bf16 bits of two rows, low half first) of word pair
    (i, i + 1) of lane t at slot s of sub-block sb, for columns cols: the
    kernel's deq()."""
    halves = q_halves(seg, sb, s, t, i, cols)
    bp0 = seg.plane_bits[0]
    r, q0 = 2 * bp0, 8 * bp0
    grp = (sb * SUB_BLOCK + q0 * s + r * t) // seg.group_rows
    sc, z = _meta(seg, grp, cols)
    out = []
    for h in halves:
        if fast_path(seg):
            # bf16 (128 + q) - bf16 (128 + z), exact; times (s, s), one
            # rounding of the exact product
            v = _bf16_bits_to_f32((h | 0x4300).astype(np.uint16))
            zc = _bf16_bits_to_f32(_round_bf16(128.0 + z))
            d = v - zc
            out.append(_round_bf16((d.astype(np.float64) * sc)
                                   .astype(np.float32)))
        else:
            v = ((h | 0x4B000000).astype(np.uint32)).view(np.float32)
            d = (v - (np.float32(8388608.0) + z)).astype(np.float32)
            out.append(_round_bf16((d * sc).astype(np.float32)))
    return out


def lane_rows(bp0, s, h, t):
    """Natural rows (in the sub-block) of the mma k indices 2t, 2t+1, 2t+8,
    2t+9 in k-step h of slot s; their word pairs are (4h, 4h+1) and
    (4h+2, 4h+3) of the lane's words."""
    base = 8 * bp0 * s + 2 * bp0 * t + 4 * h
    return {2 * t: base, 2 * t + 1: base + 1, 2 * t + 8: base + 2,
            2 * t + 9: base + 3}


def emulate_b_tile(seg, sb, s, h, cols):
    """bf16 bits [16, len(cols)] of the B tile of k-step h in slot s, and
    the natural row of each k index."""
    bp0 = seg.plane_bits[0]
    tile = np.zeros((16, len(cols)), np.uint16)
    rows = np.zeros(16, np.int64)
    for t in range(4):
        lr = lane_rows(bp0, s, h, t)
        b0 = b_register(seg, sb, s, t, 4 * h, cols)
        b1 = b_register(seg, sb, s, t, 4 * h + 2, cols)
        for k, v in zip((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9),
                        (b0[0], b0[1], b1[0], b1[1])):
            tile[k] = v
            rows[k] = lr[k]
    return tile, rows


def emulate_kernel(x, seg):
    """The kernel's product, k-step by k-step in its order: x bf16
    [m, rows_pad] -> f32 [m, N] (f64 sums)."""
    n = seg.planes[0].shape[1]
    cols = np.arange(n)
    bp0 = seg.plane_bits[0]
    xf = x.float().numpy().astype(np.float64)
    acc = np.zeros((x.shape[0], n))
    for sb in range(seg.rows_pad // SUB_BLOCK):
        for s in range(32 // bp0):
            for h in range(bp0 // 2):
                tile, rows = emulate_b_tile(seg, sb, s, h, cols)
                a = xf[:, sb * SUB_BLOCK + rows]
                acc += a @ _bf16_bits_to_f32(tile).astype(np.float64)
    return torch.from_numpy(acc.astype(np.float32))


def _segment(bits, kind, k=512, n=72, gs=32, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed * 31 + bits)
    if kind == "gptq":
        return random_gptq_linear(gen, k, n, bits=bits, group_rows=gs,
                                  device="cpu").segments[0]
    lin = random_quant_linear(gen, k, n, bits=bits, group_rows=gs,
                              device="cpu")
    if kind == "prescaled":
        lin = D.precompute_scales_linear(lin)
    return lin.segments[0]


@pytest.mark.parametrize("kind", ["prescaled", "qscale", "gptq"])
@pytest.mark.parametrize("bits", sorted(PAIRS))
def test_b_fragment_map_matches_dequant(bits, kind):
    """Every plane pair: the emulated B tiles of every k-step cover each
    row of a sub-block once and hold dequant_segment's bf16 weights bit for
    bit (n = 72: a ragged column tile)."""
    seg = _segment(bits, kind, gs=16 if bits == 5 else 32)
    assert seg.plane_bits == PAIRS[bits]
    want = D.dequant_segment(seg, torch.bfloat16, rows=seg.rows_pad)
    want = want.view(torch.int16).numpy().view(np.uint16)
    n = want.shape[1]
    cols = np.arange(n)
    bp0 = seg.plane_bits[0]
    for sb in range(seg.rows_pad // SUB_BLOCK):
        seen = np.zeros(SUB_BLOCK, np.int64)
        for s in range(32 // bp0):
            for h in range(bp0 // 2):
                tile, rows = emulate_b_tile(seg, sb, s, h, cols)
                seen[rows] += 1
                # the 16 rows of a k-step's lane lie in one 16-row chunk
                for t in range(4):
                    lr = list(lane_rows(bp0, s, h, t).values())
                    assert len({r // 16 for r in lr}) == 1
                np.testing.assert_array_equal(
                    tile, want[sb * SUB_BLOCK + rows])
        assert (seen == 1).all()


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6])
def test_bf16x2_dequant_is_bitwise_over_all_values_and_scales(bits):
    """The prescaled path's bf16x2 arithmetic against dequant_segment's
    bf16(f32(q - z) * s) over every q of the width and a sweep of bf16
    scales: both signs, every mantissa, exponents 2^-30 .. 2^5."""
    mags = np.arange(0x3080, 0x4280, dtype=np.uint32)      # 2^-30 .. 2^5
    sbits = np.concatenate([mags, mags | 0x8000])
    scales = _bf16_bits_to_f32(sbits.astype(np.uint16))
    qv = np.arange(2 ** bits)
    z = 2 ** (bits - 1)
    want = (torch.from_numpy((qv - z).astype(np.float32))[:, None]
            * torch.from_numpy(scales)[None, :]).to(torch.bfloat16)
    want = want.view(torch.int16).numpy().view(np.uint16)
    # the kernel: 0x4300 | q is bf16 128 + q; less bf16 128 + z; times s
    v = _bf16_bits_to_f32((qv | 0x4300).astype(np.uint16))
    np.testing.assert_array_equal(v, 128.0 + qv)
    zc = _bf16_bits_to_f32(_round_bf16(np.float32(128 + z)))
    assert zc == 128 + z
    d = (v - zc).astype(np.float32)
    got = _round_bf16((d[:, None].astype(np.float64) * scales[None, :])
                      .astype(np.float32))
    np.testing.assert_array_equal(got, want)
    # and through a segment: every q value at every row slot, the sweep as
    # the columns' scales
    n = 512
    cols = np.random.default_rng(bits).choice(len(scales), n, replace=False)
    bp = plane_split(bits)
    vals = np.tile(qv, SUB_BLOCK // len(qv) + 1)[:SUB_BLOCK]
    vals = np.stack([np.roll(vals, c) for c in range(n)], axis=1)
    planes, shift = [], 0
    for b in bp:
        qsb = SUB_BLOCK * b // 32
        field = ((vals >> shift) & ((1 << b) - 1)).astype(np.uint64)
        words = np.zeros((qsb, n), np.uint64)
        for r in range(SUB_BLOCK):
            words[r % qsb] |= field[r] << (b * (r // qsb))
        planes.append(torch.from_numpy(words.astype(np.uint32)
                                       .view(np.int32)))
        shift += b
    sf = torch.from_numpy(scales[cols]).to(torch.bfloat16)[None, :]
    seg = QuantSegment(planes=tuple(planes), qscale=None, smax=None,
                       bits=bits, plane_bits=bp, rows=SUB_BLOCK,
                       group_rows=SUB_BLOCK, scale_f=sf)
    ref = D.dequant_segment(seg).view(torch.int16).numpy().view(np.uint16)
    for s in range(32 // bp[0]):
        for h in range(bp[0] // 2):
            tile, rows = emulate_b_tile(seg, 0, s, h, np.arange(n))
            np.testing.assert_array_equal(tile, ref[rows])


@pytest.mark.parametrize("m", [1, 7, 16])
@pytest.mark.parametrize("bits", [3, 4, 8])
def test_emulated_kernel_matches_plain_and_reference(bits, m):
    """The emulated tile product (A rows in the permuted k order, B from the
    map) against qmm_plain and the reference's fused Pallas kernel in
    interpret mode on the same segment: f32 sums in another order, 1e-5 of
    max |ref|."""
    from exllamav2_tpu.quant import formats as F
    from exllamav2_tpu.quant import qtensor as RQ
    rng = np.random.default_rng(bits * 10 + m)
    w = rng.standard_normal((512, 136)).astype(np.float32) * 0.02
    t = F.exl2_pack(w, [bits] * 16, group_rows=32)
    ql = RQ.from_exl2(t)
    tl = linear_from_reference(jax.tree_util.tree_map(np.asarray, ql),
                               "cpu")
    seg = tl.segments[0]
    x = rng.standard_normal((m, 512)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = emulate_kernel(xb, seg)
    plain = Q.qmm_plain(xb, seg)
    ref = np.asarray(M.qmm(jnp.asarray(xb.float().numpy()), ql,
                           fused=True))
    scale = np.abs(ref).max()
    assert (got - plain).abs().max().item() <= 1e-5 * scale
    assert np.abs(got.numpy()[:, :ref.shape[1]] - ref).max() <= 1e-5 * scale


def test_merged_meta_picks_each_columns_source():
    """src_cols: the emulated kernel picks smax per column, so a tile that
    straddles sources (widths 48 | 40 | 40) still matches dequant."""
    gen = torch.Generator()
    gen.manual_seed(3)
    lin = D.merge_linears([random_quant_linear(gen, 256, w, bits=4,
                                               device="cpu")
                           for w in (48, 40, 40)])
    seg = lin.segments[0]
    assert seg.src_cols == (0, 48, 88)
    want = D.dequant_segment(seg).view(torch.int16).numpy().view(np.uint16)
    cols = np.arange(128)
    for s in range(8):
        for h in range(2):
            tile, rows = emulate_b_tile(seg, 0, s, h, cols)
            np.testing.assert_array_equal(tile, want[rows])


@pytest.mark.parametrize("n,nsb", [(4096, 16), (11008, 16), (4096, 43),
                                   (32000, 16), (12288, 16), (22016, 16),
                                   (200, 1), (384, 3)])
@pytest.mark.parametrize("m", [1, 4, 8, 16, 32])
def test_split_picker(n, nsb, m):
    """qmm_split: at most 8 splits (one cluster), none empty, the sub-blocks
    covered once, and as many splits as the target asks within the cluster
    and K, rounded to equal runs of sub-blocks."""
    tmpl = Q.qmm_template(m)
    assert tmpl == ("gemv" if m < 8 else "mma")
    target = Q._QMM_BLOCKS_PER_SM[tmpl] * 132
    splits, per = Q.qmm_split(n, nsb, target)
    assert 1 <= splits <= Q._QMM_MAX_SPLITS
    assert (splits - 1) * per < nsb <= splits * per
    want = min(nsb, Q._QMM_MAX_SPLITS, -(-target // -(-n // 128)))
    assert per == -(-nsb // want)


def test_qmm_launch_refuses_ragged_columns():
    """The kernel reads 4-column chunks: the wrapper refuses n % 4 != 0
    before any launch (checked here on a CPU tensor through the check
    itself)."""
    gen = torch.Generator()
    gen.manual_seed(1)
    seg = random_quant_linear(gen, 256, 130, device="cpu").segments[0]
    x = torch.zeros((1, 256), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        Q._kernel_segment_matmul(x, seg)


GPTQ_PAIRS = {2: (2,), 3: (2, 1), 4: (4,), 8: (8,)}


def partials_fires(bp0, gr, sb, s):
    """csrc/qmm_partials.cu's epilogue rule: does a group end with slot s of
    sub-block sb, and the index of its meta row in the stage."""
    q0 = 8 * bp0
    if gr == 128:
        return (q0 * (s + 1)) % 128 == 0, (q0 * (s + 1) - 1) // 128
    last = s + 1 == 32 // bp0
    return last and ((sb + 1) * SUB_BLOCK) % gr == 0, 0


@pytest.mark.parametrize("gr", [128, 256, 512])
@pytest.mark.parametrize("bits", sorted(GPTQ_PAIRS))
def test_partials_slots_lie_in_one_group(bits, gr):
    """Every GPTQ plane pair: a slot's Qsb = 8*bp0 rows lie in one group, so
    a group ends on a slot boundary, and the kernel's epilogue fires at
    exactly the slots that end a group, reading the ending group's meta."""
    bp0 = GPTQ_PAIRS[bits][0]
    q0 = 8 * bp0
    nsb = 2 * max(1, gr // SUB_BLOCK) + 1
    for sb in range(nsb):
        for s in range(32 // bp0):
            first = sb * SUB_BLOCK + q0 * s
            rows = np.arange(first, first + q0)
            assert len(set(rows // gr)) == 1
            ends = (first + q0) % gr == 0
            fires, mi = partials_fires(bp0, gr, sb, s)
            assert fires == ends
            if fires:
                # the stage holds the meta of group (sb*256)/gr + mi
                assert (sb * SUB_BLOCK) // gr + mi == rows[0] // gr


def test_partials_integer_fragments_are_exact():
    """The B values of the partials tile: 0x4300 | q is bf16 128 + q and less
    bf16 128 gives q for every q < 128; 8-bit q through f32 (2^23 + q less
    2^23) rounds to bf16 without loss (q <= 255 has 8 significant bits)."""
    qv = np.arange(128, dtype=np.uint32)
    v = _bf16_bits_to_f32((qv | 0x4300).astype(np.uint16))
    np.testing.assert_array_equal(v - np.float32(128.0), qv)
    q8 = np.arange(256, dtype=np.uint32)
    f = (q8 | 0x4B000000).view(np.float32) - np.float32(8388608.0)
    np.testing.assert_array_equal(_bf16_bits_to_f32(_round_bf16(f)), q8)


def emulate_partials(x, seg, sms=132):
    """csrc/qmm_partials.cu's arithmetic in its order: per split (whole
    groups, qmm_split), per k-step the f32 group partials pg and activation
    sums xs (each k-step's 16 products summed exactly, then added in f32),
    the epilogue (pg - xs*z)*s in f32 where a group ends, the splits summed
    in rank order: x bf16 [m, rows_pad] -> f32 [m, N]."""
    n = seg.planes[0].shape[1]
    cols = np.arange(n)
    bp0 = seg.plane_bits[0]
    gr = seg.group_rows
    nsb = seg.rows_pad // SUB_BLOCK
    m = x.shape[0]
    target = Q._QMM_BLOCKS_PER_SM[Q.qmm_template(m)] * sms
    splits, per = Q.qmm_split(n, nsb, target, unit=max(1, gr // SUB_BLOCK))
    assert per % max(1, gr // SUB_BLOCK) == 0
    xf = x.float().numpy().astype(np.float64)
    scale = seg.scale.numpy()
    zero = seg.zero.numpy().astype(np.float32)
    out = np.zeros((m, n), np.float32)
    for r in range(splits):
        pg = np.zeros((m, n), np.float32)
        xs = np.zeros((m, 1), np.float32)
        acc = np.zeros((m, n), np.float32)
        for sb in range(r * per, min((r + 1) * per, nsb)):
            for s in range(32 // bp0):
                for h in range(bp0 // 2):
                    tile = np.zeros((16, n))
                    rows = np.zeros(16, np.int64)
                    for t in range(4):
                        lr = lane_rows(bp0, s, h, t)
                        pairs = (q_halves(seg, sb, s, t, 4 * h, cols)
                                 + q_halves(seg, sb, s, t, 4 * h + 2, cols))
                        for kk, v in zip((2 * t, 2 * t + 1, 2 * t + 8,
                                          2 * t + 9), pairs):
                            tile[kk] = v
                            rows[kk] = lr[kk]
                    a = xf[:, sb * SUB_BLOCK + rows]
                    pg = (pg + (a @ tile).astype(np.float32)).astype(
                        np.float32)
                    xs = (xs + a.sum(1, keepdims=True).astype(np.float32)
                          ).astype(np.float32)
                fires, _ = partials_fires(bp0, gr, sb, s)
                if fires:
                    grp = (sb * SUB_BLOCK + 8 * bp0 * (s + 1)) // gr - 1
                    term = (pg - xs * zero[grp]) * scale[grp]
                    acc = (acc + term).astype(np.float32)
                    pg[:] = 0
                    xs[:] = 0
        out = (out + acc).astype(np.float32)
    return torch.from_numpy(out), splits


@pytest.mark.parametrize("m", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("bits,gr", [(4, 128), (2, 256), (3, 512), (8, 128)])
def test_emulated_partials_matches_plain_and_reference(bits, gr, m,
                                                       monkeypatch):
    """The emulated partials tile (B the exact integers, xs by the ones
    tile, the epilogue per group, the rank-order split merge) against
    qmm_partials_plain and the reference's _partials_gptq_matmul (interpret
    mode, through qmm under QMM_PARTIALS=1): f32 sums in another order,
    1e-5 of max |ref|."""
    from exllamav2_tpu.quant import formats as F
    from exllamav2_tpu.quant import qtensor as RQ
    rng = np.random.default_rng(bits * 100 + gr + m)
    k, n = 1024, 136
    g = k // gr
    qv = rng.integers(0, 2 ** bits, size=(k, n)).astype(np.uint16)
    zeros = rng.integers(1, 2 ** bits, size=(g, n)).astype(np.uint16)
    scales = rng.random((g, n)).astype(np.float32) * 0.02 + 0.001
    ql = RQ.from_gptq(F.gptq_pack(qv, zeros, scales, bits=bits))
    tl = linear_from_reference(jax.tree_util.tree_map(np.asarray, ql),
                               "cpu")
    seg = tl.segments[0]
    assert seg.plane_bits == GPTQ_PAIRS[bits] and seg.group_rows == gr
    x = rng.standard_normal((m, k)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got, splits = emulate_partials(xb, seg)
    assert splits > 1
    plain = Q.qmm_partials_plain(xb, seg)
    monkeypatch.setenv("QMM_PARTIALS", "1")
    assert M._use_partials(ql.segments[0])
    ref = np.asarray(M.qmm(jnp.asarray(xb.float().numpy()), ql,
                           fused=True))
    scale = np.abs(ref).max()
    assert (got - plain).abs().max().item() <= 1e-5 * scale
    assert np.abs(got.numpy()[:, :ref.shape[1]] - ref).max() <= 1e-5 * scale
