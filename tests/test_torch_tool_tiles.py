"""The tile maps of two tool kernels, emulated on the CPU.

csrc/perf_qmm.cu `nibble_kernel` (the nibble split of a 4-bit plane) runs on
int8 mma.sync.m16n8k32 tiles: the weights are A (16 output columns), the 8
activation rows are B. Lane (g, t) loads word t of a 4-word k-step for the
columns 4g .. 4g+3; a0 / a1 are the lo nibbles of the column pair's words,
a2 / a3 their hi nibbles, b0 / b1 four bytes of xq row g. For gr >= 32 a
group's k-steps share one int32 tile; for gr 16 a k-step holds two groups
(lanes t < 2 the first), one mma each with the other group's B zeroed. Per
group the epilogue adds (f32(p) - 8 x1) * s to an f32 sum; the partial tiles
of a block's K warps are summed in order, then the cluster's blocks in rank
order.

csrc/probe_features.cu `bf16_dot_kernel` spreads the K walk of a
[16, k] @ [k, n] bf16 product over the 8 warps of a block (k-steps of 16,
four a warp in each 512-row pass), takes the fragments with ldmatrix
(.trans for the row-major B) and sums the warps' f32 tiles in warp order.
Its `int8_dot_kernel<INT4>` takes a 16-row, 32-column tile a block of one
warp for each 64 rows of K (1 to 8; k-steps of 32 round the warps, two a
pass): lane (g, t) loads a word of columns 4g..4g+3 (int4: their 16 packed
bits, each nibble put in the high half of a byte) from each of its eight
rows of B and a byte transpose gives the B register of n-tile j for column
4g + j; the warps' int32 tiles are summed in warp order, four columns a
thread (int4: shifted back by 4).

These tests emulate the maps in numpy, as the PTX fragment layouts define
them, and hold them against the port's plain versions and the JAX
reference's Pallas kernels in interpret mode; and the nibble kernel's split
picker.
"""

import inspect

import numpy as np
import pytest
import torch

from exllamav2_tpu_torch.tools import perf_qmm as T
from exllamav2_tpu_torch.tools import probe_features as PF

from test_torch_tools import _load, _plane, _ref_perf, recorded  # noqa: F401
from torch_prmt import U32, byte_of4, byte_perm

WARPS = 8                      # warps of a block, both kernels


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# int8 m16n8k32 fragments (PTX: mma.m16n8k32 .s8): registers [.., r, g, t]
# ---------------------------------------------------------------------------

def _bytes(regs):
    """uint32 words -> [..., 4] int8 values, byte i little-endian."""
    b = (regs[..., None].astype(np.uint64)
         >> np.arange(0, 32, 8, dtype=np.uint64)) & np.uint64(0xFF)
    return b.astype(np.uint8).view(np.int8).astype(np.int64)


_R, _G, _TT, _I = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                              np.arange(4), indexing="ij")


def _frag_a(regs):
    """a0-a3 [..., 4, 8, 4] -> A [..., 16, 32]: register r of lane (g, t)
    holds row g + 8 (r & 1), k = 16 (r >> 1) + 4t + i."""
    a = np.zeros(regs.shape[:-3] + (16, 32), np.int64)
    a[..., _G + 8 * (_R & 1), 16 * (_R >> 1) + 4 * _TT + _I] = _bytes(regs)
    return a


def _frag_b(regs):
    """b0, b1 [..., 2, 8, 4] -> B [..., 32, 8]: register r of lane (g, t)
    holds k = 16 r + 4t + i of column g."""
    b = np.zeros(regs.shape[:-3] + (32, 8), np.int64)
    r, g, t, i = (x[:2] for x in (_R, _G, _TT, _I))
    b[..., 16 * r + 4 * t + i, g] = _bytes(regs)
    return b


def _frag_c(c):
    """C [..., 16, 8] -> c0-c3 [..., 4, 8, 4]: register r of lane (g, t) is
    row g + 8 (r >> 1), column 2t + (r & 1)."""
    r, g, t = (x[..., 0] for x in (_R, _G, _TT))
    return c[..., g + 8 * (r >> 1), 2 * t + (r & 1)]


def _mma_s8(c, a_regs, b_regs):
    return c + _frag_c(_frag_a(a_regs) @ _frag_b(b_regs))


def _word(xq, m, off):
    """Four bytes of xq row m from column off, as one little-endian word."""
    b = xq[m, off:off + 4].view(np.uint8).astype(np.uint32)
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


def emulate_nibble(xq, x1, plane, qs, smax, gr, kt, nt):
    """nibble_kernel on numpy arrays (xq int8 [8, K], x1 f32 [8, G], plane
    uint32 [K/8, N], qs uint8 [G, N], smax f32 [G]) with K rows a split and
    nt columns a block -> (int32 group partials [G, 8, N], y f32 [8, N])."""
    k, n = xq.shape[1], plane.shape[1]
    groups = k // gr
    npad = -(-n // nt) * nt
    words = np.zeros((k // 8, npad), np.uint32)
    words[:, :n] = plane
    qsp = np.zeros((groups, npad), np.uint32)
    qsp[:, :n] = qs
    nb = npad // 32                            # 32-column warp blocks
    warps_k = WARPS // (nt // 32)
    units, per = k // 256, kt // 256
    splits = -(-units // per)
    lo = lambda w: w & np.uint32(0x0F0F0F0F)                     # noqa: E731
    hi = lambda w: (w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)   # noqa: E731
    g_ix, t_ix = np.arange(8)[:, None], np.arange(4)[None, :]
    parts = np.zeros((groups, 8, npad), np.int64)
    f32 = np.float32

    def epilogue(acc, c, grp):
        # C register 2e + mm of pair p: column 4g + 2p + e, row 2t + mm
        z = [f32(8) * x1[2 * t_ix + mm, grp] for mm in range(2)]   # [1, 4]
        for cc in range(4):
            p, e = cc >> 1, cc & 1
            q = qsp[grp].reshape(nb, 8, 4)[:, :, cc][:, :, None]   # [nb,8,1]
            s = ((q * q).astype(f32) * smax[grp]).astype(np.float16).astype(
                f32)
            for mm in range(2):
                v = c[p][:, 2 * e + mm]                            # [nb,8,4]
                parts[grp, 2 * t_ix + mm,
                      32 * np.arange(nb)[:, None, None] + 4 * g_ix + cc] = v
                acc[:, :, :, cc, mm] = acc[:, :, :, cc, mm] + (
                    v.astype(f32) - z[mm]) * s

    tiles = {}
    for r in range(splits):
        for wk in range(warps_k):
            acc = np.zeros((nb, 8, 4, 4, 2), f32)
            for u in range(r * per + wk, min((r + 1) * per, units), warps_k):
                c = None
                for s in range(8):
                    kb = u * 256 + 32 * s
                    w = words[kb // 8:kb // 8 + 4].reshape(4, nb, 8, 4)
                    w = w.transpose(1, 2, 0, 3)          # [nb, g, t, column]
                    a_regs = [np.stack([lo(w[..., 2 * p]),
                                        lo(w[..., 2 * p + 1]),
                                        hi(w[..., 2 * p]),
                                        hi(w[..., 2 * p + 1])], axis=1)
                              for p in range(2)]
                    if gr == 16:
                        o0 = kb + 16 * (t_ix >> 1) + 4 * (t_ix & 1)
                        o1 = o0 + 8
                    else:
                        gb = kb // gr * gr
                        o0 = gb + 16 * ((kb - gb) // 32) + 4 * t_ix
                        o1 = o0 + gr // 2
                    b_regs = np.array(
                        [[[_word(xq, g, o[0, t]) for t in range(4)]
                          for g in range(8)] for o in (o0, o1)], np.uint32)
                    if gr == 16:
                        for h in range(2):
                            bh = np.where((t_ix >> 1) == h, b_regs, 0)
                            ch = [_mma_s8(np.zeros((nb, 4, 8, 4), np.int64),
                                          a_regs[p], bh) for p in range(2)]
                            epilogue(acc, ch, (kb // 16) + h)
                        continue
                    if (kb % gr) == 0:
                        c = [np.zeros((nb, 4, 8, 4), np.int64)
                             for _ in range(2)]
                    c = [_mma_s8(c[p], a_regs[p], b_regs) for p in range(2)]
                    if (kb + 32) % gr == 0:
                        epilogue(acc, c, kb // gr)
            tiles[r, wk] = acc
    # the K warps' tiles summed in order within a block, then the blocks'
    # sums in rank order
    y = np.zeros((8, npad), f32)
    for r in range(splits):
        block = np.zeros((8, npad), f32)
        for wk in range(warps_k):
            block = block + tiles[r, wk].transpose(2, 4, 0, 1, 3).reshape(
                8, npad)
        y = y + block
    assert np.abs(parts).max() < 2 ** 31
    return parts[:, :, :n].astype(np.int32), y[:, :n]


def _nibble_inputs(k, n, gr, seed):
    plane, qs, smax, x = T.mk_inputs(k, n, "cpu", seed=seed, bits=4, gr=gr)
    xq = T.quantize_x(x)
    return xq, T.group_sums(xq, gr), plane, qs, smax


def _group_partials(xq, plane, gr):
    """int64 [G, 8, N]: each group's activations against its nibble rows."""
    k, n = xq.shape[1], plane.shape[1]
    w = T.nibble_values(plane, gr).numpy().astype(np.int64).reshape(
        k // gr, gr, n)
    xg = xq.numpy().astype(np.int64).reshape(8, k // gr, gr)
    return np.einsum("mgr,grn->gmn", xg, w)


def _np(xq, x1, plane, qs, smax):
    return (xq.numpy(), x1.numpy(), plane.numpy().view(np.uint32),
            qs.numpy(), smax.numpy().reshape(-1))


@pytest.mark.parametrize("gr", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("k,n,kt,nt", [
    (2048, 72, 512, 32),       # ragged columns, 4 splits, idle K warps
    (1024, 132, 256, 64),      # 4 splits of one unit, 4 K warps
    (1280, 256, 256, 256),     # 5 splits, one K warp
    (2048, 40, 2048, 64),      # one split, two units a K warp
])
def test_nibble_fragments_match_plain(gr, k, n, kt, nt):
    """The emulated kernel's int32 group partials equal the plain version's
    integer dots bit for bit; its y is within 1e-5 of max |plain|."""
    inputs = _nibble_inputs(k, n, gr, seed=gr + n)
    parts, y = emulate_nibble(*_np(*inputs), gr, kt, nt)
    np.testing.assert_array_equal(parts, _group_partials(inputs[0],
                                                         inputs[2], gr))
    want = T.nibble_i8_plain(*inputs, gr).numpy()
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("gr", [32, 128])
def test_nibble_fragments_match_pallas(recorded, monkeypatch, gr):
    """The reference's _run_nibble kernel in interpret mode, on its own
    recorded inputs."""
    ref = _ref_perf(monkeypatch, [(2048, 256)], gr)
    ref.VARIANTS["nibble_i8"]()
    (xq, x1, plane, qs, smax), want = recorded[-1]
    kt, nt = T.nibble_tiles(2048, 256, 4)
    _, y = emulate_nibble(xq, x1, np.asarray(plane, np.uint32), qs,
                          np.asarray(smax).reshape(-1), gr, kt, nt)
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()
    got = T.nibble_i8(torch.from_numpy(xq), torch.from_numpy(x1),
                      _plane(plane), torch.from_numpy(qs),
                      torch.from_numpy(smax), gr=gr)
    assert np.abs(y - got.numpy()).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("k", [256, 1024, 4096, 11008, 16384])
@pytest.mark.parametrize("n", [8, 392, 4096, 11008])
@pytest.mark.parametrize("sms", [1, 66, 132])
def test_nibble_split_picker(k, n, sms):
    """256-row boundaries (whole groups of every size the tool takes), no
    empty split, at most the cluster's limit and K / kt0, a unit for every
    K warp where K has enough, a power-of-two column block of 32-256; a
    function of (K, N, SMs) and the hints alone."""
    assert list(inspect.signature(T.nibble_tiles).parameters) == [
        "k", "n", "sms", "kt0", "nt0"]
    for hints in ({}, {"kt0": 2048}, {"nt0": 4096}, {"kt0": 256},
                  {"kt0": 1 << 20, "nt0": 64}):
        kt, nt = T.nibble_tiles(k, n, sms, **hints)
        assert (kt, nt) == T.nibble_tiles(k, n, sms, **hints)
        assert kt % 256 == 0 and 256 <= kt
        splits = -(-k // kt)
        assert 1 <= splits <= T.NIBBLE_MAX_SPLITS
        assert k - (splits - 1) * kt > 0                 # the last split
        assert splits <= max(1, k // hints.get("kt0", 1024))
        assert nt in (32, 64, 128, 256)
        warps_k = WARPS // (nt // 32)
        assert splits == 1 or kt // 256 >= warps_k


# ---------------------------------------------------------------------------
# bf16 m16n8k16 fragments, taken with ldmatrix
# ---------------------------------------------------------------------------

def _ldmatrix(smem, rows, cols, trans):
    """ldmatrix.x4: lane l gives (rows[l], cols[l]), the start of row l % 8
    of matrix l // 8 -> [4, 8, 4, 2]: register j of lane (g, t) holds M_j[g,
    2t + i] (M_j[2t + i, g] with .trans)."""
    mats = np.stack([np.stack([smem[rows[8 * j + r], cols[8 * j + r]:
                                    cols[8 * j + r] + 8] for r in range(8)])
                     for j in range(4)])                      # [4, 8, 8]
    if trans:
        mats = mats.transpose(0, 2, 1)
    g, t, i = np.meshgrid(np.arange(8), np.arange(4), np.arange(2),
                          indexing="ij")
    return mats[:, g, 2 * t + i]


def _mma_bf16(c, ra, rb):
    """m16n8k16: a_r of lane (g, t) is row g + 8 (r & 1), k = 8 (r >> 1) +
    2t + i; b_r is k = 8r + 2t + i of column g; c_r row g + 8 (r >> 1),
    column 2t + (r & 1). f32 result of the exact products."""
    a = np.zeros((16, 16))
    b = np.zeros((16, 8))
    g, t, i = np.meshgrid(np.arange(8), np.arange(4), np.arange(2),
                          indexing="ij")
    for r in range(4):
        a[g + 8 * (r & 1), 8 * (r >> 1) + 2 * t + i] = ra[r]
    for r in range(2):
        b[8 * r + 2 * t + i, g] = rb[r]
    prod = (a @ b).astype(np.float32)
    r, g, t = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                          indexing="ij")
    return (c + prod[g + 8 * (r >> 1), 2 * t + (r & 1)]).astype(np.float32)


def emulate_bf16_dot(a, b):
    """bf16_dot_kernel on f32 arrays of bf16 values (a [16, k], b [k, n]):
    blocks of 16 columns, warp w takes k-steps 4w .. 4w+3 of each 512-row
    pass, its f32 tiles summed over the warps in order -> f32 [16, n]."""
    k, n = b.shape
    out = np.zeros((16, n), np.float32)
    lane = np.arange(32)
    mi, ri = lane >> 3, lane & 7
    for n0 in range(0, n, 16):
        bs = np.zeros((k, 16), np.float32)
        bs[:, :min(16, n - n0)] = b[:, n0:n0 + 16]
        acc = np.zeros((WARPS, 2, 4, 8, 4), np.float32)
        for kc in range(0, k, 512):
            rows = min(512, k - kc)
            for w in range(WARPS):
                for i in range(4):
                    kk = (w * 4 + i) * 16
                    if kk >= rows:
                        break
                    ra = _ldmatrix(a, ri + 8 * (mi & 1),
                                   kc + kk + 8 * (mi >> 1), False)
                    rb = _ldmatrix(bs, kc + kk + ri + 8 * (mi & 1),
                                   8 * (mi >> 1), True)
                    for j in range(2):
                        acc[w, j] = _mma_bf16(acc[w, j], ra,
                                              rb[2 * j:2 * j + 2])
        red = np.zeros((WARPS, 16, 16), np.float32)
        r, g, t = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                              indexing="ij")
        for j in range(2):
            red[:, g + 8 * (r >> 1), 8 * j + 2 * t + (r & 1)] = acc[:, j]
        s = np.zeros((16, 16), np.float32)
        for w in range(WARPS):
            s = s + red[w]
        out[:, n0:n0 + 16] = s[:, :min(16, n - n0)]
    return out


@pytest.mark.parametrize("k,n", [(256, 256), (1024, 40), (1040, 24)])
def test_bf16_dot_partition_matches_plain(k, n):
    rng = np.random.default_rng(k + n)
    a = PF._bf16(rng.standard_normal((16, k)))
    b = PF._bf16(rng.standard_normal((k, n)))
    got = emulate_bf16_dot(a.float().numpy(), b.float().numpy())
    want = PF._bf16_dot_plain(a, b).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= PF.BF16_DOT_TOL * np.abs(want).max()


def test_bf16_dot_partition_matches_pallas(recorded):
    ref = _load("probe_features")
    np.random.seed(11)
    assert ref.PROBES["bf16_dot_bf16_acc_f32"]() == "ok"
    (a, b), want = recorded[-1]
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    got = emulate_bf16_dot(a, b)
    assert np.abs(got - want).max() <= PF.BF16_DOT_TOL * np.abs(want).max()
    tensors = PF.PROBES["bf16_dot_bf16_acc_f32"].to_torch(a, b)
    assert PF._bf16_dot_verdict(tensors, torch.from_numpy(got)) == "ok"


# ---------------------------------------------------------------------------
# int8 / int4 dots: m16n8k32 fragments, B by a byte transpose
# ---------------------------------------------------------------------------

def _words(rows):
    """[..., 4] uint8 -> little-endian uint32 words."""
    b = rows.astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _b_bytes(v, int4):
    """b_bytes of the source: int4's 16 bits as four bytes of 16 v."""
    if not int4:
        return v
    x = byte_perm(v, 0, 0x1100)
    return ((x & U32(0xF000F000)) | ((x << U32(4)) & U32(0x00F000F0))).astype(
        U32)


def emulate_int8_dot(a, b, int4):
    """int8_dot_kernel on numpy arrays: a int8 [g, m, k], b int8 [g, k, n]
    (int4: packed uint8 [g, k, n/2]) -> int32 [g, m, n]."""
    gs, m, k = a.shape
    n = b.shape[-1] * (2 if int4 else 1)
    nw = PF.int8_dot_warps(k)
    out = np.zeros((gs, m, n), np.int64)
    au = a.view(np.uint8)
    g_ix, t_ix = np.arange(8)[:, None], np.arange(4)[None, :]
    for gi in range(gs):
        for m0 in range(0, m, 16):
            arows = np.zeros((16, k), np.uint8)
            arows[:min(16, m - m0)] = au[gi, m0:m0 + 16]
            for n0 in range(0, n, 32):
                col = n0 + 4 * g_ix                              # [8, 1]
                red = np.zeros((nw, 16, 32), np.int64)
                for w in range(nw):
                    acc = [np.zeros((4, 8, 4), np.int64) for _ in range(4)]
                    for k0 in range(w * 32, k, nw * 32 * 2):
                        for s in range(2):
                            kk = k0 + s * nw * 32
                            if kk >= k:
                                continue
                            # a_r: row g + 8 (r & 1), k 16 (r >> 1) + 4t + i
                            ra = np.stack([_words(np.stack(
                                [arows[g_ix + 8 * (r & 1),
                                       kk + 16 * (r >> 1) + 4 * t_ix + i]
                                 for i in range(4)], axis=-1))
                                for r in range(4)])              # [4, 8, 4]
                            bw = []
                            for i in range(8):
                                row = kk + 16 * (i >> 2) + 4 * t_ix + (i & 3)
                                live = np.broadcast_to(col < n, (8, 4))
                                if int4:
                                    c2 = np.minimum(col, n - 4) // 2
                                    raw = b[gi][row, c2].astype(U32) | (
                                        b[gi][row, c2 + 1].astype(U32)
                                        << U32(8))
                                else:
                                    raw = _words(np.stack(
                                        [b[gi].view(np.uint8)[
                                            row, np.minimum(col + j, n - 1)]
                                         for j in range(4)], axis=-1))
                                bw.append(np.where(live, _b_bytes(raw, int4),
                                                   U32(0)))
                            for j in range(4):
                                rb = np.stack([byte_of4(*bw[4 * r:4 * r + 4],
                                                         j) for r in range(2)])
                                acc[j] = _mma_s8(acc[j], ra, rb)
                    # register r of n-tile j: row g + 8 (r >> 1), mma
                    # column 2t + (r & 1) -> output column 4 (2t + (r & 1)) + j;
                    # the four n-tiles of one r are four consecutive columns,
                    # the kernel's one 16-byte store into the tile sum
                    for j in range(4):
                        for r in range(4):
                            red[w, g_ix + 8 * (r >> 1),
                                4 * (2 * t_ix + (r & 1)) + j] = acc[j][r]
                tile = red.sum(axis=0)           # integers: order is moot
                if int4:
                    assert (tile % 16 == 0).all()
                    tile = tile >> 4
                rows = min(16, m - m0)
                cols = min(32, n - n0)
                out[gi, m0:m0 + rows, n0:n0 + cols] = tile[:rows, :cols]
    return out.astype(np.int32)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("g,m,k,n", [(1, 32, 256, 256), (8, 8, 32, 256),
                                     (1, 5, 1024, 40), (3, 17, 96, 264),
                                     (2, 16, 576, 8)])
def test_int8_dot_partition_matches_plain(g, m, k, n, int4):
    """Exact against the plain version: one warp, idle warps, several
    passes, ragged rows and columns."""
    rng = np.random.default_rng(g * 1000 + k + n)
    a = rng.integers(-8, 8, (g, m, k)).astype(np.int8)
    bv = rng.integers(-8, 8, (g, k, n)).astype(np.int8)
    b = np.stack([PF.pack_int4(x) for x in bv]) if int4 else bv
    got = emulate_int8_dot(a, b, int4)
    plain = PF._int4_dot_plain if int4 else PF._int8_dot_plain
    want = np.stack([plain(torch.from_numpy(a[i]),
                           torch.from_numpy(b[i])).numpy() for i in range(g)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["int8_dot", "int8_dot_batched",
                                  "int4_dot"])
def test_int8_dot_partition_matches_pallas(recorded, name):
    ref = _load("probe_features")
    np.random.seed(11)
    assert ref.PROBES[name]() == "exact"
    (a, b), want = recorded[-1]
    int4 = name == "int4_dot"
    if int4:
        b = PF.pack_int4(np.asarray(b).astype(np.int8))
    a, b = np.asarray(a), np.asarray(b)
    batched = a.ndim == 3
    got = emulate_int8_dot(a if batched else a[None],
                           b if batched else b[None], int4)
    np.testing.assert_array_equal(got if batched else got[0], want)


@pytest.mark.parametrize("r", range(4))
def test_int8_dot_tile_sum_store(r):
    """The epilogue's store of register r: the four n-tiles are four
    consecutive, 16-byte aligned columns of one row of the tile sum (rows of
    32 + 4 ints), every output column of the tile is written once over the
    four registers, and each quarter warp's eight 16-byte stores hit 32
    distinct banks."""
    stride = 32 + 4
    g, t = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    row = g + 8 * (r >> 1)
    cols = np.stack([4 * (2 * t + (r & 1)) + j for j in range(4)], -1)
    assert (np.diff(cols, axis=-1) == 1).all() and (cols[..., 0] % 4 == 0).all()
    word = row * stride + cols[..., 0]                   # [8 (g), 4 (t)]
    assert (word % 4 == 0).all()
    lanes = word.reshape(-1)                             # lane 4g + t
    for q in range(4):
        banks = (lanes[8 * q:8 * q + 8, None] + np.arange(4)) % 32
        assert len(set(banks.reshape(-1).tolist())) == 32
    written = np.zeros((16, 32), int)
    for rr in range(4):
        rows = np.broadcast_to(g + 8 * (rr >> 1), (8, 4))
        for j in range(4):
            np.add.at(written, (rows, 4 * (2 * t + (rr & 1)) + j), 1)
    assert (written == 1).all()
