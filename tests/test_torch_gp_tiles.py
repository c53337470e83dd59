"""The tile map of the gp kernel (group partials), emulated on the CPU.

csrc/perf_qmm.cu `gp_kernel<BP, INT8, GR, VEC>` runs on mma.sync tiles: the
weights are A (16 output columns), the 8 activation rows are B, int8
m16n8k32 (int32 tile) or bf16 m16n8k16 (f32 tile). K-step s of a 256-row
unit covers rows 32s .. 32s+31 in natural order: lane (g, t) feeds k =
4t..4t+3 from rows 32s+4t+i and k = 16+4t.. from rows 32s+16+4t+i. Rows
4q..4q+3 are one slot of four consecutive words of the strided plane; the
lane takes a slot's byte of each word of a run of four with a
4x4 byte transpose (prmt) of the raw bytes, then one shift and
one mask of the register. bf16 mode ORs 0x43 above each value and
subtracts bf16 136 (8-bit values through f32 2^23 + q); int8 mode uses the
bytes as they are and takes the group sums of xq from an mma against ones.
Groups of 16 in int8 mode take one mma a group with the other half's B
zeroed. Per group the epilogue adds (f32(p) - 8 x1) * s or p * s to an f32
sum; the K warps' sums meet in order, then the cluster's blocks in rank
order.

These tests emulate that map in numpy, with the prmt selectors of the
source, as the PTX fragment layouts define them, and hold it against the
port's plain version and the JAX reference's Pallas kernels in interpret
mode; and that it takes the nibble kernel's split picker.
"""

import inspect

import numpy as np
import pytest
import torch

from exllamav2_tpu_torch.tools import perf_qmm as T

from test_torch_tools import _ref_perf, recorded  # noqa: F401
from torch_prmt import U32, byte_of4, byte_perm

WARPS = 8                      # warps of a block


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs(bits):
    return bits // 2 if bits >= 2 else 1


def _lane_words(words, bits, u):
    """The plane words lane t holds for unit u: [runs, 4 (i), 4 (t), nb, 8
    (g), 4 (c)], run r word 16r + 4t + i (bits 1: 4(t&1) + i, shifted right
    by t >> 1) of column 32 nb + 4g + c."""
    qsb, nb = 8 * bits, words.shape[1] // 32
    w = np.zeros((_runs(bits), 4, 4, nb, 8, 4), U32)
    for t in range(4):
        w0 = 4 * (t & 1) if bits == 1 else 4 * t
        for r in range(_runs(bits)):
            for i in range(4):
                w[r, i, t] = words[u * qsb + 16 * r + w0 + i].reshape(nb, 8, 4)
        if bits == 1:
            w[:, :, t] >>= U32(t >> 1)
    return w


def _slot_values(w, bits, s, h):
    """slot_values of the source for every lane and column: [4 (t), nb, 8,
    4] registers, byte i the value of row 32s + 16h + 4t + i (the raw bytes
    transposed, then one shift and one mask)."""
    r = 0 if bits == 1 else ((8 * s + 4 * h) % (2 * bits)) // 4
    j = 4 * s + 2 * h if bits == 1 else (8 * s + 4 * h) // (2 * bits)
    field = 0xFFFFFFFF if bits == 8 else ((1 << bits) - 1) * 0x01010101
    raw = byte_of4(w[r, 0], w[r, 1], w[r, 2], w[r, 3], (bits * j) // 8)
    return (raw >> U32((bits * j) % 8)) & U32(field)


def _bf16_bits_value(h16):
    """bf16 bit patterns (uint16 held in uint32) -> float64 values."""
    return (np.asarray(h16, U32) << U32(16)).view(np.float32).astype(
        np.float64)


def _bf16_pair(v, bits, p):
    """bf16_pair of the source -> [..., 2] float64 values (q - 8 of bytes
    2p, 2p + 1), checked to be exact bf16 values."""
    if bits == 8:
        vals = []
        for e in range(2):
            f = byte_perm(v, 0x4B000000, 0x7440 + 2 * p + e).view(
                np.float32) - np.float32(8388616.0)
            vals.append(f.astype(np.float64))
        out = np.stack(vals, axis=-1)
    else:
        h = byte_perm(v, 0x43, 0x4140 if p == 0 else 0x4342)
        lo = _bf16_bits_value(h & U32(0xFFFF))
        hi = _bf16_bits_value(h >> U32(16))
        out = np.stack([lo, hi], axis=-1) - 136.0   # exact: bf16 integers
    # every value is an integer in [-8, 247]: exact in bf16 (8 bits)
    assert (out == np.round(out)).all() and (np.abs(out) <= 247).all()
    return out


def _int8_bytes(regs):
    """uint32 registers -> [..., 4] int8 values, byte i little-endian."""
    b = (regs[..., None] >> (U32(8) * np.arange(4, dtype=U32))) & U32(0xFF)
    return b.astype(np.uint8).view(np.int8).astype(np.int64)


_BF16_KMAP = np.array([4 * ((kk % 8) // 2) + 2 * (kk // 8) + kk % 2
                       for kk in range(16)])


def emulate_gp(x, plane, qs, smax, bits, gr, kt, nt):
    """gp_kernel on numpy arrays (x int8 [8, K], or f32 holding bf16 values;
    plane uint32 [K*bits/32, N]; qs uint8 [G, N]; smax f32 [G]) with K rows
    a split and nt columns a block -> (group tiles [G, 8, N] as the
    epilogue meets them: int64 in int8 mode, float64 sums of the exact
    products in bf16 mode; y f32 [8, N])."""
    int8 = x.dtype == np.int8
    k, n = x.shape[1], plane.shape[1]
    groups = k // gr
    npad = -(-n // nt) * nt
    words = np.zeros((k * bits // 32, npad), U32)
    words[:, :n] = plane
    qsp = np.zeros((groups, npad), np.int64)
    qsp[:, :n] = qs
    nb = npad // 32
    warps_k = WARPS // (nt // 32)
    units, per = k // 256, kt // 256
    splits = -(-units // per)
    f32 = np.float32
    xv = x.astype(np.int64) if int8 else x.astype(np.float64)
    tiles = np.zeros((groups, 8, npad), np.int64 if int8 else np.float64)
    col = (32 * np.arange(nb)[:, None, None] + 4 * np.arange(8)[None, :, None]
           + np.arange(4)[None, None, :])                     # [nb, 8, 4]

    def epilogue(acc, c, cx, grp):
        """c [2 (p), 16, 8] float64/int64 per column block: A rows g / g+8
        are columns 4g + 2p / 4g + 2p + 1; B column j is activation row j."""
        tiles_g = np.zeros((8, npad), c.dtype)
        for p in range(2):
            for e in range(2):
                tiles_g[:, col[:, :, 2 * p + e]] = np.moveaxis(
                    c[:, p, 8 * e:8 * e + 8, :], -1, 0)
        tiles[grp] = tiles_g
        q = qsp[grp]
        s = ((q * q).astype(f32) * f32(smax[grp])).astype(
            np.float16).astype(f32)                           # [npad]
        if int8:
            z = f32(8) * cx.astype(f32)                       # [8]
            v = tiles_g.astype(f32) - z[:, None]
        else:
            v = tiles_g.astype(f32)          # the f32 tile of the mma
        return acc + v * s[None, :]

    def a_tile(regs):
        """regs [4 (r), 4 (t), nb, 8 (g)] int8 registers -> A [nb, 16, 32]:
        register r of lane (g, t) holds row g + 8 (r & 1), k = 16 (r >> 1) +
        4t + i."""
        a = np.zeros((nb, 16, 32), np.int64)
        vals = _int8_bytes(regs)                          # [r, t, nb, g, 4]
        for r in range(4):
            for t in range(4):
                for i in range(4):
                    a[:, np.arange(8) + 8 * (r & 1),
                      16 * (r >> 1) + 4 * t + i] = vals[r, t, :, :, i]
        return a

    def a_tile_bf16(pairs):
        """pairs [4 (r), 4 (t), nb, 8 (g), 2] -> A [nb, 16, 16]: a_r of lane
        (g, t) is row g + 8 (r & 1), k = 8 (r >> 1) + 2t + i."""
        a = np.zeros((nb, 16, 16))
        for r in range(4):
            for t in range(4):
                for i in range(2):
                    a[:, np.arange(8) + 8 * (r & 1),
                      8 * (r >> 1) + 2 * t + i] = pairs[r, t, :, :, i]
        return a

    accs = {}
    for r in range(splits):
        for wk in range(warps_k):
            acc = np.zeros((8, npad), f32)
            for u in range(r * per + wk, min((r + 1) * per, units), warps_k):
                w = _lane_words(words, bits, u)
                c = cx = None
                for s in range(8):
                    v = [_slot_values(w, bits, s, h) for h in range(2)]
                    if int8:
                        # B: k = 4t + i from row 32s + 4t + i, k = 16 + 4t +
                        # i from row 32s + 16 + 4t + i, column g = row g of xq
                        rows = u * 256 + 32 * s + np.arange(32)
                        b = xv[:, rows].T                         # [32, 8]
                        halves = [(0, 32)] if gr >= 32 else [(0, 16),
                                                             (16, 32)]
                        for hh, (k0, k1) in enumerate(halves):
                            bz = np.zeros_like(b)
                            bz[k0:k1] = b[k0:k1]                  # zeroed B
                            if gr == 16 or (32 * s) % gr == 0:
                                c = np.zeros((nb, 2, 16, 8), np.int64)
                                cx = np.zeros(8, np.int64)
                            for p in range(2):
                                regs = np.stack(
                                    [v[0][..., 2 * p], v[0][..., 2 * p + 1],
                                     v[1][..., 2 * p], v[1][..., 2 * p + 1]])
                                c[:, p] += a_tile(regs) @ bz
                            cx += bz.sum(axis=0)          # the ones-mma
                            if gr == 16:
                                acc = epilogue(acc, c, cx,
                                               (u * 256 + 32 * s) // 16 + hh)
                            elif (32 * (s + 1)) % gr == 0:
                                acc = epilogue(acc, c, cx,
                                               (u * 256 + 32 * s) // gr)
                    else:
                        for h in range(2):
                            # k 2t + e <- row 4t + e, k 2t + 8 + e <- row
                            # 4t + 2 + e of the half
                            kmap = u * 256 + 32 * s + 16 * h + _BF16_KMAP
                            b = xv[:, kmap].T                     # [16, 8]
                            if gr == 16 or (h == 0 and (32 * s) % gr == 0):
                                c = np.zeros((nb, 2, 16, 8))
                            for p in range(2):
                                pairs = np.stack(
                                    [_bf16_pair(v[h][..., 2 * p + e], bits,
                                                pp)
                                     for pp, e in ((0, 0), (0, 1), (1, 0),
                                                   (1, 1))])
                                c[:, p] += a_tile_bf16(pairs) @ b
                            if gr == 16:
                                acc = epilogue(acc, c, None,
                                               (u * 256 + 32 * s + 16 * h)
                                               // 16)
                            elif h == 1 and (32 * (s + 1)) % gr == 0:
                                acc = epilogue(acc, c, None,
                                               (u * 256 + 32 * s) // gr)
            accs[r, wk] = acc
    y = np.zeros((8, npad), f32)
    for r in range(splits):
        blk = np.zeros((8, npad), f32)
        for wk in range(warps_k):
            blk = blk + accs[r, wk]
        y = y + blk
    return tiles[:, :, :n], y[:, :n]


def _gp_inputs(k, n, bits, gr, mode, seed):
    plane, qs, smax, x = T.mk_inputs(k, n, "cpu", seed=seed, bits=bits,
                                     gr=gr)
    xa = T.quantize_x(x) if mode == "int8" else x.to(torch.bfloat16)
    return xa, plane, qs, smax


def _np(xa, plane, qs, smax):
    x = xa.numpy() if xa.dtype == torch.int8 else xa.float().numpy()
    return (x, plane.numpy().view(U32), qs.numpy(), smax.numpy().reshape(-1))


def _group_dots(x, plane, bits, gr):
    """Exact [G, 8, N] group dots: xq . int8(v) (int8) or x . (v - 8)."""
    vals = T.D.unpack_plane(torch.from_numpy(plane.view(np.int32)), bits)
    vals = vals.numpy().astype(np.int64)
    k, n = vals.shape
    if x.dtype == np.int8:
        w = vals.astype(np.uint8).view(np.int8).astype(np.int64)
        xg = x.astype(np.int64)
    else:
        w = vals - 8
        xg = x.astype(np.float64)
    return np.einsum("mgr,grn->gmn", xg.reshape(8, k // gr, gr),
                     w.reshape(k // gr, gr, n).astype(xg.dtype))


# (k, kt, nt): splits of two units with idle K warps, one split with two
# units a K warp, four splits of one unit with 4 K warps
_TILINGS = [(1024, 512, 32), (2048, 2048, 64), (1024, 256, 64)]


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("gr", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_gp_fragments_match_plain(bits, gr, mode):
    """N = 392 (a ragged column block). The emulated tiles equal the exact
    group dots (int8: bit for bit; bf16: the sum of exact products); y is
    within 1e-4 (bf16) / 1e-5 (int8) of max |plain|, the f32 sums' order."""
    k, kt, nt = _TILINGS[(bits + gr) % len(_TILINGS)]
    n = 392
    inputs = _gp_inputs(k, n, bits, gr, mode, seed=bits * 1000 + gr)
    x, plane, qs, smax = _np(*inputs)
    tiles, y = emulate_gp(x, plane, qs, smax, bits, gr, kt, nt)
    want_tiles = _group_dots(x, plane, bits, gr)
    if mode == "int8":
        np.testing.assert_array_equal(tiles, want_tiles)
    else:
        np.testing.assert_allclose(tiles, want_tiles, rtol=1e-12,
                                   atol=1e-9)
    want = T.gp_plain(*inputs, bits, gr).numpy()
    tol = 1e-5 if mode == "int8" else 1e-4
    assert np.abs(y - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("gr", [32, 128])
@pytest.mark.parametrize("mode,tol", [("bf16", 1e-4), ("int8", 1e-5)])
def test_gp_fragments_match_pallas(recorded, monkeypatch, mode, tol, gr):
    """The reference's gp kernel in interpret mode, on its own recorded
    inputs (4 bits, the tool's default)."""
    ref = _ref_perf(monkeypatch, [(512, 256)], gr)
    ref.VARIANTS["gp_" + mode]()
    (x, plane, qs, smax), want = recorded[-1]
    if mode == "bf16":
        x = np.asarray(x, np.float32)
    kt, nt = T.nibble_tiles(512, 256, 4)
    _, y = emulate_gp(np.asarray(x), np.asarray(plane, U32), qs,
                      np.asarray(smax).reshape(-1), 4, gr, kt, nt)
    assert np.abs(y - want).max() <= tol * np.abs(want).max()


def test_gp_takes_the_nibble_picker():
    """gp's grid is the nibble kernel's (8-warp blocks, a cluster of K
    splits), so gp takes `nibble_tiles` at its defaults and no hints of its
    own; test_torch_tool_tiles.py holds the picker's properties."""
    assert list(inspect.signature(T.gp).parameters) == [
        "x", "plane", "qs", "smax", "bits", "gr"]
    assert "nibble_tiles(k, n, sm_count(x.device))" in inspect.getsource(T.gp)
