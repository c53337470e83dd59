"""Quantized-weight storage formats: EXL2 and GPTQ.

Copy of exllamav2_tpu/quant/formats.py: this package imports
nothing of the JAX package, whose __init__ imports JAX.

Pure-numpy reference codecs (pack / unpack / dequantize). These are the golden
implementations every accelerated kernel is tested against, and the packers the
converter uses to emit checkpoints compatible with the reference ecosystem.

Format semantics re-derived from the reference implementation:
  - EXL2 bit-stream packing:   exllamav2_ext/cuda/pack_tensor.cu:100-266 (pack_columns)
  - EXL2 scale packing:        exllamav2_ext/cuda/pack_tensor.cu:10-52  (pack_rows_4)
  - EXL2 scale decode:         exllamav2_ext/cuda/quant/qdq_util.cuh:24-31 (dq_scale,
                               q_scale_max premultiplied by 1/256 in ext.py:335)
  - EXL2 group table:          conversion/adaptivegptq.py:608-676 (pack),
                               ext.py:300-316 (make_group_map_py)
  - EXL2 act-order:            module.py:119-121 (q_perm = argsort(q_invperm))
  - GPTQ packing + zero offset: cuda/q_matrix.cu:204-327 (reconstruct_gptq_kernel,
                               zeros + 1), ext.py:360-366

Storage layout summary
----------------------
An EXL2 linear layer with weight W^T of shape [K, N] (K = in_features rows,
N = out_features columns) stores:

  q_weight    int32 [qrows, N]   per-column little-endian bit-stream along K,
                                 segmented into groups of uniform bit width
  q_scale     int32 [groups, N*4/32]  4-bit packed per-group/column scales, stored
                                 value = qs - 1 with qs in [1, 16]
  q_scale_max f16   [groups]     per-group max scale
  q_groups    int16 [groups*2]   pairs (bits, qrow_start)
  q_invperm   int32 [K]          row invperm (act-order); stored row j holds
                                 original row perm[j] where perm = argsort(invperm)

Dequantization:  scale[g, n] = fp16((qs[g, n] + 1)^2 * q_scale_max[g] / 256)
                 w[k, n]     = (q[k, n] - 2^(bits-1)) * scale[group(k), n]
with k indexing the *stored* (permuted) row order.

A GPTQ layer stores:
  qweight int32 [K/8, N]   4-bit (or 2/3/8-bit) packed along K, row-major words
  qzeros  int32 [groups, N*bits/32]  packed zero points, stored value = zero - 1
  scales  f16   [groups, N]
  g_idx   int32 [K]        group index per row (act-order when non-trivial)

Dequantization:  w[k, n] = (q[k, n] - (qz[g_idx[k], n] + 1)) * scales[g_idx[k], n]
"""

from __future__ import annotations

import dataclasses
import numpy as np

__all__ = [
    "Exl2Segment",
    "Exl2Tensor",
    "GptqTensor",
    "pack_bitstream",
    "unpack_bitstream",
    "pack_rows_4",
    "unpack_rows_4",
    "exl2_decode_scales",
    "exl2_pack",
    "exl2_unpack",
    "exl2_dequantize",
    "gptq_pack",
    "gptq_unpack",
    "gptq_dequantize",
]


# ---------------------------------------------------------------------------
# Bit-stream packing (the EXL2 "pack_columns" layout)
# ---------------------------------------------------------------------------

def pack_bitstream(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack uint values [rows, N] into int32 words [ceil(rows*bits/32), N].

    Per column, value i occupies bits [i*bits, (i+1)*bits) of the column's
    little-endian word stream (words advance along axis 0).
    """
    rows, n = values.shape
    assert 1 <= bits <= 8
    v = values.astype(np.uint64) & ((1 << bits) - 1)
    qrows = -(-(rows * bits) // 32)
    out = np.zeros((qrows, n), dtype=np.uint64)
    for i in range(rows):
        j = i * bits
        w, s = j // 32, j % 32
        out[w] |= v[i] << s
        if s + bits > 32:
            out[w + 1] |= v[i] >> (32 - s)
    return (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def unpack_bitstream(packed: np.ndarray, bits: int, rows: int) -> np.ndarray:
    """Inverse of pack_bitstream -> uint8/uint16 [rows, N]."""
    p = packed.view(np.uint32).astype(np.uint64)
    qrows, n = p.shape
    out = np.empty((rows, n), dtype=np.uint16)
    mask = (1 << bits) - 1
    for i in range(rows):
        j = i * bits
        w, s = j // 32, j % 32
        val = p[w] >> s
        if s + bits > 32:
            val |= p[w + 1] << (32 - s)
        out[i] = (val & mask).astype(np.uint16)
    return out


# ---------------------------------------------------------------------------
# 4-bit row packing for scales (pack_rows_4: 8 values per word along N)
# ---------------------------------------------------------------------------

def pack_rows_4(values: np.ndarray) -> np.ndarray:
    """Pack uint16 scales [G, N] (values in [1, 16]) into int32 [G, N/8].

    Stored value is (v - 1) in 4 bits, LSB-first along N.
    """
    g, n = values.shape
    assert n % 8 == 0
    v = (values.astype(np.uint32) - 1) & 0xF
    v = v.reshape(g, n // 8, 8)
    shifts = np.arange(8, dtype=np.uint32) * 4
    packed = (v << shifts[None, None, :]).sum(axis=-1, dtype=np.uint64)
    return (packed & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def unpack_rows_4(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_rows_4 -> uint16 [G, N] with values in [1, 16]."""
    p = packed.view(np.uint32)
    g = p.shape[0]
    shifts = np.arange(8, dtype=np.uint32) * 4
    v = (p[:, :, None] >> shifts[None, None, :]) & 0xF
    return (v.reshape(g, -1)[:, :n] + 1).astype(np.uint16)


# ---------------------------------------------------------------------------
# EXL2
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Exl2Segment:
    """A contiguous run of K-rows quantized at one bit width.

    Within a segment every group spans `group_rows` rows (the trailing group of
    the matrix may be short; `rows` accounts for that).
    """
    bits: int
    row_start: int      # first K-row (stored order)
    rows: int           # number of K-rows
    qrow_start: int     # first packed word-row in q_weight
    qrows: int          # number of packed word-rows
    group_start: int    # first group index
    groups: int         # number of groups
    group_rows: int     # rows per group (last group may be shorter)


@dataclasses.dataclass
class Exl2Tensor:
    """Parsed EXL2 tensor set for one linear layer (stored/permuted row order)."""
    k: int                       # in_features
    n: int                       # out_features (possibly padded to 32 by packer)
    q_weight: np.ndarray         # int32 [qrows, n]
    q_scale: np.ndarray          # int32 [groups, n*4/32]
    q_scale_max: np.ndarray      # f16   [groups]
    q_groups: np.ndarray         # int16 [groups*2]
    q_invperm: np.ndarray | None  # int32 [k]
    bias: np.ndarray | None = None

    @property
    def groups(self) -> int:
        return self.q_scale_max.shape[0]

    def segments(self) -> list[Exl2Segment]:
        return exl2_segments(self.q_groups, self.q_weight.shape[0], self.k)


def exl2_segments(q_groups: np.ndarray, num_qrows: int, k: int) -> list[Exl2Segment]:
    """Derive per-bit-width row segments from the q_groups table.

    Mirrors the group walk in q_matrix.cu:131-160 / ext.py:300-316, then merges
    adjacent same-width groups into segments.
    """
    gr = np.asarray(q_groups).astype(np.int64)
    num_groups = len(gr) // 2
    raw = []  # (bits, row_start, rows, qrow_start, qrows, group_idx)
    row = 0
    for i in range(num_groups):
        bits = int(gr[i * 2])
        qrow_start = int(gr[i * 2 + 1])
        if i < num_groups - 1:
            qrows = int(gr[i * 2 + 3]) - qrow_start
            rows = qrows * 32 // bits
        else:
            qrows = num_qrows - qrow_start
            rows = k - row
        raw.append((bits, row, rows, qrow_start, qrows, i))
        row += rows
    assert row == k, f"group table covers {row} rows, expected {k}"

    segments: list[Exl2Segment] = []
    for bits, row_start, rows, qrow_start, qrows, gidx in raw:
        last = segments[-1] if segments else None
        if (last is not None and last.bits == bits
                and rows == last.group_rows
                and last.row_start + last.rows == row_start):
            segments[-1] = dataclasses.replace(
                last, rows=last.rows + rows, qrows=last.qrows + qrows,
                groups=last.groups + 1)
        else:
            segments.append(Exl2Segment(
                bits=bits, row_start=row_start, rows=rows,
                qrow_start=qrow_start, qrows=qrows,
                group_start=gidx, groups=1, group_rows=rows))
    # Allow a short trailing group to merge into the previous segment
    merged: list[Exl2Segment] = []
    for seg in segments:
        last = merged[-1] if merged else None
        if (last is not None and last.bits == seg.bits and seg.groups == 1
                and seg.rows < last.group_rows
                and last.row_start + last.rows == seg.row_start):
            merged[-1] = dataclasses.replace(
                last, rows=last.rows + seg.rows, qrows=last.qrows + seg.qrows,
                groups=last.groups + 1)
        else:
            merged.append(seg)
    return merged


def exl2_decode_scales(q_scale: np.ndarray, q_scale_max: np.ndarray,
                       n: int) -> np.ndarray:
    """Per-group/column dequant scales, f32 [groups, N].

    Matches the fp16 rounding of dq_scale (qdq_util.cuh:24-31): the stored
    q_scale_max is multiplied by 1/256 in fp16 on load (ext.py:335), then
    (qs+1)^2 * max is one fp16 multiply.
    """
    qs = unpack_rows_4(q_scale, n).astype(np.float32)          # in [1, 16]
    smax = (q_scale_max.astype(np.float16) / np.float16(256)).astype(np.float16)
    scales = (qs * qs).astype(np.float16) * smax[:, None]
    return scales.astype(np.float32)


def exl2_unpack(t: Exl2Tensor) -> np.ndarray:
    """Unpack quantized integers -> uint16 [K, N] in stored row order."""
    out = np.empty((t.k, t.n), dtype=np.uint16)
    for seg in t.segments():
        packed = t.q_weight[seg.qrow_start:seg.qrow_start + seg.qrows]
        out[seg.row_start:seg.row_start + seg.rows] = \
            unpack_bitstream(packed, seg.bits, seg.rows)
    return out


def exl2_dequantize(t: Exl2Tensor, original_order: bool = True) -> np.ndarray:
    """Dequantize to f32 [K, N]; rows in original order unless told otherwise."""
    q = exl2_unpack(t).astype(np.float32)
    scales = exl2_decode_scales(t.q_scale, t.q_scale_max, t.n)
    w = np.empty_like(q)
    for seg in t.segments():
        r0, r1 = seg.row_start, seg.row_start + seg.rows
        gs = seg.group_rows
        # group index per row within segment
        gi = seg.group_start + np.minimum(
            np.arange(seg.rows) // gs, seg.groups - 1)
        zero = float(2 ** (seg.bits - 1))
        w[r0:r1] = (q[r0:r1] - zero) * scales[gi]
    if original_order and t.q_invperm is not None:
        perm = np.argsort(t.q_invperm)
        out = np.empty_like(w)
        out[perm] = w          # stored row j holds original row perm[j]
        return out
    return w


def exl2_pack(weight: np.ndarray,
              bits_per_group: list[int],
              group_rows: int | dict[int, int] = 32,
              invperm: np.ndarray | None = None,
              scale_range: float = 1.0) -> Exl2Tensor:
    """Quantize+pack an f32 weight [K, N] (stored/permuted row order) to EXL2.

    A simple RTN packer used for tests and as the converter's final packing
    stage (the converter supplies already-quantized ints via exl2_pack_quantized
    instead). `bits_per_group[i]` gives the width of group i; group i covers
    rows [i*gs, (i+1)*gs). Scales are chosen per group/column like
    AdaptiveQuantizer.find_params (conversion/adaptivegptq.py:43-72) minus the
    error-minimizing p-search.
    """
    k, n = weight.shape
    gs_of = (lambda b: group_rows[b]) if isinstance(group_rows, dict) \
        else (lambda b: group_rows)

    qweight_rows = []
    qscale = np.zeros((len(bits_per_group), n), dtype=np.uint16)
    qscale_max = np.zeros((len(bits_per_group),), dtype=np.float16)
    qgroups = np.zeros((len(bits_per_group) * 2,), dtype=np.int16)
    row = 0
    qrow = 0
    quant_ints = []
    for gi, bits in enumerate(bits_per_group):
        rows = min(gs_of(bits), k - row)
        maxq = 2 ** bits - 1
        zero = (maxq + 1) / 2
        x = weight[row:row + rows]
        xmax = np.abs(x).max(axis=0) + 1e-12
        base_scale = xmax / (maxq / 2)
        smax = base_scale.max() * scale_range
        qs = np.sqrt(base_scale / smax) * 16.0
        qs = np.clip(np.round(qs), 1, 16).astype(np.uint16)
        qscale[gi] = qs
        qscale_max[gi] = np.float16(smax)
        scale = exl2_decode_scales(
            pack_rows_4(qs[None, :]), np.array([smax], np.float16), n)[0]
        q = np.clip(np.round(x / scale + zero), 0, maxq).astype(np.uint16)
        quant_ints.append((q, bits))
        qgroups[gi * 2] = bits
        qgroups[gi * 2 + 1] = qrow
        row += rows
        qrow += -(-(rows * bits) // 32)
    assert row == k

    for q, bits in quant_ints:
        qweight_rows.append(pack_bitstream(q, bits))
    return Exl2Tensor(
        k=k, n=n,
        q_weight=np.concatenate(qweight_rows, axis=0),
        q_scale=pack_rows_4(qscale),
        q_scale_max=qscale_max,
        q_groups=qgroups,
        q_invperm=None if invperm is None else invperm.astype(np.int32),
    )


def exl2_pack_quantized(q: np.ndarray, qscale: np.ndarray,
                        qscale_max: np.ndarray, bits_per_group: list[int],
                        group_rows: int | dict[int, int],
                        invperm: np.ndarray | None) -> Exl2Tensor:
    """Pack already-quantized ints (converter path, adaptivegptq.py:608-676)."""
    k, n = q.shape
    gs_of = (lambda b: group_rows[b]) if isinstance(group_rows, dict) \
        else (lambda b: group_rows)
    qweight_rows = []
    qgroups = np.zeros((len(bits_per_group) * 2,), dtype=np.int16)
    row, qrow = 0, 0
    for gi, bits in enumerate(bits_per_group):
        rows = min(gs_of(bits), k - row)
        qgroups[gi * 2] = bits
        qgroups[gi * 2 + 1] = qrow
        qweight_rows.append(pack_bitstream(q[row:row + rows], bits))
        row += rows
        qrow += -(-(rows * bits) // 32)
    assert row == k
    return Exl2Tensor(
        k=k, n=n,
        q_weight=np.concatenate(qweight_rows, axis=0),
        q_scale=pack_rows_4(qscale.astype(np.uint16)),
        q_scale_max=qscale_max.astype(np.float16),
        q_groups=qgroups,
        q_invperm=None if invperm is None else invperm.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# GPTQ
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GptqTensor:
    """Parsed GPTQ tensor set (AutoGPTQ-compatible layout)."""
    k: int
    n: int
    bits: int
    qweight: np.ndarray          # int32 [K*bits/32, N]
    qzeros: np.ndarray           # int32 [groups, N*bits/32]
    scales: np.ndarray           # f16   [groups, N]
    g_idx: np.ndarray | None     # int32 [K]
    bias: np.ndarray | None = None

    @property
    def groups(self) -> int:
        return self.scales.shape[0]

    @property
    def group_size(self) -> int:
        gs = 1
        while gs * self.groups < self.k:
            gs *= 2
        return gs


def gptq_pack(q: np.ndarray, zeros: np.ndarray, scales: np.ndarray,
              bits: int = 4, g_idx: np.ndarray | None = None) -> GptqTensor:
    """Pack quantized ints [K, N], zeros [G, N], scales [G, N] -> GPTQ tensors.

    Stored qzeros hold (zero - 1) per the GPTQ convention (reconstruct adds +1,
    q_matrix.cu:266-270).
    """
    k, n = q.shape
    qweight = pack_bitstream(q, bits)  # row-major along K == GPTQ layout for 4b
    qzeros = pack_bitstream((zeros.astype(np.int64) - 1).T % (1 << bits), bits)
    qzeros = qzeros.T.copy()  # [G, N*bits/32]
    return GptqTensor(
        k=k, n=n, bits=bits, qweight=qweight, qzeros=qzeros,
        scales=scales.astype(np.float16),
        g_idx=None if g_idx is None else g_idx.astype(np.int32))


def gptq_unpack(t: GptqTensor) -> tuple[np.ndarray, np.ndarray]:
    """-> (q [K, N] uint16, zeros [G, N] uint16 with +1 applied)."""
    q = unpack_bitstream(t.qweight, t.bits, t.k)
    zeros = unpack_bitstream(t.qzeros.T.copy(), t.bits, t.n).T
    zeros = ((zeros.astype(np.int64) + 1) % (1 << t.bits)).astype(np.uint16)
    return q, zeros


def gptq_dequantize(t: GptqTensor) -> np.ndarray:
    """Dequantize to f32 [K, N] in original row order."""
    q, zeros = gptq_unpack(t)
    gs = t.group_size
    if t.g_idx is not None and not np.all(t.g_idx == np.arange(t.k) // gs):
        gi = t.g_idx.astype(np.int64)
    else:
        gi = np.arange(t.k) // gs
    scales = t.scales.astype(np.float32)
    return (q.astype(np.float32) - zeros[gi].astype(np.float32)) * scales[gi]
