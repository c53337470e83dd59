"""Device-side layout of quantized linear weights (PyTorch port).

Counterpart of exllamav2_tpu/quant/qtensor.py with the same plane layout,
word for word, so both packages hold identical bits:

  * mixed-bit-width matrices split into per-bit-width *segments* of K-rows;
  * odd widths decompose into power-of-two **bit planes** (3 = 2+1, 5 = 4+1,
    6 = 4+2) so no value ever crosses a 32-bit word boundary;
  * within every 256-row sub-block, values are packed **strided**: natural row
    r lives in word (r mod Qsb) at bit slot (r div Qsb), Qsb = 256*bp/32;
  * EXL2 per-group scales are uint8 qs in [1,16] plus per-group f32
    q_scale_max/256 (fp16-rounded), or load-time-decoded bf16 rows
    (``scale_f``); GPTQ keeps explicit f32 scales / int32 zeros;
  * act-order is an activation gather through ``perm`` (x[:, perm]).

Plane words are stored as **int32** with the bits of the uint32 words (PyTorch
cannot shift uint32 on the CPU); unpacking masks after an arithmetic shift, so
the sign bits never leak. The CUDA kernel reads them as uint32.

Containers are ``nn.Module``s holding buffers, so ``.to(device)`` and
``state_dict()`` work; static layout facts (bits, rows, ...) are attributes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from exllamav2_tpu_torch.quant import formats as F

__all__ = ["QuantSegment", "GptqSegment", "QuantLinear", "DenseLinear",
           "from_exl2", "from_gptq", "from_dense", "slice_columns",
           "gather_columns", "SUB_BLOCK", "plane_split", "pack_planes"]

# K-rows of every segment are padded to a multiple of this at load time, with
# zero values and zero smax (padded rows dequantize to exactly 0, and the
# matmul zero-pads the matching activation columns).
SUB_BLOCK = 256


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)


def plane_split(bits: int) -> tuple[int, ...]:
    """Decompose a bit width into power-of-two planes (low plane first)."""
    return {1: (1,), 2: (2,), 3: (2, 1), 4: (4,), 5: (4, 1),
            6: (4, 2), 8: (8,)}[bits]


def pack_planes(values: np.ndarray, bits: int) -> list[np.ndarray]:
    """Pack uint values [rows, N] (rows % SUB_BLOCK == 0) into plane arrays.

    Plane p of width bp is uint32 [rows*bp/32, N]; within each 256-row
    sub-block, natural row r maps to word (r mod Qsb), slot (r div Qsb) where
    Qsb = 256*bp/32.
    """
    rows, n = values.shape
    assert rows % SUB_BLOCK == 0, rows
    out = []
    shift = 0
    for bp in plane_split(bits):
        v = (values.astype(np.uint32) >> shift) & ((1 << bp) - 1)
        qsb = SUB_BLOCK * bp // 32
        per = 32 // bp
        # [sb, j, w, n] where natural row = sb*256 + j*qsb + w
        v4 = v.reshape(rows // SUB_BLOCK, per, qsb, n)
        shifts = (np.arange(per, dtype=np.uint32) * bp)[None, :, None, None]
        words = (v4 << shifts).sum(axis=1, dtype=np.uint64) & 0xFFFFFFFF
        out.append(words.reshape(rows * bp // 32, n).astype(np.uint32))
        shift += bp
    return out


def _words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 plane words -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(words).view(np.int32))
    return torch.from_numpy(a.copy()).to(device)


class QuantSegment(nn.Module):
    """One uniform-bit-width run of K-rows of an EXL2 matrix.

    Buffers: ``plane{i}`` int32 [rows_pad*bp/32, N] per plane, ``qscale``
    uint8 [groups_pad, N] (qs in [1, 16]), ``smax`` f32 [groups_pad, 1]
    (q_scale_max/256) and the optional prescaled ``scale_f`` bf16
    [groups_pad, N]. Column-merged and W4A8 segments of the reference are
    not ported yet.
    """

    def __init__(self, planes, qscale, smax, bits: int, plane_bits,
                 rows: int, group_rows: int, scale_f=None):
        super().__init__()
        for i, p in enumerate(planes):
            self.register_buffer(f"plane{i}", p)
        self.register_buffer("qscale", qscale)
        self.register_buffer("smax", smax)
        self.register_buffer("scale_f", scale_f)
        self.bits = int(bits)
        self.plane_bits = tuple(int(b) for b in plane_bits)
        self.rows = int(rows)
        self.group_rows = int(group_rows)

    @property
    def planes(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"plane{i}")
                     for i in range(len(self.plane_bits)))

    @property
    def rows_pad(self) -> int:
        return self.plane0.shape[0] * 32 // self.plane_bits[0]

    def replace(self, planes=None, **cols):
        """Copy with some buffers swapped (slice_columns / prescaling)."""
        kw = dict(qscale=self.qscale, smax=self.smax, scale_f=self.scale_f)
        kw.update(cols)
        return QuantSegment(planes if planes is not None else self.planes,
                            bits=self.bits, plane_bits=self.plane_bits,
                            rows=self.rows, group_rows=self.group_rows, **kw)


class GptqSegment(nn.Module):
    """GPTQ layout: explicit per-group f32 ``scale`` and int32 ``zero``
    [groups_pad, N] (+1 already applied) beside the plane buffers."""

    def __init__(self, planes, scale, zero, bits: int, plane_bits,
                 rows: int, group_rows: int):
        super().__init__()
        for i, p in enumerate(planes):
            self.register_buffer(f"plane{i}", p)
        self.register_buffer("scale", scale)
        self.register_buffer("zero", zero)
        self.bits = int(bits)
        self.plane_bits = tuple(int(b) for b in plane_bits)
        self.rows = int(rows)
        self.group_rows = int(group_rows)

    planes = QuantSegment.planes
    rows_pad = QuantSegment.rows_pad

    def replace(self, planes=None, **cols):
        kw = dict(scale=self.scale, zero=self.zero)
        kw.update(cols)
        return GptqSegment(planes if planes is not None else self.planes,
                           bits=self.bits, plane_bits=self.plane_bits,
                           rows=self.rows, group_rows=self.group_rows, **kw)


class QuantLinear(nn.Module):
    """A quantized linear layer: y = x[:, perm] @ dequant(segments) + bias.

    `n` is the padded (lane-aligned) output width; `n_orig` the logical one.
    ``perm`` is int32 [k] or None, ``bias`` bf16 [n_orig] or None.
    """

    def __init__(self, segments, perm, bias, k: int, n: int, n_orig: int):
        super().__init__()
        self.segments = nn.ModuleList(segments)
        self.register_buffer("perm", perm)
        self.register_buffer("bias", bias)
        self.k = int(k)
        self.n = int(n)
        self.n_orig = int(n_orig)


class DenseLinear(nn.Module):
    """Unquantized linear: y = x @ weight + bias. weight [K, N] bf16."""

    def __init__(self, weight, bias=None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)


def _pad2d(a: np.ndarray, rows: int, cols: int, fill=0) -> np.ndarray:
    out = np.full((rows, cols), fill, dtype=a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _bf16(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device).to(
        torch.bfloat16)


def from_exl2(t: F.Exl2Tensor, lane_pad: int = 128, *,
              device) -> QuantLinear:
    """Build the device layout from a parsed EXL2 tensor set."""
    n_pad = _round_up(t.n, lane_pad)
    q_all = F.exl2_unpack(t)                               # [K, N] ints, stored order
    qs_all = F.unpack_rows_4(t.q_scale, t.n)               # [G, N] in [1,16]
    smax_all = (t.q_scale_max.astype(np.float16)
                / np.float16(256)).astype(np.float32)      # fp16-rounded /256
    segs = []
    for seg in t.segments():
        rows_pad = _round_up(seg.rows, _lcm(SUB_BLOCK, seg.group_rows))
        groups_pad = rows_pad // seg.group_rows
        q = _pad2d(q_all[seg.row_start:seg.row_start + seg.rows],
                   rows_pad, n_pad, fill=2 ** (seg.bits - 1))
        qs = _pad2d(qs_all[seg.group_start:seg.group_start + seg.groups],
                    max(groups_pad, seg.groups), n_pad, fill=1)
        smax = np.zeros((max(groups_pad, seg.groups), 1), np.float32)
        smax[:seg.groups, 0] = smax_all[
            seg.group_start:seg.group_start + seg.groups]
        planes = pack_planes(q, seg.bits)
        segs.append(QuantSegment(
            planes=tuple(_words_to_tensor(p, device) for p in planes),
            qscale=torch.from_numpy(qs.astype(np.uint8)).to(device),
            smax=torch.from_numpy(smax).to(device),
            bits=seg.bits, plane_bits=plane_split(seg.bits),
            rows=seg.rows, group_rows=seg.group_rows))
    perm = None
    if t.q_invperm is not None:
        perm = torch.from_numpy(
            np.argsort(t.q_invperm).astype(np.int32)).to(device)
    bias = None if t.bias is None else _bf16(t.bias, device)
    return QuantLinear(segments=segs, perm=perm, bias=bias,
                       k=t.k, n=n_pad, n_orig=t.n)


def from_gptq(t: F.GptqTensor, lane_pad: int = 128, *,
              device) -> QuantLinear:
    """Build the device layout from a parsed GPTQ tensor set.

    Act-order (g_idx) rows are reordered so groups are contiguous and the
    activation gather through `perm` compensates.
    """
    q, zeros = F.gptq_unpack(t)
    gs = t.group_size
    perm = None
    if t.g_idx is not None and not np.all(t.g_idx == np.arange(t.k) // gs):
        # act-order checkpoints assign exactly group_size rows per group
        counts = np.bincount(t.g_idx, minlength=t.groups)
        if not np.all(counts == gs):
            raise ValueError("non-uniform g_idx groups unsupported")
        order = np.argsort(t.g_idx, kind="stable")
        q = q[order]
        perm = torch.from_numpy(order.astype(np.int32)).to(device)
    n_pad = _round_up(t.n, lane_pad)
    rows_pad = _round_up(t.k, _lcm(SUB_BLOCK, gs))
    groups_pad = max(rows_pad // gs, t.groups) if gs <= rows_pad \
        else t.groups
    qp = _pad2d(q, rows_pad, n_pad, fill=0)
    # pad columns of q with the group zero so padded cols dequantize to 0
    if n_pad != t.n:
        gi = np.minimum(np.arange(rows_pad) // gs, t.groups - 1)
        qp[:, t.n:] = zeros[gi, :1]
    zp = _pad2d(zeros.astype(np.int32), groups_pad, n_pad, fill=0)
    if n_pad != t.n:
        zp[:zeros.shape[0], t.n:] = zeros[:, :1]
    sp = _pad2d(t.scales.astype(np.float16).astype(np.float32),
                groups_pad, n_pad, fill=0.0)
    seg = GptqSegment(
        planes=tuple(_words_to_tensor(p, device)
                     for p in pack_planes(qp, t.bits)),
        scale=torch.from_numpy(sp).to(device),
        zero=torch.from_numpy(zp).to(device),
        bits=t.bits, plane_bits=plane_split(t.bits),
        rows=t.k, group_rows=gs)
    bias = None if t.bias is None else _bf16(t.bias, device)
    return QuantLinear(segments=[seg], perm=perm, bias=bias,
                       k=t.k, n=n_pad, n_orig=t.n)


def _seg_columns(seg, take):
    """Apply a column selector to every [*, N] buffer of a segment."""
    planes = tuple(take(p) for p in seg.planes)
    if isinstance(seg, GptqSegment):
        return seg.replace(planes, scale=take(seg.scale),
                           zero=take(seg.zero))
    return seg.replace(planes, qscale=take(seg.qscale),
                       scale_f=None if seg.scale_f is None
                       else take(seg.scale_f))


def slice_columns(lin, beg: int, end: int):
    """Slice out-features [beg, end) of a linear (fused-QKV / gate_up
    splitting). Every per-segment array has N as its last axis, so a column
    slice is a clean slice of planes + scales; rows/perm are unchanged."""
    def take(a):
        return a[:, beg:end].contiguous()

    if isinstance(lin, DenseLinear):
        return DenseLinear(
            weight=take(lin.weight),
            bias=None if lin.bias is None else lin.bias[beg:end].clone())
    segs = [_seg_columns(s, take) for s in lin.segments]
    bias = None if lin.bias is None else lin.bias[beg:end].clone()
    return QuantLinear(segments=segs, perm=lin.perm, bias=bias,
                       k=lin.k, n=end - beg, n_orig=end - beg)


def gather_columns(lin, idx):
    """Gather out-features by index array (InternLM2 altpack fused-qkv
    unpacking). idx must be a 1-D int array; the result keeps k/perm."""
    idx_np = np.asarray(idx, dtype=np.int64)
    dev = (lin.weight if isinstance(lin, DenseLinear)
           else lin.segments[0].plane0).device
    it = torch.from_numpy(idx_np).to(dev)

    def take(a):
        return torch.index_select(a, 1, it).contiguous()

    if isinstance(lin, DenseLinear):
        return DenseLinear(
            weight=take(lin.weight),
            bias=None if lin.bias is None else lin.bias[it])
    segs = [_seg_columns(s, take) for s in lin.segments]
    bias = None if lin.bias is None else lin.bias[it]
    n = int(idx_np.shape[0])
    return QuantLinear(segments=segs, perm=lin.perm, bias=bias,
                       k=lin.k, n=n, n_orig=n)


def from_dense(weight: np.ndarray, bias: np.ndarray | None = None, *,
               device) -> DenseLinear:
    """FP16/BF16 layer ([K, N] input layout)."""
    return DenseLinear(
        weight=_bf16(weight, device),
        bias=None if bias is None else _bf16(bias, device))
