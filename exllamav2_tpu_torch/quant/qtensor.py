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
    (``scale_f``); GPTQ keeps explicit f32 scales / int32 zeros, and for the
    W4A8 path also their bf16 forms (``scale_bf``, ``zs_bf``);
  * a column-merged segment (q|k|v, gate|up) keeps one smax column per source
    (``src_cols``);
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
           "gather_columns", "SUB_BLOCK", "plane_split", "pack_planes_on"]

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


# elements of one chunk of pack_planes_on: its int32 temporaries stay a few
# times 64 MiB, whatever the size of the tensor being loaded
_PACK_CHUNK = 1 << 24


def pack_planes_on(values: np.ndarray, bits: int, device
                   ) -> tuple[torch.Tensor, ...]:
    """Pack uint values [rows, N] (rows % SUB_BLOCK == 0, values < 256) into
    plane words on `device`, by torch ops there: one int32 tensor a plane.

    Plane p of width bp is [rows*bp/32, N]; within each 256-row sub-block,
    natural row r maps to word (r mod Qsb), slot (r div Qsb) where
    Qsb = 256*bp/32. The values go over as bytes and are packed a few
    sub-blocks at a time (on the card, the host's numpy packing of a 7B
    layer takes seconds).
    """
    rows, n = values.shape
    assert rows % SUB_BLOCK == 0, rows
    v8 = torch.from_numpy(np.ascontiguousarray(values).astype(
        np.uint8, copy=False)).to(device)
    split = plane_split(bits)
    out = [torch.empty((rows * bp // 32, n), dtype=torch.int32,
                       device=v8.device) for bp in split]
    step = max(1, _PACK_CHUNK // (SUB_BLOCK * n))
    for sb in range(0, rows // SUB_BLOCK, step):
        v = v8[sb * SUB_BLOCK:(sb + step) * SUB_BLOCK].to(torch.int32)
        nsb = v.shape[0] // SUB_BLOCK
        shift = 0
        for bp, plane in zip(split, out):
            qsb = SUB_BLOCK * bp // 32
            # [sb, j, w, n] where natural row = sb*256 + j*qsb + w
            v4 = ((v >> shift) & ((1 << bp) - 1)).reshape(
                nsb, 32 // bp, qsb, n)
            words = v4[:, 0].clone()
            for j in range(1, 32 // bp):     # disjoint fields
                words |= v4[:, j] << (j * bp)
            plane[sb * qsb:(sb + nsb) * qsb] = words.reshape(nsb * qsb, n)
            shift += bp
    return tuple(out)


class QuantSegment(nn.Module):
    """One uniform-bit-width run of K-rows of an EXL2 matrix.

    Buffers: ``plane{i}`` int32 [rows_pad*bp/32, N] per plane, ``qscale``
    uint8 [groups_pad, N] (qs in [1, 16]), ``smax`` f32 [groups_pad, 1]
    (q_scale_max/256) and the optional prescaled ``scale_f`` bf16
    [groups_pad, N].

    ``src_cols`` marks a column-merged segment (ops/dequant.merge_linears):
    the start column of each source matrix; ``smax`` is then
    [groups_pad, n_sources] and a column decodes its scale with its own
    source's smax, so the merge is bitwise exact. ``act8`` routes the fused
    decode path through the W4A8 kernel (ops/dequant.enable_w4a8): int8
    activations, approximate; it needs ``scale_f``.
    """

    def __init__(self, planes, qscale, smax, bits: int, plane_bits,
                 rows: int, group_rows: int, scale_f=None,
                 src_cols: tuple = (), act8: bool = False):
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
        self.src_cols = tuple(int(c) for c in src_cols)
        self.act8 = bool(act8)

    @property
    def planes(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"plane{i}")
                     for i in range(len(self.plane_bits)))

    @property
    def rows_pad(self) -> int:
        return self.plane0.shape[0] * 32 // self.plane_bits[0]

    def replace(self, planes=None, **fields):
        """Copy with some buffers or flags swapped; the rest is shared."""
        kw = dict(qscale=self.qscale, smax=self.smax, scale_f=self.scale_f,
                  src_cols=self.src_cols, act8=self.act8)
        kw.update(fields)
        return QuantSegment(planes if planes is not None else self.planes,
                            bits=self.bits, plane_bits=self.plane_bits,
                            rows=self.rows, group_rows=self.group_rows, **kw)


class GptqSegment(nn.Module):
    """GPTQ layout: explicit per-group f32 ``scale`` and int32 ``zero``
    [groups_pad, N] (+1 already applied) beside the plane buffers.

    ``act8`` as in QuantSegment. ``scale_bf`` / ``zs_bf`` (bf16
    [groups_pad, N], None by default) are the W4A8 kernel's compressed meta:
    the scale and the product (zero - off) * scale, off = 128 for 8-bit
    planes (ops/dequant.enable_w4a8_linear)."""

    def __init__(self, planes, scale, zero, bits: int, plane_bits,
                 rows: int, group_rows: int, act8: bool = False,
                 scale_bf=None, zs_bf=None):
        super().__init__()
        for i, p in enumerate(planes):
            self.register_buffer(f"plane{i}", p)
        self.register_buffer("scale", scale)
        self.register_buffer("zero", zero)
        self.register_buffer("scale_bf", scale_bf)
        self.register_buffer("zs_bf", zs_bf)
        self.bits = int(bits)
        self.plane_bits = tuple(int(b) for b in plane_bits)
        self.rows = int(rows)
        self.group_rows = int(group_rows)
        self.act8 = bool(act8)

    planes = QuantSegment.planes
    rows_pad = QuantSegment.rows_pad

    def replace(self, planes=None, **fields):
        kw = dict(scale=self.scale, zero=self.zero, act8=self.act8,
                  scale_bf=self.scale_bf, zs_bf=self.zs_bf)
        kw.update(fields)
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
        segs.append(QuantSegment(
            planes=pack_planes_on(q, seg.bits, device),
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
        planes=pack_planes_on(qp, t.bits, device),
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
        return seg.replace(
            planes, scale=take(seg.scale), zero=take(seg.zero),
            scale_bf=None if seg.scale_bf is None else take(seg.scale_bf),
            zs_bf=None if seg.zs_bf is None else take(seg.zs_bf))
    if seg.src_cols:
        # smax is per source there, not per column: take the columns of the
        # source linears and merge those
        raise ValueError("cannot take columns of a column-merged segment")
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
