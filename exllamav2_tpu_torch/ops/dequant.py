"""Dequantization of plane-packed weights (plain PyTorch).

Counterpart of exllamav2_tpu/ops/dequant.py on the same layout
(quant/qtensor.py): per-bit-plane words, strided within 256-row sub-blocks.
These functions are the plain versions the fused kernel (ops/qmm.py) is held
against, and the dequant step of the many-row (prefill) path. The weight
preparations of the serving fast paths live here too: prescaled group scales,
column-merged q|k|v and gate|up linears, and the W4A8 flags and meta. They
build new modules that share the untouched buffers; no shared segment is
mutated.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from exllamav2_tpu_torch.quant.qtensor import (
    SUB_BLOCK, GptqSegment, QuantLinear)

__all__ = ["fp16_round", "unpack_plane", "unpack_planes", "exl2_scales",
           "broadcast_groups", "dequant_segment", "dequant_linear",
           "precompute_scales_linear", "precompute_model_scales",
           "enable_w4a8_linear", "enable_w4a8", "merge_linears",
           "merge_serving_weights", "strip_merged_weights",
           "replace_linears"]


def fp16_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest fp16 value (round-to-nearest-even), in f32."""
    return x.half().float()


def unpack_plane(words: torch.Tensor, bp: int) -> torch.Tensor:
    """Unpack one plane's words [nsb*Qsb, N] -> int32 values [nsb*256, N].

    Qsb = SUB_BLOCK*bp/32; natural row r of sub-block sb lives in word
    (r mod Qsb) at bit slot (r div Qsb). Words are int32 holding uint32 bits:
    the arithmetic shift smears the sign bit only above the mask.
    """
    qrows, n = words.shape
    qsb = SUB_BLOCK * bp // 32
    per = 32 // bp
    nsb = qrows // qsb
    assert nsb * qsb == qrows, (qrows, bp)
    w = words.to(torch.int32).reshape(nsb, 1, qsb, n)
    shifts = (torch.arange(per, dtype=torch.int32, device=words.device)
              * bp).reshape(1, per, 1, 1)
    vals = (w >> shifts) & ((1 << bp) - 1)
    return vals.reshape(qrows * per, n)


def unpack_planes(planes, plane_bits) -> torch.Tensor:
    """Combine bit planes -> int32 values [rows_pad, N]."""
    total = None
    shift = 0
    for bp, words in zip(plane_bits, planes):
        v = unpack_plane(words, bp)
        total = v if total is None else total | (v << shift)
        shift += bp
    return total


def exl2_scales(qscale: torch.Tensor, smax: torch.Tensor) -> torch.Tensor:
    """Decode EXL2 sqrt-encoded scales -> f32 [groups, N].

    One fp16 rounding of (qs^2) * (q_scale_max/256): qs^2 <= 256 and smax are
    fp16-exact, so the f32 product is exact and a single fp16 rounding
    reproduces the reference's dq_scale.
    """
    qs = qscale.to(torch.int32)
    s = (qs * qs).to(torch.float32) * smax
    return fp16_round(s)


def broadcast_groups(per_group: torch.Tensor, group_rows: int) -> torch.Tensor:
    """[groups, N] -> [groups*group_rows, N] (each group row repeated)."""
    return torch.repeat_interleave(per_group, group_rows, dim=0)


def _segment_scales(seg) -> torch.Tensor:
    """EXL2 segment -> f32 scales [groups, N]."""
    if seg.scale_f is not None:
        return seg.scale_f.to(torch.float32)
    smax = seg.smax
    if seg.src_cols:
        # column-merged segment: smax holds one column per merged source;
        # expand to full width before the exact decode (merge_linears)
        bounds = [*seg.src_cols, seg.qscale.shape[1]]
        smax = torch.cat([smax[:, i:i + 1].expand(-1, bounds[i + 1] - b)
                          for i, b in enumerate(seg.src_cols)], dim=1)
    return exl2_scales(seg.qscale, smax)


def dequant_segment(seg, dtype=torch.bfloat16,
                    rows: int | None = None) -> torch.Tensor:
    """Dequantize a segment -> [rows or seg.rows, N]."""
    vals = unpack_planes(seg.planes, seg.plane_bits)
    if isinstance(seg, GptqSegment):
        srows = broadcast_groups(seg.scale, seg.group_rows)[:seg.rows_pad]
        zrows = broadcast_groups(seg.zero, seg.group_rows)[:seg.rows_pad]
        w = ((vals - zrows).to(torch.float32) * srows).to(dtype)
    else:
        srows = broadcast_groups(_segment_scales(seg),
                                 seg.group_rows)[:seg.rows_pad]
        zero = float(2 ** (seg.bits - 1))
        w = ((vals.to(torch.float32) - zero) * srows).to(dtype)
    return w[:seg.rows if rows is None else rows]


def precompute_scales_linear(lin):
    """Decode a QuantLinear's EXL2 sqrt-encoded group scales once at load
    into bf16 rows carried alongside the segment (QuantSegment.scale_f).

    The fused kernel then reads the decoded scales instead of decoding them
    per group. Near-exact, not bitwise: the fp16-rounded scale takes one
    extra bf16 rounding (<= 2^-9 relative), inside the bf16 rounding the
    dequantized weight takes anyway."""
    if not isinstance(lin, QuantLinear):
        return lin
    segs = []
    for seg in lin.segments:
        if isinstance(seg, GptqSegment) or seg.scale_f is not None:
            segs.append(seg)
            continue
        sf = _segment_scales(seg).to(torch.bfloat16)
        segs.append(seg.replace(scale_f=sf))
    return QuantLinear(segs, lin.perm, lin.bias, lin.k, lin.n, lin.n_orig)


def precompute_model_scales(module):
    """Copy of a module tree (a ModelWeights or any container of linears)
    with precompute_scales_linear applied to every QuantLinear; the tree
    given is not touched (_map_linears)."""
    return _map_linears(module, precompute_scales_linear)


def _map_linears(module, f):
    """Copy of a module tree with f applied to every QuantLinear. Containers
    are shallow copies with their own child tables; every other module,
    buffer and attribute is shared with the original, which is not touched."""
    if isinstance(module, QuantLinear):
        return f(module)
    return _with(module, **{
        name: None if child is None else _map_linears(child, f)
        for name, child in module._modules.items()})


def _with(module, **attrs):
    """Shallow copy of a container module with some attributes replaced."""
    new = copy.copy(module)
    new._modules = dict(module._modules)
    new._buffers = dict(module._buffers)
    new._parameters = dict(module._parameters)
    for name, val in attrs.items():
        setattr(new, name, val)
    return new


def replace_linears(weights, f, which=("attn", "mlp", "head")):
    """Copy of ModelWeights `weights` with f(linear) -> linear applied to
    every attention q/k/v/o ("attn"), every gated or plain MLP's
    gate/up/down ("mlp"; MoE experts are left alone) and the head ("head").
    Containers are shallow copies; everything else is shared with
    `weights`, which is not touched."""
    from exllamav2_tpu_torch.models.modules import MLPWeights

    def maybe(lin):
        return None if lin is None else f(lin)

    layers = []
    for lw in weights.layers:
        attn, mlp = lw.attn, lw.mlp
        if "attn" in which:
            attn = _with(attn, q=maybe(attn.q), k=maybe(attn.k),
                         v=maybe(attn.v), o=maybe(attn.o))
        if "mlp" in which and isinstance(mlp, MLPWeights):
            mlp = _with(mlp, gate=maybe(mlp.gate), up=maybe(mlp.up),
                        down=maybe(mlp.down))
        layers.append(_with(lw, attn=attn, mlp=mlp))
    head = maybe(weights.head) if "head" in which else weights.head
    return _with(weights, layers=nn.ModuleList(layers), head=head)


def _pad_w4a8_rows(seg, max_overhead: float = 0.125):
    """Zero-pad a GPTQ segment's K rows to a multiple of
    lcm(SUB_BLOCK, 8 * group_rows) where that unit is at most 1024 rows and
    the padding at most `max_overhead` of the rows.

    Kept so that both packages hold the same words (the reference pads for
    its tile picker; the 7B down-proj goes from 11008 to 11264 rows). Exact:
    padded activation rows are zero, so their int8 partials and group sums
    vanish whatever the (zero-filled) scale and zero rows say; plane packing
    is sub-block-sequential, so appended zero sub-blocks are layout-correct.
    """
    gr = seg.group_rows
    unit = (SUB_BLOCK * 8 * gr) // math.gcd(SUB_BLOCK, 8 * gr)
    rows_pad = seg.rows_pad
    if unit > 1024 or rows_pad % unit == 0:
        return seg
    new_pad = -(-rows_pad // unit) * unit
    add = new_pad - rows_pad
    if add > max_overhead * rows_pad:
        return seg

    def grow(t, rows):
        return torch.cat([t, t.new_zeros((rows, t.shape[1]))], dim=0)

    planes = tuple(grow(p, add * bp // 32)
                   for p, bp in zip(seg.planes, seg.plane_bits))
    return seg.replace(planes, scale=grow(seg.scale, add // gr),
                       zero=grow(seg.zero, add // gr))


def enable_w4a8_linear(lin):
    """Flag every segment of a QuantLinear for the W4A8 decode path
    (ops/qmm.w4a8_segment_matmul): per-token per-group absmax int8
    activations against the packed values as int8, integer group partials,
    scales and zero corrections applied to the partials.

    NOT the exact quantized-model semantics: an opt-in approximation. EXL2
    segments are prescaled first (the kernel reads bf16 scale_f rows). GPTQ
    segments are row-padded (_pad_w4a8_rows) and get the compressed meta:
    bf16 scales and the bf16 product (zero - off) * scale, off = 128 for
    8-bit planes."""
    if not isinstance(lin, QuantLinear):
        return lin
    lin = precompute_scales_linear(lin)
    segs = []
    for seg in lin.segments:
        if seg.bits > 8:
            segs.append(seg)
            continue
        repl = {"act8": True}
        if isinstance(seg, GptqSegment):
            # pad before compressing so scale_bf / zs_bf match the padded
            # group count
            seg = _pad_w4a8_rows(seg)
            if seg.zs_bf is None:
                off = 128 if seg.bits == 8 else 0
                repl["scale_bf"] = seg.scale.to(torch.bfloat16)
                repl["zs_bf"] = ((seg.zero.to(torch.float32) - float(off))
                                 * seg.scale).to(torch.bfloat16)
        segs.append(seg.replace(**repl))
    return QuantLinear(segs, lin.perm, lin.bias, lin.k, lin.n, lin.n_orig)


def enable_w4a8(tree, skip_head: bool = True):
    """Copy of a module tree (a ModelWeights, a container of linears or one
    QuantLinear) with enable_w4a8_linear applied to every QuantLinear.

    skip_head keeps ``tree.head`` on the exact path (prescaled only): logits
    feed the sampler directly, so an error there lands 1:1 on the token
    probabilities, and the head is one matrix of many."""
    out = _map_linears(tree, enable_w4a8_linear)
    head = getattr(tree, "head", None)
    if skip_head and head is not None:
        out.head = _map_linears(head, precompute_scales_linear)
    return out


def merge_linears(lins):
    """Column-concatenate compatible QuantLinears into one wider linear
    (q|k|v, gate|up: one weight stream and one kernel launch where there were
    two or three).

    Requirements: same K, identical (or absent) act-order perm, equal segment
    structure, exact widths (no lane padding). Both formats merge bitwise
    exactly: GPTQ concatenates its explicit per-group scales and zeros; EXL2
    keeps each source's smax as a column of one [groups, n_sources] array
    (QuantSegment.src_cols). Returns None when not mergeable."""
    if any(not isinstance(l, QuantLinear) for l in lins):
        return None
    k0 = lins[0].k
    if any(l.k != k0 or l.n != l.n_orig for l in lins):
        return None
    have_perm = [l.perm is not None for l in lins]
    if any(have_perm) and not all(have_perm):
        return None
    if all(have_perm) and any(not torch.equal(lins[0].perm, l.perm)
                              for l in lins[1:]):
        return None
    nseg = len(lins[0].segments)
    if any(len(l.segments) != nseg for l in lins):
        return None

    def skey(s):
        return (type(s).__name__, s.rows, s.bits, s.plane_bits,
                s.group_rows, s.planes[0].shape[0])

    def cat(ts):
        return torch.cat(list(ts), dim=1)

    starts, col = [], 0
    for l in lins:
        starts.append(col)
        col += l.n
    segs = []
    for i in range(nseg):
        ss = [l.segments[i] for l in lins]
        s0 = ss[0]
        if any(skey(s) != skey(s0) for s in ss):
            return None
        planes = tuple(cat(s.planes[j] for s in ss)
                       for j in range(len(s0.planes)))
        if isinstance(s0, GptqSegment):
            both = all(s.scale_bf is not None for s in ss)
            segs.append(s0.replace(
                planes, scale=cat(s.scale for s in ss),
                zero=cat(s.zero for s in ss),
                scale_bf=cat(s.scale_bf for s in ss) if both else None,
                zs_bf=cat(s.zs_bf for s in ss) if both else None))
        else:
            segs.append(s0.replace(
                planes, qscale=cat(s.qscale for s in ss),
                smax=cat(s.smax for s in ss), scale_f=None,
                src_cols=tuple(starts)))
    bias = None
    if any(l.bias is not None for l in lins):
        # a missing bias merges as f32 zeros (the reference's rule), so the
        # merged bias takes the promoted type
        bias = torch.cat([
            l.bias if l.bias is not None else torch.zeros(
                l.n, dtype=torch.float32, device=lins[0].segments[0]
                .plane0.device) for l in lins])
    out = QuantLinear(segs, lins[0].perm, bias, k0, col, col)
    if any(s.act8 for s in out.segments) or any(
            getattr(s, "scale_f", None) is not None
            for l in lins for s in l.segments):
        # the merge rebuilt EXL2 segments without scale_f: prescale again
        # when the sources were prescaled, and always for act8 segments
        # (the W4A8 kernel needs scale_f)
        out = precompute_scales_linear(out)
    return out


def strip_merged_weights(w):
    """Copy of a ModelWeights without the merged qkv / gate_up linears, so
    the per-matrix linears are authoritative again."""
    layers = []
    for lw in w.layers:
        aw, mlp = lw.attn, lw.mlp
        if getattr(aw, "qkv", None) is not None:
            aw = _with(aw, qkv=None)
        if getattr(mlp, "gate_up", None) is not None:
            mlp = _with(mlp, gate_up=None)
        layers.append(_with(lw, attn=aw, mlp=mlp))
    return _with(w, layers=torch.nn.ModuleList(layers))


def merge_serving_weights(w):
    """Copy of a ModelWeights with merged qkv / gate_up linears attached to
    every layer whose structure allows it (bitwise exact; merge_linears).
    The forward prefers the merged linear; q/k/v and gate/up stay beside
    it. MoE layers keep their experts as they are (the reference merges
    attention and dense MLPs only)."""
    layers = []
    for lw in w.layers:
        aw, mlp = lw.attn, lw.mlp
        qkv = merge_linears([aw.q, aw.k, aw.v])
        if qkv is not None:
            aw = _with(aw, qkv=qkv)
        if getattr(mlp, "gate", None) is not None:
            gu = merge_linears([mlp.gate, mlp.up])
            if gu is not None:
                mlp = _with(mlp, gate_up=gu)
        layers.append(_with(lw, attn=aw, mlp=mlp))
    return _with(w, layers=torch.nn.ModuleList(layers))


def dequant_linear(ql, dtype=torch.bfloat16,
                   original_order: bool = True) -> torch.Tensor:
    """Fully dequantize a QuantLinear -> [K, N] (activation/stored order)."""
    w = torch.cat([dequant_segment(s, dtype) for s in ql.segments], dim=0)
    if original_order and ql.perm is not None:
        # stored row j corresponds to original row perm[j]
        out = torch.zeros_like(w)
        out[ql.perm.long()] = w
        w = out
    return w
