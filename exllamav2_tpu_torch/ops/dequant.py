"""Dequantization of plane-packed weights (plain PyTorch).

Counterpart of exllamav2_tpu/ops/dequant.py on the same layout
(quant/qtensor.py): per-bit-plane words, strided within 256-row sub-blocks.
These functions are the plain versions the fused kernel (ops/qmm.py) is held
against, and the dequant step of the many-row (prefill) path.
"""

from __future__ import annotations

import torch

from exllamav2_tpu_torch.quant.qtensor import (
    SUB_BLOCK, GptqSegment, QuantLinear)

__all__ = ["fp16_round", "unpack_plane", "unpack_planes", "exl2_scales",
           "broadcast_groups", "dequant_segment", "dequant_linear",
           "precompute_scales_linear", "precompute_model_scales"]


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
    return exl2_scales(seg.qscale, seg.smax)


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
    """Apply precompute_scales_linear to every QuantLinear in a module tree
    (a ModelWeights or any container of linears), in place."""
    if isinstance(module, QuantLinear):
        return precompute_scales_linear(module)
    for name, child in list(module.named_children()):
        new = precompute_model_scales(child)
        if new is not child:
            setattr(module, name, new)
    return module


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
