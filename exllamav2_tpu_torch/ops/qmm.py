"""Quantized matmul: y = x @ dequant(W).

Counterpart of exllamav2_tpu/ops/qmm.py. Two paths:

  * decode (<= FUSED_MAX_ROWS rows): the fused dequant-matmul kernel
    (csrc/qmm.cu) reads the plane-packed words once, unpacks and scales them
    in registers and accumulates the product in f32 -- the bandwidth-bound
    path that sets decode tokens/s;
  * prefill (more rows): dequantize to bf16, then one matrix product.

Mixed-bit-width EXL2 matrices are a sum of per-segment matmuls over disjoint
K-row ranges. Act-order is an activation column gather (x[:, perm]).

Operand precision: the fused path rounds activations and weights to bf16 and
accumulates in f32 on every device. The prefill path and dense linears round
their operands to bf16 on the card (the product then runs on bf16-valued
operands with an f32 result); on the CPU they keep f32 operands, as the
reference does off its accelerator.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from exllamav2_tpu_torch.quant.qtensor import (
    QuantLinear, DenseLinear, GptqSegment, SUB_BLOCK)
from exllamav2_tpu_torch.ops import dequant as D

__all__ = ["qmm", "linear_apply", "FUSED_MAX_ROWS", "fused_segment_matmul",
           "qmm_plain", "LAUNCHES"]

# Below this many activation rows the fused kernel serves the linear.
FUSED_MAX_ROWS = 32

# launches of the fused kernel (csrc/qmm.cu), counted by its wrapper
LAUNCHES = {"qmm": 0}

_COLS = 128                 # columns per thread block (csrc/qmm.cu COLS)
_BLOCKS_PER_SM = 8          # split K until the grid holds this many per SM
_META = {"scale_f": 0, "qscale": 1, "gptq": 2}
# x, m, k_pad, plane0, plane1, bp0, bp1, n, bits, group_rows, meta kind,
# meta0, meta1, partials, out, splits, sub-blocks per split, stream
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
             + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p])


def dot_dtype(t: torch.Tensor) -> torch.dtype:
    """Operand type of the plain products: bf16 on the card, f32 on CPU."""
    return torch.bfloat16 if t.is_cuda else torch.float32


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with operands rounded to dot_dtype and an f32 result."""
    dt = dot_dtype(a)
    return torch.matmul(a.to(dt).float(), b.to(dt).float())


def qmm_plain(x: torch.Tensor, seg) -> torch.Tensor:
    """Plain version of the fused kernel: x [m, rows_pad] bf16 @
    dequant(seg) -> f32 [m, N]. Weight rounded to bf16, products in f32."""
    w = D.dequant_segment(seg, torch.bfloat16, rows=seg.rows_pad)
    return torch.matmul(x.float(), w.float())


def _meta_kind(seg) -> str:
    if isinstance(seg, GptqSegment):
        return "gptq"
    return "qscale" if seg.scale_f is None else "scale_f"


@functools.lru_cache(maxsize=None)
def _target_blocks(device: torch.device) -> int:
    """Thread blocks that fill `device`: _BLOCKS_PER_SM per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _BLOCKS_PER_SM * sms


def _split_k(n: int, nsb: int, target: int) -> tuple[int, int]:
    """(splits, sub-blocks per split): about `target` blocks in the grid."""
    nblk = -(-n // _COLS)
    want = max(1, min(nsb, -(-target // nblk)))
    per = -(-nsb // want)
    return -(-nsb // per), per


def _kernel_segment_matmul(x: torch.Tensor, seg) -> torch.Tensor:
    """Launch csrc/qmm.cu on one segment (CUDA tensors only)."""
    from exllamav2_tpu_torch import _build
    bp = seg.plane_bits
    if bp[0] not in (2, 4, 8) or len(bp) > 2:
        raise NotImplementedError(f"plane widths {bp} not supported")
    if seg.group_rows % 16:
        raise NotImplementedError(f"group size {seg.group_rows} % 16 != 0")
    m, k_pad = x.shape
    if m > FUSED_MAX_ROWS or k_pad != seg.rows_pad:
        raise ValueError(f"x {tuple(x.shape)} vs rows_pad {seg.rows_pad}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be contiguous bf16")
    planes = seg.planes
    n = planes[0].shape[1]
    kind = _meta_kind(seg)
    if kind == "gptq":
        meta = (seg.scale, seg.zero)
        dts = (torch.float32, torch.int32)
    elif kind == "scale_f":
        meta = (seg.scale_f, seg.scale_f)
        dts = (torch.bfloat16, torch.bfloat16)
    else:
        meta = (seg.qscale, seg.smax)
        dts = (torch.uint8, torch.float32)
    for t, dt in zip((*planes, *meta), (torch.int32,) * len(planes) + dts):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"segment buffer {t.dtype} {t.device} "
                             f"contiguous={t.is_contiguous()} (want {dt})")
    nsb = k_pad // SUB_BLOCK
    splits, per = _split_k(n, nsb, _target_blocks(x.device))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = out if splits == 1 else torch.empty(
        (splits, m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("qmm", "qmm_segment", _ARGTYPES)
    rc = fn(x.data_ptr(), m, k_pad,
            planes[0].data_ptr(),
            planes[1].data_ptr() if len(planes) > 1 else None,
            bp[0], bp[1] if len(bp) > 1 else 0,
            n, seg.bits, seg.group_rows, _META[kind],
            meta[0].data_ptr(), meta[1].data_ptr(),
            part.data_ptr(), out.data_ptr(), splits, per,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("qmm", rc, "qmm_segment")
    LAUNCHES["qmm"] += 1
    return out


def fused_segment_matmul(x: torch.Tensor, seg) -> torch.Tensor:
    """x [m <= 32, rows_pad] bf16 (zero-padded K) @ dequant(seg) -> f32
    [m, N]. Launches the CUDA kernel on a card tensor; on a CPU tensor runs
    the plain version."""
    if x.is_cuda:
        return _kernel_segment_matmul(x, seg)
    return qmm_plain(x, seg)


def qmm(x: torch.Tensor, lin: QuantLinear, *,
        fused: bool | None = None) -> torch.Tensor:
    """x [..., K] -> [..., n] f32 (padded width; caller slices to n_orig)."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    if k != lin.k:
        raise ValueError(f"x width {k} != linear k {lin.k}")
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if lin.perm is not None:
        x2 = torch.index_select(x2, 1, lin.perm)

    if fused is None:
        fused = m <= FUSED_MAX_ROWS
    y = None
    row = 0
    for seg in lin.segments:
        xs = x2[:, row:row + seg.rows]
        if fused:
            xs = xs.to(torch.bfloat16)
            if seg.rows < seg.rows_pad:
                xs = torch.nn.functional.pad(
                    xs, (0, seg.rows_pad - seg.rows))
            part = fused_segment_matmul(xs.contiguous(), seg)
        else:
            part = _dot(xs, D.dequant_segment(seg))
        y = part if y is None else y + part
        row += seg.rows
    if lin.bias is not None:
        y = y + torch.nn.functional.pad(lin.bias.float(),
                                        (0, lin.n - lin.n_orig))
    return y.reshape(*lead, lin.n)


def linear_apply(x: torch.Tensor, lin, *,
                 fused: bool | None = None) -> torch.Tensor:
    """Apply a (quantized or dense) linear, returning the logical width."""
    if hasattr(lin, "base") and hasattr(lin, "a"):
        raise NotImplementedError("LoRA linears are not ported yet")
    if isinstance(lin, DenseLinear):
        y = _dot(x, lin.weight)
        if lin.bias is not None:
            y = y + lin.bias.float()
        return y
    y = qmm(x, lin, fused=fused)
    if lin.n != lin.n_orig:
        y = y[..., :lin.n_orig]
    return y
