"""Quantized matmul: y = x @ dequant(W).

Counterpart of exllamav2_tpu/ops/qmm.py. Two paths:

  * decode (<= FUSED_MAX_ROWS rows): the fused dequant-matmul kernel
    (csrc/qmm.cu) reads the plane-packed words once, dequantizes them in
    registers into the B fragments of bf16 tensor-core tiles and sums the
    product in f32 -- the bandwidth-bound path that sets decode tokens/s; its
    template follows m (qmm_template: "gemv" below 8 rows, "mma" from 8), and
    K is split across a thread-block cluster whose blocks merge their
    partial tiles in one launch (qmm_split). Two more kernels serve segments
    that ask for them: W4A8 segments (``act8``, ops/dequant.enable_w4a8) go
    through csrc/qmm_w4a8.cu, which multiplies int8 activations with the
    packed values as int8 and applies scales and zeros to the integer group
    partials (approximate) -- on int8 tensor-core tiles (mma.sync) from 8
    rows up, with dp4a below 8 rows or for 16-row groups (w4a8_template);
    GPTQ segments with groups of >= 128 rows go
    through csrc/qmm_partials.cu when QMM_PARTIALS=1 is set, the exact
    scales-on-partials form y = sum_g s_g (x_g @ v_g - z_g sum(x_g)), on
    the same bf16 tiles as csrc/qmm.cu (the B fragments the exact
    integers, the group sums an mma against ones, one launch);
  * prefill (more rows): dequantize to bf16, then one matrix product
    (exact; ``act8`` is ignored there).

A ``gate`` (an int32 flag on the device) makes a quantized linear's output
zero when the flag is 0: the MoE decode's "is any row routed to this
expert". Kernel 1 reads it before its first plane load and, when it is 0,
writes zeros and streams no planes (the reference's lax.cond around an
expert). Only kernel 1's path takes a gate (gate_capable says which linears
it serves); the others refuse one.

Mixed-bit-width EXL2 matrices are a sum of per-segment matmuls over disjoint
K-row ranges. Act-order is an activation column gather (x[:, perm]).

Operand precision: the fused path rounds activations and weights to bf16 and
accumulates in f32 on every device (W4A8 segments take f32 activations, so no
bf16 rounding lies under the int8 one). The prefill path and dense linears
multiply bf16 operands with an f32 result on the card (torch.mm with
out_dtype, on the tensor cores, as the reference's jnp.dot with
preferred_element_type); on the CPU they keep f32 operands, as the reference
does off its accelerator.
"""

from __future__ import annotations

import ctypes
import os

import torch

from exllamav2_tpu_torch.quant.qtensor import (
    QuantLinear, DenseLinear, GptqSegment, SUB_BLOCK)
from exllamav2_tpu_torch.device import sm_count
from exllamav2_tpu_torch.ops import dequant as D

__all__ = ["qmm", "linear_apply", "FUSED_MAX_ROWS", "fused_segment_matmul",
           "qmm_plain", "qmm_gated_plain", "gate_capable", "qmm_template",
           "qmm_split",
           "w4a8_segment_matmul", "w4a8_quantize",
           "qmm_w4a8_plain", "w4a8_template",
           "partials_segment_matmul", "qmm_partials_plain", "LAUNCHES",
           "GATED_LAUNCHES"]

# Below this many activation rows the fused kernel serves the linear.
FUSED_MAX_ROWS = 32

# launches of each kernel, counted by its wrapper: csrc/qmm.cu,
# csrc/qmm_w4a8.cu, csrc/qmm_partials.cu
LAUNCHES = {"qmm": 0, "qmm_w4a8": 0, "qmm_partials": 0}
# the launches of csrc/qmm.cu's gated entry among LAUNCHES["qmm"] (the MoE
# decode's experts, their flag on or off)
GATED_LAUNCHES = {"qmm_gated": 0}

# The W4A8 integer group dots are exact in f32 (the plain version's type)
# while 127 * 255 * group_rows < 2^24.
W4A8_MAX_GROUP_ROWS = 512

_COLS = 128                 # columns per thread block (COLS in the sources)
_BLOCKS_PER_SM = 8          # split K until the grid holds this many per SM
# the same for the two templates of csrc/qmm.cu, whose K-splits are the
# blocks of one thread-block cluster: at most _QMM_MAX_SPLITS (MAX_SPLITS in
# the source, the portable cluster size)
_QMM_BLOCKS_PER_SM = {"gemv": 3, "mma": 2}
_QMM_MAX_SPLITS = 8
# the same for the W4A8 mma template: its two-stage pipeline holds 60 KB of
# shared memory at 4 bits and m <= 16, room for three blocks per SM
_MMA_BLOCKS_PER_SM = 3
_META = {"scale_f": 0, "qscale": 1, "gptq": 2, "src_cols": 3}
_META_W4A8 = {"scale_f": 0, "gptq": 1, "gptq_bf": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, m, k_pad, plane0, plane1, bp0, bp1, n, bits, group_rows, meta kind,
# meta0, meta1, sources, start column of source 1 and 2, out, splits,
# sub-blocks per split, stream
_ARGTYPES = [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
             _I, _I, _I, _P, _I, _I, _P]
# the same with the gate (int32 flag) before the stream
_ARGTYPES_GATED = _ARGTYPES[:-1] + [_P, _P]
# x f32, m, k_pad, xq, a, x1a, plane0, plane1, bp0, bp1, n, bits,
# group_rows, meta kind, meta0, meta1, partials, out, splits, sub-blocks
# per split, mma template, stream
_ARGTYPES_W4A8 = [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _P, _P, _P, _P, _I, _I, _I, _P]
# x bf16, m, k_pad, plane0, plane1, bp0, bp1, n, group_rows, scale, zero,
# out, splits, sub-blocks per split, stream
_ARGTYPES_PARTIALS = [_P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I,
                      _I, _P]


def dot_dtype(t: torch.Tensor) -> torch.dtype:
    """Operand type of the plain products: bf16 on the card, f32 on CPU."""
    return torch.bfloat16 if t.is_cuda else torch.float32


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] with operands in dot_dtype and an f32 result:
    on the card one bf16 x bf16 product with f32 output on the tensor
    cores, on the CPU an f32 product."""
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    y = torch.mm(a.reshape(-1, a.shape[-1]).to(torch.bfloat16),
                 b.to(torch.bfloat16), out_dtype=torch.float32)
    return y.reshape(*a.shape[:-1], b.shape[-1])


def qmm_plain(x: torch.Tensor, seg) -> torch.Tensor:
    """Plain version of the fused kernel: x [m, rows_pad] bf16 @
    dequant(seg) -> f32 [m, N]. Weight rounded to bf16, products in f32."""
    w = D.dequant_segment(seg, torch.bfloat16, rows=seg.rows_pad)
    return torch.matmul(x.float(), w.float())


def qmm_gated_plain(x: torch.Tensor, seg, gate: torch.Tensor
                    ) -> torch.Tensor:
    """Plain version of the gated fused kernel: qmm_plain where the flag
    `gate` (int32 [1]) is nonzero, else zeros."""
    y = qmm_plain(x, seg)
    return torch.where(gate != 0, y, torch.zeros_like(y))


def _meta_kind(seg) -> str:
    if isinstance(seg, GptqSegment):
        return "gptq"
    if seg.scale_f is not None:
        return "scale_f"
    return "src_cols" if seg.src_cols else "qscale"


def _target_blocks(device: torch.device,
                   per_sm: int = _BLOCKS_PER_SM) -> int:
    """Thread blocks that fill `device`: per_sm per SM."""
    return per_sm * sm_count(device)


def _split_k(n: int, nsb: int, target: int, unit: int = 1
             ) -> tuple[int, int]:
    """(splits, sub-blocks per split): about `target` blocks in the grid.
    A split holds a multiple of `unit` sub-blocks (a whole number of
    groups, where a group spans several sub-blocks)."""
    nblk = -(-n // _COLS)
    want = max(1, min(nsb, -(-target // nblk)))
    per = -(-(-(-nsb // want)) // unit) * unit
    return -(-nsb // per), per


def _check_launch(x: torch.Tensor, seg, x_dtype, buffers) -> tuple:
    """The checks the three kernels share; returns (m, k_pad, n, plane
    widths). `buffers` pairs each segment buffer with the type the kernel
    reads it as."""
    bp = seg.plane_bits
    if bp[0] not in (2, 4, 8) or len(bp) > 2:
        raise NotImplementedError(f"plane widths {bp} not supported")
    if seg.group_rows % 16:
        raise NotImplementedError(f"group size {seg.group_rows} % 16 != 0")
    m, k_pad = x.shape
    if m > FUSED_MAX_ROWS or k_pad != seg.rows_pad:
        raise ValueError(f"x {tuple(x.shape)} vs rows_pad {seg.rows_pad}")
    if x.dtype != x_dtype or not x.is_contiguous():
        raise ValueError(f"x must be contiguous {x_dtype}")
    for t, dt in buffers:
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"segment buffer {t.dtype} {t.device} "
                             f"contiguous={t.is_contiguous()} (want {dt})")
    return m, k_pad, seg.planes[0].shape[1], bp


def _out_and_partials(x, m, n, k_pad, unit=1, per_sm=_BLOCKS_PER_SM):
    """Output, split-K scratch and the split the grid takes."""
    splits, per = _split_k(n, k_pad // SUB_BLOCK,
                           _target_blocks(x.device, per_sm), unit)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = out if splits == 1 else torch.empty(
        (splits, m, n), dtype=torch.float32, device=x.device)
    return out, part, splits, per


def _plane_args(seg, bp):
    planes = seg.planes
    return (planes[0].data_ptr(),
            planes[1].data_ptr() if len(planes) > 1 else None,
            bp[0], bp[1] if len(bp) > 1 else 0)


def qmm_template(m: int) -> str:
    """The template of csrc/qmm.cu that serves m activation rows: "gemv"
    below 8 rows (one bf16 m16 tile whose rows 8-15 are known zero), "mma"
    from 8 (one or two full m16 tiles)."""
    return "gemv" if m < 8 else "mma"


def qmm_split(n: int, nsb: int, target: int, unit: int = 1
              ) -> tuple[int, int]:
    """(splits, sub-blocks per split) of the grid (column blocks, splits) of
    csrc/qmm.cu and csrc/qmm_partials.cu: about `target` blocks, at most
    _QMM_MAX_SPLITS splits (the blocks of one cluster), every split
    non-empty and a multiple of `unit` sub-blocks (a whole number of
    groups, where a group spans several sub-blocks; nsb % unit == 0)."""
    nblk = -(-n // _COLS)
    units = nsb // unit
    want = max(1, min(units, _QMM_MAX_SPLITS, -(-target // nblk)))
    per = -(-units // want) * unit
    return -(-nsb // per), per


def _kernel_segment_matmul(x: torch.Tensor, seg, gate=None) -> torch.Tensor:
    """Launch csrc/qmm.cu on one segment (CUDA tensors only); with `gate`
    (int32 [1] on the device) the gated entry, whose blocks write zeros
    and load nothing when the flag is 0."""
    from exllamav2_tpu_torch import _build
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
    m, k_pad, n, bp = _check_launch(
        x, seg, torch.bfloat16,
        [*((p, torch.int32) for p in seg.planes), *zip(meta, dts)])
    if n % 4:
        raise NotImplementedError(f"{n} columns: the kernel reads 4-column "
                                  "chunks")
    if x.data_ptr() % 16:
        x = x.clone()                     # a view at an odd offset
    src = (0, 0, 0)
    if kind == "src_cols":
        # one smax column per merged source; the kernel picks a column's
        # source from the start columns
        nsrc = len(seg.src_cols)
        if nsrc not in (2, 3) or seg.smax.shape[1] != nsrc:
            raise NotImplementedError(f"{nsrc} merged sources")
        src = (nsrc, seg.src_cols[1], seg.src_cols[2] if nsrc > 2 else n)
    splits, per = qmm_split(
        n, k_pad // SUB_BLOCK,
        _target_blocks(x.device, _QMM_BLOCKS_PER_SM[qmm_template(m)]))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    args = [x.data_ptr(), m, k_pad, *_plane_args(seg, bp),
            n, seg.bits, seg.group_rows, _META[kind],
            meta[0].data_ptr(), meta[1].data_ptr(), *src,
            out.data_ptr(), splits, per]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if gate is None:
        entry = "qmm_segment"
        fn = _build.function("qmm", entry, _ARGTYPES)
        rc = fn(*args, stream)
    else:
        if (gate.device != x.device or gate.dtype != torch.int32
                or gate.numel() < 1):
            raise ValueError(f"gate {gate.dtype} {gate.device} "
                             f"{tuple(gate.shape)} (want int32 on "
                             f"{x.device})")
        entry = "qmm_segment_gated"
        fn = _build.function("qmm", entry, _ARGTYPES_GATED)
        rc = fn(*args, gate.data_ptr(), stream)
    _build.check("qmm", rc, entry)
    LAUNCHES["qmm"] += 1
    if gate is not None:
        GATED_LAUNCHES["qmm_gated"] += 1
    return out


# ---------------------------------------------------------------------------
# W4A8: int8 activations, integer group partials
# ---------------------------------------------------------------------------

def _w4a8_meta(seg) -> tuple[str, torch.Tensor, torch.Tensor]:
    """(meta kind, scale buffer, zero buffer) as the reference chooses."""
    if isinstance(seg, GptqSegment):
        if seg.zs_bf is not None:
            return "gptq_bf", seg.scale_bf, seg.zs_bf
        return "gptq", seg.scale, seg.zero
    if seg.scale_f is None:
        raise ValueError("W4A8 EXL2 segments need prescaled scale_f rows "
                         "(ops/dequant.enable_w4a8_linear makes them)")
    return "scale_f", seg.scale_f, seg.scale_f


def _w4a8_check_groups(seg) -> None:
    gr = seg.group_rows
    if gr > W4A8_MAX_GROUP_ROWS or seg.rows_pad % gr or (
            SUB_BLOCK % gr and gr % SUB_BLOCK):
        raise NotImplementedError(
            f"W4A8 group size {gr} over {seg.rows_pad} rows: want a divisor "
            f"or multiple of {SUB_BLOCK}, at most {W4A8_MAX_GROUP_ROWS}")


def w4a8_template(m: int, group_rows: int, n: int) -> str:
    """The template of csrc/qmm_w4a8.cu that serves m activation rows:
    "mma" (int8 tensor-core tiles of 16 tokens x 8 columns x 32 rows) from
    8 rows up where a 32-row k-step stays inside a group and the 16-byte
    column chunks are whole, else "dp4a" (below 8 rows an m16 tile would be
    mostly padding)."""
    if m >= 8 and group_rows % 32 == 0 and n % 8 == 0:
        return "mma"
    return "dp4a"


def w4a8_quantize_plain(x: torch.Tensor, group_rows: int):
    """Per-token per-group absmax int8 quantization of x f32 [m, K] ->
    (xq f32 [m, G, group_rows] of integers in [-127, 127], a f32 [m, G] the
    group scales amax / 127, x1a f32 [m, G] = sum(xq) * a)."""
    m, k = x.shape
    xf = x.float().reshape(m, k // group_rows, group_rows)
    amax = xf.abs().amax(dim=2)
    a = amax * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    aq = torch.where(amax > 0, a, torch.ones_like(a))
    xq = torch.clamp(torch.round(xf / aq[:, :, None]), -127, 127)
    return xq, a, xq.sum(dim=2) * a


def qmm_w4a8_plain(x: torch.Tensor, seg) -> torch.Tensor:
    """Plain version of the W4A8 kernel: x f32 [m, rows_pad] -> f32 [m, N].

    Per group g the integer dot p = xq_g . (v_g - off) (off = 128 for 8-bit
    planes, else 0) is taken in f32, exact up to W4A8_MAX_GROUP_ROWS rows a
    group; then, with a the activation scale and x1a = sum(xq_g) * a:
    compressed GPTQ meta sums p*a*s - x1a*zs, plain GPTQ meta
    (p*a - x1a*(z - off)) * s, EXL2 (p*a - x1a*(2^(bits-1) - off)) * s."""
    _w4a8_check_groups(seg)
    kind, s_buf, z_buf = _w4a8_meta(seg)
    gr = seg.group_rows
    xq, a, x1a = w4a8_quantize_plain(x, gr)
    off = 128 if seg.bits == 8 else 0
    vals = D.unpack_planes(seg.planes, seg.plane_bits) - off
    g = seg.rows_pad // gr
    n = vals.shape[1]
    p = torch.bmm(xq.transpose(0, 1), vals.float().reshape(g, gr, n))
    pa = p * a.t()[:, :, None]                              # [G, m, N]
    x1a = x1a.t()[:, :, None]                               # [G, m, 1]
    s = s_buf.float()[:, None, :]                           # [G, 1, N]
    if kind == "gptq_bf":
        return (pa * s - x1a * z_buf.float()[:, None, :]).sum(dim=0)
    if kind == "gptq":
        z = z_buf.float()[:, None, :] - float(off)
    else:
        z = float(2 ** (seg.bits - 1) - off)
    return ((pa - x1a * z) * s).sum(dim=0)


def w4a8_quantize(x: torch.Tensor, group_rows: int):
    """The W4A8 activation quantization as buffers the kernel reads: (xq
    int8 [m, K], a f32 [m, G], x1a f32 [m, G]), by the plain version. For
    callers that quantize once and launch many times."""
    xq, a, x1a = w4a8_quantize_plain(x, group_rows)
    return (xq.reshape(x.shape).to(torch.int8).contiguous(),
            a.contiguous(), x1a.contiguous())


def _kernel_w4a8_matmul(x: torch.Tensor, seg, quantized=None) -> torch.Tensor:
    """Launch csrc/qmm_w4a8.cu on one segment (CUDA tensors only): the
    quantization pass, then the integer partials kernel. With `quantized`
    (from w4a8_quantize on the same x) the pass is skipped."""
    from exllamav2_tpu_torch import _build
    _w4a8_check_groups(seg)
    kind, s_buf, z_buf = _w4a8_meta(seg)
    dts = {"scale_f": (torch.bfloat16,) * 2,
           "gptq_bf": (torch.bfloat16,) * 2,
           "gptq": (torch.float32, torch.int32)}[kind]
    m, k_pad, n, bp = _check_launch(
        x, seg, torch.float32,
        [*((p, torch.int32) for p in seg.planes), (s_buf, dts[0]),
         (z_buf, dts[1])])
    gr = seg.group_rows
    groups = k_pad // gr
    if quantized is None:
        xq = torch.empty((m, k_pad), dtype=torch.int8, device=x.device)
        a = torch.empty((m, groups), dtype=torch.float32, device=x.device)
        x1a = torch.empty_like(a)
    else:
        xq, a, x1a = quantized
        for t, dt, shape in ((xq, torch.int8, (m, k_pad)),
                             (a, torch.float32, (m, groups)),
                             (x1a, torch.float32, (m, groups))):
            if (t.device != x.device or t.dtype != dt or t.shape != shape
                    or not t.is_contiguous()):
                raise ValueError(f"quantized buffer {t.dtype} "
                                 f"{tuple(t.shape)} (want {dt} {shape})")
    mma = w4a8_template(m, gr, n) == "mma"
    out, part, splits, per = _out_and_partials(
        x, m, n, k_pad, unit=max(1, gr // SUB_BLOCK),
        per_sm=_MMA_BLOCKS_PER_SM if mma else _BLOCKS_PER_SM)
    fn = _build.function("qmm_w4a8", "qmm_w4a8_segment", _ARGTYPES_W4A8)
    rc = fn(x.data_ptr() if quantized is None else None, m, k_pad,
            xq.data_ptr(), a.data_ptr(),
            x1a.data_ptr(), *_plane_args(seg, bp), n, seg.bits, gr,
            _META_W4A8[kind], s_buf.data_ptr(), z_buf.data_ptr(),
            part.data_ptr(), out.data_ptr(), splits, per, int(mma),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("qmm_w4a8", rc, "qmm_w4a8_segment")
    LAUNCHES["qmm_w4a8"] += 1
    return out


def w4a8_segment_matmul(x: torch.Tensor, seg, quantized=None
                        ) -> torch.Tensor:
    """x [m <= 32, rows_pad] f32 (zero-padded K) -> f32 [m, N] through the
    W4A8 arithmetic. Launches the CUDA kernel on a card tensor; on a CPU
    tensor runs the plain version. `quantized` = w4a8_quantize(x, group
    rows) lets the kernel skip its quantization pass."""
    if x.is_cuda:
        return _kernel_w4a8_matmul(x, seg, quantized)
    return qmm_w4a8_plain(x, seg)


# ---------------------------------------------------------------------------
# GPTQ scales-on-partials (exact)
# ---------------------------------------------------------------------------

def _use_partials(seg) -> bool:
    """The scales-on-partials kernel serves GPTQ segments with groups of
    >= 128 rows when the environment says QMM_PARTIALS=1."""
    return (isinstance(seg, GptqSegment) and seg.group_rows >= 128
            and seg.rows_pad % seg.group_rows == 0
            and os.environ.get("QMM_PARTIALS") == "1")


def qmm_partials_plain(x: torch.Tensor, seg) -> torch.Tensor:
    """Plain version of the scales-on-partials kernel: x bf16
    [m, rows_pad] -> f32 [m, N], y = sum_g s_g * (x_g @ v_g - z_g *
    sum(x_g)) with f32 products of the bf16 activations and the packed
    integer values (each product exact; the sums are f32)."""
    gr = seg.group_rows
    g = seg.rows_pad // gr
    m = x.shape[0]
    vals = D.unpack_planes(seg.planes, seg.plane_bits)
    n = vals.shape[1]
    xg = x.float().reshape(m, g, gr).transpose(0, 1)        # [G, m, gr]
    pg = torch.bmm(xg, vals.float().reshape(g, gr, n))      # [G, m, N]
    xs = xg.sum(dim=2, keepdim=True)                        # [G, m, 1]
    z = seg.zero.float()[:, None, :]
    return ((pg - xs * z) * seg.scale[:, None, :]).sum(dim=0)


def _kernel_partials_matmul(x: torch.Tensor, seg) -> torch.Tensor:
    """Launch csrc/qmm_partials.cu on one segment (CUDA tensors only): one
    device kernel, the group sums of x taken inside it."""
    from exllamav2_tpu_torch import _build
    gr = seg.group_rows
    if gr != 128 and gr % SUB_BLOCK:
        raise NotImplementedError(
            f"group size {gr}: want 128 or a multiple of {SUB_BLOCK}")
    if seg.plane_bits not in ((2,), (2, 1), (4,), (8,)):
        raise NotImplementedError(f"GPTQ planes {seg.plane_bits}")
    m, k_pad, n, bp = _check_launch(
        x, seg, torch.bfloat16,
        [*((p, torch.int32) for p in seg.planes),
         (seg.scale, torch.float32), (seg.zero, torch.int32)])
    if n % 4:
        raise NotImplementedError(f"{n} columns: the kernel reads 4-column "
                                  "chunks")
    if x.data_ptr() % 16:
        x = x.clone()                     # a view at an odd offset
    splits, per = qmm_split(
        n, k_pad // SUB_BLOCK,
        _target_blocks(x.device, _QMM_BLOCKS_PER_SM[qmm_template(m)]),
        unit=max(1, gr // SUB_BLOCK))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("qmm_partials", "qmm_partials_segment",
                         _ARGTYPES_PARTIALS)
    rc = fn(x.data_ptr(), m, k_pad, *_plane_args(seg, bp), n, gr,
            seg.scale.data_ptr(), seg.zero.data_ptr(), out.data_ptr(),
            splits, per, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("qmm_partials", rc, "qmm_partials_segment")
    LAUNCHES["qmm_partials"] += 1
    return out


def partials_segment_matmul(x: torch.Tensor, seg) -> torch.Tensor:
    """x [m <= 32, rows_pad] bf16 @ dequant(GPTQ seg) -> f32 [m, N] in the
    scales-on-partials form. Launches the CUDA kernel on a card tensor; on
    a CPU tensor runs the plain version."""
    if x.is_cuda:
        return _kernel_partials_matmul(x, seg)
    return qmm_partials_plain(x, seg)


def fused_segment_matmul(x: torch.Tensor, seg, gate=None) -> torch.Tensor:
    """x [m <= 32, rows_pad] (zero-padded K; f32 for a W4A8 segment, else
    bf16) @ dequant(seg) -> f32 [m, N]. Dispatch as the reference's: W4A8
    segments, then GPTQ scales-on-partials where asked for, else the fused
    dequant-matmul. Each launches its CUDA kernel on a card tensor; on a
    CPU tensor it runs the plain version. `gate` (int32 [1]): zeros where
    the flag is 0, read by kernel 1 itself; kernels 4 and 5 take none."""
    if gate is not None and (seg.act8 or _use_partials(seg)):
        raise NotImplementedError("only kernel 1 takes a gate")
    if seg.act8:
        return w4a8_segment_matmul(x, seg)
    if _use_partials(seg):
        return partials_segment_matmul(x, seg)
    if x.is_cuda:
        return _kernel_segment_matmul(x, seg, gate)
    if gate is not None:
        return qmm_gated_plain(x, seg, gate)
    return qmm_plain(x, seg)


def gate_capable(linears) -> bool:
    """Every linear of `linears` (an MoE layer's experts) is a QuantLinear
    whose segments kernel 1 serves: no W4A8 segment, none under
    QMM_PARTIALS=1, no LoRA wrap or dense weight. Only then does a gate
    save the weight stream."""
    return all(isinstance(lin, QuantLinear) and not any(
        s.act8 or _use_partials(s) for s in lin.segments) for lin in linears)


def qmm(x: torch.Tensor, lin: QuantLinear, *,
        fused: bool | None = None, gate=None) -> torch.Tensor:
    """x [..., K] -> [..., n] f32 (padded width; caller slices to n_orig);
    zeros where `gate` (int32 [1] on the device) is 0. Every segment of a
    mixed-bit linear reads the same gate."""
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
    if gate is not None and not fused:
        raise ValueError("a gate needs the fused path (<= FUSED_MAX_ROWS "
                         "rows)")
    y = None
    row = 0
    if fused:
        # W4A8 segments quantize their activations to int8 themselves:
        # they are fed f32, so no bf16 rounding lies under the int8 one
        any_act8 = any(seg.act8 for seg in lin.segments)
        x2 = x2.to(torch.float32 if any_act8 else torch.bfloat16)
    for seg in lin.segments:
        xs = x2[:, row:row + seg.rows]
        if fused:
            if not seg.act8:
                xs = xs.to(torch.bfloat16)
            if seg.rows < seg.rows_pad:
                xs = torch.nn.functional.pad(
                    xs, (0, seg.rows_pad - seg.rows))
            part = fused_segment_matmul(xs.contiguous(), seg, gate)
        else:
            part = _dot(xs, D.dequant_segment(seg))
        y = part if y is None else y + part
        row += seg.rows
    if lin.bias is not None:
        bias = torch.nn.functional.pad(lin.bias.float(),
                                       (0, lin.n - lin.n_orig))
        if gate is not None:
            bias = torch.where(gate != 0, bias, torch.zeros_like(bias))
        y = y + bias
    return y.reshape(*lead, lin.n)


def linear_apply(x: torch.Tensor, lin, *,
                 fused: bool | None = None, gate=None) -> torch.Tensor:
    """Apply a (quantized or dense) linear, returning the logical width;
    a QuantLinear's output is zeros where `gate` (an int32 [1] device flag)
    is 0 (qmm).

    A LoRA linear (lora.LoraLinear) adds scaling * (x @ a) @ b to its base
    linear's output, with the reference's rounding points: bf16 x and a, an
    f32 product rounded to bf16, times b to f32 (operands in dot_dtype, as
    every plain product)."""
    if gate is not None and not isinstance(lin, QuantLinear):
        raise NotImplementedError(f"a gate on a {type(lin).__name__}")
    if hasattr(lin, "base") and hasattr(lin, "a"):
        y = linear_apply(x, lin.base, fused=fused)
        xa = _dot(x.to(torch.bfloat16), lin.a)
        return y + lin.scaling * _dot(xa.to(torch.bfloat16), lin.b)
    if isinstance(lin, DenseLinear):
        y = _dot(x, lin.weight)
        if lin.bias is not None:
            y = y + lin.bias.float()
        return y
    y = qmm(x, lin, fused=fused, gate=gate)
    if lin.n != lin.n_orig:
        y = y[..., :lin.n_orig]
    return y
