"""Roofline experiments for the quantized-matmul kernels.

Counterpart of the JAX package's tools/perf_qmm.py: candidate decode-path
kernel designs measured against the card's memory rate. Each variant runs in
a subprocess, so a variant that crashes does not end the sweep; the tool
exits non-zero after the sweep if any variant failed.

Shapes mirror Llama-2-7B decode: [M = 8, K] @ [K, N] for the layer matmuls.
The reported number is the effective plane rate, quantized plane bytes over
time, per shape and in total. Weights are cycled through enough copies to
exceed the L2 cache, as a decode step finds them cold.

Usage: python -m exllamav2_tpu_torch.tools.perf_qmm            # all variants
       python -m exllamav2_tpu_torch.tools.perf_qmm <variant>  # one, in-process
       ... --device cpu    # the plain versions at a small shape
QMM_BITS (default 4) and QMM_GROUP (default 32; 128 = GPTQ-like groups) set
the plane width and the group size; QMM_M (default 8) the activation rows of
the variant `current` (the fused kernel's template follows m).

The three kernels of csrc/perf_qmm.cu have their wrappers and plain versions
here: `dma_only` (the streaming ceiling), `gp` (group partials, bf16 or int8
activations) and `nibble_i8` (the 4-bit nibble split); `gp` and `nibble_i8`
split K over a thread-block cluster as `nibble_tiles` picks.
On a CPU tensor a wrapper runs the plain version; on a card tensor it
launches the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import subprocess
import sys

import torch

from exllamav2_tpu_torch.ops import dequant as D

__all__ = ["VARIANTS", "SHAPES", "M", "LAUNCHES", "dma_only",
           "dma_only_tiles", "dma_only_tiles_plain", "gp", "gp_plain",
           "nibble_i8", "nibble_i8_plain", "nibble_tiles",
           "nibble_values", "dense_weight", "mk_inputs",
           "report_line", "time_cycled", "variant_linear",
           "quantize_x", "group_sums", "main"]

VARIANTS = {}


def variant(name):
    """Register `fn(device) -> (report name, [(plane bytes, seconds) per
    shape])` as the variant `name` (the wrappers of the kernels own the
    plain names)."""
    def register(fn):
        VARIANTS[name] = fn
        return fn
    return register


SHAPES = [  # (K, N) of Llama-2-7B linears
    (4096, 4096),
    (4096, 11008),
    (11008, 4096),
]
CPU_SHAPES = [(4096, 256)]     # what --device cpu runs
M = 8
CURRENT_M = int(os.environ.get("QMM_M", M))
BITS = int(os.environ.get("QMM_BITS", 4))
GR = int(os.environ.get("QMM_GROUP", 32))
DMA_TILE = 512                 # word rows per K tile of dma_only
SUB_BLOCK = 256
L2_BYTES = 50 << 20

# launches of each kernel of csrc/perf_qmm.cu, counted by its wrapper
LAUNCHES = {"perf_qmm_dma_only": 0, "perf_qmm_gp_bf16": 0,
            "perf_qmm_gp_int8": 0, "perf_qmm_nibble_i8": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS_DMA = [_P, _I, _I, _P, _P]
# x, plane, qs, smax, k, n, bits, gr, int8 mode, kt, nt, out, stream
_ARGS_GP = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]
# xq, x1, plane, qs, smax, k, n, gr, kt, nt, out, stream
_ARGS_NIBBLE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
# the K splits of the nibble and gp kernels are the blocks of one
# thread-block cluster (NIB_MAX_SPLITS in the source, a non-portable size)
# and their blocks hold 8 warps (NIB_WARPS)
NIBBLE_MAX_SPLITS = 16
_NIBBLE_WARPS = 8


def report_line(name, per_shape) -> str:
    """per_shape: list of (qbytes, seconds) -> the tool's report line."""
    tot_b = sum(b for b, _ in per_shape)
    tot_t = sum(t for _, t in per_shape)
    gbs = tot_b / tot_t / 1e9
    detail = " ".join(f"{b/t/1e9:.0f}" for b, t in per_shape)
    return f"{name}: {gbs:.0f} GB/s  [{detail}]"


def _check_bits(bits: int) -> None:
    if bits not in (1, 2, 4, 8):
        raise NotImplementedError(
            f"QMM_BITS={bits}: the tool's kernels take one plane, of 1, 2, "
            "4 or 8 bits")


def _check_group(k: int, gr: int) -> None:
    if gr < 16 or gr > SUB_BLOCK or gr & (gr - 1) or k % SUB_BLOCK:
        raise NotImplementedError(
            f"group size {gr} over K = {k}: want a power of two in "
            f"[16, {SUB_BLOCK}] and K a multiple of {SUB_BLOCK}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_buffers(*pairs) -> None:
    dev = pairs[0][0].device
    for t, dt in pairs:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"buffer {t.dtype} on {t.device} contiguous="
                             f"{t.is_contiguous()} (want {dt} on {dev})")


def mk_inputs(k: int, n: int, device, seed: int = 0, bits: int | None = None,
              gr: int | None = None):
    """(plane int32 [k*bits/32, n] holding uint32 bits, qs uint8 [k/gr, n] in
    1..16, smax f32 [k/gr, 1], x f32 [M, k]) from a torch.Generator on
    `device`."""
    bits = BITS if bits is None else bits
    gr = GR if gr is None else gr
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    plane = torch.randint(-2 ** 31, 2 ** 31, (k * bits // 32, n),
                          dtype=torch.int32, generator=gen, device=device)
    qs = torch.randint(1, 17, (k // gr, n), dtype=torch.uint8, generator=gen,
                       device=device)
    smax = torch.rand((k // gr, 1), dtype=torch.float32, generator=gen,
                      device=device) * 3e-3
    x = torch.randn((M, k), dtype=torch.float32, generator=gen,
                    device=device)
    return plane, qs, smax, x


def quantize_x(x: torch.Tensor) -> torch.Tensor:
    """The tool's fixed-scale activation quantization: int8 of
    clip(round(12 x), -127, 127)."""
    return torch.clamp(torch.round(x * 12), -127, 127).to(torch.int8)


def group_sums(xq: torch.Tensor, gr: int) -> torch.Tensor:
    """x1 f32 [M, K/gr]: the per-group sums of xq."""
    m, k = xq.shape
    return xq.reshape(m, k // gr, gr).to(torch.float32).sum(dim=2)


# ---------------------------------------------------------------------------
# dma_only
# ---------------------------------------------------------------------------

def dma_only_tiles_plain(plane: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 [ceil(kq / 512), N], row t the column sums of
    f32(int32(word)) over word rows 512 t .. 512 t + 511 (fewer in a ragged
    last tile)."""
    kq, n = plane.shape
    tiles = -(-kq // DMA_TILE)
    v = plane.to(torch.float32)
    v = torch.nn.functional.pad(v, (0, 0, 0, tiles * DMA_TILE - kq))
    return v.reshape(tiles, DMA_TILE, n).sum(dim=1)


def dma_only_tiles(plane: torch.Tensor) -> torch.Tensor:
    """Every K tile's column sums of the plane, f32 [tiles, N]: each word
    read once. Launches the CUDA kernel on a card tensor; on a CPU tensor
    runs the plain version."""
    if not plane.is_cuda:
        return dma_only_tiles_plain(plane)
    from exllamav2_tpu_torch import _build
    _check_buffers((plane, torch.int32))
    kq, n = plane.shape
    if n % 4:
        raise ValueError(f"N = {n}: the kernel loads four columns at once")
    tiles = torch.empty((-(-kq // DMA_TILE), n), dtype=torch.float32,
                        device=plane.device)
    fn = _build.function("perf_qmm", "perf_dma_only", _ARGS_DMA)
    rc = fn(plane.data_ptr(), kq, n, tiles.data_ptr(), _stream(plane))
    _build.check("perf_qmm", rc, "perf_dma_only")
    LAUNCHES["perf_qmm_dma_only"] += 1
    return tiles


def dma_only(plane: torch.Tensor) -> torch.Tensor:
    """f32 [8, N]: the column sums of the LAST FULL K tile, broadcast to 8
    rows -- what the reference's kernel leaves in its output block (its grid
    holds kq // 512 tiles and every tile overwrites the block). The whole
    plane is read all the same, a ragged last tile included."""
    kq, n = plane.shape
    if kq < DMA_TILE:
        raise ValueError(f"{kq} word rows: dma_only needs one full tile of "
                         f"{DMA_TILE}")
    return dma_only_tiles(plane)[kq // DMA_TILE - 1].expand(8, n)


# ---------------------------------------------------------------------------
# gp: group partials on the strided-plane layout
# ---------------------------------------------------------------------------

def gp_plain(x: torch.Tensor, plane: torch.Tensor, qs: torch.Tensor,
             smax: torch.Tensor, bits: int, gr: int) -> torch.Tensor:
    """Plain version of both modes, by the type of x [M, K]:
    bf16: y = sum_g s_g * (x_g @ f32(v_g - 8));
    int8: y = sum_g s_g * (f32(xq_g . int8(v_g)) - 8 * sum(xq_g)), the dot
    in f32 on integer values (exact below 2^24).
    s = fp16-rounded EXL2 scales, v the unpacked plane. -> f32 [M, N]."""
    m, k = x.shape
    g = k // gr
    s = D.exl2_scales(qs, smax)                              # [G, N]
    vals = D.unpack_plane(plane, bits)                       # [K, N] int32
    n = vals.shape[1]
    xg = x.to(torch.float32).reshape(m, g, gr).transpose(0, 1)   # [G, M, gr]
    if x.dtype == torch.int8:
        w = vals.to(torch.int8).to(torch.float32).reshape(g, gr, n)
        p = torch.bmm(xg, w) - 8.0 * xg.sum(dim=2, keepdim=True)
    else:
        w = (vals - 8).to(torch.float32).reshape(g, gr, n)
        p = torch.bmm(xg, w)
    return (p * s[:, None, :]).sum(dim=0)


def gp(x: torch.Tensor, plane: torch.Tensor, qs: torch.Tensor,
       smax: torch.Tensor, bits: int | None = None,
       gr: int | None = None) -> torch.Tensor:
    """Group partials: x [8, K] (bf16, or int8 from `quantize_x`) against
    the packed plane -> f32 [8, N]. Launches the CUDA kernel (one launch, K
    split over a thread-block cluster as `nibble_tiles` says) on a card tensor;
    on a CPU tensor runs the plain version."""
    bits = BITS if bits is None else bits
    gr = GR if gr is None else gr
    _check_bits(bits)
    m, k = x.shape
    _check_group(k, gr)
    if x.dtype not in (torch.bfloat16, torch.int8) or m != M:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype}: want [{M}, K] bf16 "
                         "or int8")
    if not x.is_cuda:
        return gp_plain(x, plane, qs, smax, bits, gr)
    from exllamav2_tpu_torch import _build
    from exllamav2_tpu_torch.device import sm_count
    _check_buffers((x, x.dtype), (plane, torch.int32), (qs, torch.uint8),
                   (smax, torch.float32))
    n = plane.shape[1]
    if plane.shape[0] != k * bits // 32 or qs.shape != (k // gr, n) \
            or smax.numel() != k // gr:
        raise ValueError(f"plane {tuple(plane.shape)}, qs {tuple(qs.shape)},"
                         f" smax {tuple(smax.shape)} vs K = {k}, gr = {gr}")
    if x.data_ptr() % 16:
        x = x.clone()              # the kernel reads x in aligned pieces
    int8 = x.dtype == torch.int8
    kt, nt = nibble_tiles(k, n, sm_count(x.device))
    out = torch.empty((M, n), dtype=torch.float32, device=x.device)
    fn = _build.function("perf_qmm", "perf_gp", _ARGS_GP)
    rc = fn(x.data_ptr(), plane.data_ptr(), qs.data_ptr(), smax.data_ptr(),
            k, n, bits, gr, int(int8), kt, nt, out.data_ptr(), _stream(x))
    _build.check("perf_qmm", rc, "perf_gp")
    LAUNCHES["perf_qmm_gp_int8" if int8 else "perf_qmm_gp_bf16"] += 1
    return out


# ---------------------------------------------------------------------------
# nibble_i8: the 4-bit nibble split
# ---------------------------------------------------------------------------

def nibble_values(plane: torch.Tensor, gr: int) -> torch.Tensor:
    """int32 [K, N] in 0..15: the values of a 4-bit plane in the row order
    the nibble split meets them. lo = w & 0x0F0F0F0F, hi = (w >> 4) &
    0x0F0F0F0F, each word reinterpreted as four int8 rows under ROW MAPPING
    A (row 4k + j is byte j of word k, little-endian). Group g takes word
    rows g*gr/8 .. (g+1)*gr/8: its first gr/2 rows are the lo rows, its
    second gr/2 the hi rows."""
    kq, n = plane.shape
    g = kq * 8 // gr
    shifts = torch.arange(4, dtype=torch.int32, device=plane.device) * 8
    byts = (plane[:, None, :] >> shifts[None, :, None]) & 0xFF  # [kq, 4, N]
    lo = (byts & 0x0F).reshape(g, gr // 2, n)
    hi = ((byts >> 4) & 0x0F).reshape(g, gr // 2, n)
    return torch.cat([lo, hi], dim=1).reshape(kq * 8, n)


def dense_weight(vals: torch.Tensor, qs: torch.Tensor, smax: torch.Tensor,
                 gr: int) -> torch.Tensor:
    """bf16 [K, N]: (vals - 8) times the fp16-rounded group scales, the
    weight a library matmul of the same function multiplies by (vals from
    `unpack_plane` for gp, from `nibble_values` for the nibble split)."""
    s = D.broadcast_groups(D.exl2_scales(qs, smax), gr)
    return ((vals - 8).to(torch.float32) * s).to(torch.bfloat16)


def nibble_i8_plain(xq: torch.Tensor, x1: torch.Tensor, plane: torch.Tensor,
                    qs: torch.Tensor, smax: torch.Tensor,
                    gr: int) -> torch.Tensor:
    """Plain version: per group the activations meet the rows of
    `nibble_values` (the dot in f32 on integer values, exact), then
    y = sum_g s_g * p_g - 8 * (x1 @ s) -> f32 [M, N]."""
    m, k = xq.shape
    g = k // gr
    n = plane.shape[1]
    s = D.exl2_scales(qs, smax)                              # [G, N]
    w = nibble_values(plane, gr).to(torch.float32).reshape(g, gr, n)
    xg = xq.to(torch.float32).reshape(m, g, gr).transpose(0, 1)
    p = torch.bmm(xg, w)                                     # [G, M, N]
    return (p * s[:, None, :]).sum(dim=0) - 8.0 * torch.matmul(x1, s)


def nibble_tiles(k: int, n: int, sms: int, kt0: int = 1024,
                 nt0: int = 2048) -> tuple[int, int]:
    """(K rows a split takes, columns a block takes) of the grid (column
    blocks, splits) of the nibble and gp kernels, which share their blocks
    and cluster, from the shape, the card's SM count and the tile hints of
    the reference's grid (gp takes the defaults).

    A block takes nt0 / 64 columns, a power of two in [32, 256] (2048 ->
    32, 4096 -> 64): nt / 32 warps across the columns, the rest of its 8
    warps across K. K is split into about 1.5 blocks an SM, but into no
    more splits than leave every K warp a 256-row unit, than
    NIBBLE_MAX_SPLITS (one cluster) or than K / kt0 (kt0 is the fewest rows
    a split takes). Splits are multiples of 256 rows (whole groups of every
    size the tool takes) and none is empty. They change how K is split,
    not the function."""
    nt = 32
    while nt < 256 and 2 * nt <= nt0 // 64:
        nt *= 2
    units = k // SUB_BLOCK
    blocks = -(-n // nt)
    splits = min((3 * sms + blocks) // (2 * blocks),
                 units // (_NIBBLE_WARPS * 32 // nt), NIBBLE_MAX_SPLITS,
                 k // max(kt0, SUB_BLOCK))
    per = -(-units // max(1, splits))
    return per * SUB_BLOCK, nt


def nibble_i8(xq: torch.Tensor, x1: torch.Tensor, plane: torch.Tensor,
              qs: torch.Tensor, smax: torch.Tensor, gr: int | None = None,
              kt0: int = 1024, nt0: int = 2048) -> torch.Tensor:
    """The nibble split on a 4-bit plane: xq int8 [8, K], x1 f32 [8, K/gr]
    -> f32 [8, N]. Launches the CUDA kernel (one launch, K split over a
    thread-block cluster as `nibble_tiles` says) on a card tensor; on a CPU
    tensor runs the plain version."""
    gr = GR if gr is None else gr
    m, k = xq.shape
    _check_group(k, gr)
    if xq.dtype != torch.int8 or m != M:
        raise ValueError(f"xq {tuple(xq.shape)} {xq.dtype}: want [{M}, K] "
                         "int8")
    if not xq.is_cuda:
        return nibble_i8_plain(xq, x1, plane, qs, smax, gr)
    from exllamav2_tpu_torch import _build
    _check_buffers((xq, torch.int8), (x1, torch.float32),
                   (plane, torch.int32), (qs, torch.uint8),
                   (smax, torch.float32))
    n = plane.shape[1]
    if plane.shape[0] != k // 8 or qs.shape != (k // gr, n) \
            or smax.numel() != k // gr or x1.shape != (M, k // gr):
        raise ValueError(f"plane {tuple(plane.shape)}, qs {tuple(qs.shape)},"
                         f" x1 {tuple(x1.shape)} vs K = {k}, gr = {gr}")
    from exllamav2_tpu_torch.device import sm_count
    kt, nt = nibble_tiles(k, n, sm_count(xq.device), kt0, nt0)
    out = torch.empty((M, n), dtype=torch.float32, device=xq.device)
    fn = _build.function("perf_qmm", "perf_nibble", _ARGS_NIBBLE)
    rc = fn(xq.data_ptr(), x1.data_ptr(), plane.data_ptr(), qs.data_ptr(),
            smax.data_ptr(), k, n, gr, kt, nt, out.data_ptr(), _stream(xq))
    _build.check("perf_qmm", rc, "perf_nibble")
    LAUNCHES["perf_qmm_nibble_i8"] += 1
    return out


# ---------------------------------------------------------------------------
# timing and the variants
# ---------------------------------------------------------------------------

def n_copies(nbytes: int) -> int:
    """Copies of a weight that together exceed twice the L2 cache."""
    return max(1, -(-2 * L2_BYTES // nbytes))


def time_cycled(call, weights, like: torch.Tensor,
                iters: int | None = None) -> float:
    """Seconds per call of `call(weight)`, cycling through `weights` (so a
    call finds its weight out of cache, as a decode step does). `like` is
    any tensor on the device the calls run on."""
    from exllamav2_tpu_torch.utils.timing import device_time
    count = itertools.count()
    if iters is None:
        iters = 64 if like.is_cuda else 4
    return device_time(
        lambda _: call(weights[next(count) % len(weights)]), like,
        iters=iters)


def _copies(t: torch.Tensor) -> list:
    n = n_copies(t.numel() * t.element_size()) if t.is_cuda else 1
    return [t] + [t.clone() for _ in range(n - 1)]


def _shapes(device) -> list:
    return SHAPES if torch.device(device).type == "cuda" else CPU_SHAPES


def variant_linear(gen: torch.Generator, k: int, n: int, device,
                   w4a8: bool):
    """One random EXL2 linear of BITS and GR as the variants `current`
    (w4a8=False) and `w4a8_prod` / `w4a8_kernel` (w4a8=True) time it."""
    from exllamav2_tpu_torch.utils.testing import random_quant_linear
    lin = random_quant_linear(gen, k, n, bits=BITS, group_rows=GR,
                              device=device)
    return D.enable_w4a8_linear(lin) if w4a8 else lin


def _linears(k, n, device, w4a8: bool) -> list:
    """Copies of one random EXL2 linear of BITS and GR, past the L2."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    one = variant_linear(gen, k, n, device, w4a8)
    extra = n_copies(_plane_bytes(one)) - 1 \
        if torch.device(device).type == "cuda" else 0
    return [one] + [variant_linear(gen, k, n, device, w4a8)
                    for _ in range(extra)]


def _plane_bytes(lin) -> int:
    return sum(p.numel() * 4 for s in lin.segments for p in s.planes)


@variant("current")
def _current(device):
    """The fused dequant-matmul kernel (csrc/qmm.cu) through qmm()."""
    from exllamav2_tpu_torch.ops.qmm import qmm
    rows = []
    for k, n in _shapes(device):
        lins = _linears(k, n, device, w4a8=False)
        x = torch.ones((CURRENT_M, k), dtype=torch.bfloat16, device=device)
        t = time_cycled(lambda lin: qmm(x, lin, fused=True), lins, x)
        rows.append((_plane_bytes(lins[0]), t))
    return "current", rows


@variant("w4a8_prod")
def _w4a8_prod(device):
    """The W4A8 path end to end through qmm(): the activation quantization
    pass and csrc/qmm_w4a8.cu. Compare against gp_int8 (the isolated form)
    to see what the production path adds."""
    from exllamav2_tpu_torch.ops.qmm import qmm
    rows = []
    for k, n in _shapes(device):
        lins = _linears(k, n, device, w4a8=True)
        x = torch.ones((M, k), dtype=torch.float32, device=device)
        t = time_cycled(lambda lin: qmm(x, lin, fused=True), lins, x)
        rows.append((_plane_bytes(lins[0]), t))
    return "w4a8_prod", rows


@variant("w4a8_kernel")
def _w4a8_kernel(device):
    """The W4A8 kernel alone: the activations are quantized once, outside
    the timed chain."""
    from exllamav2_tpu_torch.ops import qmm as Q
    rows = []
    for k, n in _shapes(device):
        lins = _linears(k, n, device, w4a8=True)
        seg0 = lins[0].segments[0]
        x = torch.nn.functional.pad(
            torch.ones((M, k), dtype=torch.float32, device=device),
            (0, seg0.rows_pad - seg0.rows))
        quantized = Q.w4a8_quantize(x, seg0.group_rows)
        t = time_cycled(
            lambda lin: Q.w4a8_segment_matmul(x, lin.segments[0],
                                              quantized=quantized), lins, x)
        rows.append((_plane_bytes(lins[0]), t))
    return "w4a8_kernel", rows


@variant("dma_only")
def _dma_only(device):
    """Ceiling: stream the planes, one reduction per block (no dequant)."""
    rows = []
    for k, n in _shapes(device):
        plane = mk_inputs(k, n, device)[0]
        t = time_cycled(dma_only, _copies(plane), plane)
        rows.append((plane.numel() * 4, t))
    return "dma_only", rows


def _run_gp(mode: str, device):
    rows = []
    for k, n in _shapes(device):
        plane, qs, smax, x = mk_inputs(k, n, device)
        xa = quantize_x(x) if mode == "int8" else x.to(torch.bfloat16)
        t = time_cycled(lambda p: gp(xa, p, qs, smax), _copies(plane), plane)
        rows.append((plane.numel() * 4, t))
    return f"gp_{mode}", rows


@variant("gp_bf16")
def _gp_bf16(device):
    return _run_gp("bf16", device)


@variant("gp_int8")
def _gp_int8(device):
    return _run_gp("int8", device)


def _run_nibble(device, kt0: int = 1024, nt0: int = 2048):
    if BITS != 4:
        raise NotImplementedError("the nibble split is for 4-bit planes")
    rows = []
    for k, n in _shapes(device):
        plane, qs, smax, x = mk_inputs(k, n, device)
        xq = quantize_x(x)
        x1 = group_sums(xq, GR)
        t = time_cycled(
            lambda p: nibble_i8(xq, x1, p, qs, smax, kt0=kt0, nt0=nt0),
            _copies(plane), plane)
        rows.append((plane.numel() * 4, t))
    return f"nibble_i8_k{kt0}_n{nt0}", rows


@variant("nibble_i8")
def _nibble_i8(device):
    return _run_nibble(device)


@variant("nibble_i8_k2048")
def _nibble_i8_k2048(device):
    return _run_nibble(device, kt0=2048)


@variant("nibble_i8_n4096")
def _nibble_i8_n4096(device):
    return _run_nibble(device, nt0=4096)


def main(argv=None) -> int:
    from exllamav2_tpu_torch.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variant", nargs="?", choices=sorted(VARIANTS))
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions at a small shape; "
                         "default: the card (an error without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    _check_bits(BITS)
    if args.variant:
        print(report_line(*VARIANTS[args.variant](device)))
        return 0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu (plain versions)"
    print(f"device: {where}; bits {BITS}, group {GR}, M {M}", flush=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    failed = []
    for name in VARIANTS:
        r = subprocess.run(
            [sys.executable, "-m", "exllamav2_tpu_torch.tools.perf_qmm",
             name, "--device", str(device)],
            capture_output=True, text=True, timeout=900, cwd=root)
        out = (r.stdout or "").strip()
        if r.returncode == 0 and out:
            print(out.splitlines()[-1], flush=True)
        else:
            failed.append(name)
            tail = [line for line in (r.stderr or r.stdout).strip()
                    .splitlines() if line.strip()]
            print(f"{name} -> FAIL: "
                  f"{' | '.join(tail[-2:]) if tail else 'crash'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
