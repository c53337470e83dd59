"""Decode attention (t = 1) over the linear KV cache.

Counterpart of exllamav2_tpu/ops/decode_attn.py. On a card tensor the
wrapper launches csrc/decode_attn.cu; on a CPU tensor it runs the plain
version below, which computes the reference's exp / sum softmax. The
kernel is flash-decoding: the cache rows below `limit` are split across
blocks (the split is picked from the bucket and the SM count), each split
runs an online softmax and the last block of a (batch, KV head, head block)
merges the splits. `tile_plan` picks its template from the shape alone:
one query head a KV head takes the CUDA-core template, G >= MMA_MIN_G take
the mma template, where a KV head's G query heads are the rows of bf16
tensor-core tiles (mma.sync) and its K/V rows are read once for all of
them (up to 64 heads a block; more go to ceil(G / 64) blocks).

Scratch of a launch with more than one split: the splits' unnormalised
outputs f32 [splits, B, Hq, D] and their (max, sum) f32 [splits, B, Hq, 2],
from torch.empty; and one int32 counter per (batch, KV head, head block),
kept per
(device, stream) by device.stream_counters, which the kernel leaves at 0
(launches on one stream share it in stream order; two streams never do).

Cache layout is [L, B, H_kv, S, D]; only rows below `limit` are read (the
caller buckets past_len). GQA maps G query heads onto each KV head.

past_len is a host int or an int32 device tensor (0-d or [1]: one position
for every row; [B]: one per row). The kernel reads it from device memory,
so a captured CUDA graph of a decode step (utils/graphs.py) replays at any
later position of its bucket; a host int is checked here and written to a
one-element tensor, a tensor is checked by its caller, which knows the
position on the host.
"""

from __future__ import annotations

import ctypes

import torch

from exllamav2_tpu_torch.device import sm_count, stream_counters

__all__ = ["decode_attention", "decode_attention_plain", "split_count",
           "tile_plan", "grid", "LAUNCHES"]

# launches of csrc/decode_attn.cu, counted by its wrapper
LAUNCHES = {"decode_attn": 0}

_NEG = -1e30

# q, k, v, the four cache strides, layer, batch, hkv, g, gc, mt, d, past_len
# (a device pointer), its stride, limit, scale, softcap, window, splits,
# rows per split, out, the two scratch buffers, the counters, stream
# (csrc/decode_attn.cu)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
             + [ctypes.c_int] * 7 + [ctypes.c_void_p] + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 5)

_BLOCKS_PER_SM = 3      # the split fills the card with about this many
_SPLIT_ROWS = 32        # fewest cache rows a split takes
MAX_SPLITS = 64         # MAX_SPLITS in the source
MAX_MT = 4              # m16 tiles of the mma template a block (gqa::MAX_MT)
# G from which the mma template runs: timed once against the CUDA-core
# template at every G of chip_smoke.py phase 3, it won at every case,
# Gemma-3's 16/8 at D 256 included (PERF.md §6)
MMA_MIN_G = 2
_MMA_SPLIT_ROWS = 64    # fewest cache rows a split of the mma template takes
_MMA_HEAD_ROWS = 4      # ... and at least this many a query head of a block


def tile_plan(g: int, min_g: int | None = None) -> tuple[int, int, int]:
    """(heads a block, blocks a KV head, m16 tiles a block) of kernels 2
    and 3 for G query heads per KV head; 0 tiles is the CUDA-core template,
    below min_g heads (kernel 2's MMA_MIN_G unless given), which holds all
    G heads in one block (the sources build it for G = 1 in kernel 2 and
    G <= 4 in kernel 3, and refuse more). A block attends for heads
    c * heads .. of its KV head (the last block may hold fewer); blocks =
    ceil(g / heads), so no block is empty. The mma template holds up to
    16 * MAX_MT heads in one block (48: one block of three tiles; 71: two
    blocks of 36 and 35)."""
    if g < (MMA_MIN_G if min_g is None else min_g):
        return g, 1, 0
    blocks = -(-g // (16 * MAX_MT))
    heads = -(-g // blocks)
    return heads, blocks, -(-heads // 16)


def split_count(batch: int, hkv: int, limit: int, sms: int,
                rows: int = _SPLIT_ROWS) -> tuple[int, int]:
    """(splits, rows per split) of the kernel's grid (batch * hkv, splits;
    the caller counts every head block in hkv):
    about _BLOCKS_PER_SM blocks per SM, a multiple of `rows` rows a split
    (a multiple of 32), at most MAX_SPLITS. A function of the bucket
    `limit`, not of past_len, so the grid is fixed for a bucket."""
    want = -(-_BLOCKS_PER_SM * sms // (batch * hkv))
    want = max(1, min(want, MAX_SPLITS, -(-limit // rows)))
    per = -(-limit // want)
    per = -(-per // rows) * rows
    return -(-limit // per), per


def mma_split_rows(heads: int) -> int:
    """Fewest rows a split of the mma template takes for a block of `heads`
    query heads: a split's partial (heads x D floats, merged by one block)
    outgrows its rows' K/V bytes when the rows are few and the heads many."""
    return max(_MMA_SPLIT_ROWS, -(-_MMA_HEAD_ROWS * heads // 32) * 32)


def grid(batch: int, hkv: int, g: int, limit: int, sms: int
         ) -> tuple[int, int, int, int, int]:
    """(heads a block, blocks a KV head, m16 tiles, splits, rows a split)
    of a launch: tile_plan's template and split_count's split for it."""
    heads, blocks, mt = tile_plan(g)
    splits, per = split_count(batch, hkv * blocks, limit, sms,
                              mma_split_rows(heads) if mt else _SPLIT_ROWS)
    return heads, blocks, mt, splits, per


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, layer: int, past_len,
                           limit: int, scale: float, softcap: float = 0.0,
                           window: int = 0) -> torch.Tensor:
    """Plain version: q [B, Hq, D], k/v FULL cache [L, B, Hkv, S, D]
    -> out [B, Hq, D] f32, softmax in f32. past_len: an int, or a 0-d /
    [1] / [B] integer tensor."""
    b, hq, d = q.shape
    hkv, s_max = k.shape[2], k.shape[3]
    g = hq // hkv
    limit = min(limit, s_max)
    kk = k[layer, :, :, :limit].float()                   # [B, Hkv, L, D]
    vv = v[layer, :, :, :limit].float()
    qh = q.float().reshape(b, hkv, g, d)
    sc = torch.einsum("bhgd,bhld->bhgl", qh, kk) * scale
    if softcap > 0.0:
        sc = torch.tanh(sc * (1.0 / softcap)) * softcap
    pos = torch.arange(limit, device=q.device)
    if isinstance(past_len, torch.Tensor):                 # [B or 1, 1, 1, 1]
        past_len = past_len.to(q.device).long().reshape(-1, 1, 1, 1)
    valid = pos <= past_len
    if window > 0:
        valid = valid & (pos > past_len - window)
    sc = torch.where(valid, sc, torch.full_like(sc, _NEG))
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgl,bhld->bhgd", p, vv)
    return out.reshape(b, hq, d)


def _kernel(q, k, v, layer, past_len, limit, scale, softcap, window):
    from exllamav2_tpu_torch import _build
    b, hq, d = q.shape
    nl, kb, hkv, s_max, kd = k.shape
    if (k.shape != v.shape or k.stride() != v.stride() or kb != b
            or kd != d or hq % hkv):
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if (q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16
            or v.dtype != torch.bfloat16 or not q.is_contiguous()
            or k.stride(-1) != 1 or not (q.device == k.device == v.device)):
        raise ValueError("q, k, v must be bf16 on one device, q contiguous, "
                         "unit stride along D")
    g = hq // hkv
    if d % 32 or d > 256:
        raise NotImplementedError(f"head_dim {d}")
    if (any(st % 8 for st in k.stride()[:4]) or k.data_ptr() % 16
            or v.data_ptr() % 16):
        raise ValueError("K/V rows must be 16-byte aligned")
    limit = min(limit, s_max)
    if not 0 <= layer < nl:
        raise ValueError(f"layer {layer} of {nl}")
    dev = q.device
    if isinstance(past_len, torch.Tensor):
        if (past_len.dtype != torch.int32 or past_len.device != dev
                or past_len.numel() not in (1, b)
                or not past_len.is_contiguous()):
            raise ValueError(f"past_len {past_len.dtype} "
                             f"{tuple(past_len.shape)} on {past_len.device}: "
                             f"want contiguous int32, 1 or {b} values, on "
                             f"{dev}")
        pl = past_len
    else:
        if not 0 <= past_len < limit:
            raise ValueError(f"past_len {past_len}, limit {limit}")
        pl = torch.full((1,), past_len, dtype=torch.int32, device=dev)
    gc, chunks, mt, splits, per = grid(b, hkv, g, limit, sm_count(dev))
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    scratch = ()
    if splits > 1:
        scratch = (torch.empty((splits, b, hq, d), dtype=torch.float32,
                               device=dev),
                   torch.empty((splits, b, hq, 2), dtype=torch.float32,
                               device=dev),
                   stream_counters(dev, b * hkv * chunks))
    fn = _build.function("decode_attn", "decode_attention", _ARGTYPES)
    sl, sb, sh, ss, _ = k.stride()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), sl, sb, sh, ss,
            layer, b, hkv, g, gc, mt, d, pl.data_ptr(),
            int(pl.numel() > 1),
            limit, float(scale),
            float(softcap), int(window), splits, per, out.data_ptr(),
            *([t.data_ptr() for t in scratch] or [None] * 3),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check("decode_attn", rc, "decode_attention")
    LAUNCHES["decode_attn"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layer: int, past_len, limit: int, scale: float,
                     softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """q [B, Hq, D] (t=1), k/v FULL cache [L, B, Hkv, S, D] -> [B, Hq, D] f32.

    Attends to positions 0..past_len (inclusive: the current token's K/V must
    already be written); `limit` bounds the S rows read. past_len is a host
    int (checked against limit here) or an int32 tensor on q's device, 0-d,
    [1] or [B] (each value in [0, limit): the caller checks). softcap > 0
    applies tanh capping; window > 0 limits attention to the trailing
    window. The layer's slice is read in place: the cache is never copied.
    """
    if q.is_cuda:
        return _kernel(q, k, v, layer, past_len, limit, scale, softcap,
                       window)
    return decode_attention_plain(q, k, v, layer, past_len, limit, scale,
                                  softcap, window)
