"""Paged attention over the page pool (PagedKVCache).

Counterpart of exllamav2_tpu/ops/paged_attn.py.

* ``paged_decode_attention`` (t = 1) is the wrapper of csrc/paged_attn.cu,
  the flash-decode kernel over the block table with in-kernel dequant of the
  bf16 / fp8 / q8 / q4 kinds, split over the sequence into the blocks of a
  thread-block cluster (``split_count`` picks the split from the block
  table's width and the SM count; ``decode_attn.head_chunks`` cuts the G
  query heads of a KV head into blocks of at most 16, so any G runs). On a
  card tensor it launches the kernel;
  on a CPU tensor it runs ``paged_decode_attention_plain``, the unsplit page
  recurrence in torch.
* ``paged_attention`` is the attention of the paged forward: the t = 1
  branch folds the Hadamard rotation of the q4 / q8 kinds around the kernel
  (q pre-rotated, output post-rotated); t > 1 gathers and dequantizes the
  sequence's pages and runs a masked softmax.
"""

from __future__ import annotations

import ctypes

import torch

from exllamav2_tpu_torch.cache_paged import _kinds, _raw
from exllamav2_tpu_torch.device import sm_count
from exllamav2_tpu_torch.ops.decode_attn import head_chunks
from exllamav2_tpu_torch.ops.kvquant import hadamard32
from exllamav2_tpu_torch.ops.qmm import dot_f32

__all__ = ["paged_attention", "paged_decode_attention",
           "paged_decode_attention_plain", "split_count", "LAUNCHES",
           "KIND_LAUNCHES"]

# launches of csrc/paged_attn.cu, counted by its wrapper; KIND_LAUNCHES
# splits the same count by (k kind, v kind) template
LAUNCHES = {"paged_decode_attn": 0}
KIND_LAUNCHES: dict[str, int] = {}

_NEG = -1e30
_KIND_CODE = {"bf16": 0, "fp8": 1, "q8": 2, "q4": 3}
_DTYPE = {"bf16": torch.bfloat16, "fp8": torch.float8_e5m2,
          "q8": torch.uint8, "q4": torch.uint8}
_PAIRS = {("bf16", "bf16"), ("fp8", "fp8"), ("q8", "q8"), ("q4", "q4"),
          ("q8", "q4")}

# q, k, v, ks, vs, block_table, valid_lens, layer, batch, hkv, g, gc, d, rows,
# page, pw, scale, softcap, window, kk, vk, splits, positions per split,
# out, stream (csrc/paged_attn.cu)
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 2)

_BLOCKS_PER_SM = 2      # the split fills the card with about this many
SPLIT_WORK = 512        # positions x query heads a split takes at most ...
SPLIT_ROWS = 256        # ... but never fewer positions than this
MAX_SPLITS = 16         # blocks of a cluster (MAX_SPLITS in the source)
SCORE_FLOATS = 8192     # scores a block keeps, G x rows (SC_FLOATS)


def split_count(batch: int, hkv: int, pw: int, page: int, sms: int,
                g: int = 1) -> tuple[int, int]:
    """(splits, positions per split) of the kernel's grid (batch * hkv,
    splits; the caller counts every head chunk in hkv and passes a chunk's
    heads as g): split r takes positions [r*per, (r+1)*per) of the block
    table's pw * page, per a multiple of 16. About _BLOCKS_PER_SM blocks per
    SM, more splits where a split would pass max(SPLIT_ROWS, SPLIT_WORK / g)
    positions (one block walks its range in series, and a row costs more
    with more query heads) or its scores would outgrow the block's
    SCORE_FLOATS, at most MAX_SPLITS (one cluster). A function of
    the page bucket, never of valid_lens, so the grid is fixed for a
    bucket. Where batch * hkv pairs alone fill the card (the serving step's
    16 x 32 over two pages) one split is taken: the generator's buckets are
    padded past the live rows, and a second, empty split still cost more
    than it saved."""
    positions = pw * page
    keep = max(page, SCORE_FLOATS // g // 16 * 16)
    longest = max(SPLIT_ROWS, SPLIT_WORK // g)
    want = max(-(-_BLOCKS_PER_SM * sms // (batch * hkv)),
               -(-positions // longest), -(-positions // keep))
    want = max(1, min(want, MAX_SPLITS, -(-positions // 16)))
    per = -(-positions // want)
    per = -(-per // 16) * 16
    return -(-positions // per), per


def _dq_page(data: torch.Tensor, scales: torch.Tensor | None,
             kind: str) -> torch.Tensor:
    """[.., page, D'] -> f32 [.., page, D] WITHOUT the inverse Hadamard
    (folded into the caller's q pre-rotation / output post-rotation)."""
    if kind in ("bf16", "fp8"):
        return data.float()
    if kind == "q8":
        v = data.float() - 128.0
    else:
        w = data.to(torch.int32)
        v = torch.cat([(w & 15).float() - 8.0, ((w >> 4) & 15).float() - 8.0],
                      dim=-1)                             # natural order
    return v * scales.float().repeat_interleave(32, dim=-1)


def paged_decode_attention_plain(q, k_data, v_data, layer: int,
                                 block_table, valid_lens, k_scales, v_scales,
                                 scale: float, page_size: int, hq: int,
                                 kinds: tuple = ("bf16", "bf16"),
                                 softcap: float = 0.0,
                                 window: int = 0,
                                 dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """Plain version of the kernel: the same recurrence over the page
    columns of the block table, f32 state, K/V and p rounded to bf16.
    -> [B, 1, Hq, D] f32. dtype=torch.float64 evaluates the same rounding
    points with f64 scores and state (a yardstick for how far f32
    summation order alone moves the result)."""
    b, _, d = q.shape
    hkv = k_data.shape[1]
    g = hq // hkv
    kk, vk = kinds
    dev = q.device
    qf = q.to(torch.bfloat16).to(dtype).reshape(b, hkv, g, d)
    vl = valid_lens.to(dev).long()
    bt = block_table.to(dev).long()
    m = torch.full((b, hkv, g, 1), _NEG, device=dev, dtype=dtype)
    l = torch.zeros((b, hkv, g, 1), device=dev, dtype=dtype)
    acc = torch.zeros((b, hkv, g, d), device=dev, dtype=dtype)
    offs = torch.arange(page_size, device=dev)

    def page(data, scales, kind, rows):
        raw = _raw(data)[layer][:, rows].view(data.dtype)  # [H, B, page, D']
        s = scales[layer][:, rows] if scales is not None else None
        out = _dq_page(raw.transpose(0, 1), None if s is None
                       else s.transpose(0, 1), kind)
        return out.to(torch.bfloat16).to(dtype)           # [B, H, page, D]

    for p in range(bt.shape[1]):
        start = p * page_size
        live = start < vl
        if window > 0:
            live = live & (start + page_size > vl - window)
        if not bool(live.any()):
            continue
        rows = bt[:, p, None] * page_size + offs          # [B, page]
        kpg = page(k_data, k_scales, kk, rows)
        vpg = page(v_data, v_scales, vk, rows)
        s = torch.einsum("bhgd,bhpd->bhgp", qf, kpg) * scale
        if softcap > 0.0:
            s = torch.tanh(s * (1.0 / softcap)) * softcap
        pos = start + offs
        valid = pos[None] < vl[:, None]                   # [B, page]
        if window > 0:
            valid = valid & (pos[None] >= vl[:, None] - window)
        s = torch.where(valid[:, None, None], s, torch.full_like(s, _NEG))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        pr = torch.exp(s - m_next)
        l_new = alpha * l + pr.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgp,bhpd->bhgd",
                         pr.float().to(torch.bfloat16).to(dtype), vpg)
        acc_new = acc * alpha + o
        lv = live[:, None, None, None]
        m = torch.where(lv, m_next, m)
        l = torch.where(lv, l_new, l)
        acc = torch.where(lv, acc_new, acc)
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.float().reshape(b, 1, hq, d)


def _kernel(q, k_data, v_data, layer, block_table, valid_lens, k_scales,
            v_scales, scale, page_size, hq, kinds, softcap, window):
    from exllamav2_tpu_torch import _build
    b, hq_in, d = q.shape
    nl, hkv, rows = k_data.shape[:3]
    kk, vk = kinds
    if hq_in != hq or hq % hkv or tuple(kinds) not in _PAIRS:
        raise ValueError(f"q {tuple(q.shape)} hq {hq} hkv {hkv} kinds {kinds}")
    g = hq // hkv
    if d % 32 or d > 256 or page_size > 256 or page_size % 16:
        raise NotImplementedError(f"head_dim {d}, page {page_size}")
    dev = q.device
    want = [(q, torch.bfloat16), (k_data, _DTYPE[kk]), (v_data, _DTYPE[vk]),
            (block_table, torch.int32), (valid_lens, torch.int32)]
    for t, kind in ((k_scales, kk), (v_scales, vk)):
        if kind in ("q4", "q8"):
            if t is None:
                raise ValueError(f"{kind} pool without scales")
            want.append((t, torch.bfloat16))
    for t, dt in want:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{t.dtype} {t.device} contiguous="
                             f"{t.is_contiguous()} (want {dt} on {dev})")
    if (v_data.shape[:3] != (nl, hkv, rows) or block_table.dim() != 2
            or block_table.shape[0] != b or valid_lens.shape != (b,)
            or not 0 <= layer < nl):
        raise ValueError(f"pool {tuple(k_data.shape)} / "
                         f"{tuple(v_data.shape)}, block table "
                         f"{tuple(block_table.shape)}, layer {layer}")
    pw = block_table.shape[1]
    gc, chunks = head_chunks(g, d)
    splits, per = split_count(b, hkv * chunks, pw, page_size,
                              sm_count(dev), gc)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    fn = _build.function("paged_attn", "paged_decode_attention", _ARGTYPES)
    ks = k_scales.data_ptr() if kk in ("q4", "q8") else None
    vs = v_scales.data_ptr() if vk in ("q4", "q8") else None
    rc = fn(q.data_ptr(), k_data.data_ptr(), v_data.data_ptr(), ks, vs,
            block_table.data_ptr(), valid_lens.data_ptr(), layer, b, hkv, g,
            gc, d, rows, page_size, pw, float(scale), float(softcap),
            int(window), _KIND_CODE[kk], _KIND_CODE[vk], splits, per,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("paged_attn", rc, "paged_decode_attention")
    LAUNCHES["paged_decode_attn"] += 1
    key = f"{kk}/{vk}"
    KIND_LAUNCHES[key] = KIND_LAUNCHES.get(key, 0) + 1
    return out.reshape(b, 1, hq, d)


def paged_decode_attention(q: torch.Tensor, k_data: torch.Tensor,
                           v_data: torch.Tensor, layer: int,
                           block_table: torch.Tensor,
                           valid_lens: torch.Tensor, k_scales, v_scales,
                           scale: float, page_size: int, hq: int,
                           kinds: tuple = ("bf16", "bf16"),
                           softcap: float = 0.0,
                           window: int = 0) -> torch.Tensor:
    """Paged flash-decode (t = 1) -> [B, 1, Hq, D] f32.

    q [B, Hq, D] bf16; k/v_data the FULL pool [L, Hkv, rows, D'];
    block_table [B, P] int32 (padding -> the null page 0); valid_lens [B]
    int32 = number of valid KV rows (the cache already holds the current
    token). softcap > 0 applies tanh score capping; window > 0 attends to
    the trailing `window` positions only. Launches csrc/paged_attn.cu on a
    card tensor, runs the plain version on a CPU tensor.
    """
    args = (q, k_data, v_data, layer, block_table, valid_lens, k_scales,
            v_scales, scale, page_size, hq, tuple(kinds), float(softcap),
            int(window))
    if q.is_cuda:
        return _kernel(*args)
    return paged_decode_attention_plain(*args)


def gqa_scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """einsum("btkgd,bksd->bkgts") of queries [B, T, Hkv, G, D] and keys
    [B, Hkv, S, D] -> f32 [B, Hkv, G, T, S], operands in ops/qmm.dot_dtype:
    on the card one bf16 x bf16 batched product with an f32 result on the
    tensor cores (the reference's einsum with preferred_element_type;
    ops/qmm.dot_f32, with a gradient where autograd records), on the CPU
    the f32 einsum."""
    if not qg.is_cuda:
        return torch.einsum("btkgd,bksd->bkgts", qg.float(), k.float())
    b, t, hkv, g, d = qg.shape
    a = qg.permute(0, 2, 3, 1, 4).reshape(b * hkv, g * t, d)
    kt = k.reshape(b * hkv, -1, d).transpose(1, 2)
    y = dot_f32(a.to(torch.bfloat16), kt.to(torch.bfloat16))
    return y.reshape(b, hkv, g, t, -1)


def gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum("bkgts,bksd->btkgd") of probabilities [B, Hkv, G, T, S] and
    values [B, Hkv, S, D] -> f32 [B, T, Hkv, G, D], operands in dot_dtype
    (bf16 on the card with an f32 result, f32 on the CPU)."""
    if not p.is_cuda:
        return torch.einsum("bkgts,bksd->btkgd", p.float(), v.float())
    b, hkv, g, t, s = p.shape
    y = dot_f32(p.reshape(b * hkv, g * t, s).to(torch.bfloat16),
                v.reshape(b * hkv, s, -1).to(torch.bfloat16))
    return y.reshape(b, hkv, g, t, -1).permute(0, 3, 1, 2, 4)


def paged_attention(q: torch.Tensor, cache, layer: int,
                    block_table: torch.Tensor, cache_seqlens: torch.Tensor,
                    *, scale: float, window: int = 0, softcap: float = 0.0,
                    allow_kernel: bool = True) -> torch.Tensor:
    """q [B, T, Hq, D] -> attention output [B, T, Hq, D] f32.

    cache_seqlens[b] = past length BEFORE the current q tokens; the cache
    must already hold the q tokens' K/V at positions cache_seqlens[b] ..
    cache_seqlens[b] + T - 1 (append comes first).
    """
    b, t, hq, d = q.shape
    kk, vk = _kinds(cache.kind)
    # t = 1 takes paged_decode_attention on the card and on the CPU alike:
    # on a CPU tensor its plain version is the kernel's CPU counterpart.
    # (The reference gates this branch on a TPU as well, because off the
    # TPU its Pallas kernel could only run interpreted.)
    if allow_kernel and t == 1 and d % 32 == 0:
        qd = q[:, 0].to(torch.bfloat16)
        eff_scale = float(scale)
        if kk in ("q4", "q8"):
            h32 = hadamard32(device=q.device)
            qr = qd.float().reshape(b, hq, d // 32, 32) @ h32
            qd = qr.reshape(b, hq, d).to(torch.bfloat16)
            eff_scale = eff_scale / 32.0
        out = paged_decode_attention(
            qd.contiguous(), cache.k_data, cache.v_data, layer,
            block_table, (cache_seqlens + 1).to(torch.int32),
            cache.k_scales, cache.v_scales, eff_scale, cache.page_size, hq,
            (kk, vk), float(softcap), int(window))
        if vk in ("q4", "q8"):
            h32 = hadamard32(device=q.device)
            o = out.reshape(b, 1, hq, d // 32, 32) @ h32
            out = (o * (1.0 / 32.0)).reshape(b, 1, hq, d)
        return out

    k, v = cache.gather_layer(layer, block_table)         # [B, Hkv, S, D]
    s = k.shape[2]
    hkv = k.shape[1]
    g = hq // hkv
    scores = gqa_scores(q.reshape(b, t, hkv, g, d), k) * scale
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    pos_q = cache_seqlens.long()[:, None] + torch.arange(
        t, device=q.device)[None]                           # [B, T]
    pos_k = torch.arange(s, device=q.device)
    mask = pos_k[None, None, :] <= pos_q[:, :, None]        # [B, T, S]
    if window > 0:
        mask &= pos_k[None, None, :] > pos_q[:, :, None] - window
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, _NEG))
    out = gqa_values(torch.softmax(scores, dim=-1), v)
    return out.reshape(b, t, hq, d)
