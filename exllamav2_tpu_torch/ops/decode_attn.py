"""Decode attention (t = 1) over the linear KV cache.

Counterpart of exllamav2_tpu/ops/decode_attn.py. On a card tensor the
wrapper launches csrc/decode_attn.cu (one block per batch row and KV head,
online softmax over tiles of the live rows); on a CPU tensor it runs the
plain version below, which computes the reference's exp / sum softmax.

Cache layout is [L, B, H_kv, S, D]; only rows below `limit` are read (the
caller buckets past_len). GQA maps G query heads onto each KV head.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["decode_attention", "decode_attention_plain", "LAUNCHES"]

# launches of csrc/decode_attn.cu, counted by its wrapper
LAUNCHES = {"decode_attn": 0}

_NEG = -1e30

# q, k, v, the four cache strides, layer, batch, hkv, g, d, past_len, limit,
# scale, softcap, window, out, stream (csrc/decode_attn.cu)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
             + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
             + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, layer: int, past_len: int,
                           limit: int, scale: float, softcap: float = 0.0,
                           window: int = 0) -> torch.Tensor:
    """Plain version: q [B, Hq, D], k/v FULL cache [L, B, Hkv, S, D]
    -> out [B, Hq, D] f32, softmax in f32."""
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
    if d % 32 or d > 256 or g > 16 or g * d > 2048:
        raise NotImplementedError(f"head_dim {d}, {g} query heads per KV "
                                  "head")
    if any(st % 8 for st in k.stride()[:4]) or v.data_ptr() % 16:
        raise ValueError("K/V rows must be 16-byte aligned")
    limit = min(limit, s_max)
    if not 0 <= past_len < limit or not 0 <= layer < nl:
        raise ValueError(f"past_len {past_len}, limit {limit}, layer {layer}")
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    fn = _build.function("decode_attn", "decode_attention", _ARGTYPES)
    sl, sb, sh, ss, _ = k.stride()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), sl, sb, sh, ss,
            layer, b, hkv, g, d, int(past_len), limit, float(scale),
            float(softcap), int(window), out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attn", rc, "decode_attention")
    LAUNCHES["decode_attn"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layer: int, past_len: int, limit: int, scale: float,
                     softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """q [B, Hq, D] (t=1), k/v FULL cache [L, B, Hkv, S, D] -> [B, Hq, D] f32.

    Attends to positions 0..past_len (inclusive: the current token's K/V must
    already be written); `limit` bounds the S rows read. softcap > 0 applies
    tanh capping; window > 0 limits attention to the trailing window. The
    layer's slice is read in place: the cache is never copied.
    """
    if q.is_cuda:
        return _kernel(q, k, v, layer, past_len, limit, scale, softcap,
                       window)
    return decode_attention_plain(q, k, v, layer, past_len, limit, scale,
                                  softcap, window)
