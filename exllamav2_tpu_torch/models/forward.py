"""Forward pass for decoder models (PyTorch port of
exllamav2_tpu/models/forward.py).

Plain functions over the weight modules. Attention follows the reference:
GQA by head grouping, f32 softmax, optional softcap and sliding window,
causal masking against the linear KV cache. A single-token step
(t = 1) goes through the decode-attention kernel (ops/decode_attn.py); longer
inputs use two matrix products and a masked softmax.

``past_len`` of the linear forward is a host int (prefill, the CPU) or an
int32 tensor on the device (0-d: one position for every row; [B]: one per
row): the decode step that utils/graphs.py captures reads its position from
device memory, so one graph serves every position of a limit bucket.

``model_forward_paged`` is the serving forward over the paged KV cache
(cache_paged.PagedKVCache, per-sequence block tables and positions): its t = 1
attention goes through the paged flash-decode kernel (ops/paged_attn.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from exllamav2_tpu_torch.architecture import RopeStyle
from exllamav2_tpu_torch.cache import KVCache
from exllamav2_tpu_torch.models.modules import (
    AttnWeights, MLPWeights, ModelWeights, NormWeights, StaticModel)
from exllamav2_tpu_torch.ops.decode_attn import decode_attention
from exllamav2_tpu_torch.ops.paged_attn import (
    gqa_scores, gqa_values, paged_attention)
from exllamav2_tpu_torch.ops.qmm import linear_apply
from exllamav2_tpu_torch.ops.rope import apply_rope

__all__ = ["norm_apply", "attn_forward", "mlp_forward", "model_forward",
           "attn_forward_paged", "model_forward_paged"]

_NEG = -1e30


def _fz(st: StaticModel):
    """fused-kernel policy arg for linear_apply (None = auto by row count)."""
    return None if st.fused_matmul else False


def norm_apply(x: torch.Tensor, w: NormWeights, st: StaticModel) -> torch.Tensor:
    """RMS or LayerNorm in f32, returned in x's dtype."""
    xf = x.float()
    if st.norm_type == "rms":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + st.norm_eps)
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + st.norm_eps)
    wgt = w.weight.float() + st.norm_constant_bias
    y = y * wgt
    if w.bias is not None:
        y = y + w.bias.float()
    return y.to(x.dtype)


def _rope_style(st: StaticModel) -> RopeStyle:
    return {"neox": RopeStyle.NEOX, "gptj": RopeStyle.GPTJ,
            "none": RopeStyle.NONE}[st.rope_style]


def _attn_qkv(x: torch.Tensor, aw: AttnWeights, st: StaticModel,
              sin: torch.Tensor, cos: torch.Tensor):
    """norm -> Q/K/V projections -> RoPE; returns bf16 q, k, v [B, T, H, D]."""
    b, t, d = x.shape
    hq, hkv, hd = st.num_heads, st.num_kv_heads, st.head_dim
    hidden = norm_apply(x, aw.norm, st)
    h2 = hidden.reshape(b * t, d)
    if aw.qkv is not None:
        # merged fast path: one weight stream and one launch for q|k|v
        nq, nkv = hq * hd, hkv * hd
        y = linear_apply(h2, aw.qkv, fused=_fz(st))
        q = y[:, :nq].reshape(b, t, hq, hd)
        k = y[:, nq:nq + nkv].reshape(b, t, hkv, hd)
        v = y[:, nq + nkv:].reshape(b, t, hkv, hd)
    else:
        q = linear_apply(h2, aw.q, fused=_fz(st)).reshape(b, t, hq, hd)
        k = linear_apply(h2, aw.k, fused=_fz(st)).reshape(b, t, hkv, hd)
        v = linear_apply(h2, aw.v, fused=_fz(st)).reshape(b, t, hkv, hd)
    style = _rope_style(st)
    q = apply_rope(q.to(torch.bfloat16), sin, cos, style)
    k = apply_rope(k.to(torch.bfloat16), sin, cos, style)
    return q, k, v.to(torch.bfloat16)


def _positions(past_len, t: int, device) -> torch.Tensor:
    """Positions [past_len, past_len + t): [T] for a host int or a 0-d /
    [1] tensor, [B, T] for a [B] tensor."""
    ar = torch.arange(t, device=device)
    if not isinstance(past_len, torch.Tensor):
        return past_len + ar
    if past_len.numel() == 1:
        return past_len.long().reshape(()) + ar
    return past_len.long().reshape(-1, 1) + ar


def attn_forward(x: torch.Tensor, aw: AttnWeights, st: StaticModel,
                 layer: int, sin: torch.Tensor, cos: torch.Tensor,
                 cache: KVCache, past_len,
                 attn_limit: int | None = None
                 ) -> tuple[torch.Tensor, KVCache]:
    """x [B, T, d] -> (attn output [B, T, d] f32, cache updated in place).

    past_len: a host int or a device tensor (0-d or [B]).
    sin/cos are already gathered for positions [past_len, past_len+T).
    attn_limit bounds how much of the allocated cache is read (the caller
    buckets past_len+T up so reads track the live sequence length).
    """
    b, t, d = x.shape
    hq, hkv, hd = st.num_heads, st.num_kv_heads, st.head_dim
    q, k, v = _attn_qkv(x, aw, st, sin, cos)

    cache.update(layer, k, v, past_len)
    scale = st.attn_scale if st.attn_scale is not None else hd ** -0.5
    window = st.layers[layer].sliding_window if st.layers else 0

    if (t == 1 and attn_limit is not None and st.fused_matmul
            and hd % 32 == 0):
        out = decode_attention(q[:, 0], cache.k, cache.v, layer, past_len,
                               attn_limit, float(scale),
                               float(st.attn_logit_softcap), int(window))
        out = out.to(torch.bfloat16).reshape(b, hq * hd)
        out = linear_apply(out, aw.o, fused=_fz(st)).reshape(b, 1, -1)
        return out, cache

    ck, cv = cache.layer(layer)                           # [B, Hkv, S, D]
    if attn_limit is not None and attn_limit < ck.shape[2]:
        ck = ck[:, :, :attn_limit]
        cv = cv[:, :, :attn_limit]
    s = ck.shape[2]

    g = st.q_per_kv
    scores = gqa_scores(q.reshape(b, t, hkv, g, hd), ck) * scale
    if st.attn_logit_softcap > 0.0:
        cap = st.attn_logit_softcap
        scores = torch.tanh(scores / cap) * cap

    pos_q = _positions(past_len, t, x.device)               # [T] or [B, T]
    pos_k = torch.arange(s, device=x.device)
    mask = pos_k <= pos_q[..., None]                         # causal
    if window > 0:
        mask &= pos_k > pos_q[..., None] - window
    if mask.dim() == 3:                             # per-row positions
        mask = mask[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG))

    out = gqa_values(torch.softmax(scores, dim=-1), cv)
    out = out.to(torch.bfloat16).reshape(b * t, hq * hd)
    out = linear_apply(out, aw.o, fused=_fz(st)).reshape(b, t, -1)
    return out, cache


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return Fn.silu(x)
    if kind == "gelu":
        return Fn.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp_forward(x: torch.Tensor, mw: MLPWeights, st: StaticModel) -> torch.Tensor:
    """Gated/ungated MLP -> [B, T, d] f32."""
    b, t, d = x.shape
    hidden = norm_apply(x, mw.norm, st).reshape(b * t, d)
    if mw.gate_up is not None and st.mlp_gated and mw.gate is not None:
        # merged fast path: gate|up in one weight stream
        y = linear_apply(hidden, mw.gate_up, fused=_fz(st))
        half = mw.gate_up.n // 2
        inter = _act(y[:, :half], st.mlp_act) * y[:, half:]
    else:
        up = linear_apply(hidden, mw.up, fused=_fz(st))
        if st.mlp_gated and mw.gate is not None:
            gate = linear_apply(hidden, mw.gate, fused=_fz(st))
            inter = _act(gate, st.mlp_act) * up
        else:
            inter = _act(up, st.mlp_act)
    out = linear_apply(inter.to(torch.bfloat16), mw.down, fused=_fz(st))
    return out.reshape(b, t, -1)


def _residual_add(x, out, st):
    """x + out with type promotion, as in the reference: the embedding is
    bf16 but the block outputs are f32, so the residual is f32 from the
    first add on."""
    if st.scale_depth != 1.0:
        out = out * st.scale_depth
    return x + out


def _block_forward(x, layer_w, st, layer, sin, cos, cache, past_len,
                   attn_limit=None):
    attn_out, cache = attn_forward(
        x, layer_w.attn, st, layer, sin, cos, cache, past_len, attn_limit)
    x = _residual_add(x, attn_out, st)
    x = _residual_add(x, mlp_forward(x, layer_w.mlp, st), st)
    return x, cache


def _embed(w: ModelWeights, st: StaticModel, ids: torch.Tensor):
    x = w.embed[ids.long()]                                  # [B, T, d]
    if st.normalize_embeddings:
        x = x.float() * (st.hidden_size ** 0.5)
    if st.embedding_multiplier != 1.0:
        x = x.float() * st.embedding_multiplier
    return x.to(torch.float32 if st.residual_fp32 else torch.bfloat16)


def model_forward(w: ModelWeights, st: StaticModel, ids: torch.Tensor,
                  cache: KVCache, past_len,
                  last_token_only: bool = False,
                  attn_limit: int | None = None
                  ) -> tuple[torch.Tensor, KVCache]:
    """ids [B, T] -> (logits [B, T or 1, vocab] f32, cache).

    past_len: a host int, or an int32 device tensor (0-d or [B]) whose
    range the caller has checked. Chunking across max_input_len happens in
    the caller (Model.forward).
    """
    b, t = ids.shape
    x = _embed(w, st, ids)
    pos = _positions(past_len, t, ids.device)                # [T] or [B, T]
    sin = w.sin[pos]                                 # [(B,) T, rot/2]
    cos = w.cos[pos]

    for layer in range(st.num_layers):
        x, cache = _block_forward(x, w.layers[layer], st, layer, sin, cos,
                                  cache, past_len, attn_limit)
    return _head(w, st, x, last_token_only), cache


def attn_forward_paged(x: torch.Tensor, aw: AttnWeights, st: StaticModel,
                       layer: int, sin: torch.Tensor, cos: torch.Tensor,
                       cache, block_table: torch.Tensor,
                       cache_seqlens: torch.Tensor):
    """Paged-cache attention block: x [B, T, d] -> (attn output [B, T, d]
    f32, cache updated in place). sin/cos [B, T, rot/2] are gathered at each
    sequence's positions."""
    b, t, d = x.shape
    hq, hd = st.num_heads, st.head_dim
    q, k, v = _attn_qkv(x, aw, st, sin, cos)
    cache.append(layer, block_table, cache_seqlens, k, v)
    scale = st.attn_scale if st.attn_scale is not None else hd ** -0.5
    window = st.layers[layer].sliding_window if st.layers else 0
    out = paged_attention(q, cache, layer, block_table, cache_seqlens,
                          scale=scale, window=window,
                          softcap=st.attn_logit_softcap,
                          allow_kernel=st.fused_matmul)
    out = out.to(torch.bfloat16).reshape(b * t, hq * hd)
    out = linear_apply(out, aw.o, fused=_fz(st)).reshape(b, t, -1)
    return out, cache


def model_forward_paged(w: ModelWeights, st: StaticModel, ids: torch.Tensor,
                        cache, block_table: torch.Tensor,
                        cache_seqlens: torch.Tensor,
                        last_token_only: bool = False,
                        input_embeds=None, rope_rows=None, pos_offsets=None,
                        with_logits: bool = True):
    """Paged-cache forward: ids [B, T] with per-sequence block tables
    [B, P] and past lengths cache_seqlens [B] -> (logits [B, T or 1, vocab]
    f32, cache updated in place).

    with_logits=False skips the final norm and the head and returns
    (None, cache): a prefill step that only fills the cache.
    input_embeds, rope_rows and pos_offsets (multimodal embeddings and
    MRoPE) are not ported yet and raise.
    """
    for name, val in (("input_embeds", input_embeds),
                      ("rope_rows", rope_rows), ("pos_offsets", pos_offsets)):
        if val is not None:
            raise NotImplementedError(f"model_forward_paged({name}=...) is "
                                      "not ported yet")
    b, t = ids.shape
    x = _embed(w, st, ids)
    # per-sequence positions differ -> gather per-batch rope rows
    pos = cache_seqlens.long()[:, None] + torch.arange(
        t, device=ids.device)[None]                           # [B, T]
    sin = w.sin[pos]                                          # [B, T, rot/2]
    cos = w.cos[pos]
    for layer in range(st.num_layers):
        lw = w.layers[layer]
        attn_out, cache = attn_forward_paged(
            x, lw.attn, st, layer, sin, cos, cache, block_table,
            cache_seqlens)
        x = _residual_add(x, attn_out, st)
        x = _residual_add(x, mlp_forward(x, lw.mlp, st), st)
    if not with_logits:
        return None, cache
    return _head(w, st, x, last_token_only), cache


def _head(w: ModelWeights, st: StaticModel, x: torch.Tensor,
          last_token_only: bool) -> torch.Tensor:
    """Final norm, head linear, logit scale / softcap -> logits f32."""
    if last_token_only:
        x = x[:, -1:, :]
    x = norm_apply(x, w.final_norm, st)
    bt = x.shape[0] * x.shape[1]
    logits = linear_apply(x.reshape(bt, st.hidden_size), w.head,
                          fused=_fz(st)).float()
    logits = logits.reshape(x.shape[0], x.shape[1], -1)
    if st.logit_scale != 1.0:
        logits = logits * st.logit_scale
    if st.final_logit_softcap > 0.0:
        cap = st.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    if logits.shape[-1] > st.vocab_size:
        logits = logits[..., :st.vocab_size]
    return logits
