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

The architecture quirks follow the reference: per-head QK norms, post-norms
of the attention and MLP outputs, Cohere's parallel blocks, NoPE layers,
learned positions and the sliding-window layers' own rope tables; every
position-dependent gather indexes with the step's position tensor, so a
captured step reads its position from device memory. ``moe_forward`` is the
block-sparse MoE in three regimes, with the reference's thresholds: up to 32
rows on the card each expert's kernel-1 launches read a device gate (is any
row routed here?) and an expert with no routed row streams no weights;
mid-size batches (and the CPU) run every expert on every row and mix by the
routing weights; from max(64, 2E) rows a capacity dispatch gathers each
expert's routed rows into a static [E, C] buffer.

On a tensor-parallel rank (``st.tp_axis``, a parallel/sharding.Mesh, with
the rank's shard from parallel/sharding.shard_model) the output of every
column-split linear, and of attention over the rank's heads, is gathered
over the TP group and sliced to its logical width (``_tp_gather``); an
expert-parallel MoE layer (``moe_ep_forward``) runs the rank's experts and
sums the ranks' outputs with one all_reduce. Merged q|k|v and gate|up
streams are not taken under TP.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn

from exllamav2_tpu_torch.architecture import RopeStyle
from exllamav2_tpu_torch.cache import KVCache
from exllamav2_tpu_torch.models.modules import (
    AttnWeights, EPMoEWeights, MLPWeights, MoEWeights, ModelWeights,
    NormWeights, StaticModel)
from exllamav2_tpu_torch.ops.decode_attn import decode_attention
from exllamav2_tpu_torch.ops.paged_attn import (
    gqa_scores, gqa_values, paged_attention)
from exllamav2_tpu_torch.ops.qmm import gate_capable, linear_apply
from exllamav2_tpu_torch.ops.rope import apply_rope
from exllamav2_tpu_torch.parallel.sharding import split_width

__all__ = ["norm_apply", "attn_forward", "mlp_forward", "moe_forward",
           "moe_ep_forward", "model_forward", "attn_forward_paged",
           "model_forward_paged", "set_moe_dispatch"]

_NEG = -1e30

# test hook: the gated (sparse) MoE decode on a CPU tensor, through the
# gated kernel's plain version (on the card it is the default up to 32 rows)
_FORCE_SPARSE_MOE = [False]
# measurement hooks: the dense formulation even on the card (what the gated
# decode is held against), and, while a caller holds a list here, the gated
# decode's expert flags ([E] int32 device tensors, one a layer)
_FORCE_DENSE_MOE = [False]
_MOE_GATES = [None]
# capacity factor of the prefill dispatch (tokens per expert buffer =
# BT * topk * CF / E; routes past capacity drop that expert's term)
_MOE_CAPACITY_FACTOR = [2.0]
# the dispatch serves max(this, 2 E) rows and more
_MOE_DISPATCH_MIN_TOKENS = [64]
# a list while a caller collects the dispatch's dropped-route counts (int32
# device scalars, one a layer; the generator's prefill sets it), else None
_MOE_STATS = [None]
# a [BT] validity mask of the rows (bucketed prefill pads rows and columns
# with token 0; a pad row must not route), or None; set by the generator
_MOE_VALID = [None]


def set_moe_dispatch(capacity_factor: float | None = None,
                     min_tokens: int | None = None) -> None:
    """Tune the prefill MoE dispatch: raise `capacity_factor` to shrink
    drops on unbalanced routers, or set `min_tokens` very large (1 << 30)
    to run the exact dense mix everywhere."""
    if capacity_factor is not None:
        _MOE_CAPACITY_FACTOR[0] = float(capacity_factor)
    if min_tokens is not None:
        _MOE_DISPATCH_MIN_TOKENS[0] = int(min_tokens)


def _fz(st: StaticModel):
    """fused-kernel policy arg for linear_apply (None = auto by row count)."""
    return None if st.fused_matmul else False


def _tp_gather(x: torch.Tensor, st: StaticModel, lin) -> torch.Tensor:
    """x, the output of `lin` on this rank (or of attention over the heads
    of the rank's q shard), gathered over the TP group on its last axis
    and sliced to the whole linear's logical width: a lane-padded linear's
    column shards reassemble into the padded array, pad at the end. A
    linear that is not split (or no mesh) gives x back."""
    width = split_width(lin) if st.tp_axis is not None else 0
    if not width:
        return x
    return st.tp_axis.all_gather(x)[..., :width]


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


def _head_norm(x: torch.Tensor, w: NormWeights, eps: float) -> torch.Tensor:
    """Per-head RMS norm over head_dim in f32, returned in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.weight.float()).to(x.dtype)


def _rope_style(st: StaticModel) -> RopeStyle:
    return {"neox": RopeStyle.NEOX, "gptj": RopeStyle.GPTJ,
            "none": RopeStyle.NONE}[st.rope_style]


def _attn_qkv(x: torch.Tensor, aw: AttnWeights, st: StaticModel,
              sin: torch.Tensor, cos: torch.Tensor, layer: int):
    """norm -> Q/K/V projections -> QK norms -> RoPE (none on a NoPE
    layer); returns bf16 q, k, v [B, T, H, D]."""
    b, t, d = x.shape
    hq, hkv, hd = st.num_heads, st.num_kv_heads, st.head_dim
    hidden = norm_apply(x, aw.norm, st)
    h2 = hidden.reshape(b * t, d)
    if aw.qkv is not None and st.tp_axis is None:
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
    if st.use_qk_norm:
        q = _head_norm(q, aw.q_norm, st.norm_eps)
        k = _head_norm(k, aw.k_norm, st.norm_eps)
    style = _rope_style(st)
    if st.layers and not st.layers[layer].rope_enabled:
        style = RopeStyle.NONE
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
    q, k, v = _attn_qkv(x, aw, st, sin, cos, layer)

    cache.update(layer, k, v, past_len)
    scale = st.attn_scale if st.attn_scale is not None else hd ** -0.5
    window = st.layers[layer].sliding_window if st.layers else 0

    if (t == 1 and attn_limit is not None and st.fused_matmul
            and hd % 32 == 0):
        out = decode_attention(q[:, 0], cache.k, cache.v, layer, past_len,
                               attn_limit, float(scale),
                               float(st.attn_logit_softcap), int(window))
        out = _tp_gather(out.to(torch.bfloat16).reshape(b, hq * hd), st,
                         aw.q)
        out = _tp_gather(linear_apply(out, aw.o, fused=_fz(st)), st, aw.o)
        return _post(out.reshape(b, 1, -1), aw, st), cache

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
    out = _tp_gather(out.to(torch.bfloat16).reshape(b * t, hq * hd), st,
                     aw.q)
    out = _tp_gather(linear_apply(out, aw.o, fused=_fz(st)), st, aw.o)
    return _post(out.reshape(b, t, -1), aw, st), cache


def _post(out: torch.Tensor, w, st: StaticModel) -> torch.Tensor:
    """A block output through its post-norm, where the block has one."""
    if w.norm_post is not None:
        out = norm_apply(out, w.norm_post, st)
    return out


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
    if (mw.gate_up is not None and st.tp_axis is None and st.mlp_gated
            and mw.gate is not None):
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
    inter = _tp_gather(inter.to(torch.bfloat16), st, mw.up)
    out = _tp_gather(linear_apply(inter, mw.down, fused=_fz(st)), st,
                     mw.down)
    return _post(out.reshape(b, t, -1), mw, st)


# ---------------------------------------------------------------- MoE

def _note_moe_drops(dropped: torch.Tensor) -> None:
    if _MOE_STATS[0] is not None:
        _MOE_STATS[0].append(dropped.to(torch.int32))


def _mask_pad_routes(mix: torch.Tensor) -> torch.Tensor:
    """Zero the routes of the pad rows the generator's validity mask
    names (they would take expert capacity and count as drops)."""
    v = _MOE_VALID[0]
    if v is not None and v.shape[0] == mix.shape[0]:
        mix = mix * v.to(mix.dtype)[:, None]
    return mix


def _route(hidden: torch.Tensor, mw: MoEWeights,
           st: StaticModel) -> torch.Tensor:
    """Router -> softmax in f32 -> top-k -> the dense mixing weights
    [BT, E] (zero off the top k). Equal probabilities go to the lower
    expert index, as jax.lax.top_k orders them (a stable sort; torch.topk
    promises no order among ties)."""
    logits = linear_apply(hidden, mw.router, fused=_fz(st))
    probs = torch.softmax(logits.float(), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw = topw[:, :st.num_experts_per_tok]
    topi = topi[:, :st.num_experts_per_tok]
    if st.norm_topk_prob:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    mix = torch.zeros_like(probs).scatter_(1, topi, topw)
    return _mask_pad_routes(mix)


def _expert(hb: torch.Tensor, mw: MoEWeights, e: int, st: StaticModel,
            gate=None) -> torch.Tensor:
    """Expert e on rows hb [R, d] bf16 -> [R, d] f32; `gate` (an int32
    device flag) switches its kernel-1 launches off when 0."""
    g = linear_apply(hb, mw.w1[e], fused=_fz(st), gate=gate)
    u = linear_apply(hb, mw.w3[e], fused=_fz(st), gate=gate)
    inter = (_act(g, st.mlp_act) * u).to(torch.bfloat16)
    return linear_apply(inter, mw.w2[e], fused=_fz(st), gate=gate)


def _moe_dispatch(hb: torch.Tensor, mix: torch.Tensor, mw,
                  st: StaticModel, first: int = 0) -> torch.Tensor:
    """Capacity dispatch: each expert runs on its routed rows only, up to
    C = min(ceil8(ceil(BT * topk * CF / E)), BT), in static [E, C] buffers.
    A row's slot is the running count of the rows routed to the expert
    before it; routes past C drop that expert's term (counted over every
    expert); empty slots point at a zero sentinel row, and the combine is
    an f32 scatter-add. mw holds experts first .. of the E (all of them
    but on an expert-parallel rank)."""
    bt, d = hb.shape
    ne = st.num_experts
    cap = int(np.ceil(bt * st.num_experts_per_tok
                      * _MOE_CAPACITY_FACTOR[0] / ne))
    cap = min(-(-cap // 8) * 8, bt)
    routed = mix > 0                                          # [BT, E]
    pos = torch.cumsum(routed.to(torch.int32), dim=0) - 1
    _note_moe_drops((routed & (pos >= cap)).sum())
    # overflow routes park in a throwaway column (sliced off)
    pos_c = torch.where(routed & (pos < cap), pos, cap).long()
    t_idx = torch.arange(bt, device=hb.device)[:, None].expand(bt, ne)
    e_idx = torch.arange(ne, device=hb.device)[None, :].expand(bt, ne)
    disp = torch.full((ne, cap + 1), bt, dtype=torch.long, device=hb.device)
    disp[e_idx.reshape(-1), pos_c.reshape(-1)] = t_idx.reshape(-1)
    disp = disp[:, :cap]                                      # [E, C]
    hpad = torch.cat([hb, hb.new_zeros((1, d))])              # sentinel row
    mixp = torch.cat([mix, mix.new_zeros((1, ne))])
    out = torch.zeros((bt + 1, d), dtype=torch.float32, device=hb.device)
    for i in range(len(mw.w1)):
        idx = disp[first + i]
        y = _expert(hpad[idx], mw, i, st)                     # [C, d]
        out.index_add_(0, idx, y * mixp[idx, first + i][:, None])
    return out[:bt]


def _moe_sum(x: torch.Tensor, mw, st: StaticModel,
             first: int = 0) -> torch.Tensor:
    """The routed sum over mw's experts (experts first .. of the E) ->
    f32 [B * T, d]; moe_forward's regimes."""
    b, t, d = x.shape
    bt = b * t
    hidden = norm_apply(x, mw.norm, st).reshape(bt, d)
    mix = _route(hidden, mw, st)
    hb = hidden.to(torch.bfloat16)
    sparse = (bt <= 32 and (x.is_cuda or _FORCE_SPARSE_MOE[0])
              and not _FORCE_DENSE_MOE[0] and st.fused_matmul
              and gate_capable([*mw.w1, *mw.w2, *mw.w3]))
    if (not sparse
            and bt >= max(_MOE_DISPATCH_MIN_TOKENS[0], 2 * st.num_experts)
            and st.num_experts_per_tok < st.num_experts):
        return _moe_dispatch(hb, mix, mw, st, first)
    gates = (mix > 0).any(dim=0).to(torch.int32) if sparse else None
    if sparse and _MOE_GATES[0] is not None:
        _MOE_GATES[0].append(gates)
    out = None
    for i in range(len(mw.w1)):
        e = first + i
        y = _expert(hb, mw, i, st,
                    gate=gates[e:e + 1] if sparse else None)
        y = y * mix[:, e:e + 1]
        out = y if out is None else out + y
    return out


def moe_forward(x: torch.Tensor, mw: MoEWeights,
                st: StaticModel) -> torch.Tensor:
    """Block-sparse MoE: x [B, T, d] -> [B, T, d] f32.

    Up to 32 rows on the card (or with _FORCE_SPARSE_MOE): each expert's
    launches read the device flag "any row routed here", computed from the
    routing in the same stream, so an unrouted expert's kernel-1 blocks
    write zeros and stream no planes, with no host readback (the reference
    wraps the expert in lax.cond). Linears that kernel 1 does not serve
    (dense, W4A8, scales-on-partials, LoRA) take the dense formulation.
    Mid-size batches: every expert on every row, mixed by the routing
    weights. From max(64, 2E) rows (top-k < E): the capacity dispatch."""
    b, t, _ = x.shape
    return _post(_moe_sum(x, mw, st).reshape(b, t, -1), mw, st)


def moe_ep_forward(x: torch.Tensor, mw: EPMoEWeights,
                   st: StaticModel) -> torch.Tensor:
    """Expert-parallel MoE: x [B, T, d] -> [B, T, d] f32. The rank runs its
    whole experts mw.first .. on the replicated hidden state, in
    moe_forward's regimes (the routing is every rank's, from the replicated
    router), and one all_reduce of the [BT, d] f32 sum over the TP group
    adds the ranks' experts. With top-2 routing a row's sum has two nonzero
    terms, so it is bitwise the one-process sum."""
    b, t, _ = x.shape
    out = _moe_sum(x, mw, st, mw.first)
    if st.tp_axis is not None:
        out = st.tp_axis.all_reduce(out)
    return _post(out.reshape(b, t, -1), mw, st)


def _residual_add(x, out, st):
    """x + out with type promotion, as in the reference: the embedding is
    bf16 but the block outputs are f32, so the residual is f32 from the
    first add on."""
    if st.scale_depth != 1.0:
        out = out * st.scale_depth
    return x + out


def _ffn(x, mlp, st):
    if isinstance(mlp, EPMoEWeights):
        return moe_ep_forward(x, mlp, st)
    if isinstance(mlp, MoEWeights):
        return moe_forward(x, mlp, st)
    return mlp_forward(x, mlp, st)


def _block_tail(x, attn_out, mlp, st):
    """A decoder block after its attention: the residual adds around the
    MLP, or a parallel block's single add of attention and MLP on the
    same input (Cohere; no scale_depth)."""
    if st.parallel_blocks:
        return x + attn_out + _ffn(x, mlp, st)
    x = _residual_add(x, attn_out, st)
    return _residual_add(x, _ffn(x, mlp, st), st)


def _block_forward(x, layer_w, st, layer, rope, cache, past_len,
                   attn_limit=None):
    """One decoder block on the linear cache; `rope` is _rope_rows'."""
    sin, cos = _layer_rope(rope, st, layer)
    attn_out, cache = attn_forward(
        x, layer_w.attn, st, layer, sin, cos, cache, past_len, attn_limit)
    return _block_tail(x, attn_out, layer_w.mlp, st), cache


def _embed(w: ModelWeights, st: StaticModel, ids: torch.Tensor, pos=None,
           rows: torch.Tensor | None = None):
    """Token embeddings (scaled as the architecture says) plus, for learned
    positions, the rows of `pos` ([T] or [B, T] positions). `rows` [B, T, d]
    stands in for the table lookup (multimodal prompts) and is scaled the
    same way, image rows included, as in the reference."""
    x = w.embed[ids.long()] if rows is None else rows        # [B, T, d]
    if st.normalize_embeddings:
        x = x.float() * (st.hidden_size ** 0.5)
    if st.embedding_multiplier != 1.0:
        x = x.float() * st.embedding_multiplier
    x = x.to(torch.float32 if st.residual_fp32 else torch.bfloat16)
    if st.learned_pos_emb and w.pos_emb is not None:
        x = x + w.pos_emb[pos].to(x.dtype)
    return x


def _rope_rows(w: ModelWeights, pos: torch.Tensor):
    """The rope rows of positions `pos`: (sin, cos, sin_alt, cos_alt), the
    alternate pair the sliding-window layers' table where there is one."""
    sin, cos = w.sin[pos], w.cos[pos]
    if w.sin_alt is None:
        return sin, cos, sin, cos
    return sin, cos, w.sin_alt[pos], w.cos_alt[pos]


def _layer_rope(rope, st: StaticModel, layer: int):
    """(sin, cos) of `layer` from _rope_rows' four."""
    if st.layers and st.layers[layer].alt_rope:
        return rope[2], rope[3]
    return rope[0], rope[1]


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
    pos = _positions(past_len, t, ids.device)                # [T] or [B, T]
    x = _embed(w, st, ids, pos)
    rope = _rope_rows(w, pos)                        # [(B,) T, rot/2] each

    for layer in range(st.num_layers):
        x, cache = _block_forward(x, w.layers[layer], st, layer, rope,
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
    q, k, v = _attn_qkv(x, aw, st, sin, cos, layer)
    cache.append(layer, block_table, cache_seqlens, k, v)
    scale = st.attn_scale if st.attn_scale is not None else hd ** -0.5
    window = st.layers[layer].sliding_window if st.layers else 0
    out = paged_attention(q, cache, layer, block_table, cache_seqlens,
                          scale=scale, window=window,
                          softcap=st.attn_logit_softcap,
                          allow_kernel=st.fused_matmul)
    out = _tp_gather(out.to(torch.bfloat16).reshape(b * t, hq * hd), st,
                     aw.q)
    out = _tp_gather(linear_apply(out, aw.o, fused=_fz(st)), st, aw.o)
    return _post(out.reshape(b, t, -1), aw, st), cache


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

    Multimodal inputs, as in the reference: input_embeds [B, T, d] replaces
    the token-embedding lookup (`ids` are then never read: a prompt's
    embedding ids lie past the table); rope_rows = (sin, cos) [B, T, rot/2]
    replaces the gather of the main rope table (MRoPE prefill; the
    alternate table is still gathered by position); pos_offsets [B] int32
    adds a per-sequence offset to the rope and learned positions (MRoPE
    decode: after the multimodal prompt all three axes advance in
    lockstep), while the cache write and the attention keep cache_seqlens.
    """
    b, t = ids.shape
    base = cache_seqlens if pos_offsets is None \
        else cache_seqlens + pos_offsets
    # per-sequence positions differ -> gather per-batch rows
    pos = base.long()[:, None] + torch.arange(
        t, device=ids.device)[None]                           # [B, T]
    x = _embed(w, st, ids, pos, rows=input_embeds)
    rope = _rope_rows(w, pos)                          # [B, T, rot/2] each
    if rope_rows is not None:
        alt = rope[2:] if w.sin_alt is not None else rope_rows
        rope = (*rope_rows, *alt)
    for layer in range(st.num_layers):
        lw = w.layers[layer]
        sin, cos = _layer_rope(rope, st, layer)
        attn_out, cache = attn_forward_paged(
            x, lw.attn, st, layer, sin, cos, cache, block_table,
            cache_seqlens)
        x = _block_tail(x, attn_out, lw.mlp, st)
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
    logits = _tp_gather(linear_apply(x.reshape(bt, st.hidden_size), w.head,
                                     fused=_fz(st)).float(), st, w.head)
    logits = logits.reshape(x.shape[0], x.shape[1], -1)
    if st.logit_scale != 1.0:
        logits = logits * st.logit_scale
    if st.final_logit_softcap > 0.0:
        cap = st.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    if logits.shape[-1] > st.vocab_size:
        logits = logits[..., :st.vocab_size]
    return logits
