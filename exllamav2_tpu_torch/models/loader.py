"""Checkpoint loading: tensor sets -> ModelWeights (PyTorch port of
exllamav2_tpu/models/loader.py).

Auto-detects EXL2 ('.q_weight'), GPTQ ('.qweight') and FP16 ('.weight')
tensor sets per linear, reads them through the mmap safetensors reader and
builds the plane layout (quant/qtensor.py) directly on `device`: dense
and block-sparse MoE decoders (experts per key, or DBRX's fused expert
blocks), with the per-head, post-attention and post-feedforward norms,
learned positions and the sliding-window layers' rope tables. A
vision-language checkpoint loads its language model here (Qwen2-VL's MRoPE
needs nothing of the loader: its positions come with each job); its vision
tower is vlm.VisionTower's.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from exllamav2_tpu_torch.architecture import NormType, RopeStyle
from exllamav2_tpu_torch.config import ModelConfig
from exllamav2_tpu_torch.quant import formats as F
from exllamav2_tpu_torch.quant.qtensor import (
    QuantLinear, DenseLinear, from_exl2, from_gptq, from_dense,
    slice_columns, gather_columns)
from exllamav2_tpu_torch.stloader import TensorFileMap, read_weight_f32
from exllamav2_tpu_torch.models.modules import (
    NormWeights, AttnWeights, MLPWeights, MoEWeights, LayerWeights,
    ModelWeights, StaticModel, LayerStatic)
from exllamav2_tpu_torch.ops.rope import build_sincos

__all__ = ["load_model", "load_linear", "load_norm", "build_static"]


def _resolve(tfm: TensorFileMap, key: str) -> str:
    """Resolve '|'-separated key alternatives against the checkpoint."""
    if "|" not in key:
        return key
    cands = key.split("|")
    for cand in cands:
        if (cand + ".weight" in tfm or cand + ".q_weight" in tfm
                or cand + ".qweight" in tfm):
            return cand
    return cands[0]


def load_linear(tfm: TensorFileMap, key: str, transpose_dense: bool = True,
                *, device) -> QuantLinear | DenseLinear:
    """Load one linear layer by key prefix, auto-detecting the tensor set:
    EXL2 '.q_weight' / GPTQ '.qweight' / FP16 '.weight'.

    transpose_dense=False loads Conv1D-style [in, out] weights verbatim.
    """
    key = _resolve(tfm, key)
    bias = None
    if key + ".bias" in tfm:
        bias = read_weight_f32(tfm, key + ".bias")
    if key + ".q_weight" in tfm:
        t = F.Exl2Tensor(
            k=0, n=0,
            q_weight=tfm.get_tensor(key + ".q_weight"),
            q_scale=tfm.get_tensor(key + ".q_scale"),
            q_scale_max=tfm.get_tensor(key + ".q_scale_max").astype(np.float16),
            q_groups=tfm.get_tensor(key + ".q_groups"),
            q_invperm=tfm.get_tensor(key + ".q_invperm")
            if key + ".q_invperm" in tfm else None,
            bias=bias)
        t.n = t.q_weight.shape[1]
        # K from invperm, else from group table walk
        if t.q_invperm is not None:
            t.k = t.q_invperm.shape[0]
        else:
            gr = t.q_groups.astype(np.int64)
            bits_last = int(gr[-2])
            qrow_last = int(gr[-1])
            rows = 0
            for i in range(len(gr) // 2 - 1):
                qrows_i = int(gr[i * 2 + 3]) - int(gr[i * 2 + 1])
                rows += qrows_i * 32 // int(gr[i * 2])
            rows += (t.q_weight.shape[0] - qrow_last) * 32 // bits_last
            t.k = rows
        return from_exl2(t, device=device)
    if key + ".qweight" in tfm:
        qweight = tfm.get_tensor(key + ".qweight")
        scales = tfm.get_tensor(key + ".scales").astype(np.float16)
        qzeros = tfm.get_tensor(key + ".qzeros")
        g_idx = tfm.get_tensor(key + ".g_idx") \
            if key + ".g_idx" in tfm else None
        n = qweight.shape[1]
        bits = qzeros.shape[1] * 32 // n
        k = qweight.shape[0] * 32 // bits
        t = F.GptqTensor(k=k, n=n, bits=bits, qweight=qweight,
                         qzeros=qzeros, scales=scales, g_idx=g_idx, bias=bias)
        return from_gptq(t, device=device)
    # FP16/BF16: HF stores [out, in]; DenseLinear wants [in, out]
    w = read_weight_f32(tfm, key + ".weight")
    if transpose_dense:
        w = w.T
    return from_dense(w, bias, device=device)


def load_norm(tfm: TensorFileMap, key: str, *, device) -> NormWeights:
    key = _resolve(tfm, key)

    def f32(k):
        return torch.from_numpy(
            np.ascontiguousarray(read_weight_f32(tfm, k))).to(device)

    return NormWeights(weight=f32(key + ".weight"),
                       bias=f32(key + ".bias") if key + ".bias" in tfm
                       else None)


def _swa_layers(cfg: ModelConfig) -> list[int]:
    """Per-layer sliding window size."""
    out = []
    pattern = cfg.sliding_window_pattern
    for l in range(cfg.num_hidden_layers):
        sw = 0
        if cfg.sliding_window:
            if pattern > 1:
                # patterned archs window all but each P-th layer;
                # uniform-SWA archs (Mistral) window all
                sw = cfg.sliding_window if (l + 1) % pattern != 0 else 0
            else:
                sw = cfg.sliding_window
        out.append(sw)
    return out


def build_static(cfg: ModelConfig) -> StaticModel:
    arch = cfg.arch
    swa = _swa_layers(cfg)
    has_alt_rope = arch.sliding_rope_theta is not None and any(swa)
    per_layer = [
        LayerStatic(sliding_window=swa[l],
                    alt_rope=bool(has_alt_rope and swa[l]),
                    rope_enabled=not (arch.rope_swa_only and not swa[l]))
        for l in range(cfg.num_hidden_layers)]
    attn_scale = None
    if cfg.attention_multiplier is not None:
        attn_scale = float(cfg.attention_multiplier)
    rope_style = {RopeStyle.NEOX: "neox", RopeStyle.GPTJ: "gptj",
                  RopeStyle.NONE: "none"}[arch.rope_style]
    # kill switch: forces the dequant + matmul formulations everywhere
    fused = os.environ.get("EXLLAMA_TPU_NO_FUSED", "") != "1"
    return StaticModel(
        num_layers=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        hidden_size=cfg.hidden_size,
        vocab_size=cfg.vocab_size,
        norm_eps=cfg.norm_eps,
        norm_type="rms" if arch.norm == NormType.RMS else "layernorm",
        norm_constant_bias=arch.norm_constant_bias,
        rope_style=rope_style,
        mlp_act=arch.mlp_act,
        mlp_gated=arch.mlp_gated,
        use_qk_norm=cfg.use_qk_norm,
        attn_logit_softcap=cfg.attn_logit_softcapping,
        final_logit_softcap=cfg.final_logit_softcapping,
        normalize_embeddings=arch.normalize_embeddings,
        embedding_multiplier=cfg.embedding_multiplier,
        attn_scale=attn_scale,
        logit_scale=cfg.logit_scale,
        residual_fp32=arch.residual_stream_fp32,
        parallel_blocks=arch.parallel_decoder_blocks,
        scale_depth=cfg.scale_depth,
        learned_pos_emb=arch.learned_pos_emb,
        fused_matmul=fused,
        layers=tuple(per_layer),
        num_experts=cfg.num_experts,
        num_experts_per_tok=cfg.num_experts_per_tok,
        norm_topk_prob=cfg.norm_topk_prob,
    )


def _split_fused_qkv(fused, cfg: ModelConfig):
    """Slice a packed qkv linear into q/k/v.

    Standard packing: [q | k | v] contiguous columns. InternLM2 altpack
    groups columns per kv-head: [q0..q(g-1) k v] x kv_heads, resolved with a
    column gather."""
    hd = cfg.head_dim
    nq = cfg.num_attention_heads * hd
    nkv = cfg.num_key_value_heads * hd
    if not cfg.arch.fused_qkv_altpack:
        return (slice_columns(fused, 0, nq),
                slice_columns(fused, nq, nq + nkv),
                slice_columns(fused, nq + nkv, nq + 2 * nkv))
    g = cfg.num_attention_heads // cfg.num_key_value_heads
    idx = np.arange(nq + 2 * nkv).reshape(
        cfg.num_key_value_heads, (g + 2) * hd)
    q_idx = idx[:, :g * hd].reshape(-1)
    k_idx = idx[:, g * hd:(g + 1) * hd].reshape(-1)
    v_idx = idx[:, (g + 1) * hd:].reshape(-1)
    return (gather_columns(fused, q_idx), gather_columns(fused, k_idx),
            gather_columns(fused, v_idx))


def load_model(cfg: ModelConfig, *, device) -> tuple[ModelWeights, StaticModel]:
    """Build the full weights on `device` from a prepared config."""
    tfm = cfg.tensor_file_map
    arch = cfg.arch
    st = build_static(cfg)
    pre = arch.lm_prefix
    transpose_dense = not arch.orig_weights_transposed

    embed = read_weight_f32(tfm, pre + _resolve(
        tfm, arch.key_embedding) + ".weight")
    embed_t = torch.from_numpy(np.ascontiguousarray(embed)).to(
        device).to(torch.bfloat16)

    def lin(key):
        return load_linear(tfm, pre + key, transpose_dense=transpose_dense,
                           device=device)

    def norm(key):
        return load_norm(tfm, key, device=device)

    def _has(key):
        key = _resolve(tfm, pre + key)
        return (key + ".weight" in tfm or key + ".q_weight" in tfm
                or key + ".qweight" in tfm)

    layers = []
    for l in range(cfg.num_hidden_layers):
        k = lambda pat: pre + pat.format(l=l)
        # EXL2-converted checkpoints store fused archs unfused (each
        # submodule packs its own tensor set): prefer unfused keys
        if arch.fused_qkv and not _has(arch.key_attn_q.format(l=l)):
            fused = lin(arch.key_fused_qkv.format(l=l))
            q_lin, k_lin, v_lin = _split_fused_qkv(fused, cfg)
        else:
            q_lin = lin(arch.key_attn_q.format(l=l))
            k_lin = lin(arch.key_attn_k.format(l=l))
            v_lin = lin(arch.key_attn_v.format(l=l))
        attn = AttnWeights(
            norm=norm(k(arch.key_norm_1)), q=q_lin, k=k_lin, v=v_lin,
            o=lin(arch.key_attn_o.format(l=l)),
            q_norm=norm(k(arch.key_attn_q_norm))
            if arch.key_attn_q_norm and cfg.use_qk_norm else None,
            k_norm=norm(k(arch.key_attn_k_norm))
            if arch.key_attn_k_norm and cfg.use_qk_norm else None,
            norm_post=norm(k(arch.key_norm_1_post))
            if arch.key_norm_1_post else None)
        # parallel-decoder archs without a second norm (Cohere) share the
        # attention input norm with the MLP
        mlp_norm = norm(k(arch.key_norm_2)) if arch.key_norm_2 else attn.norm
        mlp_norm_post = norm(k(arch.key_norm_2_post)) \
            if arch.key_norm_2_post else None
        if arch.is_moe:
            mlp = _load_moe(cfg, tfm, l, lin, _has, mlp_norm, mlp_norm_post,
                            device)
        elif arch.fused_gate_up and not _has(
                "model.layers.{l}.mlp.up_proj".format(l=l)):
            fused = lin(arch.key_fused_gate_up.format(l=l))
            inter = cfg.intermediate_size
            mlp = MLPWeights(norm=mlp_norm,
                             gate=slice_columns(fused, 0, inter),
                             up=slice_columns(fused, inter, 2 * inter),
                             down=lin(arch.key_mlp_down.format(l=l)),
                             norm_post=mlp_norm_post)
        elif arch.fused_gate_up:
            mlp = MLPWeights(
                norm=mlp_norm,
                gate=lin("model.layers.{l}.mlp.gate_proj".format(l=l)),
                up=lin("model.layers.{l}.mlp.up_proj".format(l=l)),
                down=lin(arch.key_mlp_down.format(l=l)),
                norm_post=mlp_norm_post)
        else:
            mlp = MLPWeights(
                norm=mlp_norm,
                gate=lin(arch.key_mlp_gate.format(l=l))
                if arch.mlp_gated and arch.key_mlp_gate else None,
                up=lin(arch.key_mlp_up.format(l=l)),
                down=lin(arch.key_mlp_down.format(l=l)),
                norm_post=mlp_norm_post)
        layers.append(LayerWeights(attn=attn, mlp=mlp))

    final_norm = norm(pre + arch.key_norm)
    if cfg.tie_word_embeddings or not tfm.has_prefix(pre + arch.key_head + "."):
        head = from_dense(embed.T, device=device)
    else:
        head = load_linear(tfm, pre + arch.key_head, device=device)

    pos_emb = None
    if arch.learned_pos_emb and arch.key_learned_pos_emb:
        pos_emb = torch.from_numpy(np.ascontiguousarray(read_weight_f32(
            tfm, pre + arch.key_learned_pos_emb + ".weight"))).to(
            device).to(torch.bfloat16)

    sin, cos = build_sincos(cfg, device=device)
    sin_alt = cos_alt = None
    if any(ls.alt_rope for ls in st.layers):
        # the sliding-window layers' table: their own theta, no scaling
        alt_cfg = dataclasses.replace(
            cfg, rotary_embedding_base=float(arch.sliding_rope_theta),
            rope_scaling=None, tensor_file_map=cfg.tensor_file_map)
        sin_alt, cos_alt = build_sincos(alt_cfg, device=device)
    w = ModelWeights(embed=embed_t, layers=layers, final_norm=final_norm,
                     head=head, sin=sin, cos=cos, pos_emb=pos_emb,
                     sin_alt=sin_alt, cos_alt=cos_alt)
    return w, st


def _load_moe(cfg: ModelConfig, tfm: TensorFileMap, l: int, lin, has,
              norm, norm_post, device) -> MoEWeights:
    """Layer l's router and experts: one tensor set per expert and
    projection, or DBRX's fused storage (one raw [E*ffn, d] tensor a
    projection, row blocks sliced per expert; w1/v1 blocks are [out=ffn,
    in=d], w2 blocks act as x @ w2_e, i.e. already [K=ffn, N=d])."""
    arch = cfg.arch
    pre = arch.lm_prefix
    ne = cfg.num_experts
    router = lin(arch.key_moe_gate.format(l=l))
    if (arch.key_moe_fused_w1 and not has(arch.key_moe_w1.format(l=l, e=0))
            and pre + arch.key_moe_fused_w1.format(l=l) in tfm):
        ffn = cfg.intermediate_size
        w1f, w2f, w3f = (read_weight_f32(tfm, pre + key.format(l=l))
                         for key in (arch.key_moe_fused_w1,
                                     arch.key_moe_fused_w2,
                                     arch.key_moe_fused_w3))

        def blk(t, e):
            return t[e * ffn:(e + 1) * ffn]

        return MoEWeights(
            norm=norm, router=router,
            w1=[from_dense(np.ascontiguousarray(blk(w1f, e).T),
                           device=device) for e in range(ne)],
            w2=[from_dense(blk(w2f, e), device=device) for e in range(ne)],
            w3=[from_dense(np.ascontiguousarray(blk(w3f, e).T),
                           device=device) for e in range(ne)],
            norm_post=norm_post)
    return MoEWeights(
        norm=norm, router=router,
        w1=[lin(arch.key_moe_w1.format(l=l, e=e)) for e in range(ne)],
        w2=[lin(arch.key_moe_w2.format(l=l, e=e)) for e in range(ne)],
        w3=[lin(arch.key_moe_w3.format(l=l, e=e)) for e in range(ne)],
        norm_post=norm_post)
