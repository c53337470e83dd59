"""Checkpoint loading: tensor sets -> ModelWeights (PyTorch port of
exllamav2_tpu/models/loader.py).

Auto-detects EXL2 ('.q_weight'), GPTQ ('.qweight') and FP16 ('.weight')
tensor sets per linear, reads them through the mmap safetensors reader and
builds the plane layout (quant/qtensor.py) directly on `device`. Dense,
non-MoE decoders only; architecture features whose forward is not ported yet
raise NotImplementedError in build_static.
"""

from __future__ import annotations

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
    NormWeights, AttnWeights, MLPWeights, LayerWeights, ModelWeights,
    StaticModel, LayerStatic)
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


def _unported_features(cfg: ModelConfig, swa: list[int]) -> list[str]:
    """Architecture features whose forward this package does not have yet."""
    arch = cfg.arch
    checks = {
        "post-norms": bool(arch.key_norm_1_post or arch.key_norm_2_post),
        "parallel blocks": arch.parallel_decoder_blocks,
        "learned positions": arch.learned_pos_emb,
        "QK-norm": cfg.use_qk_norm,
        "alternate rope tables": bool(arch.sliding_rope_theta is not None
                                      and any(swa)),
        "NoPE layers": arch.rope_swa_only,
        "MoE": arch.is_moe,
    }
    return [name for name, on in checks.items() if on]


def build_static(cfg: ModelConfig) -> StaticModel:
    arch = cfg.arch
    swa = _swa_layers(cfg)
    missing = _unported_features(cfg, swa)
    if missing:
        raise NotImplementedError(
            f"{arch.arch_string}: {', '.join(missing)} not ported yet")
    per_layer = [LayerStatic(sliding_window=swa[l])
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
        attn_logit_softcap=cfg.attn_logit_softcapping,
        final_logit_softcap=cfg.final_logit_softcapping,
        normalize_embeddings=arch.normalize_embeddings,
        embedding_multiplier=cfg.embedding_multiplier,
        attn_scale=attn_scale,
        logit_scale=cfg.logit_scale,
        residual_fp32=arch.residual_stream_fp32,
        scale_depth=cfg.scale_depth,
        fused_matmul=fused,
        layers=tuple(per_layer),
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
        attn = AttnWeights(norm=norm(k(arch.key_norm_1)),
                           q=q_lin, k=k_lin, v=v_lin,
                           o=lin(arch.key_attn_o.format(l=l)))
        mlp_norm = norm(k(arch.key_norm_2)) if arch.key_norm_2 else attn.norm
        if arch.fused_gate_up and not _has(
                "model.layers.{l}.mlp.up_proj".format(l=l)):
            fused = lin(arch.key_fused_gate_up.format(l=l))
            inter = cfg.intermediate_size
            mlp = MLPWeights(norm=mlp_norm,
                             gate=slice_columns(fused, 0, inter),
                             up=slice_columns(fused, inter, 2 * inter),
                             down=lin(arch.key_mlp_down.format(l=l)))
        elif arch.fused_gate_up:
            mlp = MLPWeights(
                norm=mlp_norm,
                gate=lin("model.layers.{l}.mlp.gate_proj".format(l=l)),
                up=lin("model.layers.{l}.mlp.up_proj".format(l=l)),
                down=lin(arch.key_mlp_down.format(l=l)))
        else:
            mlp = MLPWeights(
                norm=mlp_norm,
                gate=lin(arch.key_mlp_gate.format(l=l))
                if arch.mlp_gated and arch.key_mlp_gate else None,
                up=lin(arch.key_mlp_up.format(l=l)),
                down=lin(arch.key_mlp_down.format(l=l)))
        layers.append(LayerWeights(attn=attn, mlp=mlp))

    final_norm = norm(pre + arch.key_norm)
    if cfg.tie_word_embeddings or not tfm.has_prefix(pre + arch.key_head + "."):
        head = from_dense(embed.T, device=device)
    else:
        head = load_linear(tfm, pre + arch.key_head, device=device)

    sin, cos = build_sincos(cfg, device=device)
    w = ModelWeights(embed=embed_t, layers=layers, final_norm=final_norm,
                     head=head, sin=sin, cos=cos)
    return w, st
