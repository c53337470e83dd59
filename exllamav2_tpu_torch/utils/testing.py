"""Random weights of real geometry, synthesized on the device, and tiny
random checkpoints on disk (PyTorch port of exllamav2_tpu/utils/testing.py).

Uniform random packed words ARE uniform random quantized values, so drawing
the plane words directly is distribution-equivalent to packing random ints,
and costs nothing but the draw. Every draw comes from the explicit
``torch.Generator`` passed in (seeded once by random_model_weights).
``make_tiny_llama`` writes a small random FP16 / EXL2 / GPTQ checkpoint in any
registered architecture's layout, with numpy draws only; ``make_tiny_vlm``
adds a vision tower of one of the four families, and ``random_vision_tower``
draws a tower of real geometry on the device.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from exllamav2_tpu_torch.architecture import NormType, RopeStyle, get_arch
from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.models.modules import (
    AttnWeights, LayerWeights, MLPWeights, MoEWeights, ModelWeights,
    NormWeights, StaticModel, LayerStatic)
from exllamav2_tpu_torch.quant import formats as F
from exllamav2_tpu_torch.quant.qtensor import (
    DenseLinear, QuantLinear, QuantSegment, GptqSegment, SUB_BLOCK,
    plane_split)
from exllamav2_tpu_torch.ops.rope import build_sincos
from exllamav2_tpu_torch.stloader import write_safetensors

__all__ = ["random_quant_linear", "random_gptq_linear",
           "random_model_weights", "write_random_lora", "make_tiny_llama",
           "random_vision_tower", "make_tiny_vlm"]


def _words(gen, shape, device):
    """Full-range int32 plane words (the bits of uniform uint32 words)."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         generator=gen, device=device)


def _uniform(gen, shape, device):
    return torch.rand(shape, dtype=torch.float32, generator=gen,
                      device=device)


def random_quant_linear(gen: torch.Generator, k: int, n: int, bits: int = 4,
                        group_rows: int = 32, smax_scale: float = 3e-3, *,
                        device) -> QuantLinear:
    """An EXL2 QuantLinear with random plane words, qs and smax."""
    rows_pad = -(-k // SUB_BLOCK) * SUB_BLOCK
    planes = tuple(_words(gen, (rows_pad * bp // 32, n), device)
                   for bp in plane_split(bits))
    groups = rows_pad // group_rows
    qscale = torch.randint(1, 17, (groups, n), dtype=torch.uint8,
                           generator=gen, device=device)
    smax = (_uniform(gen, (groups, 1), device) * smax_scale
            + smax_scale / 4)
    seg = QuantSegment(planes=planes, qscale=qscale, smax=smax, bits=bits,
                       plane_bits=plane_split(bits), rows=k,
                       group_rows=group_rows)
    return QuantLinear(segments=[seg], perm=None, bias=None, k=k, n=n,
                       n_orig=n)


def random_gptq_linear(gen: torch.Generator, k: int, n: int, bits: int = 4,
                       group_rows: int = 128, scale_mag: float = 3e-3, *,
                       device) -> QuantLinear:
    """GPTQ analog of random_quant_linear: random plane words plus explicit
    per-group f32 scales and int32 zeros."""
    rows_pad = -(-k // SUB_BLOCK) * SUB_BLOCK
    planes = tuple(_words(gen, (rows_pad * bp // 32, n), device)
                   for bp in plane_split(bits))
    groups = rows_pad // group_rows
    scale = (_uniform(gen, (groups, n), device) * scale_mag
             + scale_mag / 4)
    zero = torch.randint(0, 2 ** bits, (groups, n), dtype=torch.int32,
                         generator=gen, device=device)
    seg = GptqSegment(planes=planes, scale=scale, zero=zero, bits=bits,
                      plane_bits=plane_split(bits), rows=k,
                      group_rows=group_rows)
    return QuantLinear(segments=[seg], perm=None, bias=None, k=k, n=n,
                       n_orig=n)


def random_model_weights(*, vocab=32000, hidden=4096, layers=32, heads=32,
                         kv_heads=32, inter=11008, max_seq=2048, bits=4,
                         seed=0, fmt="exl2", moe=0, moe_topk=2, arch=None,
                         head_dim=None, sliding_window=0,
                         rope_theta=10000.0, attn_bias=False, device=None
                         ) -> tuple[ModelWeights, StaticModel]:
    """In-memory random model (ModelWeights, StaticModel) of real geometry,
    built on `device` (the card by default): EXL2 linears with 32-row
    groups, or with fmt="gptq" GPTQ linears with 128-row groups. The
    defaults are Llama-2-7B's geometry.

    moe > 0 makes every layer a block-sparse MoE of that many experts, top
    moe_topk, with a bf16 router drawn from N(0, 0.02^2). `arch` (a
    registered architecture string) takes that architecture's structure:
    norm kind and constant bias, activation and gating, per-head QK norms,
    post-norms, parallel blocks, learned positions (max_seq rows), rope
    style, embedding scale, f32 residual, softcaps and a tied bf16 head;
    sliding_window windows its pattern's layers, which take a table of the
    architecture's sliding theta where it has one (rope_theta is the
    other layers'), and NoPE layers where it says so. attn_bias gives q, k
    and v bf16 biases drawn from N(0, 0.02^2) (Qwen2). Norms are the
    identity (zero biases); head_dim defaults to hidden // heads."""
    if fmt not in ("exl2", "gptq"):
        raise ValueError(f"fmt {fmt!r}: want 'exl2' or 'gptq'")
    device = resolve_device(device)
    ap = get_arch(arch) if arch else None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    head_dim = head_dim or hidden // heads

    def lin(k, n):
        if fmt == "gptq":
            return random_gptq_linear(gen, k, n, bits=bits, device=device)
        return random_quant_linear(gen, k, n, bits=bits, device=device)

    layernorm = ap is not None and ap.norm == NormType.LAYERNORM

    # identity norms: weight 1, or 0 where the architecture scales by
    # (bias + weight) with a constant bias of 1 (Gemma)
    w_norm = 1.0 - (ap.norm_constant_bias if ap is not None else 0.0)

    def norm(width=hidden):
        return NormWeights(
            weight=torch.full((width,), w_norm, dtype=torch.float32,
                              device=device),
            bias=torch.zeros((width,), dtype=torch.float32, device=device)
            if layernorm else None)

    def dense(k, n):
        return DenseLinear((torch.randn((k, n), generator=gen, device=device)
                            * 0.02).to(torch.bfloat16), None)

    qk_norm = ap is not None and ap.default_use_qk_norm
    gated = ap is None or (ap.mlp_gated and ap.key_mlp_gate is not None)
    lws = []
    for _ in range(layers):
        an = norm()
        qkv = [lin(hidden, w) for w in (heads * head_dim, kv_heads * head_dim,
                                        kv_heads * head_dim)]
        if attn_bias:
            for x in qkv:
                x.bias = (torch.randn((x.n_orig,), generator=gen,
                                      device=device) * 0.02).to(torch.bfloat16)
        attn = AttnWeights(norm=an,
                           q=qkv[0], k=qkv[1], v=qkv[2],
                           o=lin(heads * head_dim, hidden),
                           q_norm=norm(head_dim) if qk_norm else None,
                           k_norm=norm(head_dim) if qk_norm else None,
                           norm_post=norm() if ap is not None
                           and ap.key_norm_1_post else None)
        mn = norm() if ap is None or ap.key_norm_2 else an
        mpost = norm() if ap is not None and ap.key_norm_2_post else None
        if moe:
            mlp = MoEWeights(
                norm=mn, router=dense(hidden, moe),
                w1=[lin(hidden, inter) for _ in range(moe)],
                w2=[lin(inter, hidden) for _ in range(moe)],
                w3=[lin(hidden, inter) for _ in range(moe)],
                norm_post=mpost)
        else:
            mlp = MLPWeights(norm=mn,
                             gate=lin(hidden, inter) if gated else None,
                             up=lin(hidden, inter), down=lin(inter, hidden),
                             norm_post=mpost)
        lws.append(LayerWeights(attn=attn, mlp=mlp))

    from types import SimpleNamespace

    def tables(theta):
        return build_sincos(SimpleNamespace(
            rotary_dim=head_dim, rotary_embedding_base=theta,
            rope_scaling=None, max_seq_len=max_seq,
            max_position_embeddings=max_seq,
            original_max_position_embeddings=None, head_dim=head_dim),
            device=device)

    sin, cos = tables(rope_theta)
    embed = (torch.randn((vocab, hidden), generator=gen, device=device)
             * 0.02).to(torch.bfloat16)
    pos_emb = None
    if ap is not None and ap.learned_pos_emb:
        pos_emb = (torch.randn((max_seq, hidden), generator=gen,
                               device=device) * 0.01).to(torch.bfloat16)
    pattern = ap.sliding_window_pattern if ap is not None else 0
    swa = [sliding_window if sliding_window and (
        pattern <= 1 or (l + 1) % pattern != 0) else 0
        for l in range(layers)]
    alt = (ap is not None and ap.sliding_rope_theta is not None
           and any(swa))
    sin_alt, cos_alt = tables(ap.sliding_rope_theta) if alt else (None, None)
    per_layer = tuple(LayerStatic(
        sliding_window=swa[l], alt_rope=bool(alt and swa[l]),
        rope_enabled=not (ap is not None and ap.rope_swa_only
                          and not swa[l])) for l in range(layers))
    tied = ap is not None and ap.tied_head_default
    head = DenseLinear(embed.t().contiguous(), None) if tied \
        else lin(hidden, vocab)
    w = ModelWeights(embed=embed, layers=lws, final_norm=norm(), head=head,
                     sin=sin, cos=cos, pos_emb=pos_emb, sin_alt=sin_alt,
                     cos_alt=cos_alt)
    quirks = {}
    if ap is not None:
        quirks = dict(
            norm_type="layernorm" if layernorm else "rms",
            norm_constant_bias=ap.norm_constant_bias,
            rope_style={RopeStyle.NEOX: "neox", RopeStyle.GPTJ: "gptj",
                        RopeStyle.NONE: "none"}[ap.rope_style],
            mlp_act=ap.mlp_act, mlp_gated=gated, use_qk_norm=qk_norm,
            attn_logit_softcap=ap.attn_logit_softcapping,
            final_logit_softcap=ap.final_logit_softcapping,
            normalize_embeddings=ap.normalize_embeddings,
            residual_fp32=ap.residual_stream_fp32,
            parallel_blocks=ap.parallel_decoder_blocks,
            learned_pos_emb=ap.learned_pos_emb)
    st = StaticModel(
        num_layers=layers, num_heads=heads, num_kv_heads=kv_heads,
        head_dim=head_dim, hidden_size=hidden, vocab_size=vocab,
        norm_eps=1e-5, layers=per_layer, num_experts=moe,
        num_experts_per_tok=moe_topk if moe else 0, **quirks)
    return w, st


_LORA_TARGETS = {"q_proj": ("attn", "q"), "k_proj": ("attn", "k"),
                 "v_proj": ("attn", "v"), "o_proj": ("attn", "o"),
                 "gate_proj": ("mlp", "gate"), "up_proj": ("mlp", "up"),
                 "down_proj": ("mlp", "down")}


def write_random_lora(directory: str, weights: ModelWeights, *,
                      rank: int = 16, alpha: float = 32.0,
                      scale: float = 0.05, seed: int = 0,
                      targets=tuple(_LORA_TARGETS)) -> str:
    """Write a PEFT adapter directory (adapter_config.json and BF16
    adapter_model.safetensors) for every layer's `targets` of `weights`:
    A and B drawn from N(0, scale^2) on the weights' device in bf16, from a
    generator seeded with `seed`. Returns `directory` (lora.Lora reads
    it)."""
    device = weights.embed.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(shape):
        t = (torch.randn(shape, generator=gen, device=device)
             * scale).to(torch.bfloat16)
        return t.view(torch.int16).cpu().numpy().view(np.uint16)

    tensors = {}
    for l, lw in enumerate(weights.layers):
        for t in targets:
            part, name = _LORA_TARGETS[t]
            lin = getattr(getattr(lw, part), name)
            k, n = (lin.k, lin.n_orig) if hasattr(lin, "k") \
                else tuple(lin.weight.shape)
            sub = "self_attn" if part == "attn" else "mlp"
            p = f"base_model.model.model.layers.{l}.{sub}.{t}"
            tensors[f"{p}.lora_A.weight"] = draw((rank, k))
            tensors[f"{p}.lora_B.weight"] = draw((n, rank))
    os.makedirs(directory, exist_ok=True)
    write_safetensors(os.path.join(directory, "adapter_model.safetensors"),
                      tensors, dtypes={k: "BF16" for k in tensors})
    with open(os.path.join(directory, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha,
                   "target_modules": list(targets)}, f)
    return directory


def _quant_linear_exl2(rng, w_hf: np.ndarray, bits_pattern, group_rows=32,
                       act_order=False) -> dict[str, np.ndarray]:
    """w_hf [out, in] f32 -> EXL2 tensor dict. Stored layout is W^T [in, out]."""
    wt = np.ascontiguousarray(w_hf.T)                        # [K, N]
    k = wt.shape[0]
    groups = -(-k // group_rows)
    bits = [bits_pattern[i % len(bits_pattern)] for i in range(groups)]
    invperm = None
    if act_order:
        perm = rng.permutation(k).astype(np.int32)
        invperm = np.argsort(perm).astype(np.int32)
        wt = wt[perm]
    t = F.exl2_pack(wt, bits, group_rows, invperm=invperm)
    out = {"q_weight": t.q_weight, "q_scale": t.q_scale,
           "q_scale_max": t.q_scale_max.astype(np.float16),
           "q_groups": t.q_groups}
    if t.q_invperm is not None:
        out["q_invperm"] = t.q_invperm
    return out


def _quant_linear_gptq(rng, w_hf: np.ndarray, bits=4, group_size=32,
                       act_order=False) -> dict[str, np.ndarray]:
    wt = np.ascontiguousarray(w_hf.T)
    k, n = wt.shape
    g_idx = None
    if act_order:
        perm = rng.permutation(k)
        g_idx = (perm // group_size).astype(np.int32)
        # quantize rows grouped by g_idx but stored in original order:
        order = np.argsort(g_idx, kind="stable")
        inv = np.argsort(order)
        wt_g = wt[order]
    else:
        wt_g = wt
    groups = -(-k // group_size)
    maxq = 2 ** bits - 1
    q = np.empty((k, n), np.uint16)
    zeros = np.empty((groups, n), np.uint16)
    scales = np.empty((groups, n), np.float16)
    for g in range(groups):
        rows = wt_g[g * group_size:(g + 1) * group_size]
        lo, hi = rows.min(axis=0), rows.max(axis=0)
        scale = np.maximum((hi - lo) / maxq, 1e-8)
        zero = np.clip(np.round(-lo / scale), 0, maxq)
        q[g * group_size:g * group_size + rows.shape[0]] = np.clip(
            np.round(rows / scale) + zero, 0, maxq).astype(np.uint16)
        zeros[g] = zero.astype(np.uint16)
        scales[g] = scale.astype(np.float16)
    if act_order:
        q = q[inv]
    t = F.gptq_pack(q, zeros, scales.astype(np.float32), bits=bits,
                    g_idx=g_idx)
    out = {"qweight": t.qweight, "qzeros": t.qzeros,
           "scales": t.scales.astype(np.float16)}
    if t.g_idx is not None:
        out["g_idx"] = t.g_idx
    return out


def make_tiny_llama(model_dir: str, *, quant: str | None = "exl2",
                    vocab: int = 256, hidden: int = 256, layers: int = 2,
                    heads: int = 4, kv_heads: int = 2, inter: int = 512,
                    max_pos: int = 512, seed: int = 0,
                    act_order: bool = False, arch: str = "LlamaForCausalLM",
                    extra_config: dict | None = None,
                    scale: float = 0.05, head_scale: float = 1.0,
                    attn_scale: float = 1.0) -> str:
    """Write a tiny random checkpoint in the layout the given architecture
    declares (keys derived from the ArchParams registry); returns model_dir.
    numpy only, in the reference's order of draws: for one seed the files
    are byte for byte the reference's make_tiny_llama's."""
    os.makedirs(model_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    ap = get_arch(arch, allow_fallback=True)
    head_dim = hidden // heads
    if ap.mqa:
        kv_heads = 1
    cfg = {
        "architectures": [arch],
        "hidden_size": hidden,
        "intermediate_size": inter,
        "num_hidden_layers": layers,
        "num_attention_heads": heads,
        "num_key_value_heads": kv_heads,
        "vocab_size": vocab,
        "rms_norm_eps": 1e-5,
        "layer_norm_eps": 1e-5,
        "layer_norm_epsilon": 1e-5,
        "norm_epsilon": 1e-5,
        "rope_theta": 10000.0,
        "max_position_embeddings": max_pos,
        "tie_word_embeddings": False,
        "bos_token_id": 1, "eos_token_id": 2,
    }
    if extra_config:
        cfg.update(extra_config)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)

    def dense(o, i):
        return (rng.standard_normal((o, i)) * scale).astype(np.float32)

    tensors: dict[str, np.ndarray] = {}
    pre = ap.lm_prefix
    norm_bias = ap.norm == NormType.LAYERNORM

    def put_linear(key, w_hf, bias_width=0):
        if ap.orig_weights_transposed:
            w_hf = np.ascontiguousarray(w_hf.T)   # Conv1D stores [in, out]
            assert quant is None, "transposed fixtures are fp16-only"
        if quant == "exl2":
            sub = _quant_linear_exl2(rng, w_hf, bits_pattern=[4, 4, 5, 3],
                                     act_order=act_order)
        elif quant == "gptq":
            sub = _quant_linear_gptq(rng, w_hf, act_order=act_order)
        else:
            sub = {"weight": w_hf.astype(np.float16)}
        for suffix, arr in sub.items():
            tensors[f"{pre}{key}.{suffix}"] = arr
        if bias_width:
            tensors[f"{pre}{key}.bias"] = \
                (rng.standard_normal(bias_width) * 0.01).astype(np.float16)

    def put_norm(key_pat, l):
        key = pre + key_pat.split("|")[0].format(l=l)
        tensors[f"{key}.weight"] = (
            np.ones(hidden, np.float16)
            + rng.standard_normal(hidden).astype(np.float16) * 0.01)
        if norm_bias:
            tensors[f"{key}.bias"] = np.zeros(hidden, np.float16)

    tensors[f"{pre}model.embed_tokens.weight"] = \
        dense(vocab, hidden).astype(np.float16)
    if ap.learned_pos_emb and ap.key_learned_pos_emb:
        tensors[f"{pre}{ap.key_learned_pos_emb}.weight"] = \
            (rng.standard_normal((max_pos, hidden)) * 0.01).astype(np.float16)

    attn_bias = bool(ap.attention_bias
                     or (extra_config or {}).get("attention_bias"))
    mlp_bias = ap.mlp_bias
    nq, nkv = heads * head_dim, kv_heads * head_dim
    for l in range(layers):
        put_norm(ap.key_norm_1, l)
        if ap.key_norm_1_post:
            put_norm(ap.key_norm_1_post, l)
        if ap.key_norm_2:
            put_norm(ap.key_norm_2, l)
        if ap.key_norm_2_post:
            put_norm(ap.key_norm_2_post, l)
        if ap.fused_qkv:
            if ap.fused_qkv_altpack:
                # [q_group | k | v] per kv head (InternLM2 wqkv)
                g = heads // kv_heads
                blocks = []
                for h in range(kv_heads):
                    blocks += [dense(g * head_dim, hidden),
                               dense(head_dim, hidden),
                               dense(head_dim, hidden)]
                w = np.concatenate(blocks, axis=0)
            else:
                w = dense(nq + 2 * nkv, hidden)
            put_linear(ap.key_fused_qkv.format(l=l), w,
                       bias_width=(nq + 2 * nkv) if attn_bias else 0)
        else:
            # attn_scale > 1 peaks the softmax (scores scale ~ s^2): a
            # random-init net attends near-uniformly, which hides
            # K-cache quantization error — peaked attention restores the
            # trained-model sensitivity (K error perturbs WHERE attention
            # lands, see docs/QUALITY.md q6-vs-q4 discussion)
            put_linear(ap.key_attn_q.format(l=l),
                       dense(nq, hidden) * attn_scale,
                       bias_width=nq if attn_bias else 0)
            put_linear(ap.key_attn_k.format(l=l),
                       dense(nkv, hidden) * attn_scale,
                       bias_width=nkv if attn_bias else 0)
            put_linear(ap.key_attn_v.format(l=l), dense(nkv, hidden),
                       bias_width=nkv if attn_bias else 0)
        put_linear(ap.key_attn_o.format(l=l), dense(hidden, nq),
                   bias_width=hidden if ap.attention_bias_o else 0)
        if ap.is_moe:
            n_exp = (extra_config or {}).get(
                "num_local_experts", (extra_config or {}).get(
                    "num_experts", 4))
            # router stays fp16 (reference keeps it unquantized)
            tensors[f"{pre}{ap.key_moe_gate.format(l=l)}.weight"] = \
                dense(n_exp, hidden).astype(np.float16)
            for e in range(n_exp):
                put_linear(ap.key_moe_w1.format(l=l, e=e),
                           dense(inter, hidden))
                put_linear(ap.key_moe_w2.format(l=l, e=e),
                           dense(hidden, inter))
                put_linear(ap.key_moe_w3.format(l=l, e=e),
                           dense(inter, hidden))
        elif ap.fused_gate_up:
            put_linear(ap.key_fused_gate_up.format(l=l),
                       dense(2 * inter, hidden))
            put_linear(ap.key_mlp_down.format(l=l), dense(hidden, inter))
        else:
            if ap.mlp_gated and ap.key_mlp_gate:
                put_linear(ap.key_mlp_gate.format(l=l), dense(inter, hidden),
                           bias_width=inter if mlp_bias else 0)
            put_linear(ap.key_mlp_up.format(l=l), dense(inter, hidden),
                       bias_width=inter if mlp_bias else 0)
            put_linear(ap.key_mlp_down.format(l=l), dense(hidden, inter),
                       bias_width=hidden if mlp_bias else 0)
    tensors[f"{pre}model.norm.weight"] = np.ones(hidden, np.float16)
    if norm_bias:
        tensors[f"{pre}model.norm.bias"] = np.zeros(hidden, np.float16)
    if not ap.tied_head_default:
        # head_scale > 1 sharpens logit margins so greedy argmax is stable
        # under bf16 shape-dependent accumulation (speculative-decode tests)
        w = dense(vocab, hidden) * head_scale
        if ap.orig_weights_transposed:
            w = np.ascontiguousarray(w.T)
        tensors[f"{pre}lm_head.weight"] = w.astype(np.float16)

    write_safetensors(os.path.join(model_dir, "model.safetensors"), tensors)
    return model_dir


# ---------------------------------------------------------------- vision

def random_vision_tower(cfg, *, seed: int = 0, device=None):
    """The vision tower of `cfg` (a ModelConfig with a vision_config) with
    random bf16 weights drawn on `device` (the card by default) from a
    torch.Generator seeded with `seed`: linears N(0, 0.02^2) with biases
    N(0, 0.01^2) where the family has them, identity norms. A pixtral
    tower with a spatial merge takes Mistral 3's projector norm and patch
    merger."""
    from exllamav2_tpu_torch.vlm.vision_tower import VisionTower, _VLayer
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    vt = cfg.vision_model_type
    vh, inter = cfg.vision_hidden_size, cfg.vision_intermediate_size
    nh, hd = cfg.vision_num_attention_heads, cfg.vision_head_dim
    biased = vt != "pixtral"
    layernorm = vt in ("qwen2", "siglip_vision_model")

    def draw(shape, std):
        return (torch.randn(shape, generator=gen, device=device)
                * std).to(torch.bfloat16)

    def lin(k, n, bias=biased):
        return DenseLinear(draw((k, n), 0.02),
                           draw((n,), 0.01) if bias else None)

    def norm(width=vh, ln=layernorm):
        return NormWeights(
            torch.ones((width,), dtype=torch.float32, device=device),
            torch.zeros((width,), dtype=torch.float32, device=device)
            if ln else None)

    ph, pw = cfg.vision_patch_size["height"], cfg.vision_patch_size["width"]
    tps = cfg.vision_temporal_patch_size if vt in ("qwen2", "qwen2.5") \
        else 1
    gated = vt in ("pixtral", "qwen2.5")
    layers = [_VLayer(norm(), lin(vh, nh * hd), lin(vh, nh * hd),
                      lin(vh, nh * hd), lin(nh * hd, vh), norm(),
                      lin(vh, inter) if gated else None, lin(vh, inter),
                      lin(inter, vh))
              for _ in range(cfg.vision_num_layers)]
    patch_conv = lin(3 * tps * ph * pw, vh,
                     bias=vt == "siglip_vision_model")
    ln_pre = pos_emb = None
    lm = cfg.hidden_size
    merge = cfg.vision_spatial_merge_size ** 2
    if vt == "pixtral":
        ln_pre = norm()
        merger = merge > 1
        mmp = dict(kind="mlp", act="gelu", norm_kind="rms",
                   norm=norm() if merger else None,
                   patch_merger=lin(merge * vh, vh, bias=False)
                   if merger else None,
                   up=lin(vh, lm, bias=False), down=lin(lm, lm, bias=False))
    elif vt in ("qwen2", "qwen2.5"):
        mi = merge * vh
        mmp = dict(kind="mlp", act="gelu",
                   norm_kind="rms" if vt == "qwen2.5" else "layernorm",
                   norm=norm(), patch_merger=None, up=lin(mi, mi, True),
                   down=lin(mi, lm, True))
    else:
        side = cfg.vision_size["height"] // ph
        pos_emb = draw((side * side, vh), 0.02)
        mmp = dict(kind="proj", norm=norm(ln=False),
                   proj=lin(vh, lm, bias=False))
    return VisionTower(cfg, device=device, parts=dict(
        layers=layers, patch_conv=patch_conv, ln_pre=ln_pre,
        pos_emb=pos_emb, mmp=mmp))


# tiny vision-language checkpoints: (architecture, LM config, vision_config
# and top-level extras, preprocessor_config.json)
_PREP = {"image_mean": [0.48, 0.46, 0.41], "image_std": [0.27, 0.26, 0.28],
         "rescale_factor": 1 / 255.0}
_TINY_VLM = {
    "pixtral": ("LlavaForConditionalGeneration", {
        "vision_config": {
            "model_type": "pixtral", "hidden_size": 64, "head_dim": 16,
            "num_attention_heads": 4, "patch_size": 4, "rope_theta": 10000.0,
            "num_hidden_layers": 2, "intermediate_size": 96,
            "hidden_act": "silu"},
        "vision_feature_layer": -1}, {
        "image_processor_type": "PixtralImageProcessor", **_PREP,
        "resample": 3, "patch_size": {"width": 4, "height": 4},
        "size": {"longest_edge": 32}}),
    "qwen2": ("Qwen2VLForConditionalGeneration", {
        "rope_scaling": {"type": "mrope", "mrope_section": [8, 12, 12]},
        "vision_config": {
            "model_type": "qwen2", "embed_dim": 32, "num_heads": 2,
            "mlp_ratio": 4, "patch_size": 4, "spatial_merge_size": 2,
            "spatial_patch_size": 4, "temporal_patch_size": 2,
            "depth": 2}}, {
        "image_processor_type": "Qwen2VLImageProcessor", **_PREP,
        "patch_size": 4, "temporal_patch_size": 2, "merge_size": 2,
        "min_pixels": 8 * 8, "max_pixels": 64 * 64}),
    # window 16 px = 2 merged units of 8 px: a 6 x 6 unit grid has nine
    # windows; block 1 attends over the whole image
    "qwen2.5": ("Qwen2_5_VLForConditionalGeneration", {
        "rope_scaling": {"type": "mrope", "mrope_section": [8, 12, 12]},
        "vision_config": {
            "hidden_size": 32, "intermediate_size": 48, "num_heads": 2,
            "out_hidden_size": 256, "patch_size": 4, "spatial_merge_size": 2,
            "spatial_patch_size": 4, "temporal_patch_size": 2, "depth": 2,
            "window_size": 16, "fullatt_block_indexes": [1]}}, {
        "image_processor_type": "Qwen2VLImageProcessor", **_PREP,
        "patch_size": 4, "temporal_patch_size": 2, "merge_size": 2,
        "min_pixels": 8 * 8, "max_pixels": 64 * 64}),
    "siglip": ("Gemma3ForConditionalGeneration", {
        "mm_tokens_per_image": 4,
        "vision_config": {
            "model_type": "siglip_vision_model", "hidden_size": 32,
            "num_attention_heads": 2, "num_hidden_layers": 2,
            "intermediate_size": 64, "patch_size": 4, "image_size": 16,
            "hidden_act": "gelu_pytorch_tanh"}}, {
        "image_processor_type": "Gemma3ImageProcessor",
        "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5],
        "rescale_factor": 1 / 255.0, "resample": 2,
        "size": {"width": 16, "height": 16}}),
}


def _tiny_tower_tensors(kind: str, vc: dict, lm_hidden: int,
                        seed: int) -> dict[str, np.ndarray]:
    """Tower and projector tensors of a tiny checkpoint, fp16, in the
    checkpoint's key layout. pixtral and qwen2 draw as the reference's
    tests/test_vlm.py fixtures do, seed for seed."""
    rng = np.random.default_rng(seed)

    def dense(o, i):
        return (rng.standard_normal((o, i)) * 0.05).astype(np.float16)

    def ones(n):
        return np.ones(n, np.float16)

    def zeros(n):
        return np.zeros(n, np.float16)

    t = {}
    if kind == "pixtral":
        vh, p, inter = vc["hidden_size"], vc["patch_size"], \
            vc["intermediate_size"]
        t["vision_tower.ln_pre.weight"] = ones(vh)
        t["vision_tower.patch_conv.weight"] = \
            (rng.standard_normal((vh, 3, p, p)) * 0.05).astype(np.float16)
        for l in range(vc["num_hidden_layers"]):
            b = f"vision_tower.transformer.layers.{l}"
            t[f"{b}.attention_norm.weight"] = ones(vh)
            t[f"{b}.ffn_norm.weight"] = ones(vh)
            for nm in ("q", "k", "v", "o"):
                t[f"{b}.attention.{nm}_proj.weight"] = dense(vh, vh)
            t[f"{b}.feed_forward.gate_proj.weight"] = dense(inter, vh)
            t[f"{b}.feed_forward.up_proj.weight"] = dense(inter, vh)
            t[f"{b}.feed_forward.down_proj.weight"] = dense(vh, inter)
        t["multi_modal_projector.linear_1.weight"] = dense(lm_hidden, vh)
        t["multi_modal_projector.linear_1.bias"] = zeros(lm_hidden)
        t["multi_modal_projector.linear_2.weight"] = dense(lm_hidden,
                                                           lm_hidden)
        t["multi_modal_projector.linear_2.bias"] = zeros(lm_hidden)
    elif kind in ("qwen2", "qwen2.5"):
        q25 = kind == "qwen2.5"
        vh = vc["hidden_size"] if q25 else vc["embed_dim"]
        inter = vc["intermediate_size"] if q25 else vc["mlp_ratio"] * vh
        p, tps = vc["patch_size"], vc["temporal_patch_size"]
        t["visual.patch_embed.proj.weight"] = \
            (rng.standard_normal((vh, 3, tps, p, p)) * 0.05
             ).astype(np.float16)
        for l in range(vc["depth"]):
            b = f"visual.blocks.{l}"
            t[f"{b}.norm1.weight"] = ones(vh)
            t[f"{b}.norm2.weight"] = ones(vh)
            if not q25:
                t[f"{b}.norm1.bias"] = zeros(vh)
                t[f"{b}.norm2.bias"] = zeros(vh)
            t[f"{b}.attn.qkv.weight"] = dense(3 * vh, vh)
            t[f"{b}.attn.qkv.bias"] = zeros(3 * vh)
            t[f"{b}.attn.proj.weight"] = dense(vh, vh)
            t[f"{b}.attn.proj.bias"] = zeros(vh)
            mlp = (("gate_proj", inter, vh), ("up_proj", inter, vh),
                   ("down_proj", vh, inter)) if q25 else \
                (("fc1", inter, vh), ("fc2", vh, inter))
            for nm, o, i in mlp:
                t[f"{b}.mlp.{nm}.weight"] = dense(o, i)
                t[f"{b}.mlp.{nm}.bias"] = zeros(o)
        merge = 4 * vh          # spatial merge 2: four patches concatenated
        out = vc["out_hidden_size"] if q25 else lm_hidden
        t["visual.merger.ln_q.weight"] = ones(vh)
        if not q25:
            t["visual.merger.ln_q.bias"] = zeros(vh)
        t["visual.merger.mlp.0.weight"] = dense(merge, merge)
        t["visual.merger.mlp.0.bias"] = zeros(merge)
        t["visual.merger.mlp.2.weight"] = dense(out, merge)
        t["visual.merger.mlp.2.bias"] = zeros(out)
    else:                                               # siglip
        vh, p, inter = vc["hidden_size"], vc["patch_size"], \
            vc["intermediate_size"]
        pre = "vision_tower.vision_model."
        t[pre + "embeddings.patch_embedding.weight"] = \
            (rng.standard_normal((vh, 3, p, p)) * 0.05).astype(np.float16)
        t[pre + "embeddings.patch_embedding.bias"] = zeros(vh)
        n_pos = (vc["image_size"] // p) ** 2
        t[pre + "embeddings.position_embedding.weight"] = \
            (rng.standard_normal((n_pos, vh)) * 0.05).astype(np.float16)
        for l in range(vc["num_hidden_layers"]):
            b = f"{pre}encoder.layers.{l}"
            for nm in ("layer_norm1", "layer_norm2"):
                t[f"{b}.{nm}.weight"] = ones(vh)
                t[f"{b}.{nm}.bias"] = zeros(vh)
            for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
                t[f"{b}.self_attn.{nm}.weight"] = dense(vh, vh)
                t[f"{b}.self_attn.{nm}.bias"] = zeros(vh)
            t[f"{b}.mlp.fc1.weight"] = dense(inter, vh)
            t[f"{b}.mlp.fc1.bias"] = zeros(inter)
            t[f"{b}.mlp.fc2.weight"] = dense(vh, inter)
            t[f"{b}.mlp.fc2.bias"] = zeros(vh)
        t["multi_modal_projector.mm_soft_emb_norm.weight"] = ones(vh)
        # stored [vision_hidden, lm_hidden], as Gemma 3 keeps it
        t["multi_modal_projector.mm_input_projection.weight"] = \
            dense(vh, lm_hidden)
    return t


def make_tiny_vlm(model_dir: str, kind: str, *, seed: int = 51,
                  tower_seed: int | None = None, **lm_kw) -> str:
    """A tiny random vision-language checkpoint: make_tiny_llama's FP16
    language model (vocab 384, max_pos 4096, in the architecture's layout)
    plus a vision tower of `kind` ("pixtral", "qwen2", "qwen2.5" or
    "siglip") and its preprocessor_config.json. numpy only, so the
    reference package loads the same files; pixtral (tower_seed 7) and
    qwen2 (tower_seed 9) are the reference's tests/test_vlm.py fixtures.
    Returns model_dir."""
    arch, extra, prep = _TINY_VLM[kind]
    kw = dict(quant=None, seed=seed, vocab=384, max_pos=4096)
    kw.update(lm_kw)
    make_tiny_llama(model_dir, arch=arch, extra_config=extra, **kw)
    if tower_seed is None:
        tower_seed = {"pixtral": 7, "qwen2": 9}.get(kind, 11)
    from exllamav2_tpu_torch.stloader import TensorFileMap
    tfm = TensorFileMap(model_dir)
    tensors = {k: tfm.get_tensor(k).copy() for k in tfm.keys()}
    tfm.close()
    tensors.update(_tiny_tower_tensors(kind, extra["vision_config"],
                                       kw.get("hidden", 256), tower_seed))
    write_safetensors(os.path.join(model_dir, "model.safetensors"), tensors)
    with open(os.path.join(model_dir, "preprocessor_config.json"), "w") as f:
        json.dump(prep, f)
    return model_dir
