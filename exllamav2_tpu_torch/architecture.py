"""Architecture registry: declarative per-family parameters.

Copy of exllamav2_tpu/architecture.py: this package imports
nothing of the JAX package, whose __init__ imports JAX.

TPU-native analog of the reference's exllamav2/architecture.py (966 lines,
~28 architectures). Each entry states tensor-key layouts, norm type, rope
style and quirk flags; the model builder (models/model.py) consumes these
to assemble the layer graph. Unknown architectures raise (the reference
falls back to Llama with a warning, architecture.py:922-927 — we fail loud
instead so wrong-layout checkpoints can't silently produce garbage; pass
``allow_fallback=True`` to opt into the reference behavior).

Key fields may contain "|"-separated alternatives (the analog of the
reference's alternative key lists, e.g. Yi's ["ln1", "input_layernorm"]);
the loader tries each in order.
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = ["RopeStyle", "NormType", "ArchParams", "get_arch",
           "ARCHITECTURES", "UnknownArchitectureError"]


class RopeStyle(enum.Enum):
    NONE = 0
    GPTJ = 1      # rotate interleaved even/odd pairs
    NEOX = 2      # rotate half (llama-style)


class NormType(enum.Enum):
    RMS = 0
    LAYERNORM = 1


@dataclasses.dataclass
class ArchParams:
    arch_string: str
    # tensor keys (format slots: {l} layer index, {e} expert index)
    key_embedding: str = "model.embed_tokens"
    key_norm_1: str = "model.layers.{l}.input_layernorm"
    key_norm_1_post: str | None = None       # gemma2/glm4 post-attn norm
    key_norm_2: str | None = "model.layers.{l}.post_attention_layernorm"
    key_norm_2_post: str | None = None       # gemma2/glm4 post-mlp norm
    key_attn_q: str = "model.layers.{l}.self_attn.q_proj"
    key_attn_k: str = "model.layers.{l}.self_attn.k_proj"
    key_attn_v: str = "model.layers.{l}.self_attn.v_proj"
    key_attn_o: str = "model.layers.{l}.self_attn.o_proj"
    key_attn_q_norm: str | None = None       # qwen3/gemma3 per-head qk norm
    key_attn_k_norm: str | None = None
    key_mlp_gate: str | None = "model.layers.{l}.mlp.gate_proj"
    key_mlp_up: str = "model.layers.{l}.mlp.up_proj"
    key_mlp_down: str = "model.layers.{l}.mlp.down_proj"
    key_norm: str = "model.norm"
    key_head: str = "lm_head"
    key_learned_pos_emb: str | None = None   # gpt2 model.wpe
    # MoE keys
    key_moe_gate: str | None = None           # router
    key_moe_w1: str | None = None             # gate_proj per expert
    key_moe_w2: str | None = None             # down_proj per expert
    key_moe_w3: str | None = None             # up_proj per expert
    # DBRX-style fused expert storage: one [E*ffn, d] raw tensor per
    # proj (no ".weight" suffix), sliced per expert at load
    key_moe_fused_w1: str | None = None
    key_moe_fused_w2: str | None = None
    key_moe_fused_w3: str | None = None
    # checkpoint key remapping (applied to raw safetensors names; "$" anchors
    # the match at the start of the name — reference architecture.py:81-106)
    keymap: tuple = ()
    # structure
    norm: NormType = NormType.RMS
    rope_style: RopeStyle = RopeStyle.NEOX
    mlp_act: str = "silu"                     # silu | gelu
    mlp_gated: bool = True
    is_moe: bool = False
    parallel_decoder_blocks: bool = False     # cohere-style
    # quirks (reference architecture.py:134-249)
    norm_eps_key: str = "rms_norm_eps"
    attention_bias: bool = False              # qwen2 style qkv bias
    attention_bias_o: bool = False
    mlp_bias: bool = False
    norm_constant_bias: float = 0.0           # gemma adds 1 to norm weight
    normalize_embeddings: bool = False        # gemma multiplies by sqrt(dim)
    residual_stream_fp32: bool = False
    clamp_hidden_states: bool = False
    logit_scale_basedim: bool = False         # minicpm
    attn_logit_softcapping: float = 0.0       # gemma2
    final_logit_softcapping: float = 0.0
    # SWA layer pattern (reference model.py:111-121): pattern P >= 2 means
    # layer l is sliding-window unless (l+1) % P == 0 (gemma2 P=2,
    # cohere2 P=4, gemma3 P=6); config "sliding_window_pattern" overrides.
    sliding_window_pattern: int = 0
    sliding_rope_theta: float | None = None   # gemma3 SWA layers rope theta
    rope_swa_only: bool = False               # cohere2: NoPE on full layers
    default_use_qk_norm: bool = False
    scale_attn_weights_by_layer: bool = False
    untie_word_embeddings_key: str = "tie_word_embeddings"
    fused_qkv: bool = False                   # phi3-style packed qkv
    key_fused_qkv: str | None = None
    fused_qkv_altpack: bool = False           # internlm2 grouped packing
    fused_gate_up: bool = False               # phi3-style packed gate_up
    key_fused_gate_up: str | None = None
    learned_pos_emb: bool = False             # gpt2
    mqa: bool = False                         # gptbigcode: kv_heads = 1
    requires_bos: bool = False
    orig_weights_transposed: bool = False     # gpt2 Conv1D stores [in, out]
    default_inner_dim_mult: int = 0           # gpt2: inter = 4*hidden
    tied_head_default: bool = False           # head = embedding unless present
    # gemma3 config defaults (reference architecture.py:604-612)
    default_vocab_size: int = 0
    default_head_dim: int = 0
    default_num_attention_heads: int = 0
    default_num_key_value_heads: int = 0
    default_rope_theta: float = 10000.0
    # multimodal
    lm_prefix: str = ""                       # gemma3/pixtral "language_model."
    vt_prefix: str = ""                       # vision tower prefix
    mmp_prefix: str = ""                      # multimodal projector prefix
    mrope: bool = False                       # qwen2-vl 3-axis rope
    vision: str | None = None                 # vision tower family id


class UnknownArchitectureError(ValueError):
    pass


def _llama(**kw) -> ArchParams:
    return ArchParams(**kw)


ARCHITECTURES: dict[str, ArchParams] = {}


def _register(arch: ArchParams):
    ARCHITECTURES[arch.arch_string] = arch
    return arch


# Llama family — the default (reference architecture.py:922-936).
_register(_llama(arch_string="LlamaForCausalLM"))

# Mistral: identical tensor layout; sliding window handled via config.
_register(_llama(arch_string="MistralForCausalLM"))

# Yi: llama layout with renamed norms (architecture.py:397-408).
_register(_llama(
    arch_string="YiForCausalLM",
    key_norm_1="model.layers.{l}.ln1|model.layers.{l}.input_layernorm",
    key_norm_2="model.layers.{l}.ln2|"
               "model.layers.{l}.post_attention_layernorm",
))

# Orion: llama layout with layernorm (architecture.py:412-420).
_register(_llama(arch_string="OrionForCausalLM", norm=NormType.LAYERNORM))

# Index: llama layout (architecture.py:880-887).
_register(_llama(arch_string="IndexForCausalLM"))

# Granite v3: llama layout + explicit multipliers, logits_scaling
# (architecture.py:891-898; config.py:306,330-344).
_register(_llama(arch_string="GraniteForCausalLM"))

# MiniCPM: llama layout + basedim logit scale, scale_emb/scale_depth
# (architecture.py:847-855; config.py:330-346).
_register(_llama(arch_string="MiniCPMForCausalLM", logit_scale_basedim=True))

# Qwen2/2.5: attention bias on q/k/v.
_register(_llama(arch_string="Qwen2ForCausalLM", attention_bias=True))

# Qwen3: per-head q/k norms, no attn bias.
_register(_llama(
    arch_string="Qwen3ForCausalLM",
    key_attn_q_norm="model.layers.{l}.self_attn.q_norm",
    key_attn_k_norm="model.layers.{l}.self_attn.k_norm",
    default_use_qk_norm=True,
))

# Qwen3 MoE.
_register(_llama(
    arch_string="Qwen3MoeForCausalLM",
    key_attn_q_norm="model.layers.{l}.self_attn.q_norm",
    key_attn_k_norm="model.layers.{l}.self_attn.k_norm",
    default_use_qk_norm=True,
    is_moe=True,
    key_moe_gate="model.layers.{l}.mlp.gate",
    key_moe_w1="model.layers.{l}.mlp.experts.{e}.gate_proj",
    key_moe_w2="model.layers.{l}.mlp.experts.{e}.down_proj",
    key_moe_w3="model.layers.{l}.mlp.experts.{e}.up_proj",
))

# Mixtral MoE.
_register(_llama(
    arch_string="MixtralForCausalLM",
    is_moe=True,
    key_moe_gate="model.layers.{l}.block_sparse_moe.gate",
    key_moe_w1="model.layers.{l}.block_sparse_moe.experts.{e}.w1",
    key_moe_w2="model.layers.{l}.block_sparse_moe.experts.{e}.w2",
    key_moe_w3="model.layers.{l}.block_sparse_moe.experts.{e}.w3",
))

# GemMoE: mixtral-style MoE with gemma quirks (architecture.py:680-700).
_register(_llama(
    arch_string="GemmoeForCausalLM",
    is_moe=True,
    key_moe_gate="model.layers.{l}.block_sparse_moe.gate",
    key_moe_w1="model.layers.{l}.block_sparse_moe.experts.{e}.w1",
    key_moe_w2="model.layers.{l}.block_sparse_moe.experts.{e}.w2",
    key_moe_w3="model.layers.{l}.block_sparse_moe.experts.{e}.w3",
    mlp_act="gelu",
    norm_constant_bias=1.0,
    normalize_embeddings=True,
    tied_head_default=True,
    requires_bos=True,
))

# DBRX: keymap-renamed MoE with fused qkv + layernorm
# (architecture.py:747-765).
_register(_llama(
    arch_string="DbrxForCausalLM",
    keymap=(("transformer.", "model."),
            (".blocks.", ".layers."),
            (".ffn.experts.mlp.", ".block_sparse_moe.experts."),
            (".ffn.router.layer.", ".block_sparse_moe.gate."),
            (".norm_attn_norm.norm_1.", ".input_layernorm."),
            (".norm_attn_norm.norm_2.", ".post_attention_layernorm."),
            (".norm_attn_norm.attn.", ".self_attn."),
            (".out_proj.", ".o_proj."),
            (".norm_f.", ".norm."),
            (".wte.", ".embed_tokens.")),
    norm=NormType.LAYERNORM,
    is_moe=True,
    fused_qkv=True,
    key_fused_qkv="model.layers.{l}.self_attn.Wqkv",
    key_moe_gate="model.layers.{l}.block_sparse_moe.gate",
    key_moe_w1="model.layers.{l}.block_sparse_moe.experts.{e}.w1",
    key_moe_w2="model.layers.{l}.block_sparse_moe.experts.{e}.w2",
    key_moe_w3="model.layers.{l}.block_sparse_moe.experts.{e}.v1",
    key_moe_fused_w1="model.layers.{l}.block_sparse_moe.experts.w1",
    key_moe_fused_w2="model.layers.{l}.block_sparse_moe.experts.w2",
    key_moe_fused_w3="model.layers.{l}.block_sparse_moe.experts.v1",
))

# Gemma: geglu, +1 norm bias, embedding scaling, tied head.
_register(_llama(
    arch_string="GemmaForCausalLM",
    mlp_act="gelu",
    norm_constant_bias=1.0,
    normalize_embeddings=True,
    tied_head_default=True,
    requires_bos=True,
))

# Gemma2: four norms per layer + softcapping + alternating SWA
# (architecture.py:556-576: norm_1=input, norm_1_post=post_attention,
# norm_2=pre_feedforward, norm_2_post=post_feedforward).
_register(_llama(
    arch_string="Gemma2ForCausalLM",
    key_norm_1="model.layers.{l}.input_layernorm",
    key_norm_1_post="model.layers.{l}.post_attention_layernorm",
    key_norm_2="model.layers.{l}.pre_feedforward_layernorm",
    key_norm_2_post="model.layers.{l}.post_feedforward_layernorm",
    mlp_act="gelu",
    norm_constant_bias=1.0,
    normalize_embeddings=True,
    attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0,
    sliding_window_pattern=2,
    residual_stream_fp32=True,
    tied_head_default=True,
    requires_bos=True,
))

# Gemma3 (text model; the ForConditionalGeneration wrapper adds the
# "language_model." prefix + vision tower — architecture.py:580-652).
def _gemma3(arch_string: str, lm_prefix: str, vision: str | None) -> ArchParams:
    return _llama(
        arch_string=arch_string,
        key_norm_1="model.layers.{l}.input_layernorm",
        key_norm_1_post="model.layers.{l}.post_attention_layernorm",
        key_norm_2="model.layers.{l}.pre_feedforward_layernorm",
        key_norm_2_post="model.layers.{l}.post_feedforward_layernorm",
        key_attn_q_norm="model.layers.{l}.self_attn.q_norm",
        key_attn_k_norm="model.layers.{l}.self_attn.k_norm",
        mlp_act="gelu",
        norm_constant_bias=1.0,
        normalize_embeddings=True,
        residual_stream_fp32=True,
        tied_head_default=True,
        requires_bos=True,
        default_use_qk_norm=True,
        default_vocab_size=262208,
        default_head_dim=256,
        default_num_attention_heads=8,
        default_num_key_value_heads=4,
        default_rope_theta=1e6,
        sliding_window_pattern=6,
        sliding_rope_theta=10000.0,
        lm_prefix=lm_prefix,
        vt_prefix="vision_tower.vision_model." if vision else "",
        mmp_prefix="multi_modal_projector." if vision else "",
        vision=vision,
    )

_register(_gemma3("Gemma3ForCausalLM", "", None))
_register(_gemma3("Gemma3ForConditionalGeneration", "language_model.",
                  "siglip"))

# Phi3: fused qkv + fused gate_up.
_register(_llama(
    arch_string="Phi3ForCausalLM",
    fused_qkv=True,
    key_fused_qkv="model.layers.{l}.self_attn.qkv_proj",
    fused_gate_up=True,
    key_fused_gate_up="model.layers.{l}.mlp.gate_up_proj",
))

# InternLM2: renamed tensors + grouped ("altpack") fused qkv
# (architecture.py:859-876, keymap architecture.py:103-106).
_register(_llama(
    arch_string="InternLM2ForCausalLM",
    keymap=(("$output.", "lm_head."),
            ("$model.tok_embeddings.", "model.embed_tokens."),
            (".attention.", ".self_attn."),
            (".wo.", ".o_proj.")),
    key_norm_1="model.layers.{l}.attention_norm",
    key_norm_2="model.layers.{l}.ffn_norm",
    key_mlp_gate="model.layers.{l}.feed_forward.w1",
    key_mlp_up="model.layers.{l}.feed_forward.w3",
    key_mlp_down="model.layers.{l}.feed_forward.w2",
    fused_qkv=True,
    key_fused_qkv="model.layers.{l}.self_attn.wqkv",
    fused_qkv_altpack=True,
))

# StarCoder2: layernorm + ungated gelu MLP + biases.
_register(_llama(
    arch_string="Starcoder2ForCausalLM",
    norm=NormType.LAYERNORM,
    norm_eps_key="norm_epsilon",
    mlp_gated=False,
    mlp_act="gelu",
    key_mlp_gate=None,
    key_mlp_up="model.layers.{l}.mlp.c_fc",
    key_mlp_down="model.layers.{l}.mlp.c_proj",
    attention_bias=True,
    attention_bias_o=True,
    mlp_bias=True,
    tied_head_default=True,
))

# GPTBigCode: keymap + MQA + fused qkv + learned positions, no rope
# (architecture.py:784-811).
_register(_llama(
    arch_string="GPTBigCodeForCausalLM",
    keymap=(("transformer.ln_f", "model.norm"),
            ("transformer.", "model."),
            (".attn.c_proj.", ".self_attn.o_proj."),
            (".attn.", ".self_attn."),
            (".h.", ".layers."),
            (".wte.", ".embed_tokens.")),
    key_norm_1="model.layers.{l}.ln_1",
    key_norm_2="model.layers.{l}.ln_2",
    key_mlp_gate=None,
    key_mlp_up="model.layers.{l}.mlp.c_fc",
    key_mlp_down="model.layers.{l}.mlp.c_proj",
    key_learned_pos_emb="model.wpe",
    norm=NormType.LAYERNORM,
    norm_eps_key="layer_norm_epsilon",
    rope_style=RopeStyle.NONE,
    mlp_gated=False,
    mlp_act="gelu",
    mqa=True,
    learned_pos_emb=True,
    fused_qkv=True,
    key_fused_qkv="model.layers.{l}.self_attn.c_attn",
    attention_bias=True,
    attention_bias_o=True,
    mlp_bias=True,
    tied_head_default=True,
))

# GPT2: like GPTBigCode but MHA, Conv1D (transposed) weights
# (architecture.py:815-843).
_register(_llama(
    arch_string="GPT2LMHeadModel",
    keymap=(("$ln_f.", "model.norm."),
            (".attn.c_proj.", ".self_attn.o_proj."),
            (".attn.", ".self_attn."),
            ("$h.", "model.layers."),
            ("$wte.", "model.embed_tokens."),
            ("$wpe.", "model.wpe.")),
    key_norm_1="model.layers.{l}.ln_1",
    key_norm_2="model.layers.{l}.ln_2",
    key_mlp_gate=None,
    key_mlp_up="model.layers.{l}.mlp.c_fc",
    key_mlp_down="model.layers.{l}.mlp.c_proj",
    key_learned_pos_emb="model.wpe",
    norm=NormType.LAYERNORM,
    norm_eps_key="layer_norm_epsilon",
    rope_style=RopeStyle.NONE,
    mlp_gated=False,
    mlp_act="gelu",
    learned_pos_emb=True,
    fused_qkv=True,
    key_fused_qkv="model.layers.{l}.self_attn.c_attn",
    attention_bias=True,
    attention_bias_o=True,
    mlp_bias=True,
    default_inner_dim_mult=4,
    orig_weights_transposed=True,
    tied_head_default=True,
))

# Cohere: layernorm, parallel decoder blocks sharing one input norm
# (norm_2=None — architecture.py:704-721), GPTJ rope, tied head.
_register(_llama(
    arch_string="CohereForCausalLM",
    norm=NormType.LAYERNORM,
    norm_eps_key="layer_norm_eps",
    rope_style=RopeStyle.GPTJ,
    key_norm_2=None,
    parallel_decoder_blocks=True,
    tied_head_default=True,
    requires_bos=True,
))

# Cohere2: cohere + alternating SWA (architecture.py:725-743).
_register(_llama(
    arch_string="Cohere2ForCausalLM",
    norm=NormType.LAYERNORM,
    norm_eps_key="layer_norm_eps",
    rope_style=RopeStyle.GPTJ,
    key_norm_2=None,
    parallel_decoder_blocks=True,
    tied_head_default=True,
    requires_bos=True,
    sliding_window_pattern=4,
    # HF Cohere2Attention applies rotary only on sliding-window layers;
    # full-attention layers are NoPE
    rope_swa_only=True,
))

# GLM4: GPTJ rope, fused gate_up, extra post norms, tied head
# (architecture.py:902-920; glm4 norm keys architecture.py:19-22).
_register(_llama(
    arch_string="Glm4ForCausalLM",
    rope_style=RopeStyle.GPTJ,
    key_norm_1="model.layers.{l}.input_layernorm",
    key_norm_1_post="model.layers.{l}.post_self_attn_layernorm",
    key_norm_2="model.layers.{l}.post_attention_layernorm",
    key_norm_2_post="model.layers.{l}.post_mlp_layernorm",
    fused_gate_up=True,
    key_fused_gate_up="model.layers.{l}.mlp.gate_up_proj",
    tied_head_default=True,
))

# Pixtral / LLaVA (pixtral vision tower; llama LM — architecture.py:309-347).
_register(_llama(
    arch_string="LlavaForConditionalGeneration",
    lm_prefix="language_model.",
    vt_prefix="vision_tower.",
    mmp_prefix="multi_modal_projector.",
    vision="pixtral",
))

# Mistral3 multimodal (pixtral tower + patch merger — architecture.py:351-393).
_register(_llama(
    arch_string="Mistral3ForConditionalGeneration",
    lm_prefix="language_model.",
    vt_prefix="vision_tower.",
    mmp_prefix="multi_modal_projector.",
    vision="pixtral",
))

# Qwen2-VL / Qwen2.5-VL: llama LM + qkv bias + MRoPE (architecture.py:470-534).
_register(_llama(
    arch_string="Qwen2VLForConditionalGeneration",
    attention_bias=True,
    mrope=True,
    vt_prefix="visual.",
    mmp_prefix="visual.merger.",
    vision="qwen2",
))
_register(_llama(
    arch_string="Qwen2_5_VLForConditionalGeneration",
    attention_bias=True,
    mrope=True,
    vt_prefix="visual.",
    mmp_prefix="visual.merger.",
    vision="qwen2.5",
))


def get_arch(arch_string: str, allow_fallback: bool = False) -> ArchParams:
    """Look up an architecture. Unknown archs raise UnknownArchitectureError
    unless allow_fallback (then: Llama layout + warning, the reference
    behavior, architecture.py:922-927)."""
    if arch_string in ARCHITECTURES:
        return ARCHITECTURES[arch_string]
    if allow_fallback:
        import warnings
        warnings.warn(
            f"unknown architecture {arch_string!r}; assuming Llama layout")
        return dataclasses.replace(
            ARCHITECTURES["LlamaForCausalLM"], arch_string=arch_string)
    raise UnknownArchitectureError(
        f"unknown architecture {arch_string!r}; known: "
        f"{sorted(ARCHITECTURES)}. Pass allow_fallback=True (config: "
        f"arch_fallback) to force the Llama layout.")
