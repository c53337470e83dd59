"""Model configuration: reads HF config.json and resolves hyperparameters.

Copy of exllamav2_tpu/config.py (imports rewritten): this package imports
nothing of the JAX package, whose __init__ imports JAX.

TPU-native analog of ExLlamaV2Config (reference exllamav2/config.py:210-626):
parses config.json / generation_config.json, resolves hidden sizes, GQA
groups, RoPE scaling variants (config.py:383-412), sliding window, soft-
capping, MoE params, and builds the tensor file map from safetensors headers.
Runtime limits (max_seq_len etc., config.py:60-75) live here too.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from exllamav2_tpu_torch.architecture import ArchParams, get_arch
from exllamav2_tpu_torch.stloader import TensorFileMap

__all__ = ["ModelConfig"]


def _get(d: dict, keys, default=None):
    for k in (keys if isinstance(keys, (list, tuple)) else [keys]):
        if k in d and d[k] is not None:
            return d[k]
    return default


@dataclasses.dataclass
class ModelConfig:
    model_dir: str | None = None
    arch: ArchParams | None = None

    # core dims
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int = 128
    vocab_size: int = 32000
    norm_eps: float = 1e-5
    tie_word_embeddings: bool = False

    # rope
    rotary_embedding_base: float = 10000.0
    rope_scaling: dict | None = None
    partial_rotary_factor: float = 1.0
    max_position_embeddings: int = 2048
    original_max_position_embeddings: int | None = None

    # quirks resolved from config
    sliding_window: int = 0
    sliding_window_pattern: int = 0
    attn_logit_softcapping: float = 0.0
    final_logit_softcapping: float = 0.0
    use_qk_norm: bool = False
    logit_scale: float = 1.0
    attention_multiplier: float | None = None  # granite-style explicit scale
    embedding_multiplier: float = 1.0
    scale_depth: float = 1.0                   # minicpm/granite residual mult
    arch_fallback: bool = False                # load unknown archs as Llama

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True

    # runtime limits (reference config.py:60-75)
    max_seq_len: int = 2048
    max_batch_size: int = 256
    max_input_len: int = 2048
    max_attention_size: int = 2048 ** 2
    max_output_len: int | None = None

    # token ids
    bos_token_id: int | None = None
    eos_token_id: Any = None
    pad_token_id: int | None = None

    # vision tower (reference config.py:494-622); None = text-only
    vision_model_type: str | None = None
    vision_num_layers: int = 0
    vision_hidden_size: int = 0
    vision_intermediate_size: int = 0
    vision_merger_intermediate_size: int = 0
    vision_num_attention_heads: int = 0
    vision_num_key_value_heads: int = 0
    vision_head_dim: int = 0
    vision_patch_size: dict = dataclasses.field(default_factory=dict)
    vision_hidden_act: str = "gelu"
    vision_rope_theta: float = 10000.0
    vision_feature_layer: int = -1
    vision_image_mean: tuple = (0.5, 0.5, 0.5)
    vision_image_std: tuple = (0.5, 0.5, 0.5)
    vision_resample: int = 3
    vision_rescale_factor: float = 1.0 / 255.0
    vision_size: dict = dataclasses.field(default_factory=dict)
    vision_num_channels: int = 3
    vision_spatial_merge_size: int = 1
    vision_spatial_patch_size: int = 14
    vision_temporal_patch_size: int = 2
    vision_min_pixels: int = 56 * 56
    vision_max_pixels: int = 14 * 14 * 4 * 1280
    vision_max_size: int = 16384
    vision_window_size: int | None = None
    vision_fullatt_block_indexes: list | None = None
    vision_mm_tokens_per_image: int = 0
    multimodal_projector_bias: bool = True
    mrope_section: list | None = None

    raw: dict = dataclasses.field(default_factory=dict)
    tensor_file_map: TensorFileMap | None = None
    quant_method: str | None = None           # None (fp16) | "exl2" | "gptq"
    gptq_bits: int = 4
    gptq_group_size: int = 128

    @classmethod
    def from_dir(cls, model_dir: str, prepare: bool = True) -> "ModelConfig":
        cfg = cls(model_dir=model_dir)
        if prepare:
            cfg.prepare()
        return cfg

    def prepare(self):
        assert self.model_dir is not None
        with open(os.path.join(self.model_dir, "config.json")) as f:
            c = json.load(f)
        self.load_dict(c)
        self.tensor_file_map = TensorFileMap(self.model_dir,
                                             keymap=self.arch.keymap)
        self.detect_quant()
        return self

    def load_dict(self, c: dict):
        self.raw = c
        archs = _get(c, "architectures", ["LlamaForCausalLM"])
        self.arch = get_arch(archs[0], allow_fallback=self.arch_fallback)
        # multimodal configs nest the LM params (reference config.py reads
        # with opt_subkey="text_config"); merge them over the top level
        if isinstance(c.get("text_config"), dict):
            c = {**c, **c["text_config"]}
        # DBRX nests attention/ffn params in sub-dicts (attn_config.
        # kv_n_heads, ffn_config.ffn_hidden_size/moe_num_experts...);
        # flatten them under the top level (top level wins)
        for sub in ("attn_config", "ffn_config"):
            if isinstance(c.get(sub), dict):
                c = {**c[sub], **c}

        self.hidden_size = int(_get(c, ["hidden_size", "n_embd", "d_model"], 4096))
        self.num_hidden_layers = int(_get(
            c, ["num_hidden_layers", "n_layer", "n_layers", "num_layers"],
            32))
        self.num_attention_heads = int(_get(
            c, ["num_attention_heads", "n_head", "n_heads"],
            self.arch.default_num_attention_heads or 32))
        self.num_key_value_heads = int(_get(
            c, ["num_key_value_heads", "num_kv_heads", "kv_n_heads"],
            self.arch.default_num_key_value_heads
            or self.num_attention_heads))
        if self.arch.mqa:                      # GPTBigCode (attn.py mqa)
            self.num_key_value_heads = 1
        self.head_dim = int(_get(
            c, "head_dim", self.arch.default_head_dim
            or self.hidden_size // self.num_attention_heads))
        self.intermediate_size = int(_get(
            c, ["intermediate_size", "n_inner", "ffn_dim",
                "ffn_hidden_size"],
            (self.arch.default_inner_dim_mult or 4) * self.hidden_size))
        self.vocab_size = int(_get(
            c, "vocab_size", self.arch.default_vocab_size or 32000))
        self.norm_eps = float(_get(
            c, [self.arch.norm_eps_key, "rms_norm_eps", "layer_norm_eps",
                "layer_norm_epsilon"], 1e-5))
        self.tie_word_embeddings = bool(_get(c, "tie_word_embeddings", False))

        self.rotary_embedding_base = float(_get(
            c, ["rope_theta", "rotary_emb_base"],
            self.arch.default_rope_theta))
        self.max_position_embeddings = int(_get(
            c, ["max_position_embeddings", "n_positions", "max_seq_len"],
            2048))
        self.original_max_position_embeddings = _get(
            c, "original_max_position_embeddings")
        self.partial_rotary_factor = float(_get(c, "partial_rotary_factor", 1.0))
        rs = _get(c, ["rope_scaling", "rope_parameters"])
        self.rope_scaling = rs if isinstance(rs, dict) else None

        sw = _get(c, "sliding_window", 0)
        self.sliding_window = int(sw) if sw else 0
        self.sliding_window_pattern = int(_get(
            c, "sliding_window_pattern", self.arch.sliding_window_pattern))
        self.attn_logit_softcapping = float(_get(
            c, "attn_logit_softcapping",
            self.arch.attn_logit_softcapping))
        self.final_logit_softcapping = float(_get(
            c, "final_logit_softcapping",
            self.arch.final_logit_softcapping))
        self.use_qk_norm = bool(_get(
            c, "use_qk_norm", self.arch.default_use_qk_norm))
        self.logit_scale = float(_get(c, "logit_scale", 1.0))
        if self.arch.logit_scale_basedim:
            # MiniCPM: scale logits by dim_model_base/hidden
            # (reference config.py:330-333)
            dim_model_base = float(_get(c, "dim_model_base",
                                        self.hidden_size))
            self.logit_scale /= self.hidden_size / dim_model_base
        logits_scaling = _get(c, "logits_scaling")
        if logits_scaling:                    # Granite is backwards
            self.logit_scale = 1.0 / float(logits_scaling)
        self.attention_multiplier = _get(c, "attention_multiplier")
        self.embedding_multiplier = float(_get(
            c, ["scale_emb", "embedding_multiplier"], 1.0))
        # MiniCPM scale_depth / Granite residual_multiplier
        # (reference config.py:340-346)
        residual_multiplier = _get(c, "residual_multiplier")
        scale_depth = _get(c, "scale_depth")
        if residual_multiplier:
            self.scale_depth = float(residual_multiplier)
        elif scale_depth:
            import math
            self.scale_depth = (float(scale_depth)
                                / math.sqrt(self.num_hidden_layers))

        self.num_experts = int(_get(
            c, ["num_local_experts", "num_experts", "n_routed_experts",
                "moe_num_experts"], 0))
        self.num_experts_per_tok = int(_get(
            c, ["num_experts_per_tok", "moe_top_k"], 0))
        self.moe_intermediate_size = int(_get(
            c, "moe_intermediate_size", self.intermediate_size))
        self.norm_topk_prob = bool(_get(c, "norm_topk_prob", True))

        self.bos_token_id = _get(c, "bos_token_id")
        self.eos_token_id = _get(c, "eos_token_id")
        self.pad_token_id = _get(c, "pad_token_id")

        self.max_seq_len = min(self.max_position_embeddings, 0x7FFFFFFF) \
            if self.max_position_embeddings else self.max_seq_len
        # rope-scaled models advertise the scaled length already
        self.max_input_len = min(self.max_input_len, self.max_seq_len)

        if self.rope_scaling and "mrope_section" in self.rope_scaling:
            self.mrope_section = list(self.rope_scaling["mrope_section"])
        self._load_vision_dict(self.raw)

    def _load_vision_dict(self, c: dict):
        """Vision-tower hyperparameters (reference config.py:494-622)."""
        vc = c.get("vision_config")
        if not isinstance(vc, dict):
            return
        self.vision_model_type = vc.get("model_type")
        if self.arch is not None and self.arch.vision and \
                self.vision_model_type is None:
            self.vision_model_type = self.arch.vision
        vt = self.vision_model_type
        if vt is None:
            return
        prep = {}
        if self.model_dir:
            p = os.path.join(self.model_dir, "preprocessor_config.json")
            if os.path.exists(p):
                with open(p) as f:
                    prep = json.load(f)

        self.vision_image_mean = tuple(_get(
            prep, "image_mean", (0.5, 0.5, 0.5)))
        self.vision_image_std = tuple(_get(
            prep, "image_std", (0.5, 0.5, 0.5)))
        self.vision_resample = int(_get(prep, "resample", 3))
        self.vision_rescale_factor = float(_get(
            prep, "rescale_factor", 1.0 / 255.0))
        self.vision_size = _get(prep, "size", {}) or {}

        if vt in ("siglip_vision_model", "siglip"):
            self.vision_model_type = "siglip_vision_model"
            self.vision_num_attention_heads = int(_get(
                vc, "num_attention_heads", 16))
            self.vision_num_key_value_heads = int(_get(
                vc, "num_key_value_heads", self.vision_num_attention_heads))
            self.vision_hidden_size = int(_get(vc, "hidden_size", 1152))
            self.vision_head_dim = int(_get(
                vc, "head_dim",
                self.vision_hidden_size // self.vision_num_attention_heads))
            ps = int(_get(vc, "patch_size", 14))
            self.vision_patch_size = {"width": ps, "height": ps}
            self.vision_hidden_act = _get(vc, "hidden_act", "gelu")
            self.vision_num_layers = int(_get(vc, "num_hidden_layers", 24))
            self.vision_intermediate_size = int(_get(
                vc, "intermediate_size", self.hidden_size))
            self.vision_mm_tokens_per_image = int(_get(
                c, "mm_tokens_per_image", 256))
            self.multimodal_projector_bias = bool(_get(
                c, "multimodal_projector_bias", False))
            if not self.vision_size:
                sz = int(_get(vc, "image_size", 896))
                self.vision_size = {"width": sz, "height": sz}
        elif vt == "pixtral":
            self.vision_head_dim = int(_get(vc, "head_dim", 64))
            self.vision_num_attention_heads = int(_get(vc, "num_attention_heads", 16))
            self.vision_num_key_value_heads = int(_get(
                vc, "num_key_value_heads", self.vision_num_attention_heads))
            self.vision_hidden_act = _get(vc, "hidden_act", "silu")
            self.vision_hidden_size = int(_get(vc, "hidden_size", 1024))
            ps = _get(vc, "patch_size", 16)
            self.vision_patch_size = ps if isinstance(ps, dict) else \
                {"width": int(ps), "height": int(ps)}
            self.vision_rope_theta = float(_get(vc, "rope_theta", 10000.0))
            self.vision_feature_layer = int(_get(c, "vision_feature_layer", -1))
            self.vision_num_layers = int(_get(vc, "num_hidden_layers", 24))
            self.vision_intermediate_size = int(_get(
                vc, "intermediate_size", self.hidden_size))
            self.vision_merger_intermediate_size = self.vision_intermediate_size
            self.vision_spatial_merge_size = int(_get(
                c, "spatial_merge_size", 1))
            self.multimodal_projector_bias = bool(_get(
                c, "multimodal_projector_bias", True))
            if not self.vision_size:
                self.vision_size = {"longest_edge": 1024}
        elif vt in ("qwen2", "qwen2.5"):
            if vt == "qwen2":
                self.vision_hidden_size = int(_get(vc, "embed_dim", 1280))
                self.vision_intermediate_size = \
                    self.vision_hidden_size * int(_get(vc, "mlp_ratio", 4))
                self.vision_merger_intermediate_size = \
                    self.vision_intermediate_size
            else:
                self.vision_hidden_size = int(_get(vc, "hidden_size", 1280))
                self.vision_intermediate_size = int(_get(
                    vc, "intermediate_size", 3420))
                self.vision_fullatt_block_indexes = _get(
                    vc, "fullatt_block_indexes")
                self.vision_window_size = _get(vc, "window_size")
                self.vision_merger_intermediate_size = int(_get(
                    vc, "out_hidden_size", 5120))
            self.vision_num_attention_heads = int(_get(vc, "num_heads", 16))
            self.vision_num_key_value_heads = self.vision_num_attention_heads
            self.vision_head_dim = (self.vision_hidden_size
                                    // self.vision_num_attention_heads)
            self.vision_hidden_act = "quickgelu" if vt == "qwen2" else "silu"
            self.vision_spatial_merge_size = int(_get(
                vc, "spatial_merge_size", 2))
            self.vision_spatial_patch_size = int(_get(
                vc, "spatial_patch_size", 14))
            ps = int(_get(vc, "patch_size", 14))
            self.vision_patch_size = {"width": ps, "height": ps}
            self.vision_rope_theta = float(_get(vc, "rope_theta", 10000.0))
            self.vision_num_layers = int(_get(vc, "depth", 32))
            self.vision_temporal_patch_size = int(_get(
                prep, "temporal_patch_size",
                _get(vc, "temporal_patch_size", 2)))
            self.vision_min_pixels = int(_get(prep, "min_pixels", 56 * 56))
            self.vision_max_pixels = int(_get(
                prep, "max_pixels", 14 * 14 * 4 * 1280))

    def detect_quant(self):
        """Detect quantization from tensor names / quantization_config.

        EXL2 = '.q_weight' tensors; GPTQ = '.qweight' (module.py:101-151)."""
        qc = self.raw.get("quantization_config")
        tfm = self.tensor_file_map
        # converted fused-arch checkpoints store unfused tensor sets, so
        # probe both the unfused and the fused key
        probes = [self.arch.key_attn_q.format(l=0).split("|")[0]]
        if self.arch.fused_qkv and self.arch.key_fused_qkv:
            probes.append(self.arch.key_fused_qkv.format(l=0))
        probes = [self.arch.lm_prefix + p for p in probes]
        if tfm is not None and any(p + ".q_weight" in tfm for p in probes):
            self.quant_method = "exl2"
        elif tfm is not None and any(p + ".qweight" in tfm
                                     for p in probes):
            self.quant_method = "gptq"
            if qc:
                self.gptq_bits = int(qc.get("bits", 4))
                self.gptq_group_size = int(qc.get("group_size", 128))
        elif qc and qc.get("quant_method") == "gptq":
            self.quant_method = "gptq"
            self.gptq_bits = int(qc.get("bits", 4))
            self.gptq_group_size = int(qc.get("group_size", 128))
        else:
            self.quant_method = None

    @property
    def num_q_per_kv(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)
