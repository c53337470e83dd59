"""Weight containers for decoder models (PyTorch port of
exllamav2_tpu/models/modules.py).

The containers are ``nn.Module``s holding buffers (``.to(device)`` and
``state_dict()`` work); the math stays in plain functions on tensors
(models/forward.py). ``StaticModel`` / ``LayerStatic`` are the same frozen
dataclasses as in the reference: everything shape- or branch-determining.
"""

from __future__ import annotations

import dataclasses

from torch import nn

__all__ = ["NormWeights", "AttnWeights", "MLPWeights", "MoEWeights",
           "EPMoEWeights", "LayerWeights", "ModelWeights", "StaticModel",
           "LayerStatic"]


class NormWeights(nn.Module):
    """RMS / LayerNorm weights: ``weight`` [d] f32, ``bias`` [d] f32 or None."""

    def __init__(self, weight, bias=None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)


class AttnWeights(nn.Module):
    """One attention block. q/k/v/o are QuantLinear or DenseLinear;
    q_norm/k_norm are per-head-dim norms (Qwen3, Gemma3), norm_post the
    post-attention norm applied to the block output before the residual add
    (Gemma2/3, GLM4). qkv is the optional merged q|k|v linear
    (ops/dequant.merge_serving_weights), which the forward prefers when it
    is there."""

    def __init__(self, norm, q, k, v, o, q_norm=None, k_norm=None,
                 norm_post=None, qkv=None):
        super().__init__()
        self.norm = norm
        self.q, self.k, self.v, self.o = q, k, v, o
        self.q_norm, self.k_norm, self.norm_post = q_norm, k_norm, norm_post
        self.qkv = qkv


class MLPWeights(nn.Module):
    """Gated or ungated MLP; gate is None when ungated; norm_post is the
    post-feedforward norm (Gemma2/3, GLM4). gate_up is the optional merged
    gate|up linear (ops/dequant.merge_serving_weights)."""

    def __init__(self, norm, gate, up, down, norm_post=None, gate_up=None):
        super().__init__()
        self.norm = norm
        self.gate, self.up, self.down = gate, up, down
        self.norm_post = norm_post
        self.gate_up = gate_up


class MoEWeights(nn.Module):
    """Block-sparse MoE: a dense router [d, n_experts] and one gate (w1),
    down (w2) and up (w3) linear per expert, each list an nn.ModuleList."""

    def __init__(self, norm, router, w1, w2, w3, norm_post=None):
        super().__init__()
        self.norm = norm
        self.router = router
        self.w1 = nn.ModuleList(w1)
        self.w2 = nn.ModuleList(w2)
        self.w3 = nn.ModuleList(w3)
        self.norm_post = norm_post


class EPMoEWeights(nn.Module):
    """Expert-parallel MoE: this rank's whole experts, `first` ..
    first + len(w1) - 1 of the model's `num_experts` (E / tp each, in rank
    order), as nn.ModuleLists; the router is dense and replicated. The
    forward (models/forward.moe_ep_forward) runs the local experts on the
    replicated hidden state and sums the ranks' outputs with one
    all_reduce. With first = 0 and every expert it is the whole layer on
    one process."""

    def __init__(self, norm, router, w1, w2, w3, norm_post=None,
                 first: int = 0, num_experts: int | None = None):
        super().__init__()
        self.norm = norm
        self.router = router
        self.w1 = nn.ModuleList(w1)
        self.w2 = nn.ModuleList(w2)
        self.w3 = nn.ModuleList(w3)
        self.norm_post = norm_post
        self.first = int(first)
        self.num_experts = len(w1) if num_experts is None \
            else int(num_experts)


class LayerWeights(nn.Module):
    def __init__(self, attn: AttnWeights, mlp):
        super().__init__()
        self.attn = attn
        self.mlp = mlp


class ModelWeights(nn.Module):
    """embed [vocab, d] bf16, layers (each mlp an MLPWeights or a
    MoEWeights), final norm, head linear and the rope tables sin/cos
    [max_seq, rot/2] f32; pos_emb [max_pos, d] bf16 the learned positions
    (GPT2) and sin_alt/cos_alt the rope tables of the sliding-window layers
    (Gemma3), or None."""

    def __init__(self, embed, layers, final_norm, head, sin, cos,
                 pos_emb=None, sin_alt=None, cos_alt=None):
        super().__init__()
        self.register_buffer("embed", embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.head = head
        self.register_buffer("sin", sin)
        self.register_buffer("cos", cos)
        self.register_buffer("pos_emb", pos_emb)
        self.register_buffer("sin_alt", sin_alt)
        self.register_buffer("cos_alt", cos_alt)


@dataclasses.dataclass(frozen=True)
class LayerStatic:
    """Per-layer static info."""
    sliding_window: int = 0           # 0 = full attention
    alt_rope: bool = False            # gemma3: SWA layers use sin/cos_alt
    rope_enabled: bool = True         # cohere2: NoPE on full-attn layers


@dataclasses.dataclass(frozen=True)
class StaticModel:
    """Static model description: the reference's fields that this package's
    forward reads.

    tp_axis is the tensor-parallel mesh (parallel/sharding.Mesh) of a
    rank's shard, or None: head counts are then the rank's own where
    attention is split (parallel/sharding.local_static), and the forward
    gathers the outputs of every split linear over the mesh's TP group."""
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    hidden_size: int
    vocab_size: int
    norm_eps: float
    norm_type: str = "rms"            # "rms" | "layernorm"
    norm_constant_bias: float = 0.0
    rope_style: str = "neox"          # "neox" | "gptj" | "none"
    mlp_act: str = "silu"
    mlp_gated: bool = True
    use_qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    normalize_embeddings: bool = False
    embedding_multiplier: float = 1.0
    attn_scale: float | None = None   # None -> 1/sqrt(head_dim)
    logit_scale: float = 1.0
    residual_fp32: bool = False
    parallel_blocks: bool = False
    scale_depth: float = 1.0          # minicpm/granite residual multiplier
    learned_pos_emb: bool = False     # gpt2: add pos_emb rows after embed
    # False forces the dequant + matmul path everywhere
    fused_matmul: bool = True
    tp_axis: object = None            # parallel/sharding.Mesh, or None
    layers: tuple = ()                # tuple[LayerStatic, ...]
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    norm_topk_prob: bool = True

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads
