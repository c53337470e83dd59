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

__all__ = ["NormWeights", "AttnWeights", "MLPWeights", "LayerWeights",
           "ModelWeights", "StaticModel", "LayerStatic"]


class NormWeights(nn.Module):
    """RMS / LayerNorm weights: ``weight`` [d] f32, ``bias`` [d] f32 or None."""

    def __init__(self, weight, bias=None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)


class AttnWeights(nn.Module):
    """One attention block. q/k/v/o are QuantLinear or DenseLinear;
    q_norm/k_norm are per-head-dim norms, norm_post the post-attention norm
    (architectures not served by this package yet leave them None)."""

    def __init__(self, norm, q, k, v, o, q_norm=None, k_norm=None,
                 norm_post=None):
        super().__init__()
        self.norm = norm
        self.q, self.k, self.v, self.o = q, k, v, o
        self.q_norm, self.k_norm, self.norm_post = q_norm, k_norm, norm_post


class MLPWeights(nn.Module):
    """Gated or ungated MLP; gate is None when ungated."""

    def __init__(self, norm, gate, up, down, norm_post=None):
        super().__init__()
        self.norm = norm
        self.gate, self.up, self.down = gate, up, down
        self.norm_post = norm_post


class LayerWeights(nn.Module):
    def __init__(self, attn: AttnWeights, mlp: MLPWeights):
        super().__init__()
        self.attn = attn
        self.mlp = mlp


class ModelWeights(nn.Module):
    """embed [vocab, d] bf16, layers, final norm, head linear and the rope
    tables sin/cos [max_seq, rot/2] f32."""

    def __init__(self, embed, layers, final_norm, head, sin, cos):
        super().__init__()
        self.register_buffer("embed", embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.head = head
        self.register_buffer("sin", sin)
        self.register_buffer("cos", cos)


@dataclasses.dataclass(frozen=True)
class LayerStatic:
    """Per-layer static info."""
    sliding_window: int = 0           # 0 = full attention


@dataclasses.dataclass(frozen=True)
class StaticModel:
    """Static model description: the reference's fields that this package's
    forward reads (architecture features it has not ported are rejected by
    build_static and interop.weights_from_reference)."""
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
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    normalize_embeddings: bool = False
    embedding_multiplier: float = 1.0
    attn_scale: float | None = None   # None -> 1/sqrt(head_dim)
    logit_scale: float = 1.0
    residual_fp32: bool = False
    scale_depth: float = 1.0          # minicpm/granite residual multiplier
    # False forces the dequant + matmul path everywhere
    fused_matmul: bool = True
    layers: tuple = ()                # tuple[LayerStatic, ...]

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads
