"""Random weights of real geometry, synthesized on the device (PyTorch port
of exllamav2_tpu/utils/testing.py).

Uniform random packed words ARE uniform random quantized values, so drawing
the plane words directly is distribution-equivalent to packing random ints,
and costs nothing but the draw. Every draw comes from the explicit
``torch.Generator`` passed in (seeded once by random_model_weights).
"""

from __future__ import annotations

import torch

from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.models.modules import (
    AttnWeights, LayerWeights, MLPWeights, ModelWeights, NormWeights,
    StaticModel, LayerStatic)
from exllamav2_tpu_torch.quant.qtensor import (
    QuantLinear, QuantSegment, GptqSegment, SUB_BLOCK, plane_split)
from exllamav2_tpu_torch.ops.rope import build_sincos

__all__ = ["random_quant_linear", "random_gptq_linear",
           "random_model_weights"]


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
                         seed=0, device=None
                         ) -> tuple[ModelWeights, StaticModel]:
    """In-memory random EXL2 model (ModelWeights, StaticModel) of real
    geometry, built on `device` (the card by default). The defaults are
    Llama-2-7B's geometry."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    head_dim = hidden // heads

    def lin(k, n):
        return random_quant_linear(gen, k, n, bits=bits, device=device)

    def norm():
        return NormWeights(weight=torch.ones((hidden,), dtype=torch.float32,
                                             device=device))

    lws = []
    for _ in range(layers):
        attn = AttnWeights(norm=norm(),
                           q=lin(hidden, heads * head_dim),
                           k=lin(hidden, kv_heads * head_dim),
                           v=lin(hidden, kv_heads * head_dim),
                           o=lin(heads * head_dim, hidden))
        mlp = MLPWeights(norm=norm(), gate=lin(hidden, inter),
                         up=lin(hidden, inter), down=lin(inter, hidden))
        lws.append(LayerWeights(attn=attn, mlp=mlp))

    from types import SimpleNamespace
    rope_cfg = SimpleNamespace(
        rotary_dim=head_dim, rotary_embedding_base=10000.0, rope_scaling=None,
        max_seq_len=max_seq, max_position_embeddings=max_seq,
        original_max_position_embeddings=None, head_dim=head_dim)
    sin, cos = build_sincos(rope_cfg, device=device)
    embed = (torch.randn((vocab, hidden), generator=gen, device=device)
             * 0.02).to(torch.bfloat16)
    w = ModelWeights(embed=embed, layers=lws, final_norm=norm(),
                     head=lin(hidden, vocab), sin=sin, cos=cos)
    st = StaticModel(
        num_layers=layers, num_heads=heads, num_kv_heads=kv_heads,
        head_dim=head_dim, hidden_size=hidden, vocab_size=vocab,
        norm_eps=1e-5, layers=tuple(LayerStatic() for _ in range(layers)))
    return w, st
