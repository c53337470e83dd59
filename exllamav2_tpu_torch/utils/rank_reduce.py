"""Rank reduction of linear weights by truncated SVD (PyTorch port of
exllamav2_tpu/utils/rank_reduce.py): keep the top-k singular directions of
a [K, N] weight, where k = ceil(rank_fraction * min(K, N)).

Used experimentally to test how much of a layer's behavior survives a
low-rank approximation. The SVD runs in f64 on the weight's device: torch's
f32 SVD leaves ~1e-5 of max |w| of error at a quarter of the rank on a
random 96x160 weight, 50x numpy's f32 SVD, which the reference uses.
"""

from __future__ import annotations

import math

import torch

from exllamav2_tpu_torch.models.modules import ModelWeights
from exllamav2_tpu_torch.ops.dequant import replace_linears
from exllamav2_tpu_torch.quant.qtensor import DenseLinear

__all__ = ["rank_reduce_weight", "rank_reduce_linear", "rank_reduce_model"]


def rank_reduce_weight(w, fraction: float) -> torch.Tensor:
    """[K, N] (a tensor or an array) -> f32 of the same shape on the same
    device, the top ceil(fraction * min(K, N)) singular directions kept."""
    assert 0.0 < fraction <= 1.0
    wd = torch.as_tensor(w).double()
    k = math.ceil(fraction * min(wd.shape))
    u, s, vh = torch.linalg.svd(wd, full_matrices=False)
    return ((u[:, :k] * s[:k]) @ vh[:k]).float()


def rank_reduce_linear(lin, fraction: float) -> DenseLinear:
    """DenseLinear -> rank-reduced DenseLinear, bf16 on the same device
    (quantized linears must be dequantized first; see ops.dequant)."""
    if not isinstance(lin, DenseLinear):
        raise TypeError("rank_reduce_linear expects DenseLinear; "
                        "dequantize QuantLinear weights first")
    w = rank_reduce_weight(lin.weight, fraction)
    return DenseLinear(w.to(torch.bfloat16), lin.bias)


def rank_reduce_model(weights: ModelWeights, fraction: float,
                      which=("mlp",)) -> ModelWeights:
    """Copy of `weights` with the dense MLP and/or attention projections
    rank-reduced (`which` holds "mlp" and/or "attn"); quantized linears
    are left untouched."""

    def maybe(lin):
        if isinstance(lin, DenseLinear):
            return rank_reduce_linear(lin, fraction)
        return lin

    return replace_linears(weights, maybe,
                           tuple(p for p in which if p in ("attn", "mlp")))
