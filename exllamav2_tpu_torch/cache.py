"""Linear KV cache (PyTorch port of exllamav2_tpu/cache.py).

K and V are preallocated tensors [L, B, Hkv, max_seq, D]; ``update`` writes
new rows into them **in place** (the reference returns a new pytree instead).
Heads come ahead of sequence so the decode-attention kernel's per-head rows
are contiguous.
"""

from __future__ import annotations

import torch

__all__ = ["KVCache"]


class KVCache:
    """Linear per-layer K/V tensors, [L, B, Hkv, max_seq, D]."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    @classmethod
    def alloc(cls, num_layers: int, batch: int, max_seq: int,
              kv_heads: int, head_dim: int, dtype=torch.bfloat16, *,
              device) -> "KVCache":
        shape = (num_layers, batch, kv_heads, max_seq, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    def update(self, layer: int, new_k: torch.Tensor, new_v: torch.Tensor,
               past_len: int) -> "KVCache":
        """Write new_k/new_v [B, T, Hkv, D] at position past_len of layer,
        in place, and return this cache. Raises when the rows would run past
        max_seq (the reference's dynamic_update_slice would clamp the start
        and overwrite earlier rows instead)."""
        t = new_k.shape[1]
        if past_len < 0 or past_len + t > self.max_seq:
            raise ValueError(f"cache write [{past_len}, {past_len + t}) "
                             f"outside max_seq {self.max_seq}")
        self.k[layer, :, :, past_len:past_len + t] = \
            new_k.transpose(1, 2).to(self.k.dtype)
        self.v[layer, :, :, past_len:past_len + t] = \
            new_v.transpose(1, 2).to(self.v.dtype)
        return self

    def layer(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """-> K/V [B, Hkv, S, D] views of one layer."""
        return self.k[layer], self.v[layer]
