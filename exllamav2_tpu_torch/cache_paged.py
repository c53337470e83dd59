"""Paged KV cache with optional quantization.

Counterpart of exllamav2_tpu/cache_paged.py. K/V live in a flat pool of
pages indexed through per-sequence block tables; the kinds are bf16, fp8, q4,
q8 and q6 (q8 keys + q4 values). Quantization (ops/kvquant.py) happens on
append for exactly the touched rows.

Layout is head-major -- data [L, Hkv, P * page_size, D'] with scales
[L, Hkv, P * page_size, D / g] bf16 -- so one (layer, head, page) is a
contiguous [page_size, D'] block that the paged-attention kernel
(csrc/paged_attn.cu) reads directly.

``append`` and ``copy_pages`` update the pool IN PLACE: one indexed write of
the touched rows, for decode and prefill alike. The reference keeps two code
paths (per-row and per-page update slices) only to stop XLA from copying the
whole pool on a scatter; eager PyTorch writes the rows where they are.
"""

from __future__ import annotations

import torch

from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.ops import kvquant as KQ

__all__ = ["PagedKVCache", "PAGE_SIZE"]

PAGE_SIZE = 256


def _kinds(kind: str) -> tuple[str, str]:
    """cache kind -> (k kind, v kind); Q6 = 8-bit K + 4-bit V."""
    if kind == "q6":
        return "q8", "q4"
    if kind not in KQ.CACHE_KINDS:
        raise ValueError(f"cache kind {kind!r}")
    return kind, kind


def _raw(t: torch.Tensor) -> torch.Tensor:
    """fp8 data as its uint8 bits (indexed reads and writes of fp8 are not
    available on every device); other types as they are."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e5m2 else t


class PagedKVCache:
    """Flat page pool: data [L, Hkv, P * page_size, D'] (+ scales)."""

    def __init__(self, k_data, k_scales, v_data, v_scales, kind: str,
                 page_size: int, head_dim: int):
        self.k_data, self.k_scales = k_data, k_scales
        self.v_data, self.v_scales = v_data, v_scales
        self.kind = kind
        self.page_size = page_size
        self.head_dim = head_dim

    @classmethod
    def alloc(cls, num_layers: int, num_pages: int, kv_heads: int,
              head_dim: int, kind: str = "bf16", page_size: int = PAGE_SIZE,
              *, device=None) -> "PagedKVCache":
        """A zeroed pool on `device` (the card by default)."""
        device = resolve_device(device)
        rows = num_pages * page_size

        def mk(k):
            data = torch.zeros((num_layers, kv_heads, rows,
                                *KQ.data_shape(k, head_dim)),
                               dtype=KQ.data_dtype(k), device=device)
            scales = None
            if k in ("q4", "q8"):
                scales = torch.zeros(
                    (num_layers, kv_heads, rows, KQ.num_groups(head_dim)),
                    dtype=torch.bfloat16, device=device)
            return data, scales

        kk, vk = _kinds(kind)
        kd, ks = mk(kk)
        vd, vs = mk(vk)
        return cls(kd, ks, vd, vs, kind, page_size, head_dim)

    @property
    def num_pages(self) -> int:
        return self.k_data.shape[2] // self.page_size

    @property
    def num_layers(self) -> int:
        return self.k_data.shape[0]

    @property
    def kv_heads(self) -> int:
        return self.k_data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.k_data.device

    def append(self, layer: int, block_table: torch.Tensor,
               cache_seqlens: torch.Tensor, new_k: torch.Tensor,
               new_v: torch.Tensor) -> "PagedKVCache":
        """Write new_k/new_v [B, T, H, D] at positions cache_seqlens[b] + t
        of each sequence (through its block table [B, max_pages]), in place.

        Positions whose page index lies past the table's width go to the
        null page 0, like every padded table column. Pad rows of a bucketed
        batch all write page 0 too; which of their values lands there is
        unspecified, and nothing live reads it."""
        b, t = new_k.shape[:2]
        ps = self.page_size
        pos = cache_seqlens.long()[:, None] + torch.arange(
            t, device=new_k.device)[None]                     # [B, T]
        lp = pos // ps
        width = block_table.shape[1]
        page = torch.gather(block_table.long(), 1, lp.clamp(max=width - 1))
        page = torch.where(lp < width, page, torch.zeros_like(page))
        rows = (page * ps + pos % ps).reshape(-1)             # [B * T]
        kk, vk = _kinds(self.kind)
        for x, kind, data, scales in ((new_k, kk, self.k_data, self.k_scales),
                                      (new_v, vk, self.v_data, self.v_scales)):
            qd, qs = KQ.kv_quant(x, kind)                     # [B, T, H, *]
            _raw(data)[layer, :, rows] = _raw(
                qd.reshape(b * t, *qd.shape[2:]).transpose(0, 1))
            if scales is not None:
                scales[layer, :, rows] = qs.reshape(b * t, *qs.shape[2:]) \
                    .transpose(0, 1)
        return self

    def gather_layer(self, layer: int, block_table: torch.Tensor,
                     dtype=torch.bfloat16):
        """Dequantized K/V [B, H, max_pages * page_size, D] for attention
        (the t > 1 path; the t = 1 kernel streams pages instead)."""
        ps = self.page_size
        rows = (block_table.long()[..., None] * ps + torch.arange(
            ps, device=block_table.device)).reshape(block_table.shape[0], -1)
        kk, vk = _kinds(self.kind)

        def gather(data, scales, kind):
            d = _raw(data)[layer][:, rows].transpose(0, 1).view(
                data.dtype)                                   # [B, H, S, D']
            s = None
            if scales is not None:
                s = scales[layer][:, rows].transpose(0, 1)
            return KQ.kv_dequant(d, s, kind, dtype)

        return (gather(self.k_data, self.k_scales, kk),
                gather(self.v_data, self.v_scales, vk))

    def copy_pages(self, src, dst) -> "PagedKVCache":
        """Copy whole pages src[i] -> dst[i] of every layer, in place (prompt
        dedup and defrag)."""
        ps = self.page_size
        for s, d in zip(torch.as_tensor(src).tolist(),
                        torch.as_tensor(dst).tolist()):
            for a in (self.k_data, self.k_scales, self.v_data,
                      self.v_scales):
                if a is not None:
                    a[:, :, d * ps:(d + 1) * ps] = a[:, :, s * ps:(s + 1) * ps]
        return self
