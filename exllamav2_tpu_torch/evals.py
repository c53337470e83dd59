"""Evaluation helpers: perplexity over token rows (PyTorch port of
exllamav2_tpu/evals.py).

Scores rows through the paged cache in the requested kind (bf16, fp8, q4,
q6, q8), so the quantized caches' quality deltas are measurable, and a
conversion is judged by the perplexity of its output.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["perplexity"]


def perplexity(model, token_rows: np.ndarray, cache_kind: str = "bf16",
               batch: int = 1, progress=None) -> float:
    """exp of the mean next-token NLL over rows [R, T] (test_inference.py
    ppl mode), `batch` rows a forward over a PagedKVCache of `cache_kind`
    on the model's device. A short last chunk is padded by repeating its
    last row; the pad rows are masked out of the sum."""
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.models.forward import model_forward_paged

    rows, t = token_rows.shape
    st = model.static
    dev = model.device
    pages_per = -(-t // 256)
    cache = PagedKVCache.alloc(st.num_layers, pages_per * batch + 1,
                               st.num_kv_heads, st.head_dim, cache_kind,
                               device=dev)
    bt = torch.arange(1, pages_per * batch + 1, dtype=torch.int32,
                      device=dev).reshape(batch, pages_per)
    zeros = torch.zeros((batch,), dtype=torch.int32, device=dev)
    total_nll = 0.0
    total_tok = 0
    for r0 in range(0, rows, batch):
        chunk = token_rows[r0:r0 + batch]
        real = chunk.shape[0]
        if real < batch:
            pad = np.repeat(chunk[-1:], batch - real, axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        mask = torch.zeros((batch,), dtype=torch.float32, device=dev)
        mask[:real] = 1.0
        ids = torch.from_numpy(np.asarray(chunk, np.int32)).to(dev)
        with torch.no_grad():
            logits, cache = model_forward_paged(model.weights, st, ids,
                                                cache, bt, zeros)
        lsm = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
        tgt = ids[:, 1:].long()
        nll = -torch.gather(lsm, -1, tgt[..., None])[..., 0]
        total_nll += float(torch.sum(nll * mask[:, None]))
        total_tok += real * (t - 1)
        if progress:
            progress(r0 + real, rows)
    return math.exp(total_nll / total_tok)
