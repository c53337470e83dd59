"""High-level model container (PyTorch port of exllamav2_tpu/models/model.py).

A model is its weight modules, its StaticModel and its config; forward runs
eagerly, updating the KV cache in place.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from exllamav2_tpu_torch.cache import KVCache
from exllamav2_tpu_torch.config import ModelConfig
from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.models.forward import model_forward
from exllamav2_tpu_torch.models.loader import load_model
from exllamav2_tpu_torch.models.modules import ModelWeights, StaticModel

__all__ = ["Model"]


def _limit_bucket(n: int, cap: int, step: int = 256) -> int:
    """Bucket the attention span up to a multiple of `step` (bounds cache
    reads to the live sequence)."""
    return min(-(-n // step) * step, cap)


class Model:
    """Loaded model: weights on one device + forward/generation."""

    def __init__(self, weights: ModelWeights, static: StaticModel,
                 config: ModelConfig | None = None):
        self.weights = weights
        self.static = static
        self.config = config

    @property
    def device(self) -> torch.device:
        return self.weights.embed.device

    @classmethod
    def from_dir(cls, model_dir: str, prescale: bool | None = None, *,
                 device=None, **cfg_overrides) -> "Model":
        """Load a checkpoint directory onto `device` (the card by default).

        EXL2 group scales are decoded once at load into bf16 rows the fused
        kernel reads (ops/dequant.precompute_scales_linear); prescale=False
        or EXL2_TPU_PRESCALE=0 keeps the in-kernel decode."""
        device = resolve_device(device)
        cfg = ModelConfig.from_dir(model_dir)
        for k, v in cfg_overrides.items():
            setattr(cfg, k, v)
        w, st = load_model(cfg, device=device)
        if prescale is None:
            prescale = os.environ.get("EXL2_TPU_PRESCALE", "1") == "1"
        if prescale:
            from exllamav2_tpu_torch.ops.dequant import precompute_model_scales
            w = precompute_model_scales(w)
        m = cls(w, st, cfg)
        m._prescale = prescale      # the generator's prescale default
        return m

    def new_cache(self, batch: int = 1, max_seq: int | None = None,
                  dtype=torch.bfloat16) -> KVCache:
        st = self.static
        max_seq = max_seq or (self.config.max_seq_len if self.config else 2048)
        return KVCache.alloc(st.num_layers, batch, max_seq,
                             st.num_kv_heads, st.head_dim, dtype,
                             device=self.device)

    def forward(self, ids, cache: KVCache, past_len: int,
                last_token_only: bool = False):
        """ids [B, T] -> (logits f32, cache).

        Inputs longer than max_input_len are processed in chunks bounded
        additionally by max_attention_size."""
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.asarray(ids, np.int32))
        ids = ids.to(self.device)
        max_in = self.config.max_input_len if self.config else 2048
        max_attn = self.config.max_attention_size if self.config \
            else 2048 ** 2
        t = ids.shape[1]
        if t > max_in or (past_len + t) * t > max_attn:
            chunks = []
            pos = 0
            while pos < t:
                remaining = t - pos
                size = min(max_in, remaining)
                # shrink so q_len * kv_len stays under max_attention_size
                while size > 1 and (past_len + pos + size) * size > max_attn:
                    size = max(size // 2, 1)
                last = pos + size >= t
                lg, cache = self._forward_one(
                    ids[:, pos:pos + size], cache, past_len + pos,
                    last_token_only)
                if last or not last_token_only:
                    chunks.append(lg)
                pos += size
            logits = chunks[-1] if last_token_only \
                else torch.cat(chunks, dim=1)
            return logits, cache
        return self._forward_one(ids, cache, past_len, last_token_only)

    def _forward_one(self, ids, cache: KVCache, past_len: int,
                     last_token_only: bool):
        limit = _limit_bucket(int(past_len) + ids.shape[1], cache.max_seq)
        with torch.inference_mode():
            return model_forward(self.weights, self.static, ids, cache,
                                 int(past_len), last_token_only=last_token_only,
                                 attn_limit=limit)

    def generate_greedy(self, prompt_ids: np.ndarray, max_new_tokens: int,
                        max_seq: int | None = None,
                        stop_token: int | None = None) -> np.ndarray:
        """Greedy loop: prompt_ids [B, T0] -> [B, T0 + max_new] (numpy)."""
        prompt_ids = np.atleast_2d(np.asarray(prompt_ids, np.int32))
        b, t0 = prompt_ids.shape
        total = t0 + max_new_tokens
        cache = self.new_cache(batch=b, max_seq=max_seq or total)
        logits, cache = self.forward(prompt_ids, cache, 0,
                                     last_token_only=True)
        out = [prompt_ids]
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        pos = t0
        for _ in range(max_new_tokens - 1):
            tok_np = tok.cpu().numpy()
            out.append(tok_np[:, None])
            if stop_token is not None and bool((tok_np == stop_token).all()):
                return np.concatenate(out, axis=1)
            logits, cache = self.forward(tok[:, None], cache, pos)
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            pos += 1
        out.append(tok.cpu().numpy()[:, None])
        return np.concatenate(out, axis=1)
