"""High-level model container (PyTorch port of exllamav2_tpu/models/model.py).

A model is its weight modules, its StaticModel and its config; forward
updates the KV cache in place. On the card every forward replays a CUDA graph
(utils/graphs.py), the counterparts of the reference's jitted steps: a
one-token step one of ``_decode_step``, keyed by (batch, attention-limit
bucket, the cache's K/V storage, QMM_PARTIALS), at most MAX_GRAPHS of them;
a longer input (a prompt, each chunk of a long one) one of ``_prefill_step``,
keyed as the reference compiles it by the shape of ``ids`` as well: the same
key plus T and last_token_only, at most MAX_PREFILL_GRAPHS of them in a
runner of their own that shares the decode graphs' memory pool. A decode
key is captured on its first call, a prefill key on its second (the first
runs eagerly): a key holds its cache, which the reference's compiled step
does not, so a caller that makes a new cache for each forward (an eval, a
KL estimate) would otherwise pay a capture for every prompt. Both take
their position from device memory, so the chunks of a long prompt share a
key. A graph reads the weights and the
cache it was captured with, so setting ``model.weights`` drops every graph of
the model, and a cache that is collected takes its graphs with it (a graph
holds its cache weakly). ``Model(..., graphs=False)`` (or ``model.graphs =
False``) runs every forward eagerly; on the CPU the forward is eager unless
graphs=True, which runs each graph's step function on its static buffers
(the tests do).
"""

from __future__ import annotations

import os
import weakref
from collections import OrderedDict

import numpy as np
import torch

from exllamav2_tpu_torch.cache import KVCache
from exllamav2_tpu_torch.config import ModelConfig
from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.models import forward as F
from exllamav2_tpu_torch.models.forward import model_forward
from exllamav2_tpu_torch.models.loader import load_model
from exllamav2_tpu_torch.models.modules import ModelWeights, StaticModel

__all__ = ["Model"]


# step graphs a model keeps (decode, prefill), and the caches generate_greedy
# keeps for reuse, one per (batch, max_seq)
MAX_GRAPHS = 16
MAX_PREFILL_GRAPHS = 8
# prefill keys met once (captured at their second call), the newest kept
MAX_PREFILL_SEEN = 64
MAX_GREEDY_CACHES = 2


def _limit_bucket(n: int, cap: int, step: int = 256) -> int:
    """Bucket the attention span up to a multiple of `step` (bounds cache
    reads to the live sequence)."""
    return min(-(-n // step) * step, cap)


def _drop_cache_graphs(runner_ref, kptr: int) -> None:
    """Finalizer of a cache: forget the step graphs that wrote into it (a
    decode or a prefill key: the cache's K storage is k[2] of both)."""
    runner = runner_ref()
    if runner is not None:
        runner.drop(lambda k: k[2] == kptr)


class Model:
    """Loaded model: weights on one device + forward/generation.

    graphs: replay a CUDA graph for each forward (default: on a card
    device); False runs every forward eagerly."""

    def __init__(self, weights: ModelWeights, static: StaticModel,
                 config: ModelConfig | None = None,
                 graphs: bool | None = None):
        self.step_graphs = None             # StepGraphs, made at first use:
        self.prefill_graphs = None          # one-token steps, longer inputs
        self._prefill_seen: OrderedDict = OrderedDict()
        self.weights = weights
        self.static = static
        self.config = config
        self.graphs = self.device.type == "cuda" if graphs is None \
            else bool(graphs)
        self._greedy_caches: OrderedDict = OrderedDict()

    @property
    def weights(self) -> ModelWeights:
        return self._weights

    @weights.setter
    def weights(self, w: ModelWeights) -> None:
        """New weights (an adapter applied, a swap): every step graph read
        the old ones, so all of them go; the next step captures anew."""
        self._weights = w
        for runner in (self.step_graphs, self.prefill_graphs):
            if runner is not None:
                runner.drop(lambda k: True)

    @property
    def device(self) -> torch.device:
        return self.weights.embed.device

    @classmethod
    def from_dir(cls, model_dir: str, prescale: bool | None = None, *,
                 device=None, graphs: bool | None = None,
                 **cfg_overrides) -> "Model":
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
        m = cls(w, st, cfg, graphs=graphs)
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
                     last_token_only: bool, copy: bool = True):
        past_len, t = int(past_len), ids.shape[1]
        if past_len < 0 or past_len + t > cache.max_seq:
            raise ValueError(f"positions [{past_len}, {past_len + t}) "
                             f"outside max_seq {cache.max_seq}")
        limit = _limit_bucket(past_len + t, cache.max_seq)
        with torch.inference_mode():
            if t == 1 and (ids.is_cuda or self.graphs):
                logits = self._decode_step(ids, cache, past_len, limit)
                return (logits.clone() if copy else logits), cache
            if t > 1 and self.graphs and self._prefill_graphed(
                    ids, cache, limit, last_token_only):
                return self._prefill_step(ids, cache, past_len, limit,
                                          last_token_only).clone(), cache
            return model_forward(self.weights, self.static, ids, cache,
                                 past_len, last_token_only=last_token_only,
                                 attn_limit=limit)

    def _runner(self, prefill: bool):
        """The model's decode or prefill StepGraphs (the second shares the
        first's memory pool), made at first use."""
        from exllamav2_tpu_torch.utils.graphs import StepGraphs
        if self.step_graphs is None:
            self.step_graphs = StepGraphs(self.device, MAX_GRAPHS)
        if prefill and self.prefill_graphs is None:
            self.prefill_graphs = StepGraphs(
                self.device, MAX_PREFILL_GRAPHS, share_pool=self.step_graphs)
        return self.prefill_graphs if prefill else self.step_graphs

    def _graph_key(self, runner, key: tuple, cache: KVCache, body):
        """A step function for `key` when the runner lacks it, else None:
        body(cache, *static inputs), the cache held weakly (a replay runs
        while the caller holds it), the key dropped when the cache is
        collected."""
        if key in runner:
            return None
        weakref.finalize(cache, _drop_cache_graphs, weakref.ref(runner),
                         key[2]).atexit = False
        cref = weakref.ref(cache)
        return lambda *a: body(cref(), *a)

    def _key(self, ids, cache: KVCache, limit: int) -> tuple:
        return (ids.shape[0], limit, cache.k.data_ptr(), cache.v.data_ptr(),
                os.environ.get("QMM_PARTIALS") == "1")

    def _prefill_key(self, ids, cache, limit, last_token_only) -> tuple:
        return (*self._key(ids, cache, limit), ids.shape[1], last_token_only)

    def _prefill_graphed(self, ids, cache, limit, last_token_only) -> bool:
        """Whether this prefill replays its graph: its key has a graph, or
        this is the key's second call (the first ran eagerly)."""
        key = self._prefill_key(ids, cache, limit, last_token_only)
        if self.prefill_graphs is not None and key in self.prefill_graphs:
            return True
        if self._prefill_seen.pop(key, None) is not None:
            return True
        self._prefill_seen[key] = True
        while len(self._prefill_seen) > MAX_PREFILL_SEEN:
            self._prefill_seen.popitem(last=False)
        return False

    def _prefill_step(self, ids, cache: KVCache, past_len: int, limit: int,
                      last_token_only: bool):
        """ids [B, T > 1] at past_len (checked) -> logits: the graph of the
        decode key plus (T, last_token_only) replayed, its position a device
        tensor. The logits are the graph's static output."""
        st, w = self.static, self.weights
        runner = self._runner(True)
        key = self._prefill_key(ids, cache, limit, last_token_only)
        step = self._graph_key(runner, key, cache, lambda c, ids, pos: (
            model_forward(w, st, ids, c, pos, last_token_only=last_token_only,
                          attn_limit=limit)[0]))
        return runner(key, step, ids.to(torch.int32), past_len)

    def _decode_step(self, ids, cache: KVCache, past_len: int, limit: int):
        """One token [B, 1] at past_len (checked) -> logits [B, 1, vocab]:
        the step graph of (batch, limit, the cache's storage, QMM_PARTIALS)
        replayed, or with graphs off the same step eagerly, its position a
        device tensor either way. A replay's logits are the graph's static
        output (the next replay overwrites them)."""
        st, w = self.static, self.weights
        if not self.graphs:
            return model_forward(w, st, ids, cache, torch.full(
                (), past_len, dtype=torch.int32, device=ids.device),
                attn_limit=limit)[0]
        runner = self._runner(False)
        key = self._key(ids, cache, limit)
        step = self._graph_key(runner, key, cache, lambda c, ids, pos: (
            model_forward(w, st, ids, c, pos, attn_limit=limit)[0]))
        return runner(key, step, ids.to(torch.int32), past_len)

    def forward_with_hooks(self, ids, cache: KVCache, past_len: int,
                           pre_hooks: dict | None = None,
                           post_hooks: dict | None = None):
        """Layer-stepped eager forward with intervention hooks: ids [B, T]
        -> (logits [B, T, vocab] f32, cache). pre_hooks / post_hooks map a
        layer index to fn(hidden [B, T, d]) -> hidden, applied before /
        after that decoder block. Never graphed: a hook is any Python."""
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.asarray(ids, np.int32))
        ids = ids.to(self.device)
        pre_hooks, post_hooks = pre_hooks or {}, post_hooks or {}
        w, st = self.weights, self.static
        past_len = int(past_len)
        with torch.inference_mode():
            pos = F._positions(past_len, ids.shape[1], ids.device)
            x = F._embed(w, st, ids, pos)
            rope = F._rope_rows(w, pos)
            for layer in range(st.num_layers):
                if layer in pre_hooks:
                    x = pre_hooks[layer](x)
                x, cache = F._block_forward(x, w.layers[layer], st, layer,
                                            rope, cache, past_len)
                if layer in post_hooks:
                    x = post_hooks[layer](x)
            return F._head(w, st, x, False), cache

    def _greedy_cache(self, batch: int, max_seq: int) -> KVCache:
        """generate_greedy's cache of (batch, max_seq), kept for the next
        call (rows past the position are never read); the least recently
        used of MAX_GREEDY_CACHES goes, with its step graphs."""
        key = (batch, max_seq)
        cache = self._greedy_caches.get(key)
        if cache is None:
            while len(self._greedy_caches) >= MAX_GREEDY_CACHES:
                _, old = self._greedy_caches.popitem(last=False)
                ptr = old.k.data_ptr()
                for runner in (self.step_graphs, self.prefill_graphs):
                    if runner is not None:
                        runner.drop(lambda k: k[2] == ptr)
            cache = self.new_cache(batch=batch, max_seq=max_seq)
            self._greedy_caches[key] = cache
        self._greedy_caches.move_to_end(key)
        return cache

    def generate_greedy(self, prompt_ids: np.ndarray, max_new_tokens: int,
                        max_seq: int | None = None,
                        stop_token: int | None = None) -> np.ndarray:
        """Greedy loop: prompt_ids [B, T0] -> [B, T0 + max_new] (numpy).

        The cache is kept on the model for the next call of the same batch
        and max_seq (by default T0 + max_new rounded up to a multiple of
        256, the attention-limit step), so the step graphs are reused. One
        host readback a token."""
        prompt_ids = np.ascontiguousarray(np.atleast_2d(
            np.asarray(prompt_ids, np.int32)))
        b, t0 = prompt_ids.shape
        total = t0 + max_new_tokens
        cache = self._greedy_cache(b, max_seq or -(-total // 256) * 256)
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
            logits, cache = self._forward_one(tok[:, None], cache, pos,
                                              False, copy=False)
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            pos += 1
        out.append(tok.cpu().numpy()[:, None])
        return np.concatenate(out, axis=1)
