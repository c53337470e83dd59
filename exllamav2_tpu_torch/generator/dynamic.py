"""Dynamic generator: continuous batching over the paged KV cache.

PyTorch port of exllamav2_tpu/generator/dynamic.py. The host-side scheduler
is the reference's: a page pool with a blake2b hash chain for prompt dedup,
LRU eviction by access serial, chunked page-aligned prefill, stop tokens and
stop strings with held UTF-8 text. The device side:

  * a decode step is paged forward -> token bias -> penalties -> DRY ->
    sampling, and the sampled ids go back to the host in one readback (the
    only per-step host sync); its host inputs (block tables, seqlens, slots,
    sampler rows, packed allow-masks) go up in one int32 buffer;
  * a burst of k steps feeds each sampled token back through the token
    history on the device and reads [k, B] tokens back once;
  * on the card every decode step replays a CUDA graph (utils/graphs.py),
    the counterpart of the reference's jitted steps, keyed as the reference
    keys them: ("decode", b_bucket, p_bucket, masked, use_dry, biased,
    topk, ret_logits, use_pen), ("decode_burst", b_bucket, p_bucket, k,
    use_dry, biased, use_pen), ("decode_cfg", rows_bucket, p_bucket),
    ("draft", b_bucket, p_bucket, k) and ("verify", b_bucket, p_bucket, d),
    at most MAX_GRAPHS, the sampler's generator registered with each;
    so does every prefill chunk, keyed as the reference keys its compiled
    prefills plus the batch bucket: ("prefill", t, p, b) (a CFG job's
    second stream takes the same graph over its own pages), ("prefill_mm",
    t, p, with_rope, b) and the draft model's ("dprefill", t, p, b), at
    most MAX_PREFILL_GRAPHS in a runner of their own that shares the
    decode graphs' memory pool. A key is captured on its first call, as the
    reference compiles on first use (``warmup`` primes a short prompt's).
    ``graphs=False`` runs them all eagerly (the default on the CPU). Which
    kernel serves a linear (QMM_PARTIALS) is read when a key is captured, as
    the reference reads it when it traces. A graph reads the weights it was
    captured with: new weights (set_loras, or ``generator.model`` replaced)
    drop every graph;
  * the token history ``hist`` [slots + 1, max_seq_len + 2] int32 lives on
    the device, so penalties and the decode input gather never re-upload a
    sequence;
  * batch and block-table widths are bucketed to powers of two, with pad
    rows pointing at a dummy history slot and the null page 0. They change
    no result; they are the shapes the step graphs are keyed on.

``merged_weights=True`` serves from merged q|k|v and gate|up linears (exact;
ops/dequant.merge_serving_weights), ``w4a8=True`` decodes through the W4A8
kernel (int8 activations, approximate; the head and the prefill stay exact).

Constrained generation runs on the host, one token a dispatch: filters
(generator/filters) and token healing become per-job allow-masks for the
sampler, banned strings rewind the job to the checkpoint where the string
began and block its first token once (pages whose fill dropped are
unpublished, or copied when another job shares them), and post-sampling
hooks see every sampled token. The device history needs no repair after a
rewind: row `slot` holds the job's sequence up to the rewound length, the
next step reads hist[slot, kv_pos] and overwrites what lies behind it.

CFG (``DynamicJob(negative_prompt_ids=)`` with ``settings.cfg_scale``)
runs a second, unconditional stream with its own pages and history slot;
the paired decode step mixes the two streams' log-probabilities.
Speculative decoding (``use_ngram_draft=True``, or ``draft_model=`` with a
``draft_cache=`` over the same page count) drafts d = num_draft_tokens
tokens (host n-gram tables, generator/speculative.py, or d greedy steps of
the draft model in one graph) and verifies them in one t = d + 1 forward
that samples every position; the matching prefix and one more token are
accepted. Rejected drafts leave KV rows past the accepted length, which
the next step overwrites before any query reads them. ``set_loras``
attaches PEFT adapters (lora.py) to the served weights.

MoE models count the routes their prefill's capacity dispatch drops
(models/forward.moe_forward): each prefill forward sums its layers' counts
on the device (a static output of its graph, copied after the replay), and
the host reads them back when a job finishes (its result carries
``moe_dropped_tokens``) or when ``moe_dropped_tokens`` is read, never in the
middle of a step. The prefill's pad rows and columns are masked out of the
routing by a validity mask made on the device from the rows' lengths.

Multimodal jobs (``DynamicJob(embeddings=)``, vlm.MMEmbedding: an image's
rows under a token-id range of its own from 1e9 up) prefill one job at a
time: the chunk's rows are one gather of the embedding table plus each
embedding's rows copied in on the device, and the embedding ids take part
in the page hashes, so the same image's pages are reused. On an MRoPE model
(Qwen2-VL) every job's prompt gets its 3-axis rope rows on the host, and its
decode steps add a per-job offset to the rope positions: the offsets are
one more section of a step's input buffer (0 for a text job and for pad
rows), data of the step and never part of a graph key, so text and image
jobs share one captured step. Multimodal and MRoPE jobs take no part in the
batched prefill, and multimodal jobs none in speculative rounds.

``mesh=`` (parallel/sharding.make_mesh) serves a tensor-parallel shard on
each rank of the mesh's TP group: every rank runs this generator on the same
jobs in lockstep, its model the rank's shard (parallel/sharding.shard_model:
split linears, attention on the rank's KV heads, expert-parallel MoE) and
its cache the rank's KV heads; the gathered logits are the same bytes on
every rank and the samplers are seeded alike, so the scheduler needs no
traffic of its own. ``_tp_fused`` says whether everything split (dp = 1 and
parallel/sharding.tp_fusable), else what does not split stays whole on every
rank. On a mesh the steps run eagerly (a gloo collective cannot be captured
in a CUDA graph), merged_weights and w4a8 are ignored with a warning, the
draft model of speculative decoding is replicated, and ``set_loras`` wraps
the rank's shard (parallel/sharding.lora_wrap_tp).

Under a torch.profiler session the scheduler's phases are spans
(utils/profiling.span; nothing is recorded without one): ``dyn.iterate``
over all of ``iterate()``, inside it ``dyn.admit`` (the pending loop),
``dyn.prefill`` (each prefill forward, with the counts ``rows``, its real
prompt tokens, and ``rows_computed``, B x T of its padded ids),
``dyn.decode`` (each decode, CFG or speculative step), inside that
``dyn.readback`` (the wait for the card's tokens) and ``dyn.emit``
(accepting and emitting them), and ``dyn.reap``; utils/graphs.py adds
``graphs.capture.<kind>``, ``graphs.load`` and ``graphs.replay``. No span
lies inside a captured step. Every job is stamped at enqueue
(``time_enqueue``), admission (``time_admitted``) and its first and last
token, on the perf_counter clock; its last result carries
``time_enqueued`` (the wait for admission), ``time_prefill`` (admission to
first token) and ``time_generate``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import time
import weakref
from collections import OrderedDict, deque

import numpy as np
import torch

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.filters.base import piece_table
from exllamav2_tpu_torch.generator.hooks import PostSamplingResult
from exllamav2_tpu_torch.generator.sampler import (
    ROWS, Settings, params_from_rows, settings_rows)
from exllamav2_tpu_torch.generator.speculative import NgramDrafter
from exllamav2_tpu_torch.models import forward as F
from exllamav2_tpu_torch.models.forward import model_forward_paged
from exllamav2_tpu_torch.native import find_first_match, max_partial_overlap
from exllamav2_tpu_torch.ops.sampling import (
    apply_dry, apply_penalties, sample, unpack_mask)
from exllamav2_tpu_torch.utils import profiling
from exllamav2_tpu_torch.vlm.mm_embedding import EMBEDDING_INDEX

__all__ = ["DynamicGenerator", "DynamicJob"]

_HASH = lambda b: hashlib.blake2b(b, digest_size=16).digest()  # noqa: E731


# step graphs a generator keeps, decode steps and prefills apart (the least
# recently used of each goes first)
MAX_GRAPHS = 32
MAX_PREFILL_GRAPHS = 16
# the keys of the prefill steps, as the reference names its compiled ones
PREFILL_KEYS = ("prefill", "prefill_mm", "dprefill")


def _bucket(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class CachePage:
    """One physical page of the pool."""

    __slots__ = ("index", "phash", "prev_hash", "ref_count",
                 "access_serial", "kv_position", "tokens")

    def __init__(self, index: int):
        self.index = index
        self.phash: bytes | None = None
        self.prev_hash: bytes | None = None
        self.ref_count = 0
        self.access_serial = 0
        self.kv_position = 0
        self.tokens: np.ndarray | None = None   # contents when hashed


class DynamicJob:
    """One generation request."""

    def __init__(self, input_ids, max_new_tokens: int = 128,
                 settings: Settings | None = None,
                 stop_conditions: list | None = None,
                 decode_special_tokens: bool = False,
                 seed: int = 0, identifier=None,
                 filters: list | None = None,
                 token_healing: bool = False,
                 banned_strings: list[str] | None = None,
                 negative_prompt_ids=None,
                 embeddings: list | None = None,
                 return_top_tokens: int = 0,
                 return_probs: bool = False,
                 filter_prefer_eos: bool = False,
                 post_sampling_hooks: list | None = None,
                 min_new_tokens: int = 0,
                 max_skips: int | None = 4,
                 return_logits: bool = False):
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        self.prompt_ids = ids
        self.min_new_tokens = min_new_tokens   # suppress EOS below this
        self.max_skips = max_skips             # admission-failure budget
        self.skips = 0
        self.return_top_tokens = return_top_tokens
        self.return_probs = return_probs
        self.return_logits = return_logits
        self.filter_prefer_eos = filter_prefer_eos
        self.post_sampling_hooks = post_sampling_hooks or []
        self.last_logits = None
        self.last_prob: float | None = None
        self.last_top: tuple | None = None      # (tokens, probs) np arrays
        self.max_new_tokens = max_new_tokens
        self.settings = settings or Settings()
        self.identifier = identifier
        self.seed = seed
        self.decode_special_tokens = decode_special_tokens
        self.filters = filters or []
        self.token_healing = token_healing
        self.healing_token: int | None = None
        self.banned_strings = [s.lower() for s in (banned_strings or [])]
        self.blocked_tokens: set[int] = set()   # one-shot (rewind/healing)
        self.checkpoint = None                  # banned-string rewind state
        self.rewind_deferred = False            # awaiting a page for rewind
        self.draft_accepted = 0
        # multimodal embeddings: prompt ids >= EMBEDDING_INDEX resolve into
        # their rows at prefill
        self.embeddings = embeddings or []
        self.mrope_offset = 0          # decode rope offset (MRoPE models)
        self.mrope_rows = None         # (sin, cos) np rows of the prompt

        # CFG: the second (negative, unconditional) stream, when the
        # settings carry a cfg_scale
        self.negative_ids = None
        if negative_prompt_ids is not None and \
                (settings and settings.cfg_scale is not None):
            self.negative_ids = np.asarray(
                negative_prompt_ids, np.int32).reshape(-1)
        self.pages2: list[CachePage] = []
        self.slot2 = -1
        self.kv_pos2 = 0

        self.stop_tokens: set[int] = set()
        self.stop_strings: list[str] = []
        for sc in (stop_conditions or []):
            if isinstance(sc, int):
                self.stop_tokens.add(sc)
            elif isinstance(sc, str):
                self.stop_strings.append(sc)
            else:
                self.stop_tokens.update(int(x) for x in sc)

        # runtime state
        self.status = "pending"        # pending -> prefill -> generating -> done
        self.pages: list[CachePage] = []
        self.page_hashes: list[bytes] = []
        self.kv_pos = 0                # cached kv rows
        self.reused_tokens = 0
        self.slot = -1
        self.sequence: np.ndarray = ids.copy()   # prompt + generated
        self.new_tokens = 0
        self.mirostat_mu = float(self.settings.mirostat_mu or 0.0)
        self.held_text = ""
        self.emitted_text = ""
        self.eos_reason: str | None = None
        self.time_enqueue = 0.0
        self.time_admitted = 0.0
        self.time_first_token = 0.0
        self.time_last_token = 0.0
        # dropped MoE routes of each prefill chunk (int32 device scalars),
        # totalled when the job finishes
        self._moe_drop_parts: list = []

    @property
    def is_cfg(self) -> bool:
        return self.negative_ids is not None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)

    def pages_needed(self, page_size: int, margin: int = 0) -> int:
        """Pages for prompt + generation; `margin` holds the verify step's
        KV rows past the accepted length (speculative decoding)."""
        total = self.prompt_len + self.max_new_tokens + margin
        return -(-total // page_size)

    def pages2_needed(self, page_size: int, margin: int = 0) -> int:
        """Pages of the CFG stream (0 without one)."""
        if not self.is_cfg:
            return 0
        total = len(self.negative_ids) + self.max_new_tokens + margin
        return -(-total // page_size)


class DynamicGenerator:
    """Continuous-batching scheduler over a PagedKVCache."""

    # only TTFTs younger than this feed the adaptive-burst policy
    TTFT_WINDOW_S = 30.0

    def __init__(self, model, cache: PagedKVCache, tokenizer,
                 max_batch_size: int = 32, max_chunk_size: int = 512,
                 max_seq_len: int | None = None,
                 draft_model=None, draft_cache=None,
                 num_draft_tokens: int = 4, use_ngram_draft: bool = False,
                 max_ngram: int = 4, mesh=None,
                 merged_weights: bool = False,
                 prescale: bool | None = None,
                 w4a8: bool = False,
                 decode_burst: int | None = None,
                 ttft_slo_ms: float | None = None,
                 device=None, graphs: bool | None = None):
        """model: a models.model.Model; cache: a PagedKVCache on the same
        device. `device` defaults to the model's. decode_burst: up to this
        many tokens per dispatch when no job needs per-step host work
        (default: the DECODE_BURST environment variable, else 8).
        ttft_slo_ms: shrink bursts while the rolling p50 time to first
        token breaches this target. merged_weights: serve from merged
        q|k|v and gate|up linears (exact). w4a8: opt-in approximate decode
        with int8 activations (decode steps only; the prefill and the head
        stay exact). Neither changes the caller's model. graphs: replay
        the decode steps and the prefills as CUDA graphs (default: on a
        card device); False runs them eagerly. use_ngram_draft, or draft_model with a
        draft_cache over the same number of pages: speculative decoding
        with num_draft_tokens drafts a round. mesh: serve this rank's
        tensor-parallel shard (module docstring); model and cache are the
        whole model's, on the mesh's device."""
        from exllamav2_tpu_torch.models.model import Model
        from exllamav2_tpu_torch.ops import dequant as D
        import warnings
        self.mesh = mesh
        self._tp_fused = False
        if mesh is not None:
            from exllamav2_tpu_torch.parallel.sharding import Mesh
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh={mesh!r}: want a "
                                "parallel.sharding.Mesh (make_mesh)")
            for flag, name in ((merged_weights, "merged_weights"),
                               (w4a8, "w4a8")):
                if flag:
                    warnings.warn(f"DynamicGenerator: {name} is not "
                                  "supported with mesh=; ignoring",
                                  stacklevel=2)
            merged_weights = w4a8 = False
            graphs = False
        if decode_burst is None:
            decode_burst = int(os.environ.get("DECODE_BURST", 8))
        self.decode_burst = int(decode_burst)
        self._merged_weights = bool(merged_weights)
        self.ttft_slo_ms = ttft_slo_ms
        self._ttft_recent = deque(maxlen=32)
        if prescale is None:
            prescale = getattr(model, "_prescale", None)
        if prescale is None:
            prescale = os.environ.get("EXL2_TPU_PRESCALE", "1") == "1"
        # the reference's order: merge, then prescale, then w4a8
        if merged_weights:
            model = Model(D.merge_serving_weights(model.weights),
                          model.static, model.config)
        if prescale:
            # decode EXL2 group scales once into bf16 rows (idempotent)
            model = Model(D.precompute_model_scales(model.weights),
                          model.static, model.config)
        if w4a8:
            model = Model(D.enable_w4a8(model.weights), model.static,
                          model.config)
        if mesh is not None:
            from exllamav2_tpu_torch.parallel import sharding as S
            self._tp_fused = mesh.dp == 1 and S.tp_fusable(
                model.weights, model.static, mesh.tp)
            w, st = S.shard_model(model.weights, model.static, mesh)
            if S.heads_split(w):
                cache = S.shard_paged_cache(cache, mesh)
            model = Model(w, st, model.config, graphs=False)
        self.model = model
        self.device = torch.device(device) if device is not None \
            else model.device
        if cache.device != self.device or model.device != self.device:
            raise ValueError(f"model on {model.device}, cache on "
                             f"{cache.device}, generator on {self.device}")
        self.cache = cache
        self.tokenizer = tokenizer
        self.page_size = cache.page_size
        self.max_batch_size = max_batch_size
        self.max_chunk_size = max_chunk_size
        self.max_seq_len = max_seq_len or cache.num_pages * self.page_size

        # speculative decoding
        self.draft_model = draft_model
        self.draft_cache = draft_cache
        self.num_draft_tokens = num_draft_tokens
        self.use_ngram_draft = use_ngram_draft
        self.ngram = NgramDrafter(max_ngram) if use_ngram_draft else None
        if draft_model is not None and (
                draft_cache is None or draft_cache.num_pages != cache.num_pages
                or draft_cache.device != self.device
                or draft_model.device != self.device):
            raise ValueError("draft_model needs a draft_cache on the "
                             "generator's device over the main cache's "
                             f"{cache.num_pages} pages")

        # page pool; page 0 reserved as the null page for padded batch rows
        self.pages = [CachePage(i) for i in range(cache.num_pages)]
        self.free_pages: list[CachePage] = self.pages[1:][::-1]
        self.referenced: dict[bytes, CachePage] = {}
        self.unreferenced: OrderedDict[bytes, CachePage] = OrderedDict()
        self.access_serial = 0
        # dropped MoE routes of finished jobs, and the device scalars of
        # batched prefills (not one job's), folded when read
        self._moe_dropped_host = 0
        self._moe_drop_batch: list = []

        # device-side token history; the extra row is the dummy slot of pad
        # rows, the extra columns hold the tokens sampled at the end (a
        # verify step writes num_draft_tokens + 1 of them)
        self.num_slots = max_batch_size
        self.hist = torch.zeros(
            (self.num_slots + 1, self.max_seq_len + num_draft_tokens + 2),
            dtype=torch.int32, device=self.device)
        self.free_slots = list(range(self.num_slots))[::-1]

        self.pending: list[DynamicJob] = []
        self.active: list[DynamicJob] = []
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(0)
        self._bias_pool = None         # [slots + 1, vocab] f32, lazy
        if graphs is None:
            graphs = self.device.type == "cuda"
        self.step_graphs = self.prefill_graphs = None
        self._graphed_weights = ()     # weak refs to what the graphs read
        self._active_loras = ()
        if graphs:
            from exllamav2_tpu_torch.utils.graphs import StepGraphs
            self.step_graphs = StepGraphs(self.device, MAX_GRAPHS,
                                          generators=[self._rng])
            self.prefill_graphs = StepGraphs(
                self.device, MAX_PREFILL_GRAPHS, share_pool=self.step_graphs)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sync_bias_row(self, job: DynamicJob):
        """Upload (or clear) the job's token_bias into the device pool."""
        tb = job.settings.token_bias
        if tb is None and self._bias_pool is None:
            return
        vocab = self.model.static.vocab_size
        if self._bias_pool is None:
            self._bias_pool = torch.zeros((self.num_slots + 1, vocab),
                                          dtype=torch.float32,
                                          device=self.device)
        row = np.zeros(vocab, np.float32)
        if tb is not None:
            tb = np.asarray(tb, np.float32).reshape(-1)
            row[:min(len(tb), vocab)] = tb[:vocab]
        self._bias_pool[job.slot] = self._dev(row)

    # ------------------------------------------------------------------
    # page pool
    # ------------------------------------------------------------------

    def _touch(self, page: CachePage):
        self.access_serial += 1
        page.access_serial = self.access_serial

    def _take_free_page(self) -> CachePage | None:
        if self.free_pages:
            return self.free_pages.pop()
        if self.unreferenced:
            # evict the least recently used hashed page
            h, p = min(self.unreferenced.items(),
                       key=lambda kv: kv[1].access_serial)
            del self.unreferenced[h]
            p.phash = None
            p.prev_hash = None
            p.tokens = None
            return p
        return None

    def defrag(self):
        """Reorder idle pages so hash chains are physically consecutive.

        Runs only with no active or pending jobs; page contents move by
        copy_pages, and CachePage.index is rewritten in place so a later
        reuse sees the new location."""
        if self.active or self.pending or not self.unreferenced:
            return
        if not self.free_pages:
            return                      # need one scratch page for cycles
        if self.draft_cache is not None:
            return                      # keep the draft's pages in step
        by_prev: dict[bytes | None, list[CachePage]] = {}
        for p in self.unreferenced.values():
            by_prev.setdefault(p.prev_hash, []).append(p)
        order: list[CachePage] = []
        stack = sorted(by_prev.get(None, []), key=lambda p: p.access_serial)
        seen = set()
        while stack:
            p = stack.pop(0)
            if id(p) in seen:
                continue
            seen.add(id(p))
            order.append(p)
            stack = sorted(by_prev.get(p.phash, []),
                           key=lambda q: q.access_serial) + stack
        for p in self.unreferenced.values():
            if id(p) not in seen:
                order.append(p)

        targets = sorted(p.index for p in order)
        moves = {p.index: t for p, t in zip(order, targets) if p.index != t}
        if not moves:
            return
        temp = self.free_pages[-1].index
        by_index = {p.index: p for p in order}
        done = set()
        for start in list(moves):
            if start in done:
                continue
            # rotate the cycle through the scratch page (moves is a
            # permutation of its non-fixed points, so every cycle closes)
            cycle = [start]
            nxt = moves[start]
            while nxt != start:
                cycle.append(nxt)
                nxt = moves[nxt]
            self.cache.copy_pages([cycle[-1]], [temp])
            for src in reversed(cycle[:-1]):
                self.cache.copy_pages([src], [moves[src]])
            self.cache.copy_pages([temp], [moves[cycle[-1]]])
            for src in cycle:
                by_index[src].index = moves[src]
                done.add(src)

    def _free_capacity(self) -> int:
        return len(self.free_pages) + len(self.unreferenced)

    def cancel(self, job: DynamicJob):
        """Abort a job: a pending job is dropped, an active one releases its
        pages and slot at once. No result is emitted for it."""
        if job in self.pending:
            self.pending.remove(job)
        elif job in self.active:
            self.active.remove(job)
            self._release_job_pages(job)
            if job.slot >= 0:
                self.free_slots.append(job.slot)
                job.slot = -1
            self._moe_dropped_host += self._fold_drops(job)
        else:
            return
        job.status = "done"
        job.eos_reason = "cancelled"

    def clear_queue(self):
        """Cancel every pending and active job."""
        for job in list(self.pending) + list(self.active):
            self.cancel(job)

    def num_remaining_jobs(self) -> int:
        """Jobs not yet finished."""
        return len(self.pending) + len(self.active)

    def reset_page_table(self):
        """Forget all cached pages: clears the dedup hash tables and returns
        every page to the free pool. Only valid with no jobs in flight."""
        assert not self.active and not self.pending, \
            "reset_page_table with jobs in flight"
        for p in self.pages:
            p.phash = None
            p.prev_hash = None
            p.ref_count = 0
            p.kv_position = 0
            p.tokens = None
            p.access_serial = 0
        self.free_pages = self.pages[1:][::-1]
        self.referenced.clear()
        self.unreferenced.clear()

    def warmup(self):
        """Run one tiny greedy job end to end, as the reference does: it
        builds the kernels on first use and, graphed, captures the keys of
        a short prompt's prefill and decode; then reset the page table so
        its tokens do not linger."""
        job = DynamicJob(np.asarray([1, 2, 3], np.int32), max_new_tokens=2,
                         settings=Settings.greedy())
        self.enqueue(job)
        while job.status != "done":
            self.iterate()
        self.reset_page_table()

    def set_loras(self, loras):
        """Attach PEFT adapters (lora.Lora) to the served weights, or detach
        them all with None / []. Rebuilds the weights with LoraLinear
        wraps (merged q|k|v and gate|up streams are stripped while adapters
        are attached, and merged again on detach when the generator serves
        merged weights) and drops every step graph: the next steps capture
        with the new weights. A no-op when the same adapter objects are
        attached already; they are held by strong reference, so no id of a
        collected adapter can stand for another."""
        from exllamav2_tpu_torch.lora import apply_lora, remove_lora
        from exllamav2_tpu_torch.ops import dequant as D
        requested = tuple(loras or [])
        active = self._active_loras
        if len(requested) == len(active) and all(
                a is b for a, b in zip(requested, active)):
            return
        w = remove_lora(self.model.weights)
        if self.mesh is not None:
            from exllamav2_tpu_torch.parallel.sharding import lora_wrap_tp
            apply = functools.partial(lora_wrap_tp, mesh=self.mesh)
        else:
            apply = apply_lora
        if requested:
            # the forward prefers a merged stream, which would bypass the
            # wrapped q/k/v and gate/up
            w = D.strip_merged_weights(w)
        elif self._merged_weights:
            w = D.merge_serving_weights(w)
        for lora in requested:
            w = apply(w, lora)
        self.model = type(self.model)(w, self.model.static,
                                      self.model.config)
        self._drop_graphs()
        self._active_loras = requested

    def encode_with_embeddings(self, text: str, embeddings: list,
                               add_bos: bool = False,
                               encode_special_tokens: bool = False
                               ) -> np.ndarray:
        """Tokenize text holding MMEmbedding text aliases, each alias
        replaced by its embedding's token-id range -> int32 ids."""
        segments = [(None, text)]
        for e in embeddings:
            out = []
            for emb, seg in segments:
                if emb is not None:
                    out.append((emb, seg))
                    continue
                for i, part in enumerate(seg.split(e.text_alias)):
                    if i:
                        out.append((e, None))
                    out.append((None, part))
            segments = out
        ids = []
        if add_bos and self.tokenizer.bos_token_id is not None:
            ids.append(np.asarray([self.tokenizer.bos_token_id], np.int64))
        for emb, seg in segments:
            if emb is not None:
                ids.append(emb.get_ids_array())
            elif seg:
                ids.append(np.asarray(self.tokenizer.encode(
                    seg, add_bos=False,
                    encode_special_tokens=encode_special_tokens),
                    np.int64).reshape(-1))
        return np.concatenate(ids).astype(np.int32) if ids else \
            np.zeros(0, np.int32)

    @property
    def moe_dropped_tokens(self) -> int:
        """Routes the MoE prefill dispatch dropped past expert capacity, over
        finished jobs and batched prefills (0 when none: the prefill then
        equals the exact dense mix; forward.set_moe_dispatch raises the
        capacity). Reads the batched prefills' device counts back."""
        if self._moe_drop_batch:
            self._moe_dropped_host += int(sum(
                int(d) for d in self._moe_drop_batch))
            self._moe_drop_batch.clear()
        return self._moe_dropped_host

    @staticmethod
    def _fold_drops(job: DynamicJob) -> int:
        """Read back and clear a job's dropped-route scalars."""
        n = int(sum(int(d) for d in job._moe_drop_parts))
        job._moe_drop_parts.clear()
        return n

    def print_page_list(self, short: bool = True):
        """Debug dump of the page pool."""
        for p in self.pages:
            state = ("null" if p.index == 0 else
                     "free" if p.ref_count == 0 and p.phash is None else
                     "unref" if p.ref_count == 0 else "ref")
            if short:
                print(f"{p.index}:{state}:{p.ref_count}", end=" ")
            else:
                h = p.phash.hex()[:8] if p.phash else "-"
                print(f"page {p.index:4d} {state:5s} refs={p.ref_count} "
                      f"kv={p.kv_position} hash={h}")
        if short:
            print()

    def validate_cache(self):
        """No-op on the serving path; the invariant checker is
        _validate_cache, which the tests call."""

    def _validate_cache(self):
        """Page-table invariants: free / unreferenced / referenced are
        disjoint, ref_counts equal the active jobs' references, and the
        hash tables are consistent."""
        free = set(id(p) for p in self.free_pages)
        unref = set(id(p) for p in self.unreferenced.values())
        ref = set(id(p) for p in self.referenced.values())
        assert not free & unref and not free & ref and not unref & ref, \
            "page sets overlap"
        counts: dict[int, int] = {}
        for job in self.active:
            for p in job.pages + job.pages2:
                counts[id(p)] = counts.get(id(p), 0) + 1
        for p in self.pages:
            if p.index == 0:
                continue
            held = counts.get(id(p), 0)
            assert p.ref_count == held, \
                f"page {p.index}: ref_count {p.ref_count} != held {held}"
            if id(p) in free:
                assert p.ref_count == 0, f"free page {p.index} referenced"
            if id(p) in unref:
                assert p.ref_count == 0 and p.phash is not None, \
                    f"unreferenced page {p.index} inconsistent"
        for h, p in self.referenced.items():
            assert p.phash == h, "referenced hash key mismatch"
        for h, p in self.unreferenced.items():
            assert p.phash == h, "unreferenced hash key mismatch"

    def _release_job_pages(self, job: DynamicJob):
        for page in job.pages2:
            page.ref_count -= 1
            if page.ref_count == 0:
                self.free_pages.append(page)
        job.pages2 = []
        if job.slot2 >= 0:
            self.free_slots.append(job.slot2)
            job.slot2 = -1
        for page in job.pages:
            page.ref_count -= 1
            if page.ref_count == 0:
                del_ref = self.referenced.pop(page.phash, None) \
                    if page.phash is not None else None
                if page.phash is not None and del_ref is page:
                    self.unreferenced[page.phash] = page
                elif page.phash is not None and del_ref is not None:
                    # another page holds this hash; keep it referenced
                    self.referenced[page.phash] = del_ref
                    page.phash = None
                    self.free_pages.append(page)
                else:
                    self.free_pages.append(page)
        job.pages = []

    # ------------------------------------------------------------------
    # job admission
    # ------------------------------------------------------------------

    def enqueue(self, job: DynamicJob) -> DynamicJob:
        assert job.prompt_len + job.max_new_tokens <= self.max_seq_len, \
            "job exceeds max_seq_len"
        # a job referencing more distinct pages than the pool holds can
        # never be admitted (page 0 is the reserved null page): fail here
        # instead of stalling every later admission
        margin = self._draft_margin()
        demand = job.pages_needed(self.page_size, margin) \
            + job.pages2_needed(self.page_size, margin)
        usable = len(self.pages) - 1
        if demand > usable:
            raise ValueError(
                f"job needs {demand} cache pages (prompt {job.prompt_len} "
                f"+ max_new_tokens {job.max_new_tokens} + draft margin "
                f"{margin}) but the cache only has {usable} usable pages")
        if job.is_cfg and self.num_slots < 2:
            raise ValueError("CFG jobs need max_batch_size >= 2")
        # token healing: re-predict the last prompt token constrained to
        # pieces extending it
        if job.token_healing and job.prompt_len >= 2:
            job.healing_token = int(job.prompt_ids[-1])
            job.prompt_ids = job.prompt_ids[:-1]
            job.sequence = job.prompt_ids.copy()
        for f in job.filters:
            f.begin("")
        # prompt page hash chain
        job.page_hashes = []
        prev = b""
        ids = job.prompt_ids
        for p in range(len(ids) // self.page_size):
            chunk = ids[p * self.page_size:(p + 1) * self.page_size]
            h = _HASH(prev + chunk.tobytes())
            job.page_hashes.append(h)
            prev = h
        job.time_enqueue = time.perf_counter()
        self.pending.append(job)
        return job

    def _draft_margin(self) -> int:
        """KV rows a verify step may write past a job's accepted length."""
        spec = self.draft_model is not None or self.use_ngram_draft
        return self.num_draft_tokens if spec else 0

    def _try_start(self, job: DynamicJob) -> bool:
        margin = self._draft_margin()
        needed = job.pages_needed(self.page_size, margin)
        needed2 = job.pages2_needed(self.page_size, margin)
        if len(self.free_slots) < (2 if job.is_cfg else 1):
            return False

        # hash-chain prompt reuse: only pages that end strictly before the
        # last prompt token can be referenced (the first decode step
        # appends at prompt_len - 1; shared pages are never written)
        reusable: list[CachePage] = []
        for j, h in enumerate(job.page_hashes):
            if (j + 1) * self.page_size > job.prompt_len - 1:
                break
            page = self.referenced.get(h)
            if page is None:
                page = self.unreferenced.pop(h, None)
                if page is not None:
                    self.referenced[h] = page
            if page is None:
                break
            reusable.append(page)

        fresh_needed = needed - len(reusable)
        if self._free_capacity() < fresh_needed + needed2:
            # roll back unreferenced -> referenced moves made above
            for page in reusable:
                if page.ref_count == 0 and page.phash in self.referenced:
                    del self.referenced[page.phash]
                    self.unreferenced[page.phash] = page
            return False

        pages: list[CachePage] = []
        for page in reusable:
            page.ref_count += 1
            self.referenced[page.phash] = page
            self._touch(page)
            pages.append(page)
        for _ in range(fresh_needed):
            page = self._take_free_page()
            assert page is not None
            page.ref_count = 1
            page.kv_position = 0
            self._touch(page)
            pages.append(page)

        job.pages = pages
        job.reused_tokens = len(reusable) * self.page_size
        job.kv_pos = job.reused_tokens

        # partial-page reuse: longest token-prefix match against a cached
        # full page continuing the same chain, copied into the job's page
        j = len(reusable)
        seg = job.prompt_ids[j * self.page_size:(j + 1) * self.page_size]
        if len(seg) > 1 and j < len(pages):
            prev = reusable[-1].phash if reusable else b""
            best, best_m = None, 0
            for page in self.pages:
                if page.phash is None or page.tokens is None:
                    continue
                if (page.prev_hash or b"") != (prev or b""):
                    continue
                n = min(len(seg) - 1, len(page.tokens))
                m = int(np.argmin(np.concatenate([
                    (seg[:n] == page.tokens[:n]).astype(np.int8),
                    np.zeros(1, np.int8)])))
                if m > best_m:
                    best, best_m = page, m
            if best is not None and best_m > 0:
                self._copy_pages([best.index], [pages[j].index])
                self._touch(best)
                job.kv_pos += best_m
                job.reused_tokens += best_m

        job.slot = self.free_slots.pop()
        if job.is_cfg:
            for _ in range(needed2):
                page = self._take_free_page()
                page.ref_count = 1
                page.kv_position = 0
                self._touch(page)
                job.pages2.append(page)
            job.slot2 = self.free_slots.pop()
            job.kv_pos2 = 0
            n2 = min(_bucket(len(job.negative_ids), 16), self.max_seq_len)
            padded2 = np.zeros((n2,), np.int32)
            padded2[:len(job.negative_ids)] = job.negative_ids
            self._write_hist(job.slot2, 0, padded2)
        job.status = "prefill"
        self.active.append(job)

        # upload the prompt into the device history once (length bucketed;
        # the pad is overwritten by decode steps before it is read).
        # Embedding ids are masked to 0: the history only feeds the
        # penalties and DRY, which leave image rows out
        n = min(_bucket(job.prompt_len, 16), self.max_seq_len)
        padded = np.zeros((n,), np.int32)
        padded[:job.prompt_len] = np.where(
            job.prompt_ids >= EMBEDDING_INDEX, 0, job.prompt_ids)
        self._write_hist(job.slot, 0, padded)
        self._prepare_mrope(job)
        self._sync_bias_row(job)
        job.time_admitted = time.perf_counter()
        return True

    def _prepare_mrope(self, job: DynamicJob):
        """On an MRoPE model: the prompt's rope rows and the job's decode
        offset (every job, text-only ones too, as the reference does). The
        offset is <= 0 (a span advances the text position by max(t, h, w),
        at most its length), so every decode position stays in the table:
        checked here once, never in a step."""
        cfg = getattr(self.model, "config", None)
        if (cfg is None or not getattr(cfg.arch, "mrope", False)
                or not cfg.mrope_section):
            return
        from exllamav2_tpu_torch.ops.mrope import gen_mrope_pos_ids, mrope_rows
        from exllamav2_tpu_torch.ops.rope import rope_params
        spans = [e.get_vision_token_range() for e in job.embeddings]
        grids = [e.thw_grid for e in job.embeddings]
        merge = cfg.vision_spatial_merge_size if job.embeddings else 1
        pos, nxt = gen_mrope_pos_ids(
            job.prompt_ids.astype(np.int64), merge, spans, grids,
            job.prompt_len)
        inv, scale = rope_params(cfg)
        job.mrope_rows = mrope_rows(pos, inv, cfg.mrope_section, scale)
        job.mrope_offset = int(nxt - job.prompt_len)
        assert -job.prompt_len < job.mrope_offset <= 0, job.mrope_offset

    def _copy_pages(self, src: list[int], dst: list[int]):
        """Copy pages of the cache, and of the draft cache with it."""
        self.cache.copy_pages(src, dst)
        if self.draft_cache is not None:
            self.draft_cache.copy_pages(src, dst)

    def _write_hist(self, slot: int, start: int, ids: np.ndarray):
        """hist[slot, start:start + len(ids)] = ids, on the device."""
        self.hist[slot, start:start + len(ids)] = self._dev(ids)

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    def _note_ttft(self, job) -> None:
        if self.ttft_slo_ms is not None and job.time_enqueue:
            self._ttft_recent.append(
                (job.time_first_token,
                 job.time_first_token - job.time_enqueue))

    def _burst_limit(self) -> int:
        """Burst cap this step. With a TTFT SLO, bursts back off while any
        active job is still prefilling, or while the rolling p50 TTFT (last
        32 jobs within TTFT_WINDOW_S) breaches the target (half above 70 %
        of the SLO, a quarter above it)."""
        k = self.decode_burst
        if self.ttft_slo_ms is None or k <= 1:
            return k
        if any(j.status == "prefill" for j in self.active):
            return 1
        now = time.perf_counter()
        recent = [v for t, v in self._ttft_recent
                  if now - t < self.TTFT_WINDOW_S]
        if recent:
            p50_ms = sorted(recent)[len(recent) // 2] * 1000.0
            if p50_ms > self.ttft_slo_ms:
                return max(1, k // 4)
            if p50_ms > 0.7 * self.ttft_slo_ms:
                return max(1, k // 2)
        return k

    @staticmethod
    def _needs_penalties(jobs) -> bool:
        """Greedy / neutral-penalty batches skip apply_penalties."""
        return any(j.settings.token_repetition_penalty != 1.0
                   or j.settings.token_frequency_penalty != 0.0
                   or j.settings.token_presence_penalty != 0.0
                   for j in jobs)

    def _prefill_forward(self, ids: np.ndarray, bt: np.ndarray,
                         pos: np.ndarray, lens: np.ndarray,
                         draft: bool = True, embeds=None, rope=None):
        """One prefill forward that fills the cache (and the draft model's
        cache, unless draft=False); its logits are never used, so the head
        is skipped. ids [B, T], bt [B, P], pos and lens [B] (the real tokens
        of each row) go up as one int32 buffer. The steps are those the
        reference compiles, keyed as it keys them, the batch last (jax.jit
        keys it by shape): ("prefill", T, P, B), with `embeds`
        ("prefill_mm", T, P, with_rope, B), and the draft model's own
        ("dprefill", T, P, B). `embeds` [B, T, d] (a device tensor)
        replaces the main model's embedding lookup and `rope` = (sin, cos)
        [B, T, rot/2] numpy its rope gather (multimodal and MRoPE prompts;
        the main model then reads no id); both are static inputs of the
        step. For an MoE model the rows' pad tokens route nowhere, and the
        return is a copy of the forward's dropped-route count (an int32
        device scalar), else None."""
        b, t = ids.shape
        p = bt.shape[1]
        with profiling.span("dyn.prefill") as rec:
            if rec.on:
                rec.count(rows=int(lens.sum()), rows_computed=b * t)
            buf = torch.from_numpy(np.concatenate(
                [ids.ravel(), bt.ravel(), pos, lens]).astype(np.int32))
            if embeds is None:
                dropped = self._run(("prefill", t, p, b),
                                    DynamicGenerator._prefill_fn, buf)
            else:
                rows = () if rope is None else tuple(
                    map(torch.from_numpy, rope))
                dropped = self._run(("prefill_mm", t, p, rope is not None, b),
                                    DynamicGenerator._prefill_mm_fn, buf,
                                    embeds, *rows)
            if dropped is not None:
                dropped = dropped.clone()   # the next replay overwrites it
            if draft and self.draft_model is not None:
                self._run(("dprefill", t, p, b),
                          DynamicGenerator._dprefill_fn, buf)
            return dropped

    @staticmethod
    def _prefill_views(buf: torch.Tensor, t: int, p: int, b: int):
        """The device views of a _prefill_forward buffer: (ids [b, t],
        block tables [b, p], positions [b], lens [b])."""
        ids, bt, pos, lens = buf.split([b * t, b * p, b, b])
        return ids.view(b, t), bt.view(b, p), pos, lens

    def _prefill_fn(self, t, p, b, buf):
        """The prefill of key ("prefill", t, p, b) on the inputs `buf` ->
        the dropped-route count of an MoE model, else None."""
        return self._prefill_body(*self._prefill_views(buf, t, p, b))

    def _prefill_mm_fn(self, t, p, with_rope, b, buf, embeds, *rope):
        """The prefill of key ("prefill_mm", t, p, with_rope, b): the
        embedding rows `embeds` in place of the lookup, and with_rope the
        (sin, cos) rows in place of the rope gather."""
        ids, bt, pos, lens = self._prefill_views(buf, t, p, b)
        return self._prefill_body(torch.zeros_like(ids), bt, pos, lens,
                                  embeds, rope if with_rope else None)

    def _dprefill_fn(self, t, p, b, buf):
        """The draft model's prefill of key ("dprefill", t, p, b)."""
        ids, bt, pos, _ = self._prefill_views(buf, t, p, b)
        model_forward_paged(self.draft_model.weights, self.draft_model.static,
                            ids, self.draft_cache, bt, pos,
                            last_token_only=True, with_logits=False)

    def _prefill_body(self, ids, bt, pos, lens, embeds=None, rope=None):
        """The main model's prefill forward; an MoE model's validity mask
        (column < lens) is made on the device from lens, and the routes its
        capacity dispatch drops are summed over the layers there (the
        module globals of models/forward.py hold them only while the
        forward runs)."""
        moe = bool(self.model.static.num_experts)
        if moe:
            valid = torch.arange(ids.shape[1], device=ids.device)[None] \
                < lens[:, None]
            F._MOE_STATS[0] = []
            F._MOE_VALID[0] = valid.reshape(-1)
        try:
            model_forward_paged(
                self.model.weights, self.model.static, ids, self.cache, bt,
                pos, last_token_only=True, input_embeds=embeds,
                rope_rows=rope, with_logits=False)
            if not moe:
                return None
            parts = F._MOE_STATS[0]
            return sum(parts) if parts else torch.zeros(
                (), dtype=torch.int32, device=ids.device)
        finally:
            F._MOE_STATS[0] = None
            F._MOE_VALID[0] = None

    @staticmethod
    def _block_table(pages: list[CachePage], width: int) -> np.ndarray:
        bt = np.zeros((width,), np.int32)     # null page padding
        for i, p in enumerate(pages):
            bt[i] = p.index
        return bt

    def _next_chunk_span(self, job: DynamicJob, stream2: bool = False):
        """(pos, end) of the job's next page-aligned prefill chunk (of its
        CFG stream with stream2)."""
        if stream2:
            pos, plen = job.kv_pos2, len(job.negative_ids)
        else:
            pos, plen = job.kv_pos, job.prompt_len
        end = min(pos + self.max_chunk_size, plen - 1)
        if end < plen - 1:
            end = (end // self.page_size) * self.page_size
            if end <= pos:
                end = min(pos + self.max_chunk_size, plen - 1)
        return pos, end

    def _prefill_chunk_batch(self, jobs: list[DynamicJob]):
        """One batched prefill forward over several jobs' next chunks
        (padded to shared t/p buckets; pad rows write into the null page,
        pad columns of a short job land in the null page through its
        zero-padded block table)."""
        chunks = []
        for job in jobs:
            pos, end = self._next_chunk_span(job)
            if end - pos > 0:
                chunks.append((job, pos, end))
        if not chunks:
            return
        if len(chunks) == 1:
            self._prefill_chunk(chunks[0][0])
            return
        b_bucket = _bucket(len(chunks), 1)
        t_bucket = _bucket(max(e - p for _, p, e in chunks), 16)
        ps = self.page_size
        # the table must cover pos + t_bucket for EVERY row, so a short
        # job's pad positions resolve to null-page columns
        p_need = max(max(len(j.pages) for j, _, _ in chunks),
                     max((p + t_bucket - 1) // ps + 1 for _, p, _ in chunks))
        p_bucket = _bucket(p_need, 2)
        ids = np.zeros((b_bucket, t_bucket), np.int32)
        bt = np.zeros((b_bucket, p_bucket), np.int32)
        pos_a = np.zeros((b_bucket,), np.int32)
        lens = np.zeros((b_bucket,), np.int32)
        for i, (job, pos, end) in enumerate(chunks):
            ids[i, :end - pos] = job.prompt_ids[pos:end]
            bt[i] = self._block_table(job.pages, p_bucket)
            pos_a[i] = pos
            lens[i] = end - pos
        dropped = self._prefill_forward(ids, bt, pos_a, lens)
        if dropped is not None:
            # a batch's count is not one job's: folded when read
            self._moe_drop_batch.append(dropped)
        for job, pos, end in chunks:
            job.kv_pos = end
            self._update_page_fill(job)

    def _prefill_chunk(self, job: DynamicJob, stream2: bool = False):
        """The job's next prefill chunk, of its CFG stream with stream2
        (which the draft model does not see)."""
        pos, end = self._next_chunk_span(job, stream2)
        t = end - pos
        if t <= 0:
            return
        ids, pages = ((job.negative_ids, job.pages2) if stream2
                      else (job.prompt_ids, job.pages))
        t_bucket = _bucket(t, 16)
        p_bucket = _bucket(len(pages), 2)
        chunk = np.zeros((1, t_bucket), np.int32)
        chunk[0, :t] = ids[pos:end]
        bt = self._block_table(pages, p_bucket)[None]
        embeds = rope = None
        if not stream2 and (job.mrope_rows is not None or (
                job.embeddings and (chunk >= EMBEDDING_INDEX).any())):
            embeds = self._chunk_embeds(job, chunk[0])
            if job.mrope_rows is not None:
                # pad columns rotate by nothing: sin 0, cos 1
                rot = job.mrope_rows[0].shape[-1]
                rope = (np.zeros((1, t_bucket, rot), np.float32),
                        np.ones((1, t_bucket, rot), np.float32))
                for r, rows in zip(rope, job.mrope_rows):
                    r[0, :t] = rows[pos:end]
        dropped = self._prefill_forward(
            chunk, bt, np.asarray([pos], np.int32),
            np.asarray([t], np.int32),
            draft=not stream2 and not job.embeddings, embeds=embeds,
            rope=rope)
        if dropped is not None:
            job._moe_drop_parts.append(dropped)
        if stream2:
            job.kv_pos2 = end
        else:
            job.kv_pos = end
            self._update_page_fill(job)

    def _chunk_embeds(self, job: DynamicJob, chunk_ids: np.ndarray):
        """Embedding rows [1, T, d] of a prefill chunk: one gather of the
        embedding table (embedding ids read as 0), then each embedding's
        rows copied over its positions, on the device."""
        ids = np.asarray(chunk_ids, np.int64)
        x = self.model.weights.embed[self._dev(
            np.where(ids >= EMBEDDING_INDEX, 0, ids))]
        for e in job.embeddings:
            sel = np.nonzero((ids >= e.first_index)
                             & (ids < e.first_index + e.length))[0]
            if sel.size:
                rows = e.embeddings[self._dev(ids[sel] - e.first_index)]
                x.index_copy_(0, self._dev(sel),
                              rows.to(self.device, x.dtype))
        return x[None]

    def _update_page_fill(self, job: DynamicJob):
        """Track per-page fill; hash pages as they fill."""
        for i, page in enumerate(job.pages):
            fill = min(max(job.kv_pos - i * self.page_size, 0),
                       self.page_size)
            if fill > page.kv_position and page.ref_count >= 1:
                page.kv_position = fill
            if (fill == self.page_size and page.phash is None
                    and (i + 1) * self.page_size <= len(job.sequence)):
                prev = job.pages[i - 1].phash if i > 0 else b""
                if i > 0 and prev is None:
                    continue
                chunk = job.sequence[i * self.page_size:
                                     (i + 1) * self.page_size]
                h = _HASH((prev or b"") + np.asarray(
                    chunk, np.int32).tobytes())
                if h not in self.referenced and h not in self.unreferenced:
                    page.phash = h
                    page.prev_hash = prev or None
                    page.tokens = np.asarray(chunk, np.int32).copy()
                    self.referenced[h] = page

    def _rewind_pages(self, job: DynamicJob) -> bool:
        """After a banned-string rewind, fix up pages whose fill dropped.

        A page published as full (phash in referenced/unreferenced) may no
        longer match its hash once kv_pos moves back across its boundary:
        unpublish it so dedup cannot attach stale KV. If another job shares
        it, this job gets a private copy instead (the shared KV must not be
        overwritten by the re-generation).

        Returns False when a needed private copy could not be made (no free
        or evictable page anywhere): the rewound history is already applied,
        so the caller defers decoding this job and retries -- writing at
        kv_pos inside the still-shared page would corrupt the other jobs'
        KV."""
        ok = True
        for i, page in enumerate(job.pages):
            fill = min(max(job.kv_pos - i * self.page_size, 0),
                       self.page_size)
            if page.phash is not None and fill < self.page_size:
                if page.ref_count > 1:
                    fresh = self._take_free_page()
                    if fresh is None:
                        # defer: leave the page shared and untouched; the
                        # job sits out decode until a page frees up
                        ok = False
                        continue
                    self._copy_pages([page.index], [fresh.index])
                    page.ref_count -= 1
                    fresh.ref_count = 1
                    fresh.kv_position = fill
                    self._touch(fresh)
                    job.pages[i] = fresh
                    continue
                self.referenced.pop(page.phash, None)
                self.unreferenced.pop(page.phash, None)
                page.phash = None
                page.prev_hash = None
                page.tokens = None
            if fill < page.kv_position and page.ref_count <= 1:
                page.kv_position = fill
        job.rewind_deferred = not ok
        return ok

    def _step(self, bts, seqlens, slots, offs, params, use_pen: bool,
              use_dry: bool, biased: bool, lf=None):
        """One decode step on the device: the token at hist[slot, seqlen]
        of every row, at rope position seqlen + offs -> (raw logits,
        filtered logits, tokens, probs, mu); the sampled token is written to
        hist[slot, seqlen + 1]."""
        pos = seqlens.long()
        ids = self.hist[slots, pos][:, None]                    # [B, 1]
        logits, _ = model_forward_paged(
            self.model.weights, self.model.static, ids, self.cache, bts,
            seqlens, last_token_only=True, pos_offsets=offs)
        raw = lg = logits[:, -1, :]
        if biased:
            lg = lg + self._bias_pool[slots]
        hist_rows = self.hist[slots]
        if use_pen:
            lg = apply_penalties(lg, hist_rows, seqlens + 1, params)
        if use_dry:
            lg = apply_dry(lg, hist_rows, seqlens + 1, params.dry_multiplier,
                           params.dry_base, params.dry_allowed_length,
                           params.dry_range, params.dry_breakers)
        toks, probs, mu = sample(lg, params, generator=self._rng,
                                 logit_filter=lf)
        self.hist[slots, pos + 1] = toks
        return raw, lg, toks, probs, mu

    def _step_inputs(self, jobs: list[DynamicJob], b: int, p: int,
                     masks) -> torch.Tensor:
        """A step's host inputs in one int32 buffer, uploaded at once (into
        the key's static buffer when the step is a graph): block tables
        [b, p], seqlens [b], slots [b], MRoPE offsets [b], the sampler
        rows (f32 as their bits, bools as 0 / 1) and, when `masks` is given,
        the allow-masks packed eight tokens a byte. Pad rows point at the
        dummy history slot and the null page, take offset 0 and sample
        greedily."""
        bts = np.zeros((b, p), np.int32)
        seqlens = np.zeros((b,), np.int32)
        slots = np.full((b,), self.num_slots, np.int32)         # dummy slot
        offs = np.zeros((b,), np.int32)
        for i, job in enumerate(jobs):
            bts[i] = self._block_table(job.pages, p)
            seqlens[i] = job.kv_pos
            slots[i] = job.slot
            offs[i] = job.mrope_offset
        extra = []
        if masks is not None:
            vocab = self.model.static.vocab_size
            allow = np.ones((b, vocab), bool)
            for i, m in enumerate(masks):
                if m is not None:
                    allow[i] = m
            packed = np.packbits(allow, axis=1, bitorder="little")
            packed = np.pad(packed, ((0, 0), (0, -packed.shape[1] % 4)))
            extra.append(packed.view(np.int32).ravel())
        return self._pack_inputs(bts, seqlens, slots, offs, jobs, b, *extra)

    @staticmethod
    def _pack_inputs(bts, seqlens, slots, offs, jobs, n: int, *extra
                     ) -> torch.Tensor:
        """Block tables, seqlens, slots, MRoPE offsets, the sampler rows of
        `jobs` padded to n greedy rows (f32 as their bits, bools as 0 / 1)
        and `extra` int32 arrays, as one int32 host buffer."""
        sett = [j.settings for j in jobs] + \
            [Settings.greedy()] * (n - len(jobs))
        mus = [j.mirostat_mu for j in jobs] + [0.0] * (n - len(jobs))
        f, i32, bl = settings_rows(sett, mus)
        return torch.from_numpy(np.concatenate(
            [bts.ravel(), seqlens, slots, offs, f.view(np.int32).ravel(),
             i32.ravel(), bl.astype(np.int32).ravel(), *extra]))

    @staticmethod
    def _views(buf: torch.Tensor, b: int, p: int, n: int | None = None):
        """The device views of a _pack_inputs buffer of b rows and n sampler
        rows (default b): (block tables, seqlens, slots, MRoPE offsets,
        SamplingParams, the extra int32 words)."""
        n = b if n is None else n
        sizes = [b * p, b, b, b, ROWS[0] * n, ROWS[1] * n, ROWS[2] * n]
        sizes.append(buf.numel() - sum(sizes))
        parts = buf.split(sizes)
        params = params_from_rows(
            parts[4].view(torch.float32).view(ROWS[0], n),
            parts[5].view(ROWS[1], n), parts[6].view(ROWS[2], n) != 0)
        return parts[0].view(b, p), parts[1], parts[2].long(), parts[3], \
            params, parts[7]

    def _step_views(self, buf: torch.Tensor, b: int, p: int, masked: bool):
        """The device views of a _step_inputs buffer: (block tables,
        seqlens, slots, MRoPE offsets, SamplingParams, allow-mask or
        None)."""
        bts, seqlens, slots, offs, params, rest = self._views(buf, b, p)
        lf = None
        if masked:
            packed = rest.view(b, -1).view(torch.uint8)
            lf = unpack_mask(packed, self.model.static.vocab_size)
        return bts, seqlens, slots, offs, params, lf

    def _decode_fn(self, b, p, masked, use_dry, biased, topk, ret_logits,
                   use_pen, buf):
        """The decode step of key ("decode", b, p, masked, use_dry, biased,
        topk, ret_logits, use_pen) on the inputs `buf` -> [tokens, probs,
        mu] f32 [3, b] (+ top-k ids and probs [b, topk], + raw logits)."""
        bts, seqlens, slots, offs, params, lf = self._step_views(
            buf, b, p, masked)
        raw, lg, toks, probs, mu = self._step(bts, seqlens, slots, offs,
                                              params, use_pen, use_dry,
                                              biased, lf)
        outs = [torch.stack([toks.float(), probs, mu])]
        if topk:
            dist = torch.softmax(
                lg.masked_fill(~lf, -torch.inf) if lf is not None else lg,
                dim=-1)
            tp, tt = torch.sort(dist, dim=-1, descending=True, stable=True)
            outs += [tt[:, :topk], tp[:, :topk]]
        if ret_logits:
            outs.append(raw.float())
        return outs

    def _burst_fn(self, b, p, k, use_dry, biased, use_pen, buf):
        """k decode steps of key ("decode_burst", b, p, k, use_dry, biased,
        use_pen): each sampled token feeds the next step through the device
        history (the MRoPE offsets stay as seqlens advance), mirostat's mu
        is carried from step to step -> [tokens [k], probs [k], mu] f32
        [2k + 1, b]."""
        bts, seqlens, slots, offs, params, _ = self._step_views(
            buf, b, p, False)
        toks_k, probs_k = [], []
        for i in range(k):
            _, _, toks, probs, mu = self._step(
                bts, seqlens + i, slots, offs, params, use_pen, use_dry,
                biased)
            params = dataclasses.replace(params, mirostat_mu=mu)
            toks_k.append(toks.float())
            probs_k.append(probs)
        return torch.cat([torch.stack(toks_k), torch.stack(probs_k),
                          mu[None]])

    def _run(self, key: tuple, method, *args: torch.Tensor):
        """method(self, *key[1:], *args) on the inputs `args` (host or
        device tensors): the key's step graph replayed, or with graphs off
        the step run eagerly on the inputs moved to the device. The runner
        keeps the step function for the life of its graph, so the function
        holds this generator weakly: a strong reference would be a cycle
        that only the cyclic collector frees, and a CUDA graph destroyed
        while any capture is under way voids that capture. A graph reads
        the weights of its capture, so new weights drop every graph. The
        prefill keys (PREFILL_KEYS) go to a runner of their own, which
        shares the decode runner's memory pool: they never push out the
        decode graphs a round replays."""
        if self.step_graphs is not None:
            served = (self.model.weights, self.draft_model.weights
                      if self.draft_model is not None else None)
            if tuple(r() if r else None for r in self._graphed_weights) \
                    != served:
                self._drop_graphs()
                self._graphed_weights = tuple(
                    weakref.ref(w) if w is not None else None
                    for w in served)
            runner = self.prefill_graphs if key[0] in PREFILL_KEYS \
                else self.step_graphs
            fn = functools.partial(method, weakref.proxy(self), *key[1:])
            return runner(key, fn, *args)
        return method(self, *key[1:], *(a.to(self.device) for a in args))

    def _drop_graphs(self) -> None:
        """Forget every step and prefill graph (new weights)."""
        for runner in (self.step_graphs, self.prefill_graphs):
            if runner is not None:
                runner.drop(lambda k: True)

    def _decode(self, jobs: list[DynamicJob], results: list[dict]):
        b = len(jobs)
        b_bucket = _bucket(b, 1)
        p_bucket = _bucket(max(len(j.pages) for j in jobs), 2)

        # per-job logit masks (filters, healing, EOS floor, banned tokens)
        vocab = self.model.static.vocab_size
        masks = [self._job_mask(j, vocab) for j in jobs]
        any_masked = any(m is not None for m in masks)
        use_dry = any(j.settings.dry_multiplier > 0 for j in jobs)
        use_pen = self._needs_penalties(jobs)
        biased = self._bias_pool is not None and any(
            j.settings.token_bias is not None for j in jobs)
        topk = max((j.return_top_tokens for j in jobs), default=0)
        topk = _bucket(topk, 4) if topk else 0
        ret_logits = any(j.return_logits for j in jobs)
        buf = self._step_inputs(jobs, b_bucket, p_bucket,
                                masks if any_masked else None)

        # ---- burst: k tokens per readback, when no job needs per-step host
        # work (masks, top-k, logits, banned-string rewinds) and every job
        # has room for k rows in its own pages. Pending jobs force k = 1 so
        # a new job's first token does not wait behind a burst. A job with a
        # LIVE filter decodes per token even when this step's mask is None:
        # an external filter may be unconstrained on one step and constrain
        # the next while is_completed() stays False.
        live_filters = any(
            not f.is_completed() for j in jobs for f in j.filters)
        burst_limit = self._burst_limit()
        if (burst_limit > 1 and not any_masked and not topk
                and not ret_logits and not self.pending
                and not live_filters
                and not any(j.banned_strings for j in jobs)):
            room = min(
                min(j.max_new_tokens - j.new_tokens for j in jobs),
                min(len(j.pages) * self.page_size - j.kv_pos for j in jobs),
                self.max_seq_len - max(j.kv_pos for j in jobs))
            k = 1
            while k * 2 <= min(burst_limit, room):
                k *= 2
            if k > 1:
                t_disp = time.perf_counter()
                key = ("decode_burst", b_bucket, p_bucket, k, use_dry,
                       biased, use_pen)
                out = self._run(key, DynamicGenerator._burst_fn, buf)
                with profiling.span("dyn.readback"):
                    host = out.cpu().numpy()
                toks_h, probs_h, mu_h = host[:k], host[k:2 * k], host[2 * k]
                now = time.perf_counter()
                with profiling.span("dyn.emit"):
                    for i, job in enumerate(jobs):
                        job.mirostat_mu = float(mu_h[i])
                    for step in range(k):
                        # per-token times are not observable inside a
                        # burst; spread the dispatch interval evenly
                        t_step = t_disp + (now - t_disp) * (step + 1) / k
                        for i, job in enumerate(jobs):
                            if job.status == "done":
                                continue   # mid-burst stop: rows wasted
                            job.last_prob = float(probs_h[step, i])
                            self._accept(job, int(toks_h[step, i]), t_step,
                                         results)
                return

        key = ("decode", b_bucket, p_bucket, any_masked, use_dry, biased,
               topk, ret_logits, use_pen)
        outs = self._run(key, DynamicGenerator._decode_fn, buf)
        with profiling.span("dyn.readback"):
            toks_h, probs_h, mu_h = outs[0].cpu().numpy()
            tt_h = tp_h = lg_h = None
            if topk:
                tt_h, tp_h = outs[1].cpu().numpy(), outs[2].cpu().numpy()
            if ret_logits:
                lg_h = outs[-1].cpu().numpy()
        now = time.perf_counter()
        with profiling.span("dyn.emit"):
            for i, job in enumerate(jobs):
                job.mirostat_mu = float(mu_h[i])
                job.last_prob = float(probs_h[i])
                if tt_h is not None and job.return_top_tokens:
                    k = job.return_top_tokens
                    job.last_top = (tt_h[i, :k].copy(), tp_h[i, :k].copy())
                job.last_logits = lg_h[i].copy() if (
                    lg_h is not None and job.return_logits) else None
                self._accept(job, int(toks_h[i]), now, results)

    def _accept(self, job: DynamicJob, tok: int, now: float,
                results: list[dict]):
        """Append one sampled token to a job and emit it."""
        job.kv_pos += 1
        job.sequence = np.append(job.sequence, np.int32(tok))
        job.new_tokens += 1
        if job.new_tokens == 1:
            job.time_first_token = now
            self._note_ttft(job)
        job.time_last_token = now
        self._update_page_fill(job)
        self._emit(job, tok, results)

    # ------------------------------------------------------------------
    # CFG
    # ------------------------------------------------------------------

    def _cfg_fn(self, rows, p, buf):
        """The paired decode step of key ("decode_cfg", rows, p): rows
        2i / 2i + 1 are job i's conditional and unconditional streams; the
        mix s * cond + (1 - s) * uncond of their log-probabilities, with
        the penalties over the conditional history, is sampled once a job
        and written to both streams' history -> [tokens, probs, mu] f32
        [3, rows / 2]. The scales are the buffer's last rows / 2 words. The
        conditional rows take their job's MRoPE offset, the unconditional
        (text-only) rows 0; the reference's paired step passes no offsets
        and decodes an image job's conditional stream at its cache
        positions (ROADMAP.md, section 3)."""
        n = rows // 2
        bts, seqlens, slots, offs, params, scale = self._views(
            buf, rows, p, n)
        scale = scale.view(torch.float32)[:, None]
        pos = seqlens.long()
        ids = self.hist[slots, pos][:, None]
        logits, _ = model_forward_paged(
            self.model.weights, self.model.static, ids, self.cache, bts,
            seqlens, last_token_only=True, pos_offsets=offs)
        lsm = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
        mixed = scale * lsm[0::2] + (1.0 - scale) * lsm[1::2]
        mixed = apply_penalties(mixed, self.hist[slots[0::2]],
                                seqlens[0::2] + 1, params)
        toks, probs, mu = sample(mixed, params, generator=self._rng)
        self.hist[slots, pos + 1] = toks.repeat_interleave(2)
        return torch.stack([toks.float(), probs, mu])

    def _decode_cfg(self, jobs: list[DynamicJob], results: list[dict]):
        n = len(jobs)
        n_bucket = _bucket(n, 1)
        rows = 2 * n_bucket
        p_bucket = _bucket(max(max(len(j.pages), len(j.pages2))
                               for j in jobs), 2)
        bts = np.zeros((rows, p_bucket), np.int32)
        seqlens = np.zeros((rows,), np.int32)
        slots = np.full((rows,), self.num_slots, np.int32)
        offs = np.zeros((rows,), np.int32)
        scales = np.ones((n_bucket,), np.float32)
        for i, job in enumerate(jobs):
            offs[2 * i] = job.mrope_offset
            bts[2 * i] = self._block_table(job.pages, p_bucket)
            bts[2 * i + 1] = self._block_table(job.pages2, p_bucket)
            seqlens[2 * i], seqlens[2 * i + 1] = job.kv_pos, job.kv_pos2
            slots[2 * i], slots[2 * i + 1] = job.slot, job.slot2
            scales[i] = job.settings.cfg_scale
        buf = self._pack_inputs(bts, seqlens, slots, offs, jobs, n_bucket,
                                scales.view(np.int32))
        out = self._run(("decode_cfg", rows, p_bucket),
                        DynamicGenerator._cfg_fn, buf)
        with profiling.span("dyn.readback"):
            toks_h, probs_h, mu_h = out.cpu().numpy()
        now = time.perf_counter()
        with profiling.span("dyn.emit"):
            for i, job in enumerate(jobs):
                job.mirostat_mu = float(mu_h[i])
                job.last_prob = float(probs_h[i])
                job.kv_pos2 += 1
                self._accept(job, int(toks_h[i]), now, results)

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------

    def _draft_fn(self, b, p, k, buf):
        """k greedy t = 1 steps of the draft model, key ("draft", b, p, k):
        the first input is hist[slot, seqlen] of each row, each step's
        argmax the next -> drafts int32 [b, k]. Writes the draft cache's
        rows seqlen .. seqlen + k - 1."""
        bts, seqlens, slots, _, _, _ = self._views(buf, b, p)
        dm = self.draft_model
        ids = self.hist[slots, seqlens.long()][:, None]
        drafts = []
        for i in range(k):
            logits, _ = model_forward_paged(
                dm.weights, dm.static, ids, self.draft_cache, bts,
                seqlens + i, last_token_only=True)
            ids = torch.argmax(logits[:, -1, :], dim=-1).to(
                torch.int32)[:, None]
            drafts.append(ids)
        return torch.cat(drafts, dim=1)

    def _verify_fn(self, b, p, d, buf, drafts):
        """The verify step of key ("verify", b, p, d): one t = d + 1
        forward of hist[slot, seqlen] and the d drafts (-1 = no draft, fed
        as 0, never matched), the penalties of the pre-draft context at
        every position, a sample at every position; draft j is accepted
        when it and every draft before it equal the samples. The d + 1
        samples go to hist[slot, seqlen + 1 ..] -> int32 [b, d + 2]: the
        samples, then the accepted count."""
        bts, seqlens, slots, offs, params, _ = self._views(buf, b, p)
        pos = seqlens.long()
        t0 = self.hist[slots, pos][:, None]
        ids = torch.cat([t0, drafts.clamp(min=0)], dim=1)
        logits, _ = model_forward_paged(
            self.model.weights, self.model.static, ids, self.cache, bts,
            seqlens, pos_offsets=offs)
        lg = logits.reshape(b * (d + 1), -1)
        rep = functools.partial(torch.repeat_interleave, repeats=d + 1,
                                dim=0)
        params_r = type(params)(**{f.name: rep(getattr(params, f.name))
                                   for f in dataclasses.fields(params)})
        lg = apply_penalties(lg, rep(self.hist[slots]), rep(seqlens + 1),
                             params_r)
        toks, _, _ = sample(lg, params_r, generator=self._rng)
        toks = toks.reshape(b, d + 1)
        match = (toks[:, :d] == drafts).to(torch.int32)
        accepts = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        off = torch.arange(d + 1, device=pos.device)
        self.hist[slots[:, None], pos[:, None] + 1 + off] = toks
        return torch.cat([toks, accepts[:, None]], dim=1)

    def _decode_spec(self, jobs: list[DynamicJob], results: list[dict]):
        """One speculative round: d drafts a job (the n-gram tables on the
        host, or the draft step), verified in one forward."""
        d = self.num_draft_tokens
        b_bucket = _bucket(len(jobs), 1)
        p_bucket = _bucket(max(len(j.pages) for j in jobs), 2)
        buf = self._step_inputs(jobs, b_bucket, p_bucket, None)
        if self.use_ngram_draft:
            drafts = np.full((b_bucket, d), -1, np.int32)
            for i, job in enumerate(jobs):
                self.ngram.update(id(job), job.sequence)
                dr = self.ngram.draft(id(job), job.sequence, d)
                drafts[i, :len(dr)] = dr
            drafts = torch.from_numpy(drafts)
        else:
            drafts = self._run(("draft", b_bucket, p_bucket, d),
                               DynamicGenerator._draft_fn, buf)
        out = self._run(("verify", b_bucket, p_bucket, d),
                        DynamicGenerator._verify_fn, buf, drafts)
        with profiling.span("dyn.readback"):
            out = out.cpu().numpy()
        now = time.perf_counter()
        with profiling.span("dyn.emit"):
            for i, job in enumerate(jobs):
                n_new = min(int(out[i, d + 1]) + 1,
                            job.max_new_tokens - job.new_tokens)
                job.draft_accepted += n_new - 1
                for j in range(n_new):
                    self._accept(job, int(out[i, j]), now, results)
                    if job.status == "done":
                        break
                if self.ngram is not None:
                    if job.status == "done":
                        self.ngram.reset(id(job))
                    else:
                        self.ngram.update(id(job), job.sequence)

    # ------------------------------------------------------------------
    # iterate
    # ------------------------------------------------------------------

    @torch.no_grad()
    def iterate(self) -> list[dict]:
        with profiling.span("dyn.iterate"):
            return self._iterate()

    def _iterate(self) -> list[dict]:
        results: list[dict] = []

        # admit pending jobs. A job accrues a skip only when a LATER job is
        # admitted ahead of it; once a job exhausts max_skips the queue
        # stalls so it is guaranteed to start next (jobs are never killed)
        with profiling.span("dyn.admit"):
            still = []
            stalled = False
            for job in self.pending:
                if not stalled and self._try_start(job):
                    for passed in still:
                        if passed.max_skips is not None:
                            passed.skips += 1
                    continue
                still.append(job)
                if job.max_skips is not None and job.skips >= job.max_skips:
                    stalled = True
            self.pending = still

        # prefill round: plain jobs batch into one forward per group of
        # max_batch_size (a lone job takes the single-job path); CFG jobs
        # take the single-job path for each stream, and so do multimodal
        # and MRoPE jobs
        prefilling = [j for j in self.active if j.status == "prefill"]
        plain = [j for j in prefilling
                 if not (j.embeddings or j.mrope_rows is not None
                         or j.is_cfg)]
        batched = set()
        if len(plain) >= 2:
            batched = set(map(id, plain))
            for i in range(0, len(plain), self.max_batch_size):
                self._prefill_chunk_batch(plain[i:i + self.max_batch_size])
        for job in prefilling:
            if id(job) not in batched:
                self._prefill_chunk(job)
                if job.is_cfg and job.kv_pos2 < len(job.negative_ids) - 1:
                    self._prefill_chunk(job, stream2=True)
            if job.kv_pos >= job.prompt_len - 1 and (
                    not job.is_cfg
                    or job.kv_pos2 >= len(job.negative_ids) - 1):
                job.status = "generating"
            else:
                results.append({
                    "job": job, "stage": "prefill", "eos": False,
                    "curr_progress": job.kv_pos,
                    "max_progress": job.prompt_len - 1,
                    "serial": id(job)})

        # retry deferred banned-string rewinds (a shared page needed a
        # private copy but none was free); still-deferred jobs sit out this
        # round's decode so the shared KV is never overwritten
        for job in self.active:
            if job.rewind_deferred:
                self._rewind_pages(job)

        # forward-progress guarantee: if EVERY active job sits out on a
        # deferred rewind (each holds shared pages another deferred job
        # needs privately copied), no page can ever free on its own and
        # iterate() would spin forever. Finish the youngest deferred job at
        # its rewound state (its emitted text is valid: the rewind already
        # retracted the banned string) so its pages release and the others
        # retry.
        if self.active and all(j.rewind_deferred for j in self.active):
            victim = max(self.active, key=lambda j: j.time_enqueue)
            victim.rewind_deferred = False
            victim.eos_reason = "rewind_page_starvation"
            victim.status = "done"
            victim.held_text = ""
            r = {"job": victim, "stage": "streaming", "eos": True,
                 "text": "", "token_ids": np.zeros((0,), np.int64),
                 "identifier": victim.identifier, "serial": id(victim)}
            r.update(self._final_stats(victim))
            results.append(r)

        # CFG jobs decode as paired rows in their own batches
        cfg_jobs = [j for j in self.active if j.status == "generating"
                    and j.is_cfg and not j.rewind_deferred]
        n_cfg = max(self.max_batch_size // 2, 1)
        for i in range(0, len(cfg_jobs), n_cfg):
            with profiling.span("dyn.decode"):
                self._decode_cfg(cfg_jobs[i:i + n_cfg], results)

        # batched decode (split into max_batch_size groups; no starvation);
        # speculative rounds for groups that need no per-step masks
        gen_jobs = [j for j in self.active if j.status == "generating"
                    and not j.is_cfg and not j.rewind_deferred]
        spec = self.use_ngram_draft or self.draft_model is not None
        for i in range(0, len(gen_jobs), self.max_batch_size):
            grp = gen_jobs[i:i + self.max_batch_size]
            constrained = any(
                j.filters or j.banned_strings or j.blocked_tokens
                or j.embeddings or j.new_tokens < j.min_new_tokens
                or j.settings.banned_tokens
                or (j.healing_token is not None and j.new_tokens == 0)
                for j in grp)
            with profiling.span("dyn.decode"):
                if spec and not constrained:
                    self._decode_spec(grp, results)
                else:
                    self._decode(grp, results)

        # reap finished jobs
        with profiling.span("dyn.reap"):
            for job in [j for j in self.active if j.status == "done"]:
                self.active.remove(job)
                self._release_job_pages(job)
                if job.slot >= 0:
                    self.free_slots.append(job.slot)
                    job.slot = -1
        return results

    # ------------------------------------------------------------------
    # stop handling / text emission
    # ------------------------------------------------------------------

    def _job_mask(self, job: DynamicJob, vocab: int) -> np.ndarray | None:
        """Combined allow-mask for the next sample, or None if free."""
        allow = None
        if job.healing_token is not None and job.new_tokens == 0:
            pieces = piece_table(self.tokenizer)
            pre = pieces[job.healing_token] \
                if job.healing_token < len(pieces) else ""
            allow = np.zeros(vocab, bool)
            if pre:
                # sorted-prefix binary search: O(log V + matches) instead
                # of scanning the vocabulary
                ids = self.tokenizer.prefix_ids(pre) \
                    if hasattr(self.tokenizer, "prefix_ids") else None
                if ids is not None:
                    ids = ids[ids < vocab]
                    allow[ids] = True
                else:
                    for t, p in enumerate(pieces):
                        if p.startswith(pre):
                            allow[t] = True
            else:
                allow[:] = True
        eos_ids = [t for t in (self.tokenizer.eos_set() | job.stop_tokens)
                   if 0 <= t < vocab]
        if job.new_tokens < job.min_new_tokens and eos_ids:
            # EOS floor: ban stop tokens until min_new_tokens is met
            if allow is None:
                allow = np.ones(vocab, bool)
            allow[eos_ids] = False
        for f in job.filters:
            if f.is_completed():
                continue
            ps, es = f.next()
            if ps is None:
                continue
            # filter_prefer_eos: when a stop token is currently allowed,
            # force it
            if job.filter_prefer_eos and es and any(t in es or t in ps
                                                    for t in eos_ids):
                m = np.zeros(vocab, bool)
                for t in eos_ids:
                    if t in es or t in ps:
                        m[t] = True
                allow = m if allow is None else (allow & m)
                continue
            m = np.zeros(vocab, bool)
            if ps:
                m[np.fromiter((t for t in ps if t < vocab), int,
                              count=-1)] = True
            allow = m if allow is None else (allow & m)
        # in numpy: a settings list may ban most of the vocabulary
        banned = np.asarray(list(job.settings.banned_tokens or [])
                            + list(job.blocked_tokens), np.int64)
        banned = banned[(banned >= 0) & (banned < vocab)]
        if banned.size:
            if allow is None:
                allow = np.ones(vocab, bool)
            allow[banned] = False
        if allow is not None and not allow.any():
            allow[:] = True     # degenerate constraint: fail open
        return allow

    def _emit(self, job: DynamicJob, tok: int, results: list[dict]):
        eos = False
        job.blocked_tokens.clear()          # one-shot rewind blocks
        feed_filters = True
        if job.post_sampling_hooks:
            psr = PostSamplingResult(
                sampled_token=tok,
                sampled_prob=job.last_prob,
                candidate_tokens=job.last_top[0] if job.last_top else None,
                candidate_probs=job.last_top[1] if job.last_top else None)
            for hook in job.post_sampling_hooks:
                hook(psr)
            feed_filters = psr.feed_filters
        if feed_filters:
            for f in job.filters:
                f.feed(tok)
        if tok in job.stop_tokens or tok in self.tokenizer.eos_set():
            eos = True
            job.eos_reason = "stop_token"
            # flush held text minus the stop token itself
            full = self.tokenizer.decode(job.sequence[job.prompt_len:-1])
            new_text = full[len(job.emitted_text):]
            job.held_text = ""
        else:
            full = self.tokenizer.decode(job.sequence[job.prompt_len:])
            # hold back an incomplete UTF-8 fragment: a trailing
            # replacement char re-decodes once the codepoint completes
            while full.endswith("�"):
                full = full[:-1]
            added = full[len(job.emitted_text) + len(job.held_text):]
            held_before = job.held_text
            job.held_text += added
            new_text = ""

            # banned strings: rewind to where the string began and block
            # its first token for one step
            low = job.held_text.lower()
            if any(b in low for b in job.banned_strings):
                ck = job.checkpoint
                if ck is None:
                    # the banned string arrived within a single token:
                    # rewind exactly that token
                    ck = {"seq_len": len(job.sequence) - 1,
                          "kv_pos": job.kv_pos - 1,
                          "new_tokens": job.new_tokens - 1,
                          "held_text": held_before}
                first_tok = int(job.sequence[ck["seq_len"]]) \
                    if len(job.sequence) > ck["seq_len"] else None
                job.sequence = job.sequence[:ck["seq_len"]]
                job.kv_pos = ck["kv_pos"]
                job.new_tokens = ck["new_tokens"]
                job.held_text = ck["held_text"]
                job.checkpoint = None
                self._rewind_pages(job)
                if first_tok is not None:
                    job.blocked_tokens.add(first_tok)
                if self.ngram is not None:
                    self.ngram.reset(id(job))
                results.append({
                    "job": job, "stage": "streaming", "eos": False,
                    "text": "", "token_ids": np.asarray([], np.int32),
                    "identifier": job.identifier, "serial": id(job)})
                return

            stopped_at = None
            if job.stop_strings:
                pos, _ = find_first_match(job.held_text, job.stop_strings)
                if pos >= 0:
                    stopped_at = pos
            if stopped_at is not None:
                new_text = job.held_text[:stopped_at]
                job.held_text = ""
                eos = True
                job.eos_reason = "stop_string"
            else:
                # hold back any suffix that prefixes a stop or banned string
                hold = max_partial_overlap(job.held_text, job.stop_strings) \
                    if job.stop_strings else 0
                hold_banned = max_partial_overlap(low, job.banned_strings) \
                    if job.banned_strings else 0
                was_held = hold_banned > 0
                hold = max(hold, hold_banned)
                if was_held and job.checkpoint is None:
                    job.checkpoint = {
                        "seq_len": len(job.sequence) - 1,
                        "kv_pos": job.kv_pos - 1,
                        "new_tokens": job.new_tokens - 1,
                        "held_text": held_before,
                    }
                elif not was_held:
                    job.checkpoint = None
                release = len(job.held_text) - hold
                if release > 0:
                    new_text = job.held_text[:release]
                    job.held_text = job.held_text[release:]

            # constrained region completed (SelectFilter end)
            if not eos and job.filters and \
                    all(f.is_completed() for f in job.filters):
                nxt = [f.next() for f in job.filters]
                if any(ps is not None and len(ps) == 0 for ps, _ in nxt):
                    eos = True
                    job.eos_reason = "end_filter"
                    new_text += job.held_text
                    job.held_text = ""

        if not eos and job.new_tokens >= job.max_new_tokens:
            eos = True
            job.eos_reason = "max_new_tokens"
            # flush everything, including a held-back UTF-8 fragment
            full = self.tokenizer.decode(job.sequence[job.prompt_len:])
            new_text = full[len(job.emitted_text):]
            job.held_text = ""

        job.emitted_text += new_text
        r = {"job": job, "stage": "streaming", "eos": eos,
             "text": new_text, "token_ids": np.asarray([tok]),
             "identifier": job.identifier, "serial": id(job)}
        if job.return_probs and job.last_prob is not None:
            r["token_probs"] = np.asarray([job.last_prob], np.float32)
        if job.return_top_tokens and job.last_top is not None:
            r["top_k_tokens"] = job.last_top[0][None]
            r["top_k_probs"] = job.last_top[1][None]
        if job.return_logits and job.last_logits is not None:
            r["logits"] = job.last_logits[None]
        if eos:
            job.status = "done"
            r.update(self._final_stats(job))
        results.append(r)

    def _final_stats(self, job: DynamicJob) -> dict:
        """The fields a job's last result carries; its dropped MoE routes,
        where its prefill dropped any, are read back and counted."""
        t_gen = max(job.time_last_token - job.time_first_token, 1e-9)
        out = {
            "eos_reason": job.eos_reason,
            "full_completion": job.emitted_text,
            "new_tokens": job.new_tokens,
            "prompt_tokens": job.prompt_len,
            "cached_tokens": job.reused_tokens,
            "time_enqueued": job.time_admitted - job.time_enqueue,
            "time_prefill": job.time_first_token - job.time_admitted,
            "time_generate": t_gen,
            "tokens_per_second": (job.new_tokens - 1) / t_gen
            if job.new_tokens > 1 else 0.0,
        }
        if job._moe_drop_parts:
            nd = self._fold_drops(job)
            out["moe_dropped_tokens"] = nd
            self._moe_dropped_host += nd
        return out

    # ------------------------------------------------------------------
    # convenience API
    # ------------------------------------------------------------------

    def generate(self, prompt, max_new_tokens: int = 128,
                 settings: Settings | None = None, seed: int = 0,
                 stop_conditions=None, add_bos: bool | None = None,
                 completion_only: bool = True, embeddings: list | None = None,
                 encode_special_tokens: bool = False,
                 negative_prompt_ids=None):
        """Generate for one prompt (str or ids) or a list of them, all
        enqueued at once -> completion text(s). negative_prompt_ids (ids,
        or a list of them, one a prompt) makes CFG jobs when the settings
        carry a cfg_scale; the speculative options are the generator's.
        `embeddings` (MMEmbeddings) go with every job, and a str prompt's
        aliases of them become their token ids."""
        if add_bos is None:
            # the architecture decides (BOS-trained Llama / Gemma families)
            cfg = getattr(self.model, "config", None)
            add_bos = bool(cfg is not None
                           and getattr(cfg.arch, "requires_bos", False))
        prompts = prompt if isinstance(prompt, list) else [prompt]
        negs = negative_prompt_ids if isinstance(prompt, list) \
            else [negative_prompt_ids]
        if negs is None:
            negs = [None] * len(prompts)
        jobs = []
        for i, p in enumerate(prompts):
            if embeddings and isinstance(p, str):
                ids = self.encode_with_embeddings(
                    p, embeddings, add_bos=add_bos,
                    encode_special_tokens=encode_special_tokens)
            elif isinstance(p, str):
                ids = self.tokenizer.encode(
                    p, add_bos=add_bos,
                    encode_special_tokens=encode_special_tokens)
            else:
                ids = np.asarray(p, np.int32)
            jobs.append(self.enqueue(DynamicJob(
                ids, max_new_tokens=max_new_tokens, settings=settings,
                seed=seed + i, stop_conditions=stop_conditions,
                identifier=i, negative_prompt_ids=negs[i],
                embeddings=embeddings)))
        completions = {id(j): "" for j in jobs}
        pending = {id(j) for j in jobs}
        guard = 0
        while pending:
            for r in self.iterate():
                if r["stage"] != "streaming":
                    continue
                completions[r["serial"]] += r.get("text", "")
                if r["eos"]:
                    pending.discard(r["serial"])
            guard += 1
            assert guard < 100000, "generator stuck"
        outs = [completions[id(j)] if completion_only
                else (prompts[i] + completions[id(j)])
                for i, j in enumerate(jobs)]
        return outs if isinstance(prompt, list) else outs[0]
