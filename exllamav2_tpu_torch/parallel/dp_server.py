"""Data-parallel serving: dp replicas behind one dispatcher (PyTorch port
of exllamav2_tpu/parallel/dp_server.py).

Replicas are independent DynamicGenerators, each with its own cache, and a
dispatcher sends every job to the replica with the lightest load (pending
plus active jobs), as in the reference.

* tp = 1: the dp replicas live in this process, each on a device of
  `devices` (a device may repeat: two replicas on one card), with their
  step graphs.
* tp > 1: a world of dp * tp ranks (parallel/sharding.make_mesh), cut into
  dp TP groups; a rank serves its replica's tensor-parallel shard. Every
  rank runs the same dispatcher on the same jobs: each ``iterate`` gathers
  the replicas' loads over the DP group as one small int tensor, so every
  rank's pick sees the same numbers, and a rank steps only its own replica
  (``replicas`` holds that one). ``generate`` gathers the texts to every
  rank.
"""

from __future__ import annotations

import numpy as np
import torch

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.models.model import Model

__all__ = ["DataParallelGenerator"]


def _on(model: Model, device: torch.device) -> Model:
    """`model` on `device` (itself where it is there already)."""
    if model.device == device:
        return model
    import copy
    return Model(copy.deepcopy(model.weights).to(device), model.static,
                 model.config)


class DataParallelGenerator:
    """Dispatcher over dp DynamicGenerator replicas (module docstring), with
    the DynamicGenerator surface: enqueue / iterate / generate."""

    def __init__(self, model, tokenizer, *, num_pages: int, dp: int,
                 tp: int | None = None, devices=None, cache_kind="bf16",
                 page_size: int = 256, mesh=None, **gen_kwargs):
        """tp = 1 (the default without a mesh): replicas on `devices`
        (default: the model's device), taken in turn. tp > 1: `mesh` (a
        parallel/sharding.Mesh of dp x tp) or one made here over the
        world on the model's device."""
        st = model.static
        tp = tp or (mesh.tp if mesh is not None else 1)
        self.tokenizer = tokenizer
        self.mesh = None

        def gen(device, mesh=None):
            cache = PagedKVCache.alloc(st.num_layers, num_pages,
                                       st.num_kv_heads, st.head_dim,
                                       cache_kind, page_size=page_size,
                                       device=device)
            return DynamicGenerator(_on(model, device), cache, tokenizer,
                                    mesh=mesh, **gen_kwargs)

        if tp == 1:
            devices = [torch.device(d) for d in (devices or [model.device])]
            self.replicas = [gen(devices[g % len(devices)])
                             for g in range(dp)]
            self.dp_rank = None
        else:
            if mesh is None:
                from exllamav2_tpu_torch.parallel.sharding import make_mesh
                mesh = make_mesh(tp, dp, device=model.device)
            if mesh.shape != {"dp": dp, "tp": tp}:
                raise ValueError(f"mesh {mesh.shape}, want dp {dp} tp {tp}")
            self.mesh = mesh
            self.dp_rank = mesh.dp_rank
            self.replicas = [gen(mesh.device, mesh.replica())]
        self.dp = dp
        self._loads = [0] * dp
        self.served = [0] * dp          # jobs sent to each replica

    @property
    def tp_fused(self) -> bool:
        return all(r._tp_fused for r in self.replicas)

    def _mine(self, g: int):
        """Replica g's generator when this process serves it, else None."""
        if self.mesh is None:
            return self.replicas[g]
        return self.replicas[0] if g == self.dp_rank else None

    def _pick(self) -> int:
        if self.mesh is None:
            self._loads = [len(r.pending) + len(r.active)
                           for r in self.replicas]
        return int(np.argmin(self._loads))

    def _send(self, job) -> tuple[int, DynamicJob]:
        g = self._pick()
        self._loads[g] += 1
        self.served[g] += 1
        r = self._mine(g)
        return g, r.enqueue(job) if r is not None else job

    def enqueue(self, job):
        """Send `job` to the least loaded replica (on every rank: a rank
        whose replica it is not keeps no trace of it but the load)."""
        return self._send(job)[1]

    def iterate(self) -> list[dict]:
        results = []
        for r in self.replicas:
            if r.pending or r.active:
                results.extend(r.iterate())
        if self.mesh is not None:
            r = self.replicas[0]
            self._loads = self.mesh.dp_gather_ints(
                [len(r.pending) + len(r.active)])
        return results

    def generate(self, prompt, max_new_tokens: int = 128,
                 settings=None, seed: int = 0, stop_conditions=None,
                 add_bos: bool | None = None, completion_only: bool = True,
                 embeddings: list | None = None,
                 encode_special_tokens: bool = False):
        """Batch generate across replicas, DynamicGenerator.generate's
        surface and semantics (per-prompt seed offset, multimodal
        embeddings, special-token encoding, completion_only)."""
        if add_bos is None:
            cfg = getattr(self.replicas[0].model, "config", None)
            add_bos = bool(cfg is not None
                           and getattr(cfg.arch, "requires_bos", False))
        prompts = prompt if isinstance(prompt, list) else [prompt]
        mine = []
        for i, p in enumerate(prompts):
            if embeddings and isinstance(p, str):
                ids = self.replicas[0].encode_with_embeddings(
                    p, embeddings, add_bos=add_bos,
                    encode_special_tokens=encode_special_tokens)
            elif isinstance(p, str):
                ids = self.tokenizer.encode(
                    p, add_bos=add_bos,
                    encode_special_tokens=encode_special_tokens)
            else:
                ids = np.asarray(p, np.int32)
            g, job = self._send(DynamicJob(
                ids, max_new_tokens=max_new_tokens, settings=settings,
                seed=seed + i, stop_conditions=stop_conditions,
                identifier=i, embeddings=embeddings))
            if self._mine(g) is not None:
                mine.append((i, job))
        if self.mesh is None:
            while any(j.status != "done" for _, j in mine):
                self.iterate()
        else:
            # every rank steps until every replica is idle: the gathered
            # loads end the loop on all ranks at once
            self.iterate()
            while any(self._loads):
                self.iterate()
        texts = {i: j.emitted_text for i, j in mine}
        if self.mesh is not None:
            import torch.distributed as dist
            every = [None] * self.dp
            dist.all_gather_object(every, texts, group=self.mesh.dp_group)
            for part in every:
                texts.update(part)
        outs = [texts[i] if completion_only else prompts[i] + texts[i]
                for i in range(len(prompts))]
        return outs if isinstance(prompt, list) else outs[0]
