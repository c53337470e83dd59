"""Tensor-parallel placement over torch.distributed (PyTorch port of
exllamav2_tpu/parallel/sharding.py).

The reference runs one controller over a jax Mesh and lets shard_map hand
each device its block. Here one rank is one process holding one device,
and every rank runs the same program in lockstep, as the reference's
multi-host mode does (tools/multihost_worker.py): every rank's scheduler
sees the same jobs, the gathered logits are the same bytes on every rank
and every rank samples from generators seeded alike, so page tables and
token ids agree with no control traffic.

* ``make_mesh(tp, dp=1)`` -> ``Mesh``: the world cut into dp groups of tp
  consecutive ranks; a TP group carries the forward's collectives.
  ``make_multihost_mesh`` starts the world from the variables torchrun
  sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
* ``shard_model(w, st, mesh)`` -> this rank's (ModelWeights,
  StaticModel): every linear column-split (plane words, qscale, scale_f,
  scale and zero; smax and the act-order perm replicated; the bias padded
  to n before the split), attention on Hkv / tp local heads, MoE layers
  expert-parallel (E / tp whole experts a rank, a quantized router made
  dense). The forward gathers a split linear's output over the TP group
  and slices it to the logical width (models/forward._tp_gather). What
  does not split evenly stays whole on every rank, the counterpart of the
  reference's GSPMD fallback: a linear whose out-features do not divide is
  replicated and gathered from no one; attention whose head counts do not
  divide (or whose q/k/v are lane-padded) is replicated with its cache; an
  MoE layer whose experts do not divide keeps them all. The tokens are the
  same; less memory is saved. ``tp_fusable`` says whether everything
  splits, the reference's fused path.
* ``shard_paged_cache``: the page pool split on KV heads, scale pools too.
* ``lora_wrap_tp``: a PEFT adapter on the rank's shard (A replicated, B
  column-split in the lane-padded coordinates).

Collectives run on NCCL when each rank has its own GPU, and on gloo when
the caller names it (the CPU; two ranks on one card), which carries a
card's tensors through the host. A failure of one backend never falls
back to the other.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from exllamav2_tpu_torch.cache_paged import PagedKVCache, _raw
from exllamav2_tpu_torch.models.modules import (
    AttnWeights, EPMoEWeights, LayerWeights, MLPWeights, MoEWeights,
    ModelWeights, StaticModel)
from exllamav2_tpu_torch.quant.qtensor import (
    DenseLinear, QuantLinear, _seg_columns)

__all__ = ["Mesh", "make_mesh", "make_multihost_mesh", "init_distributed",
           "tp_fusable", "shard_model", "local_static", "shard_paged_cache",
           "lora_wrap_tp", "split_width", "heads_split"]

TORCHRUN_HINT = ("start every rank with torchrun, which sets RANK, "
                 "WORLD_SIZE, MASTER_ADDR and MASTER_PORT: torchrun "
                 "--nproc-per-node <N> <script> ...")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (dp, tp) mesh of processes: the world's ranks
    in order, dp groups of tp consecutive ranks. tp_group holds this rank's
    TP group (None at tp = 1), dp_group the ranks of its TP index across the
    replicas (None at dp = 1)."""
    tp: int
    dp: int
    rank: int
    tp_rank: int
    dp_rank: int
    tp_group: object
    dp_group: object
    backend: str
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    def replica(self) -> "Mesh":
        """The mesh of this rank's replica alone (dp = 1)."""
        return dataclasses.replace(self, dp=1, dp_rank=0, dp_group=None)

    def _host(self, x: torch.Tensor) -> bool:
        # gloo carries a card's tensors through the host
        return self.backend == "gloo" and x.is_cuda

    def all_gather(self, x: torch.Tensor, group=None, n=None
                   ) -> torch.Tensor:
        """The ranks' x concatenated on the last axis, in rank order (the
        TP group by default)."""
        group = self.tp_group if group is None else group
        n = self.tp if n is None else n
        if n == 1:
            return x
        src = (x.cpu() if self._host(x) else x).contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=-1).to(x.device)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the TP ranks' x (a new tensor)."""
        if self.tp == 1:
            return x
        y = x.cpu() if self._host(x) else x.clone()
        dist.all_reduce(y, group=self.tp_group)
        return y.to(x.device)

    def dp_gather_ints(self, values: list[int]) -> list[int]:
        """Each replica's `values`, concatenated in replica order (the DP
        group; every rank of a replica holds the same values)."""
        t = torch.tensor(values, dtype=torch.int64)
        return self.all_gather(t, self.dp_group, self.dp).tolist()


def init_distributed(backend: str, *, timeout: float = 600.0) -> None:
    """Join the world from RANK and WORLD_SIZE (torchrun's variables), at
    EXL2_INIT_METHOD (a file store of parallel/launch.py), else env://,
    which reads MASTER_ADDR and MASTER_PORT. Every collective fails after `timeout`
    seconds instead of hanging. A world already started must use
    `backend`."""
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the world runs {dist.get_backend()}, not "
                             f"{backend}")
        return
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(f"no process group to join: {TORCHRUN_HINT}")
    dist.init_process_group(
        backend,
        init_method=os.environ.get("EXL2_INIT_METHOD", "env://"),
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout))


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (and "
                           "backend='gloo') to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def make_mesh(tp: int, dp: int = 1, device=None,
              backend: str | None = None, *, timeout: float = 600.0) -> Mesh:
    """This rank's Mesh over the world's ranks (the world started here if
    it is not), which must number dp * tp. Every rank of the world calls
    it with the same arguments (groups are made collectively). device defaults to cuda:LOCAL_RANK; backend to NCCL on
    a card and gloo on the CPU. Name gloo to put several ranks on one
    card (NCCL refuses that)."""
    device = _default_device() if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL needs a CUDA device")
        torch.cuda.set_device(device)
    init_distributed(backend, timeout=timeout)
    ranks = list(range(dist.get_world_size()))
    if len(ranks) != dp * tp:
        raise ValueError(f"{len(ranks)} ranks for a mesh of dp {dp} x tp "
                         f"{tp}")
    me = ranks.index(dist.get_rank())
    td = datetime.timedelta(seconds=timeout)
    tp_group = dp_group = None
    if tp > 1:
        for d in range(dp):
            g = dist.new_group(ranks[d * tp:(d + 1) * tp], timeout=td)
            if d == me // tp:
                tp_group = g
    if dp > 1:
        for t in range(tp):
            g = dist.new_group(ranks[t::tp], timeout=td)
            if t == me % tp:
                dp_group = g
    return Mesh(tp=tp, dp=dp, rank=dist.get_rank(), tp_rank=me % tp,
                dp_rank=me // tp, tp_group=tp_group, dp_group=dp_group,
                backend=backend, device=device)


def make_multihost_mesh(dp: int = 1, tp: int | None = None,
                        **kw) -> Mesh:
    """The mesh of a world started by torchrun on one or several hosts:
    tp defaults to WORLD_SIZE / dp. Keep a TP group within one host (its
    gathers run every layer)."""
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        raise RuntimeError(f"no process group to join: {TORCHRUN_HINT}")
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ["WORLD_SIZE"]))
    return make_mesh(tp or world // dp, dp, **kw)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _base(lin):
    while hasattr(lin, "base"):               # a LoRA wrap
        lin = lin.base
    return lin


def split_width(lin) -> int:
    """The logical out-features of the whole linear whose column shard
    `lin` (or the linear a LoRA wraps) is, or 0 for a linear that is not
    split: the width the forward slices the gathered output to."""
    return getattr(_base(lin), "tp_width", 0)


def heads_split(w: ModelWeights) -> bool:
    """Whether this rank's attention runs on its own share of the heads
    (q, k and v column-split; the cache split on KV heads)."""
    return split_width(w.layers[0].attn.q) > 0


def _out_features(lin) -> int:
    return lin.weight.shape[1] if isinstance(lin, DenseLinear) else lin.n


def _logical_width(lin) -> int:
    return lin.weight.shape[1] if isinstance(lin, DenseLinear) \
        else lin.n_orig


def _tp_fusable_linear(lin, tp: int, exact_width: bool) -> bool:
    """Whether a linear column-splits over tp ranks: its (padded)
    out-features divide; `exact_width` (q/k/v, whose output reshapes to
    heads) also wants no lane padding. Act-order perms and mixed-bitrate
    segments split: K stays whole on every rank."""
    if lin is None:
        return True
    if _out_features(lin) % tp:
        return False
    return not (exact_width and isinstance(lin, QuantLinear)
                and lin.n != lin.n_orig)


def _attention_splits(w: ModelWeights, st: StaticModel, tp: int) -> bool:
    return (st.num_heads % tp == 0 and st.num_kv_heads % tp == 0
            and all(_tp_fusable_linear(x, tp, True) for lw in w.layers
                    for x in (lw.attn.q, lw.attn.k, lw.attn.v)))


def _ep_stackable(mw: MoEWeights, tp: int) -> bool:
    """Whole experts divide over the ranks. (The reference also wants
    structurally equal experts, to stack their arrays; a rank here keeps
    its experts as a list.)"""
    return len(mw.w1) % tp == 0


def tp_fusable(w: ModelWeights, st: StaticModel, tp: int) -> bool:
    """Whether everything splits over tp ranks (the reference's fused
    path): both head counts, every linear's out-features (q/k/v unpadded),
    every MoE layer's experts; not for parallel blocks (the reference keeps
    those on its fallback)."""
    if tp <= 1 or st.parallel_blocks or not _attention_splits(w, st, tp):
        return False
    for lw in w.layers:
        lins = [lw.attn.o]
        if isinstance(lw.mlp, MoEWeights):
            if not _ep_stackable(lw.mlp, tp):
                return False
        else:
            lins += [lw.mlp.gate, lw.mlp.up, lw.mlp.down]
        if not all(_tp_fusable_linear(x, tp, False) for x in lins):
            return False
    return _tp_fusable_linear(w.head, tp, False)


def _densify_router(lin):
    """A quantized router as a dense bf16 [d, E] (tiny and replicated)."""
    if not isinstance(lin, QuantLinear):
        return lin
    from exllamav2_tpu_torch.ops.dequant import dequant_linear
    return DenseLinear(dequant_linear(lin)[:, :lin.n_orig].to(
        torch.bfloat16).contiguous(), lin.bias)


def _tpf_linear(lin, mesh: Mesh):
    """Rank tp_rank's column shard of a linear, marked with the whole
    linear's logical width (split_width). The planes and every per-column
    meta array take columns [r * n/tp, (r + 1) * n/tp) of the padded width;
    smax and perm are shared; the bias is padded to n first."""
    if lin is None:
        return None
    tp, r = mesh.tp, mesh.tp_rank
    nl = _out_features(lin) // tp

    def take(a):
        return a[:, r * nl:(r + 1) * nl].contiguous()

    bias = lin.bias
    if bias is not None:
        if isinstance(lin, QuantLinear):
            bias = torch.nn.functional.pad(bias, (0, lin.n - lin.n_orig))
        bias = bias[r * nl:(r + 1) * nl].contiguous()
    if isinstance(lin, DenseLinear):
        out = DenseLinear(take(lin.weight), bias)
    else:
        out = QuantLinear([_seg_columns(s, take) for s in lin.segments],
                          lin.perm, bias, k=lin.k, n=nl, n_orig=nl)
    out.tp_width = _logical_width(lin)
    return out


def _tpf_stacked(lins, mesh: Mesh) -> list:
    """This rank's whole experts: E / tp of them, in rank order."""
    e_local = len(lins) // mesh.tp
    return list(lins[mesh.tp_rank * e_local:(mesh.tp_rank + 1) * e_local])


def local_static(st: StaticModel, tp: int, mesh: Mesh) -> StaticModel:
    """A rank's StaticModel when its attention is split: its own head
    counts, and the mesh whose TP group the forward gathers over."""
    return dataclasses.replace(st, num_heads=st.num_heads // tp,
                               num_kv_heads=st.num_kv_heads // tp,
                               tp_axis=mesh)


def shard_model(w: ModelWeights, st: StaticModel, mesh: Mesh
                ) -> tuple[ModelWeights, StaticModel]:
    """This rank's shard of (w, st) on `mesh`'s TP group (see the module
    docstring); everything that splits is split. Merged q|k|v and gate|up
    linears are dropped (a column shard would cut across their sources).
    At tp = 1 the weights come back whole, with no mesh in the static."""
    tp = mesh.tp
    if tp == 1:
        return w, st

    def col(lin, exact=False):
        return _tpf_linear(lin, mesh) if _tp_fusable_linear(
            lin, tp, exact) else lin

    heads = _attention_splits(w, st, tp)
    layers = []
    for lw in w.layers:
        a, m = lw.attn, lw.mlp
        q, k, v = ((_tpf_linear(x, mesh) if heads else x)
                   for x in (a.q, a.k, a.v))
        attn = AttnWeights(a.norm, q, k, v, col(a.o), q_norm=a.q_norm,
                           k_norm=a.k_norm, norm_post=a.norm_post)
        if isinstance(m, MoEWeights):
            if _ep_stackable(m, tp):
                m = EPMoEWeights(
                    m.norm, _densify_router(m.router),
                    _tpf_stacked(m.w1, mesh), _tpf_stacked(m.w2, mesh),
                    _tpf_stacked(m.w3, mesh), norm_post=m.norm_post,
                    first=mesh.tp_rank * (len(m.w1) // tp),
                    num_experts=len(m.w1))
        else:
            gu = (_tp_fusable_linear(m.gate, tp, False)
                  and _tp_fusable_linear(m.up, tp, False))
            m = MLPWeights(m.norm, _tpf_linear(m.gate, mesh) if gu
                           else m.gate,
                           _tpf_linear(m.up, mesh) if gu else m.up,
                           col(m.down), norm_post=m.norm_post)
        layers.append(LayerWeights(attn, m))
    out = ModelWeights(w.embed, layers, w.final_norm, col(w.head), w.sin,
                       w.cos, pos_emb=w.pos_emb, sin_alt=w.sin_alt,
                       cos_alt=w.cos_alt)
    st = (local_static(st, tp, mesh) if heads
          else dataclasses.replace(st, tp_axis=mesh))
    return out, st


def shard_paged_cache(cache: PagedKVCache, mesh: Mesh) -> PagedKVCache:
    """Rank tp_rank's KV heads of a page pool (data and scale pools;
    layout [L, Hkv, rows, D']). Page indices are global, so every rank
    holds the same page table."""
    tp, r = mesh.tp, mesh.tp_rank
    hl = cache.kv_heads // tp

    def take(a):
        if a is None:
            return None
        return _raw(a)[:, r * hl:(r + 1) * hl].contiguous().view(a.dtype)

    return PagedKVCache(take(cache.k_data), take(cache.k_scales),
                        take(cache.v_data), take(cache.v_scales),
                        cache.kind, cache.page_size, cache.head_dim)


def lora_wrap_tp(w: ModelWeights, lora, mesh: Mesh) -> ModelWeights:
    """Copy of a rank's shard with a PEFT adapter on its targets: A [k, r]
    replicated (x @ A is the same on every rank); on a split linear B
    [r, n_orig] padded to the whole padded width and column-split like the
    base planes, so the rank's bypass adds onto its own output columns and
    the gather stitches both."""
    from exllamav2_tpu_torch.lora import LoraLinear, _map_targets, _wrap

    def wrap(lin, key):
        if lin is None or not split_width(lin):
            return _wrap(lin, lora, key, mesh.device)
        pair = lora.pair_for(key)
        if pair is None:
            return lin
        a, b = (torch.from_numpy(x).to(device=mesh.device,
                                       dtype=torch.bfloat16) for x in pair)
        nl = _out_features(_base(lin))
        b = torch.nn.functional.pad(b, (0, nl * mesh.tp - b.shape[1]))
        r = mesh.tp_rank
        return LoraLinear(lin, a, b[:, r * nl:(r + 1) * nl].contiguous(),
                          lora.scaling)

    return _map_targets(w, wrap)
