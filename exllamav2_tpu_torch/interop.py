"""Build this package's weight modules from the reference package's tree.

``weights_from_reference(w, st)`` takes the JAX package's ``ModelWeights``
tree whose leaves have been mapped to numpy arrays, and its ``StaticModel``,
reads their fields by name and returns (ModelWeights, StaticModel) of this
package holding the same bits, so both packages compute with identical
weights (``random_model_weights`` of the reference draws with jax.random,
which this package cannot reproduce). ``vision_tower_from_reference`` does
the same for a vision tower. Nothing of JAX is imported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.models.modules import (
    AttnWeights, EPMoEWeights, LayerStatic, LayerWeights, MLPWeights,
    MoEWeights, ModelWeights, NormWeights, StaticModel)
from exllamav2_tpu_torch.quant.qtensor import (
    DenseLinear, GptqSegment, QuantLinear, QuantSegment)

__all__ = ["to_tensor", "linear_from_reference", "weights_from_reference",
           "paged_cache_from_reference", "sampling_params_from_reference",
           "vision_tower_from_reference"]


def to_tensor(a, device=None) -> torch.Tensor | None:
    """numpy array -> tensor with the same bits on `device` (the card by
    default; None passes through).

    bf16 and fp8 e5m2 arrays (ml_dtypes) go through their integer bits;
    uint32 plane words become int32 with the same bits."""
    if a is None:
        return None
    device = resolve_device(device)
    a = np.array(a, copy=True)            # reference leaves are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    if a.dtype.name == "float8_e5m2":
        return torch.from_numpy(a.view(np.uint8)).view(
            torch.float8_e5m2).to(device)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def linear_from_reference(lin, device=None):
    """A reference QuantLinear / DenseLinear / LoraLinear with numpy leaves
    -> this package's linear on `device` (the card by default)."""
    device = resolve_device(device)
    if hasattr(lin, "base"):
        from exllamav2_tpu_torch.lora import LoraLinear
        return LoraLinear(linear_from_reference(lin.base, device),
                          to_tensor(lin.a, device), to_tensor(lin.b, device),
                          lin.scaling)
    if hasattr(lin, "weight"):
        return DenseLinear(to_tensor(lin.weight, device),
                           to_tensor(lin.bias, device))
    segs = []
    for s in lin.segments:
        planes = tuple(to_tensor(p, device) for p in s.planes)
        if hasattr(s, "zero"):
            segs.append(GptqSegment(
                planes, to_tensor(s.scale, device), to_tensor(s.zero, device),
                bits=s.bits, plane_bits=s.plane_bits, rows=s.rows,
                group_rows=s.group_rows, act8=s.act8,
                scale_bf=to_tensor(s.scale_bf, device),
                zs_bf=to_tensor(s.zs_bf, device)))
        else:
            # a column-merged segment's smax is [groups, n_sources]
            segs.append(QuantSegment(
                planes, to_tensor(s.qscale, device), to_tensor(s.smax, device),
                bits=s.bits, plane_bits=s.plane_bits, rows=s.rows,
                group_rows=s.group_rows,
                scale_f=to_tensor(s.scale_f, device),
                src_cols=s.src_cols, act8=s.act8))
    return QuantLinear(segs, to_tensor(lin.perm, device),
                       to_tensor(lin.bias, device), k=lin.k, n=lin.n,
                       n_orig=lin.n_orig)


def _norm(nw, device):
    return NormWeights(to_tensor(nw.weight, device),
                       to_tensor(nw.bias, device))


def _port_fields(obj, cls):
    """Fields of a reference dataclass `obj` that `cls` has; every other
    field must hold its default (a feature this package has not ported)."""
    names = {f.name for f in dataclasses.fields(cls)}
    for f in dataclasses.fields(obj):
        if f.name not in names and getattr(obj, f.name) != f.default:
            raise NotImplementedError(
                f"{type(obj).__name__}.{f.name}={getattr(obj, f.name)!r} "
                "is not ported yet")
    return {n: getattr(obj, n) for n in names}


def _static(st) -> StaticModel:
    kw = _port_fields(st, StaticModel)
    kw["layers"] = tuple(LayerStatic(**_port_fields(ls, LayerStatic))
                         for ls in st.layers)
    # the reference's tp_axis names a jax mesh axis; the port's holds a
    # mesh, which the generator sets when it shards
    kw["tp_axis"] = None
    return StaticModel(**kw)


def _expert(stacked, e: int):
    """Expert e of a reference linear whose arrays carry a leading expert
    axis (EPMoEWeights): every array indexed at e, the rest kept."""
    if isinstance(stacked, np.ndarray):
        return stacked[e]
    if isinstance(stacked, (tuple, list)):
        return type(stacked)(_expert(x, e) for x in stacked)
    if dataclasses.is_dataclass(stacked):
        return dataclasses.replace(stacked, **{
            f.name: _expert(getattr(stacked, f.name), e)
            for f in dataclasses.fields(stacked) if f.init})
    return stacked


def _num_stacked(stacked) -> int:
    """The length of the expert axis of a stacked reference linear."""
    if isinstance(stacked, np.ndarray):
        return stacked.shape[0]
    fields = stacked if isinstance(stacked, (tuple, list)) else [
        getattr(stacked, f.name) for f in dataclasses.fields(stacked)]
    for x in fields:
        if isinstance(x, np.ndarray) or dataclasses.is_dataclass(x) or (
                isinstance(x, (tuple, list)) and x):
            return _num_stacked(x)
    raise ValueError("no array in a stacked linear")


def weights_from_reference(w, st, *, device=None
                           ) -> tuple[ModelWeights, StaticModel]:
    """Reference (ModelWeights with numpy leaves, StaticModel) -> this
    package's (ModelWeights, StaticModel) on `device` (the card by
    default). Per-head and post norms, learned positions, the alternate
    rope tables and block-sparse MoE layers come along (a tuple of expert
    linears becomes an nn.ModuleList); an expert-parallel layer
    (EPMoEWeights, arrays stacked on a leading expert axis) becomes an
    EPMoEWeights holding every expert (first 0). A reference StaticModel's
    tp_axis (a jax mesh axis name) becomes None: the port's model is whole
    until DynamicGenerator(mesh=) shards it."""
    device = resolve_device(device)

    def lin(x):
        return None if x is None else linear_from_reference(x, device)

    def norm(nw):
        return None if nw is None else _norm(nw, device)

    layers = []
    for lw in w.layers:
        aw, mw = lw.attn, lw.mlp
        # the merged qkv / gate_up linears come along where the reference
        # tree carries them
        attn = AttnWeights(_norm(aw.norm, device), lin(aw.q), lin(aw.k),
                           lin(aw.v), lin(aw.o), q_norm=norm(aw.q_norm),
                           k_norm=norm(aw.k_norm),
                           norm_post=norm(aw.norm_post), qkv=lin(aw.qkv))
        if hasattr(mw, "up"):
            mlp = MLPWeights(_norm(mw.norm, device), lin(mw.gate),
                             lin(mw.up), lin(mw.down),
                             norm_post=norm(mw.norm_post),
                             gate_up=lin(mw.gate_up))
        elif isinstance(mw.w1, (tuple, list)):
            mlp = MoEWeights(_norm(mw.norm, device), lin(mw.router),
                             [lin(x) for x in mw.w1], [lin(x) for x in mw.w2],
                             [lin(x) for x in mw.w3],
                             norm_post=norm(mw.norm_post))
        else:
            ne = _num_stacked(mw.w1)
            mlp = EPMoEWeights(
                _norm(mw.norm, device), lin(mw.router),
                *([lin(_expert(g, e)) for e in range(ne)]
                  for g in (mw.w1, mw.w2, mw.w3)),
                norm_post=norm(mw.norm_post), num_experts=ne)
        layers.append(LayerWeights(attn, mlp))
    out = ModelWeights(to_tensor(w.embed, device), layers,
                       _norm(w.final_norm, device),
                       linear_from_reference(w.head, device),
                       to_tensor(w.sin, device), to_tensor(w.cos, device),
                       pos_emb=to_tensor(w.pos_emb, device),
                       sin_alt=to_tensor(w.sin_alt, device),
                       cos_alt=to_tensor(w.cos_alt, device))
    return out, _static(st)


def paged_cache_from_reference(cache, device=None):
    """A reference PagedKVCache whose leaves are numpy arrays -> this
    package's PagedKVCache holding the same bits on `device` (the card by
    default)."""
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    device = resolve_device(device)
    return PagedKVCache(
        to_tensor(cache.k_data, device), to_tensor(cache.k_scales, device),
        to_tensor(cache.v_data, device), to_tensor(cache.v_scales, device),
        cache.kind, cache.page_size, cache.head_dim)


def sampling_params_from_reference(p, device=None):
    """A reference SamplingParams with numpy leaves -> this package's
    SamplingParams on `device` (the card by default)."""
    from exllamav2_tpu_torch.ops.sampling import SamplingParams
    device = resolve_device(device)
    return SamplingParams(**{f.name: to_tensor(getattr(p, f.name), device)
                             for f in dataclasses.fields(SamplingParams)})


def _config(cfg):
    """A reference ModelConfig -> this package's, field by field (the
    architecture by its name; no tensor file map)."""
    from exllamav2_tpu_torch.architecture import get_arch
    from exllamav2_tpu_torch.config import ModelConfig
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(ModelConfig) if hasattr(cfg, f.name)}
    kw["arch"] = get_arch(cfg.arch.arch_string) if cfg.arch else None
    kw["tensor_file_map"] = None
    return ModelConfig(**kw)


def vision_tower_from_reference(tower, *, device=None):
    """The reference's VisionTower (numpy or JAX leaves) -> this package's
    vlm.VisionTower holding the same bits on `device` (the card by
    default): the _VLayer blocks, patch_conv, ln_pre, pos_emb and the
    projector dict."""
    from exllamav2_tpu_torch.vlm.vision_tower import VisionTower, _VLayer
    device = resolve_device(device)

    def lin(x):
        return None if x is None else linear_from_reference(x, device)

    def norm(nw):
        return None if nw is None else _norm(nw, device)

    layers = [_VLayer(norm(l.norm1), lin(l.q), lin(l.k), lin(l.v), lin(l.o),
                      norm(l.norm2), lin(l.gate), lin(l.up), lin(l.down))
              for l in tower.layers]
    mmp = {k: v if isinstance(v, str) else norm(v) if k == "norm"
           else lin(v) for k, v in tower.mmp.items()}
    parts = dict(layers=layers, patch_conv=lin(tower.patch_conv),
                 ln_pre=norm(tower.ln_pre),
                 pos_emb=to_tensor(tower.pos_emb, device), mmp=mmp)
    return VisionTower(_config(tower.cfg), device=device, parts=parts)
