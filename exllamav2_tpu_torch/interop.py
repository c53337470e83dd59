"""Build this package's weight modules from the reference package's tree.

``weights_from_reference(w, st)`` takes the JAX package's ``ModelWeights``
tree whose leaves have been mapped to numpy arrays, and its ``StaticModel``,
reads their fields by name and returns (ModelWeights, StaticModel) of this
package holding the same bits, so both packages compute with identical
weights (``random_model_weights`` of the reference draws with jax.random,
which this package cannot reproduce). Nothing of JAX is imported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.models.modules import (
    AttnWeights, LayerStatic, LayerWeights, MLPWeights, ModelWeights,
    NormWeights, StaticModel)
from exllamav2_tpu_torch.quant.qtensor import (
    DenseLinear, GptqSegment, QuantLinear, QuantSegment)

__all__ = ["to_tensor", "linear_from_reference", "weights_from_reference"]


def to_tensor(a, device=None) -> torch.Tensor | None:
    """numpy array -> tensor with the same bits on `device` (the card by
    default; None passes through).

    bf16 arrays (ml_dtypes) go through their int16 bits; uint32 plane words
    become int32 with the same bits."""
    if a is None:
        return None
    device = resolve_device(device)
    a = np.array(a, copy=True)            # reference leaves are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def linear_from_reference(lin, device=None):
    """A reference QuantLinear / DenseLinear with numpy leaves -> this
    package's linear on `device` (the card by default)."""
    device = resolve_device(device)
    if hasattr(lin, "base"):
        raise NotImplementedError("LoRA linears are not ported yet")
    if hasattr(lin, "weight"):
        return DenseLinear(to_tensor(lin.weight, device),
                           to_tensor(lin.bias, device))
    segs = []
    for s in lin.segments:
        if getattr(s, "act8", False) or getattr(s, "src_cols", ()):
            raise NotImplementedError(
                "W4A8 and column-merged segments are not ported yet")
        planes = tuple(to_tensor(p, device) for p in s.planes)
        if hasattr(s, "zero"):
            segs.append(GptqSegment(
                planes, to_tensor(s.scale, device), to_tensor(s.zero, device),
                bits=s.bits, plane_bits=s.plane_bits, rows=s.rows,
                group_rows=s.group_rows))
        else:
            segs.append(QuantSegment(
                planes, to_tensor(s.qscale, device), to_tensor(s.smax, device),
                bits=s.bits, plane_bits=s.plane_bits, rows=s.rows,
                group_rows=s.group_rows,
                scale_f=to_tensor(s.scale_f, device)))
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
    return StaticModel(**kw)


def weights_from_reference(w, st, *, device=None
                           ) -> tuple[ModelWeights, StaticModel]:
    """Reference (ModelWeights with numpy leaves, StaticModel) -> this
    package's (ModelWeights, StaticModel) on `device` (the card by
    default)."""
    device = resolve_device(device)
    for name in ("pos_emb", "sin_alt", "cos_alt"):
        if getattr(w, name, None) is not None:
            raise NotImplementedError(f"{name} is not ported yet")
    layers = []
    for lw in w.layers:
        aw, mw = lw.attn, lw.mlp
        for name in ("q_norm", "k_norm", "norm_post"):
            if getattr(aw, name, None) is not None:
                raise NotImplementedError(f"attention {name} not ported yet")
        if not hasattr(mw, "up") or getattr(mw, "norm_post", None) is not None:
            raise NotImplementedError("MoE / post-norm MLPs not ported yet")
        # merged qkv / gate_up fast-path copies are ignored: q/k/v and
        # gate/up hold the same weights
        def lin(x):
            return None if x is None else linear_from_reference(x, device)

        attn = AttnWeights(_norm(aw.norm, device), lin(aw.q), lin(aw.k),
                           lin(aw.v), lin(aw.o))
        mlp = MLPWeights(_norm(mw.norm, device), lin(mw.gate), lin(mw.up),
                         lin(mw.down))
        layers.append(LayerWeights(attn, mlp))
    out = ModelWeights(to_tensor(w.embed, device), layers,
                       _norm(w.final_norm, device),
                       linear_from_reference(w.head, device),
                       to_tensor(w.sin, device), to_tensor(w.cos, device))
    return out, _static(st)
