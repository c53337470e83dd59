"""LoRA adapters (PyTorch port of exllamav2_tpu/lora.py).

``Lora(directory)`` reads a PEFT adapter (``adapter_config.json`` and
``adapter_model.safetensors``). ``apply_lora`` returns a copy of a weight
tree whose targeted linears (q/k/v/o, gate/up/down) are wrapped in a
``LoraLinear``: ``linear_apply`` adds the rank-r bypass
``scaling * (x @ a) @ b`` to the base linear's output (ops/qmm.py). The
tree given is not touched; ``remove_lora`` unwraps every adapter.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

from exllamav2_tpu_torch.models.modules import MLPWeights
from exllamav2_tpu_torch.ops.dequant import _with
from exllamav2_tpu_torch.stloader import STFile, bf16_bits_to_f32

__all__ = ["Lora", "LoraLinear", "apply_lora", "remove_lora"]


class LoraLinear(nn.Module):
    """y = base(x) + scaling * (x @ a) @ b;  a [in, r] bf16, b [r, out]
    bf16."""

    def __init__(self, base, a: torch.Tensor, b: torch.Tensor,
                 scaling: float):
        super().__init__()
        self.base = base
        self.register_buffer("a", a)
        self.register_buffer("b", b)
        self.scaling = float(scaling)


class Lora:
    """A parsed PEFT adapter: `targets` maps a module name
    (``model.layers.{l}.self_attn.q_proj``, ...) to (A [in, r], B [r, out])
    f32 arrays, `scaling` is lora_scaling * alpha / r."""

    def __init__(self, directory: str, lora_scaling: float = 1.0):
        with open(os.path.join(directory, "adapter_config.json")) as f:
            cfg = json.load(f)
        self.lora_r = int(cfg["r"])
        self.lora_alpha = float(cfg["lora_alpha"])
        self.scaling = lora_scaling * self.lora_alpha / self.lora_r
        st = STFile(os.path.join(directory, "adapter_model.safetensors"))

        def get(name):
            t = st.get_tensor(name)
            if st.get_dtype(name) == "BF16":
                return bf16_bits_to_f32(t)
            return t.astype(np.float32)

        self.targets: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for name in list(st.keys()):
            if not name.endswith("lora_A.weight"):
                continue
            prefix = name[:-len(".lora_A.weight")]
            a = get(name)                              # [r, in] (PEFT)
            b = get(prefix + ".lora_B.weight")         # [out, r]
            key = prefix.replace("base_model.model.", "")
            self.targets[key] = (a.T.copy(), b.T.copy())
        st.close()

    def pair_for(self, key: str):
        return self.targets.get(key)


def _wrap(lin, lora: Lora, key: str, device):
    pair = lora.pair_for(key)
    if pair is None or lin is None:
        return lin
    a, b = (torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)
            for x in pair)
    return LoraLinear(lin, a, b, lora.scaling)


_ATTN = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "o_proj"))
_MLP = (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj"))


def _map_targets(weights, f):
    """Copy of a ModelWeights with f(linear, module name) on every LoRA
    target of every layer."""
    layers = []
    for l, lw in enumerate(weights.layers):
        p = f"model.layers.{l}"
        attn = _with(lw.attn, **{a: f(getattr(lw.attn, a),
                                      f"{p}.self_attn.{t}")
                                 for a, t in _ATTN})
        mlp = lw.mlp
        if isinstance(mlp, MLPWeights):
            mlp = _with(mlp, **{a: f(getattr(mlp, a), f"{p}.mlp.{t}")
                                for a, t in _MLP})
        layers.append(_with(lw, attn=attn, mlp=mlp))
    return _with(weights, layers=nn.ModuleList(layers))


def apply_lora(weights, lora: Lora):
    """Copy of `weights` with the adapter's targets wrapped in LoraLinear
    (A and B in bf16 on the weights' device)."""
    device = weights.embed.device
    return _map_targets(weights,
                        lambda lin, key: _wrap(lin, lora, key, device))


def remove_lora(weights):
    """Copy of `weights` with every LoraLinear unwrapped."""
    def unwrap(lin, _key):
        while isinstance(lin, LoraLinear):
            lin = lin.base
        return lin
    return _map_targets(weights, unwrap)
