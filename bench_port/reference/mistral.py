"""Mistral's MLP (MistralForCausalLM): down(silu(gate(h)) * up(h))."""

import torch.nn.functional as Fn

from bench_port.reference.common import dequant


def mlp(packed, d, layer, h):
    g = h @ dequant(packed.linears[f"l{layer}.gate"])
    u = h @ dequant(packed.linears[f"l{layer}.up"])
    return (Fn.silu(g) * u) @ dequant(packed.linears[f"l{layer}.down"])
