"""Mixtral's sparse MoE block (MixtralForCausalLM): softmax over the router's
logits, the top num_experts_per_tok experts renormalised to sum to one (equal
probabilities to the lower index), each expert w2(silu(w1(h)) * w3(h)) run
on its routed rows only. Exact routing: no capacity, no dropped route."""

import torch
import torch.nn.functional as Fn

from bench_port.reference.common import dequant


def mlp(packed, d, layer, h):
    probs = torch.softmax(h @ packed.router[layer].float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :d["topk"]], idx[:, :d["topk"]]
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(d["experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = (Fn.silu(x @ dequant(packed.linears[f"l{layer}.e{e}.w1"]))
             * (x @ dequant(packed.linears[f"l{layer}.e{e}.w3"])))
        y = y @ dequant(packed.linears[f"l{layer}.e{e}.w2"])
        out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out
