"""The plain reference: EXL2 decoding and a decoder's forward pass in f32.

Plain PyTorch, TF32 off, no cache and no batching across sequences. It
imports nothing of the port and reads only what the benchmark drew from the
seed (bench_port/weights.Packed) and the token ids: it decodes the scales
and the weights, routes the experts and attends over each sequence itself.

The forward runs layer by layer over every sequence together, so one layer's
weights are decoded once and the whole model never sits on the card in f32.
The family's MLP is ``reference/<family>.py``'s ``mlp`` (the configuration
file names the family).
"""

from __future__ import annotations

import importlib
import math

import torch

__all__ = ["dequant", "rms_norm", "rope", "attention", "served_gaps"]

SUB_BLOCK = 256


def dequant(lin) -> torch.Tensor:
    """An EXL2 4-bit linear -> f32 [k, n]. Within each 256-row sub-block,
    row r is 4-bit slot r // 32 of word r % 32; a group of 32 rows shares
    the scale fp16(qscale^2 * smax), and a weight is (q - 8) * scale."""
    k, n = lin.k, lin.n
    words = lin.planes.reshape(k // SUB_BLOCK, 1, SUB_BLOCK * 4 // 32, n)
    shifts = (torch.arange(8, device=words.device, dtype=torch.int32)
              * 4).reshape(1, 8, 1, 1)
    q = ((words >> shifts) & 15).reshape(k, n).to(torch.float32)
    qs = lin.qscale.to(torch.float32)
    scale = (qs * qs * lin.smax).half().float()          # [k / 32, n]
    return (q - 8.0) * torch.repeat_interleave(scale, k // scale.shape[0],
                                               dim=0)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding (rotate-half) of x [T, heads, d] at positions
    0 .. T - 1, the angles computed in f64."""
    t, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    sin = torch.sin(ang).float()[:, None, :]
    cos = torch.cos(ang).float()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int = 512) -> torch.Tensor:
    """Causal attention of one sequence: q [T, H, d], k and v [T, Hkv, d]
    (query head i reads KV head i // (H / Hkv)) -> [T, H * d], softmax in
    f32 over query blocks."""
    t, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qh = q.reshape(t, hkv, g, d).permute(1, 2, 0, 3)           # [Hkv, g, T, d]
    kh = k.permute(1, 0, 2)                                    # [Hkv, T, d]
    vh = v.permute(1, 0, 2)
    out = torch.empty((hkv, g, t, d), dtype=torch.float32, device=q.device)
    pos = torch.arange(t, device=q.device)
    for s in range(0, t, block):
        e = min(s + block, t)
        sc = torch.matmul(qh[:, :, s:e], kh[:, None, :e].transpose(-1, -2))
        sc = sc / math.sqrt(d)
        mask = pos[None, :e] > pos[s:e, None]                  # future keys
        sc = sc.masked_fill(mask, float("-inf"))
        out[:, :, s:e] = torch.matmul(torch.softmax(sc, dim=-1),
                                      vh[:, None, :e])
    return out.permute(2, 0, 1, 3).reshape(t, hq * d)


def _forward_hidden(packed, d, family, seqs):
    """Final hidden states f32 [sum T, hidden] of the token sequences."""
    mlp = importlib.import_module(f"bench_port.reference.{family}").mlp
    lens = [len(s) for s in seqs]
    dev = packed.embed.device
    ids = torch.cat([torch.as_tensor(s, dtype=torch.long) for s in seqs])
    x = packed.embed[ids.to(dev)].float()
    hd, hq, hkv = d["head_dim"], d["heads"], d["kv_heads"]
    for l in range(d["layers"]):
        h = rms_norm(x, packed.norms[2 * l], d["eps"])
        q = h @ dequant(packed.linears[f"l{l}.q"])
        k = h @ dequant(packed.linears[f"l{l}.k"])
        v = h @ dequant(packed.linears[f"l{l}.v"])
        att = torch.empty_like(q)
        o = 0
        for t in lens:
            att[o:o + t] = attention(
                rope(q[o:o + t].reshape(t, hq, hd), d["theta"]),
                rope(k[o:o + t].reshape(t, hkv, hd), d["theta"]),
                v[o:o + t].reshape(t, hkv, hd))
            o += t
        del q, k, v
        x = x + att @ dequant(packed.linears[f"l{l}.o"])
        del att
        h = rms_norm(x, packed.norms[2 * l + 1], d["eps"])
        x = x + mlp(packed, d, l, h)
    return x


def served_gaps(packed, d, family, samples) -> list[torch.Tensor]:
    """For each (prompt, served tokens) pair: the gap by which each served
    token's logit lies below the best logit at its position, f32 [n]."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            seqs = [list(p) + list(s[:-1]) for p, s in samples]
            x = _forward_hidden(packed, d, family, seqs)
            rows, o = [], 0
            for (p, s), seq in zip(samples, seqs):
                rows.append(torch.arange(o + len(p) - 1, o + len(seq)))
                o += len(seq)
            sel = x[torch.cat(rows).to(x.device)]
            del x
            h = rms_norm(sel, packed.norms[-1], d["eps"])
            logits = h @ dequant(packed.linears["head"])
            tok = torch.cat([torch.as_tensor(s, dtype=torch.long)
                             for _, s in samples]).to(logits.device)
            gaps = logits.max(dim=-1).values - logits.gather(
                1, tok[:, None])[:, 0]
            return list(gaps.cpu().split([len(s) for _, s in samples]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
