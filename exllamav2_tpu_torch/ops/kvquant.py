"""KV-cache quantization: FP8 / Q4 / Q8 with a Hadamard rotation per group.

Counterpart of exllamav2_tpu/ops/kvquant.py, same scheme bit for bit:
  * groups of group_for(D) consecutive elements along head_dim (32 for the
    common dims);
  * rotate: r = x @ H (unnormalized +-1 Hadamard; the 1/g folds into dequant)
  * Q4: q = clamp(round(r / s + 8), 0, 15),    s = absmax / 8
  * Q8: q = clamp(round(r / s + 128), 0, 255), s = absmax / 128
    (s pre-rounded to its bf16 storage value, bumped up one ulp when bf16
    rounded it below absmax / qmax: _bf16_scale_consistent)
  * dequant: (q - mid) * s, then @ H.T / g
  * FP8: round-to-nearest-even cast to e5m2.
Q4 packs two nibbles per byte in halves: byte j = el[j] | el[j + D/2] << 4.
kv_quant runs as torch ops on append (the reference has no kernel for it).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hadamard32", "hadamard_for", "group_for", "num_groups",
           "kv_quant", "kv_dequant", "cache_bytes_per_el", "data_shape",
           "data_dtype", "CACHE_KINDS"]

CACHE_KINDS = ("bf16", "fp8", "q4", "q8")
_GROUP = 32


def _paley1(q: int) -> np.ndarray:
    """Paley-I Hadamard of order q+1 (q prime, q = 3 mod 4): H = S + I with
    S the skew matrix of the quadratic-residue (Jacobsthal) pattern."""
    residues = {(i * i) % q for i in range(1, q)}
    chi = np.array([0] + [1 if i in residues else -1 for i in range(1, q)],
                   np.float32)
    qm = chi[(np.arange(q)[:, None] - np.arange(q)[None, :]) % q]
    smat = np.zeros((q + 1, q + 1), np.float32)
    smat[0, 1:] = 1.0
    smat[1:, 0] = -1.0
    smat[1:, 1:] = qm
    h = smat + np.eye(q + 1, dtype=np.float32)
    assert np.allclose(h @ h.T, (q + 1) * np.eye(q + 1))
    return h


def _had(n: int) -> np.ndarray:
    """Unnormalized Hadamard of order n: Sylvester doubling from 1 (n a power
    of two) or from a Paley-I seed (n = 2^a * {12, 20, 24})."""
    for seed in (12, 20, 24):
        if n % seed == 0 and (n // seed) & (n // seed - 1) == 0:
            h = _paley1(seed - 1)
            break
    else:
        assert n & (n - 1) == 0, f"no Hadamard construction for {n}"
        h = np.array([[1]], np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def group_for(d: int) -> int:
    """Rotation group width for a head_dim: the largest constructible
    Hadamard order dividing d (32 for the common dims; 24 for 72, 20 for 80
    and 100, 16 for 112)."""
    for g in (32, 24, 20, 16, 12, 8, 4):
        if d % g == 0:
            return g
    raise ValueError(f"head_dim {d} not divisible by 4")


def num_groups(d: int) -> int:
    """Scale entries per cached [.., D] row for quantized kinds."""
    return d // group_for(d)


_HAD_CACHE: dict[int, np.ndarray] = {_GROUP: _had(_GROUP)}
# per (order, dtype, device): the decode step uses these every layer, and a
# fresh host-to-device copy of a pageable array may wait on the stream
_HAD_TENSORS: dict[tuple, torch.Tensor] = {}


def hadamard_for(g: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Unnormalized g x g Hadamard; H @ H.T = g I."""
    key = (g, dtype, torch.device(device or "cpu"))
    t = _HAD_TENSORS.get(key)
    if t is None:
        if g not in _HAD_CACHE:
            _HAD_CACHE[g] = _had(g)
        t = torch.as_tensor(_HAD_CACHE[g], device=key[2]).to(dtype)
        _HAD_TENSORS[key] = t
    return t


def hadamard32(dtype=torch.float32, device=None) -> torch.Tensor:
    """Unnormalized 32x32 Hadamard (entries +-1); H @ H = 32 I."""
    return hadamard_for(_GROUP, dtype, device)


def _bf16_scale_consistent(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """Group scale pre-rounded to its bf16 storage value, bumped up one ulp
    where bf16 rounded it below absmax / qmax (so |r / s| <= qmax). Returns
    f32 [..., G, 1] equal to the stored bf16 value."""
    s = (absmax / qmax).to(torch.bfloat16)
    sf = s.float()
    s_up = (s.view(torch.int16) + 1).view(torch.bfloat16).float()
    return torch.where(sf * qmax < absmax, s_up, sf)


def kv_quant(x: torch.Tensor, kind: str):
    """x [..., D] float -> (data, scales [..., D / g] bf16 | None)."""
    if kind == "bf16":
        return x.to(torch.bfloat16), None
    if kind == "fp8":
        return x.to(torch.float8_e5m2), None
    d = x.shape[-1]
    gw = group_for(d)
    g = d // gw
    xf = x.float().reshape(*x.shape[:-1], g, gw)
    r = xf @ hadamard_for(gw, device=x.device)
    absmax = torch.clamp(r.abs().amax(dim=-1, keepdim=True), min=1e-8)
    if kind == "q4":
        s = _bf16_scale_consistent(absmax, 8.0)           # [..., G, 1]
        q = torch.clamp(torch.round(r / s + 8.0), 0, 15)
        q = q.reshape(*x.shape[:-1], d).to(torch.uint8)
        data = q[..., :d // 2] | (q[..., d // 2:] << 4)
        return data, s[..., 0].to(torch.bfloat16)
    if kind == "q8":
        s = _bf16_scale_consistent(absmax, 128.0)
        q = torch.clamp(torch.round(r / s + 128.0), 0, 255)
        data = q.to(torch.uint8).reshape(*x.shape[:-1], d)
        return data, s[..., 0].to(torch.bfloat16)
    raise ValueError(kind)


def kv_dequant(data: torch.Tensor, scales: torch.Tensor | None, kind: str,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of kv_quant -> [..., D] in `dtype`."""
    if kind in ("bf16", "fp8"):
        return data.to(dtype)
    if kind == "q4":
        lo = (data & 0x0F).float() - 8.0
        hi = ((data >> 4) & 0x0F).float() - 8.0
        q = torch.cat([lo, hi], dim=-1)                   # natural order
    elif kind == "q8":
        q = data.float() - 128.0
    else:
        raise ValueError(kind)
    d = q.shape[-1]
    gw = group_for(d)
    q = q.reshape(*q.shape[:-1], d // gw, gw)
    r = q * scales.float()[..., None]
    y = (r @ hadamard_for(gw, device=data.device).T) * (1.0 / gw)
    return y.reshape(*data.shape[:-1], d).to(dtype)


def cache_bytes_per_el(kind: str) -> float:
    """Device-memory bytes per cached element (scales included)."""
    return {"bf16": 2.0, "fp8": 1.0,
            "q4": 0.5 + 2.0 / _GROUP, "q8": 1.0 + 2.0 / _GROUP}[kind]


def data_shape(kind: str, d: int) -> tuple[int, ...]:
    """Trailing data dims for one [.., D] row of cache."""
    return {"bf16": (d,), "fp8": (d,), "q4": (d // 2,), "q8": (d,)}[kind]


def data_dtype(kind: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "fp8": torch.float8_e5m2,
            "q4": torch.uint8, "q8": torch.uint8}[kind]
