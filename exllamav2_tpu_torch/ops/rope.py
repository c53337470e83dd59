"""Rotary position embeddings: frequency computation + application.

Counterpart of exllamav2_tpu/ops/rope.py: every scaling variant (default,
linear, NTK-alpha/dynamic, YaRN, llama3, su/longrope) builds host numpy
tables once at load; application is plain tensor math (GPTJ/NEOX styles).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from exllamav2_tpu_torch.architecture import RopeStyle

__all__ = ["rope_params", "build_sincos", "apply_rope"]


def rope_params(cfg) -> tuple[np.ndarray, float]:
    """-> (inv_freq [rotary_dim/2] f64, attention scaling factor).

    cfg needs: rotary_embedding_base, rotary_dim (or head_dim),
    rope_scaling (HF dict or None), max_position_embeddings,
    original_max_position_embeddings.
    """
    dim = getattr(cfg, "rotary_dim", None) or cfg.head_dim
    base = float(cfg.rotary_embedding_base)
    rs = getattr(cfg, "rope_scaling", None) or {}
    rope_type = rs.get("rope_type", rs.get("type", "default"))
    scale = 1.0

    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))

    if rope_type in ("default", "mrope"):
        pass

    elif rope_type == "linear":
        factor = float(rs.get("factor", 1.0))
        inv_freq = inv_freq / factor

    elif rope_type == "ntk":
        # NTK-alpha: scale the base
        alpha = float(rs.get("alpha", rs.get("factor", 1.0)))
        base = base * alpha ** (dim / (dim - 2))
        inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))

    elif rope_type == "dynamic":
        # HF dynamic-NTK recomputes the base as the sequence grows; a static
        # table bakes the base per position (build_sincos special-cases it)
        factor = float(rs.get("factor", 1.0))
        orig_max = int(rs.get("original_max_position_embeddings",
                              cfg.original_max_position_embeddings
                              or cfg.max_position_embeddings))
        seq_len = max(getattr(cfg, "max_seq_len", orig_max), orig_max)
        alpha = factor * seq_len / orig_max - (factor - 1)
        base_l = base * alpha ** (dim / (dim - 2))
        inv_freq = 1.0 / (base_l ** (np.arange(0, dim, 2,
                                               dtype=np.float64) / dim))

    elif rope_type == "llama3":
        factor = float(rs.get("factor", 8.0))
        lo = float(rs.get("low_freq_factor", 1.0))
        hi = float(rs.get("high_freq_factor", 4.0))
        old_len = float(rs.get("original_max_position_embeddings", 8192))
        wavelen = 2 * math.pi / inv_freq
        low_wl = old_len / lo
        high_wl = old_len / hi
        new = np.where(wavelen > low_wl, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - lo) / (hi - lo)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        mid = (wavelen <= low_wl) & (wavelen >= high_wl)
        inv_freq = np.where(mid, smoothed, new)

    elif rope_type == "yarn":
        factor = float(rs.get("factor", 1.0))
        orig_max = int(rs.get("original_max_position_embeddings",
                              cfg.original_max_position_embeddings
                              or cfg.max_position_embeddings))
        beta_fast = float(rs.get("beta_fast", 32.0))
        beta_slow = float(rs.get("beta_slow", 1.0))
        mscale = rs.get("mscale", 1.0)
        mscale_all_dim = rs.get("mscale_all_dim", 0.0)
        partial_factor = getattr(cfg, "max_seq_len", orig_max) / orig_max \
            if factor == 1.0 else factor

        def find_dim(num_rot):
            return (dim * math.log(orig_max / (num_rot * 2 * math.pi))
                    / (2 * math.log(base)))

        low = max(math.floor(find_dim(beta_fast)), 0)
        high = min(math.ceil(find_dim(beta_slow)), dim - 1)
        rng = np.arange(dim // 2, dtype=np.float64)
        # ramp 0 at the high-frequency head (extrapolate: keep inv_freq)
        # -> 1 at the low-frequency tail (interpolate: divide by factor)
        ramp = np.clip((rng - low) / max(high - low, 1e-3), 0, 1)
        inv_freq_inter = inv_freq / partial_factor
        inv_freq = inv_freq * (1 - ramp) + inv_freq_inter * ramp

        def get_mscale(s, m=1.0):
            if s <= 1.0 or m == 0.0:
                return 1.0
            return 0.1 * m * math.log(s) + 1.0

        scale = float(get_mscale(partial_factor, float(mscale))
                      / get_mscale(partial_factor, float(mscale_all_dim))) \
            if mscale_all_dim else float(get_mscale(partial_factor, float(mscale)))

    elif rope_type in ("su", "longrope"):
        orig_max = int(rs.get("original_max_position_embeddings",
                              cfg.original_max_position_embeddings
                              or cfg.max_position_embeddings))
        seq_len = getattr(cfg, "max_seq_len", orig_max)
        if seq_len > orig_max:
            ext = np.asarray(rs["long_factor"], dtype=np.float64)
        else:
            ext = np.asarray(rs["short_factor"], dtype=np.float64)
        inv_freq = inv_freq / ext
        s = seq_len / orig_max
        scale = math.sqrt(1 + math.log(max(s, 1.0)) / math.log(orig_max)) \
            if s > 1.0 else 1.0

    else:
        raise ValueError(f"unsupported rope_type {rope_type!r}")

    return inv_freq, scale


def build_sincos(cfg, max_len: int | None = None, dtype=torch.float32, *,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (sin, cos) [max_len, rotary_dim/2] tables on `device`.

    Dynamic-NTK checkpoints get a per-position base: rows below
    original_max_position_embeddings use the unscaled base, rows beyond use
    alpha evaluated at that position's length."""
    inv_freq, scale = rope_params(cfg)
    max_len = max_len or cfg.max_seq_len
    t = np.arange(max_len, dtype=np.float64)

    rs = getattr(cfg, "rope_scaling", None) or {}
    if rs.get("rope_type", rs.get("type")) == "dynamic":
        dim = getattr(cfg, "rotary_dim", None) or cfg.head_dim
        base = float(cfg.rotary_embedding_base)
        factor = float(rs.get("factor", 1.0))
        orig_max = int(rs.get("original_max_position_embeddings",
                              cfg.original_max_position_embeddings
                              or cfg.max_position_embeddings))
        alpha_t = np.maximum(
            factor * (t + 1.0) / orig_max - (factor - 1.0), 1.0)
        base_t = base * alpha_t ** (dim / (dim - 2))       # [T]
        exp = np.arange(0, dim, 2, dtype=np.float64) / dim  # [rot/2]
        inv_freq_t = 1.0 / (base_t[:, None] ** exp[None, :])
        freqs = t[:, None] * inv_freq_t
    else:
        freqs = np.outer(t, inv_freq)
    sin = np.sin(freqs) * scale
    cos = np.cos(freqs) * scale
    return (torch.as_tensor(sin.astype(np.float32), device=device).to(dtype),
            torch.as_tensor(cos.astype(np.float32), device=device).to(dtype))


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               style: RopeStyle = RopeStyle.NEOX) -> torch.Tensor:
    """Apply rotary embedding to x [..., T, H, D].

    sin/cos are [T, rot/2] (already gathered at the right positions).
    NEOX rotates halves [x1; x2] -> [x1 c - x2 s; x2 c + x1 s]; GPTJ rotates
    interleaved even/odd pairs. Rows beyond rotary_dim pass through unchanged
    (partial rotary).
    """
    if style == RopeStyle.NONE:
        return x
    rot = sin.shape[-1] * 2
    d = x.shape[-1]
    xf = x[..., :rot].float()
    s = sin[..., :, None, :]   # [T, 1, rot/2] broadcasting over heads
    c = cos[..., :, None, :]
    if style == RopeStyle.NEOX:
        x1 = xf[..., : rot // 2]
        x2 = xf[..., rot // 2:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:  # GPTJ interleaved
        x1 = xf[..., 0::2]
        x2 = xf[..., 1::2]
        r1 = x1 * c - x2 * s
        r2 = x2 * c + x1 * s
        out = torch.stack([r1, r2], dim=-1).reshape(xf.shape)
    out = out.to(x.dtype)
    if rot < d:
        out = torch.cat([out, x[..., rot:]], dim=-1)
    return out
