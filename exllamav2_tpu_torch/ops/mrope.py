"""MRoPE: 3-axis (temporal/height/width) rotary positions for Qwen2-VL
(PyTorch port of exllamav2_tpu/ops/mrope.py; host numpy, the same arrays
bit for bit).

Position ids are generated on the host (one walk over the prompt per job);
the sin/cos rows they give feed the standard apply_rope (tables are
[T, rot/2] with the mrope_section interleave baked into the columns, so the
model forward needs no MRoPE-specific math).

After the multimodal prompt, text positions advance all three axes in
lockstep, so decode needs only a per-job offset into the standard rope
table (gen_mrope_pos_ids returns the next position, the offset follows).
"""

from __future__ import annotations

import numpy as np

__all__ = ["gen_mrope_pos_ids", "mrope_rows"]


def gen_mrope_pos_ids(ids: np.ndarray, merge_size: int,
                      spans: list[tuple[int, int]],
                      grids: list[tuple[int, int, int]],
                      max_length: int) -> tuple[np.ndarray, int]:
    """-> (pos_ids [3, max_length], next_offset).

    ids: full token sequence (may contain MM token ids >= 1e9);
    spans: [(first_vision_token_id, end_id)] per embedding (id range of
    the *vision* rows, excluding pre/post text tokens);
    grids: (t, h, w) patch grid per embedding (pre-merge).
    """
    pos = np.zeros((3, max_length), np.int64)
    n = 0                                  # sequence cursor
    base = 0                               # next text position
    L = len(ids)
    while n < max_length:
        in_span = None
        if n < L:
            for (smin, smax), thw in zip(spans, grids):
                if smin <= ids[n] < smax:
                    in_span = thw
                    break
        if in_span is not None:
            t, h, w = in_span
            h, w = h // merge_size, w // merge_size
            span_len = t * h * w
            tt = np.repeat(np.arange(t), h * w)
            hh = np.tile(np.repeat(np.arange(h), w), t)
            ww = np.tile(np.arange(w), t * h)
            end = min(n + span_len, max_length)
            m = end - n
            pos[0, n:end] = base + tt[:m]
            pos[1, n:end] = base + hh[:m]
            pos[2, n:end] = base + ww[:m]
            base = base + max(t, h, w)
            n = end
        else:
            pos[:, n] = base
            base += 1
            n += 1
    return pos, int(base)


def mrope_rows(pos_ids: np.ndarray, inv_freq: np.ndarray,
               mrope_section: list[int],
               scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """pos_ids [3, T] -> (sin, cos) [T, rot/2] f32 with the section
    interleave (mrope.py:62-73): column block i of the half-dim table
    takes its positions from axis i % 3."""
    freqs = pos_ids[:, :, None].astype(np.float64) * inv_freq[None, None, :]
    sin3 = np.sin(freqs) * scale                     # [3, T, rot/2]
    cos3 = np.cos(freqs) * scale
    halfdim = inv_freq.shape[0]
    assert sum(mrope_section) == halfdim, (mrope_section, halfdim)
    sin = np.empty((pos_ids.shape[1], halfdim), np.float32)
    cos = np.empty_like(sin)
    col = 0
    for i, sec in enumerate(mrope_section):
        sin[:, col:col + sec] = sin3[i % 3, :, col:col + sec]
        cos[:, col:col + sec] = cos3[i % 3, :, col:col + sec]
        col += sec
    return sin, cos
