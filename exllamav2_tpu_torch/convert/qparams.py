"""Quantization parameter grids and exact bit accounting.

Copy of exllamav2_tpu/convert/qparams.py (host code; this package imports
nothing of the JAX package).

Analog of conversion/qparams.py: a QParams names per-group bit widths and
proportions; total_bits accounts for packed weights, 4-bit scales,
qscale_max, the group table and the act-order permutation
(qparams.py:60-113). Candidate grids per layer type follow the
reference's qparams_attn / qparams_mlp tables in spirit (a spread from
~2 to ~8 bpw with mixed-precision splits).
"""

from __future__ import annotations

import dataclasses

__all__ = ["QParams", "qparams_attn", "qparams_mlp", "qparams_head",
           "qparams_head_for"]


@dataclasses.dataclass(frozen=True)
class QParams:
    group_size: int
    bits: tuple            # per-segment widths, e.g. (4, 3)
    bits_prop: tuple       # proportion of rows per width, sums to 1
    scale_bits: int = 4

    def groups(self, rows: int) -> list[tuple[int, int, int]]:
        """-> [(bits, row_start, row_end)] covering [0, rows) with
        group_size-aligned boundaries."""
        out = []
        total_groups = -(-rows // self.group_size)
        g = 0
        for i, (b, p) in enumerate(zip(self.bits, self.bits_prop)):
            if i == len(self.bits) - 1:
                ng = total_groups - g
            else:
                ng = int(round(total_groups * p))
            for _ in range(ng):
                a = g * self.group_size
                e = min(a + self.group_size, rows)
                if a >= rows:
                    break
                out.append((b, a, e))
                g += 1
        return out

    def total_bits(self, rows: int, columns: int) -> int:
        """Exact stored size in bits (qparams.py:60-113)."""
        bits = 0
        groups = 0
        for (b, a, e) in self.groups(rows):
            bits += -(-((e - a) * b) // 32) * 32 * columns
            groups += 1
        bits += groups * columns * 4          # q_scale (packed 4-bit)
        bits += groups * 16                   # q_scale_max f16
        bits += groups * 2 * 16               # q_groups table
        bits += rows * 32                     # q_invperm
        return bits

    def bpw(self, rows: int, columns: int) -> float:
        return self.total_bits(rows, columns) / (rows * columns)

    @property
    def desc(self) -> str:
        return "/".join(f"{b}b" for b in self.bits) + f" g{self.group_size}"


def qparams_attn(group_size: int = 32) -> list[QParams]:
    """Candidate grid for q/k/v/o (qparams.py:131-199 in spirit).

    group_size=128 emits checkpoints with the coarser groups of the W4A8
    decode mode (ops/dequant.enable_w4a8), at a small quality cost that
    the measurement stage prices in per layer like any other option."""
    g = group_size
    return [
        QParams(g, (2,), (1.0,)),
        QParams(g, (3, 2), (0.25, 0.75)),
        QParams(g, (3,), (1.0,)),
        QParams(g, (4, 3), (0.25, 0.75)),
        QParams(g, (4, 3), (0.75, 0.25)),
        QParams(g, (4,), (1.0,)),
        QParams(g, (5, 4), (0.5, 0.5)),
        QParams(g, (5,), (1.0,)),
        QParams(g, (6,), (1.0,)),
        QParams(g, (8,), (1.0,)),
    ]


def qparams_mlp(group_size: int = 32) -> list[QParams]:
    g = group_size
    return [
        QParams(g, (2,), (1.0,)),
        QParams(g, (3, 2), (0.3, 0.7)),
        QParams(g, (3,), (1.0,)),
        QParams(g, (4, 3), (0.25, 0.75)),
        QParams(g, (4,), (1.0,)),
        QParams(g, (5, 4), (0.5, 0.5)),
        QParams(g, (5,), (1.0,)),
        QParams(g, (6,), (1.0,)),
        QParams(g, (8,), (1.0,)),
    ]


def qparams_head() -> list[QParams]:
    """lm_head options (qparams.py:338)."""
    return [
        QParams(32, (6,), (1.0,)),
        QParams(32, (8,), (1.0,)),
    ]


# head_bits -> QParams (reference qparams_headoptions, qparams.py:338-347)
_HEAD_OPTIONS = {
    2: QParams(32, (4, 2), (0.3, 0.7)),
    3: QParams(32, (4, 3), (0.15, 0.85)),
    4: QParams(32, (6, 4), (0.15, 0.85)),
    5: QParams(128, (6, 5), (0.15, 0.85)),
    6: QParams(128, (8, 6), (0.15, 0.85)),
    8: QParams(128, (8,), (1.0,)),
}


def qparams_head_for(head_bits: int | None) -> QParams | None:
    """QParams for lm_head at the given width; None keeps it fp16."""
    if head_bits is None or head_bits >= 16:
        return None
    return _HEAD_OPTIONS[head_bits]
