"""String helpers of the generator's stop handling.

Counterparts of find_first_match and max_partial_overlap in
exllamav2_tpu/native/__init__.py, in their pure-Python form: this package has
no compiled string helper (the C++ helpers of exllamav2_tpu/native/native.cpp
come with the generator features that need them).
"""

from __future__ import annotations

__all__ = ["find_first_match", "max_partial_overlap"]


def find_first_match(haystack: str, needles: list[str]) -> tuple[int, int]:
    """-> (pos, needle_idx) of the earliest full match, or (-1, -1)."""
    best = (-1, -1)
    for i, s in enumerate(needles):
        p = haystack.find(s)
        if p >= 0 and (best[0] < 0 or p < best[0]):
            best = (p, i)
    return best


def max_partial_overlap(haystack: str, needles: list[str]) -> int:
    """Longest suffix of haystack that prefixes any needle."""
    best = 0
    for s in needles:
        for k in range(min(len(s), len(haystack)), best, -1):
            if haystack.endswith(s[:k]):
                best = k
                break
    return best
