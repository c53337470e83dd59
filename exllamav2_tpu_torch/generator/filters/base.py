"""Constrained-decoding filter interface.

PyTorch port of exllamav2_tpu/generator/filters/base.py (host-only, copied):
a filter exposes begin/feed/next and yields (pass set, end set) per step.
The generator turns the pass set into a packed bitmask for the sampler on
the device (ops/sampling.unpack_mask); external grammar engines
(lm-format-enforcer, formatron) plug in through this same interface.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Filter", "piece_table"]

_PIECE_CACHE: dict[int, list[str]] = {}


def piece_table(tokenizer) -> list[str]:
    """Decoded piece per token id (cached per tokenizer instance)."""
    key = id(tokenizer)
    if key not in _PIECE_CACHE:
        pieces = []
        for i in range(tokenizer.vocab_size):
            try:
                pieces.append(tokenizer.decode(np.asarray([i])))
            except Exception:
                pieces.append("")
        _PIECE_CACHE[key] = pieces
    return _PIECE_CACHE[key]


class Filter:
    """Base class (ExLlamaV2Filter analog)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.sequence_str = ""

    def clone(self):
        import copy
        return copy.copy(self)

    def begin(self, prefix_str: str = "") -> None:
        self.sequence_str = prefix_str

    def feed(self, token: int) -> None:
        self.sequence_str += piece_table(self.tokenizer)[int(token)]

    def next(self) -> tuple[set[int] | None, set[int]]:
        """-> (allowed token ids or None = unconstrained, tokens that end
        the constrained region)."""
        raise NotImplementedError

    def is_completed(self) -> bool:
        return False


def allowed_for_remainders(tokenizer, remainders: list[str]
                           ) -> tuple[set[int], set[int]]:
    """Tokens whose piece advances any remainder string.

    -> (pass set, end set): a piece passes when it is a prefix of some
    remainder or some remainder is a prefix of it; it ends the constraint
    when it covers an entire remainder.
    """
    pieces = piece_table(tokenizer)
    pass_set: set[int] = set()
    end_set: set[int] = set()
    for tid, p in enumerate(pieces):
        if not p:
            continue
        for r in remainders:
            if not r:
                continue
            if p.startswith(r):
                pass_set.add(tid)
                end_set.add(tid)
                break
            if r.startswith(p):
                pass_set.add(tid)
                if len(p) == len(r):
                    end_set.add(tid)
                break
    return pass_set, end_set
