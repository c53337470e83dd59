"""Prefix filter: force generation to start with a given string
(ExLlamaV2PrefixFilter analog, generator/filters/prefix.py)."""

from __future__ import annotations

from exllamav2_tpu_torch.generator.filters.base import (
    Filter, allowed_for_remainders, piece_table)

__all__ = ["PrefixFilter"]


class PrefixFilter(Filter):
    def __init__(self, tokenizer, prefix: str | list[str]):
        super().__init__(tokenizer)
        self.prefixes = [prefix] if isinstance(prefix, str) else list(prefix)
        self._matched = ""

    def begin(self, prefix_str: str = "") -> None:
        self._matched = ""

    def feed(self, token: int) -> None:
        self._matched += piece_table(self.tokenizer)[int(token)]

    def is_completed(self) -> bool:
        return any(self._matched.startswith(p) for p in self.prefixes)

    def next(self):
        if self.is_completed():
            return None, set()      # unconstrained from here on
        rema = [p[len(self._matched):] for p in self.prefixes
                if p.startswith(self._matched)]
        if not rema:
            return set(), set()     # dead end (shouldn't happen)
        return allowed_for_remainders(self.tokenizer, rema)
