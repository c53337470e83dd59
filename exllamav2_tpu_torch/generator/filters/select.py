"""Select filter: constrain output to one of N fixed strings
(ExLlamaV2SelectFilter analog, generator/filters/select.py)."""

from __future__ import annotations

from exllamav2_tpu_torch.generator.filters.base import (
    Filter, allowed_for_remainders, piece_table)

__all__ = ["SelectFilter"]


class SelectFilter(Filter):
    def __init__(self, tokenizer, options: list[str],
                 case_insensitive: bool = False):
        super().__init__(tokenizer)
        self.options = list(options)
        self.case_insensitive = case_insensitive
        self._matched = ""

    def begin(self, prefix_str: str = "") -> None:
        self._matched = ""

    def feed(self, token: int) -> None:
        self._matched += piece_table(self.tokenizer)[int(token)]

    def _norm(self, s: str) -> str:
        return s.lower() if self.case_insensitive else s

    def is_completed(self) -> bool:
        m = self._norm(self._matched)
        return any(m.startswith(self._norm(o)) for o in self.options)

    def next(self):
        if self.is_completed():
            return set(), set()     # option fully emitted -> end
        m = self._norm(self._matched)
        rema = [o[len(self._matched):] for o in self.options
                if self._norm(o).startswith(m)]
        if not rema:
            return set(), set()
        return allowed_for_remainders(self.tokenizer, rema)
