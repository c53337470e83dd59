"""Adapters for external constrained-decoding engines.

The reference integrates lm-format-enforcer and formatron through its
filter interface via example glue (examples/inference_lmfe.py /
inference_formatron.py). These adapters play that role here: wrap an
external engine object behind the Filter begin/feed/next contract so the
dynamic generator can drive it. Engines are optional dependencies —
construction fails with a clear error when the package is missing.
"""

from __future__ import annotations

import inspect

from exllamav2_tpu_torch.generator.filters.base import Filter

__all__ = ["LMFormatEnforcerFilter", "FormatronFilter", "CallableFilter"]


class CallableFilter(Filter):
    """Minimal adapter: `allowed_fn(tokens_so_far) -> set[int] | None`
    (None = unconstrained). `eos_ends` marks whether sampling an allowed
    eos completes the constraint."""

    def __init__(self, tokenizer, allowed_fn, eos_ids=()):
        super().__init__(tokenizer)
        self.allowed_fn = allowed_fn
        self.eos_ids = set(eos_ids)
        self._fed: list[int] = []

    def begin(self, prefix: str = "") -> None:
        self._fed = []

    def feed(self, token: int) -> None:
        self._fed.append(int(token))

    def next(self):
        allowed = self.allowed_fn(list(self._fed))
        if allowed is None:
            return None, set()
        return set(allowed), set(a for a in allowed if a in self.eos_ids)

    def is_completed(self) -> bool:
        return False


class LMFormatEnforcerFilter(Filter):
    """lm-format-enforcer bridge (examples/inference_lmfe.py analog).

    Takes a `CharacterLevelParser` (e.g. JsonSchemaParser) and drives a
    TokenEnforcer over this framework's tokenizer.
    """

    def __init__(self, tokenizer, character_level_parser):
        super().__init__(tokenizer)
        try:
            from lmformatenforcer import TokenEnforcer, TokenEnforcerTokenizerData
        except ImportError as e:                      # pragma: no cover
            raise ImportError(
                "pip install lm-format-enforcer to use "
                "LMFormatEnforcerFilter") from e
        # decoded strings, not raw vocab pieces — the parser is
        # character-level over output text ("▁the" must register as
        # " the")
        pieces = tokenizer.get_id_to_decoded_list()

        def decode(tokens):
            return tokenizer.decode(tokens)

        # lm-format-enforcer 0.11 takes the token-list kind and the vocab
        # size too (and returns a TokenList, whose allowed_tokens is a list
        # without the bitmask); earlier versions take neither
        kw = {}
        if "use_bitmask" in inspect.signature(
                TokenEnforcerTokenizerData.__init__).parameters:
            kw = {"use_bitmask": False, "vocab_size": len(pieces)}
        data = TokenEnforcerTokenizerData(
            regular_tokens=[(i, p, p.startswith(" "))
                            for i, p in enumerate(pieces)],
            decoder=decode,
            eos_token_id=tokenizer.eos_token_id or 0, **kw)
        self.enforcer = TokenEnforcer(data, character_level_parser)
        self._fed: list[int] = []

    def begin(self, prefix: str = "") -> None:
        self._fed = []

    def feed(self, token: int) -> None:
        self._fed.append(int(token))

    def next(self):
        allowed = self.enforcer.get_allowed_tokens(self._fed)
        allowed = getattr(allowed, "allowed_tokens", allowed)
        eos = self.tokenizer.eos_token_id
        ends = {eos} if eos in allowed else set()
        return set(allowed), ends

    def is_completed(self) -> bool:
        return False


class FormatronFilter(Filter):
    """formatron bridge: wraps a formatron FormatterBuilder result.

    The formatter consumes generated text and exposes the permitted
    next-token id set per step.
    """

    def __init__(self, tokenizer, formatter):
        super().__init__(tokenizer)
        self.formatter = formatter
        self._done = False

    def begin(self, prefix: str = "") -> None:
        self._done = False

    def feed(self, token: int) -> None:
        if hasattr(self.formatter, "accept_token"):
            res = self.formatter.accept_token(int(token))
            self._done = bool(getattr(res, "finished", False) or res is True)

    def next(self):
        if self._done:
            return set(), set()
        if hasattr(self.formatter, "compute_allowed_tokens"):
            self.formatter.compute_allowed_tokens()
        allowed = getattr(self.formatter, "allowed_tokens", None)
        if allowed is None:
            return None, set()
        eos = self.tokenizer.eos_token_id
        allowed = set(int(t) for t in allowed)
        return allowed, ({eos} if eos in allowed else set())

    def is_completed(self) -> bool:
        return self._done
