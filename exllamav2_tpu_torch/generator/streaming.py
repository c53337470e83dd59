"""Legacy streaming generator (ExLlamaV2StreamingGenerator analog,
generator/streaming.py): single-sequence token-by-token streaming API.

Superseded by the dynamic generator (as in the reference); provided for
API familiarity: begin_stream_ex / stream_ex loop.
"""

from __future__ import annotations

import numpy as np

from exllamav2_tpu_torch.generator.sampler import Settings

__all__ = ["StreamingGenerator"]


class StreamingGenerator:
    def __init__(self, model, cache, tokenizer):
        from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
        self.generator = DynamicGenerator(model, cache, tokenizer)
        self.tokenizer = self.generator.tokenizer
        self.job = None
        self._queue: list[dict] = []
        self.stop_settings: list = []

    def set_stop_conditions(self, stop_conditions):
        self.stop_settings = list(stop_conditions or [])

    def begin_stream_ex(self, input_ids, gen_settings: Settings | None = None,
                        token_healing: bool = False,
                        max_new_tokens: int = 10 ** 9,
                        banned_strings: list[str] | None = None,
                        return_probabilities: bool = False,
                        return_top_tokens: int = 0,
                        return_logits: bool = False,
                        loras=None,
                        decode_special_tokens: bool = False):
        from exllamav2_tpu_torch.generator.dynamic import DynamicJob
        if loras is not None:
            # reference streaming generator takes per-call LoRA lists
            # (streaming.py begin_stream_ex loras arg)
            self.generator.set_loras(
                loras if isinstance(loras, list) else [loras])
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        self.job = self.generator.enqueue(DynamicJob(
            ids, max_new_tokens=max_new_tokens,
            settings=gen_settings or Settings(),
            stop_conditions=self.stop_settings,
            token_healing=token_healing,
            banned_strings=banned_strings,
            return_probs=return_probabilities,
            return_top_tokens=return_top_tokens,
            return_logits=return_logits,
            decode_special_tokens=decode_special_tokens))
        self._queue = []

    def stream_ex(self) -> dict:
        """-> {"chunk", "eos", "chunk_token_ids"} + the optional
        probs/top_probs/logits extras when requested at begin_stream_ex
        (reference streaming.py:180-220 return-* surface)."""
        assert self.job is not None, "begin_stream_ex first"
        while not self._queue and self.job.status != "done":
            for r in self.generator.iterate():
                if r.get("serial") == id(self.job) and \
                        r["stage"] == "streaming":
                    self._queue.append(r)
        if not self._queue:
            return {"chunk": "", "eos": True,
                    "chunk_token_ids": np.empty((0,), np.int32)}
        r = self._queue.pop(0)
        out = {"chunk": r.get("text", ""), "eos": bool(r.get("eos")),
               "chunk_token_ids": np.asarray(r.get("token_ids", []))}
        for key in ("token_probs", "top_k_tokens", "top_k_probs",
                    "logits"):
            if key in r:
                out[key] = r[key]
        return out

    def stream(self) -> tuple[str, bool, np.ndarray]:
        r = self.stream_ex()
        return r["chunk"], r["eos"], r["chunk_token_ids"]
