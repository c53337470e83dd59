"""Speculative decoding: the n-gram drafter (PyTorch port of
exllamav2_tpu/generator/speculative.py).

A round drafts d tokens cheaply, verifies them with one t = d + 1 forward
of the main model and accepts the matching prefix plus one more token
(generator/dynamic.py _decode_spec). The KV rows of rejected drafts are
overwritten by later appends before any query attends to them, as the pad
rows of a chunked prefill are, so nothing is rolled back on the device;
only the host's positions move.

The n-gram drafter is a host-side table of continuations over each job's
sequence; the draft-model drafter is k greedy decode steps of a small model
in one step graph (dynamic.py _draft_fn).
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np

__all__ = ["NgramDrafter"]


class NgramDrafter:
    """Per-job n-gram continuation table: for every n < max_n, the tokens
    that followed each n-gram of the sequence, counted."""

    def __init__(self, max_n: int = 4):
        self.max_n = max_n
        self.tables = {}       # job id -> {ngram tuple -> Counter}
        self.positions = {}    # job id -> tokens indexed so far

    def reset(self, job_key):
        self.tables.pop(job_key, None)
        self.positions.pop(job_key, None)

    def update(self, job_key, sequence: np.ndarray):
        """Index new tokens of the sequence into the table."""
        tab = self.tables.setdefault(job_key, defaultdict(Counter))
        start = self.positions.get(job_key, 0)
        seq = sequence.tolist()
        lo = max(1, start - self.max_n)
        for i in range(lo, len(seq)):
            for n in range(1, self.max_n):
                if i - n < 0:
                    break
                tab[tuple(seq[i - n:i])][seq[i]] += 1
        self.positions[job_key] = len(seq)

    def draft(self, job_key, sequence: np.ndarray, k: int) -> np.ndarray:
        """Greedily draft up to k continuation tokens (may return fewer)."""
        tab = self.tables.get(job_key)
        if not tab:
            return np.zeros((0,), np.int32)
        seq = sequence.tolist()
        out = []
        for _ in range(k):
            tok = None
            for n in range(self.max_n - 1, 0, -1):
                key = tuple(seq[-n:]) if n <= len(seq) else None
                if key is not None and key in tab:
                    tok = tab[key].most_common(1)[0][0]
                    break
            if tok is None:
                break
            out.append(tok)
            seq.append(tok)
        return np.asarray(out, np.int32)
