"""Post-sampling hook interface (reference generator/hooks.py).

A hook is a callable receiving a PostSamplingResult after each sampled
token; it can inspect candidates/probabilities and suppress filter
feedback by setting feed_filters=False.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

__all__ = ["PostSamplingResult", "PostSamplingHook"]


@dataclasses.dataclass
class PostSamplingResult:
    sampled_token: int | None = None
    sampled_prob: float | None = None
    candidate_tokens: Optional[np.ndarray] = None   # [K] top tokens
    candidate_probs: Optional[np.ndarray] = None    # [K]
    logits: Optional[np.ndarray] = None

    feed_filters: bool = True


PostSamplingHook = Callable[[PostSamplingResult], None]
