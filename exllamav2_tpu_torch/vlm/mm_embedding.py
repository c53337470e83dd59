"""Multimodal embedding container and its token-id allocator (PyTorch port
of exllamav2_tpu/vlm/mm_embedding.py).

An image's or a video's feature rows get a token-id range of their own,
from EMBEDDING_INDEX up, so that prompts interleave text ids with embedding
ids; distinct ranges also give distinct page hashes, so the paged cache's
prompt dedup tells two images apart and reuses the pages of the same one.
"""

from __future__ import annotations

import numpy as np
import torch

from exllamav2_tpu_torch.device import resolve_device

__all__ = ["MMEmbedding", "EMBEDDING_INDEX"]

EMBEDDING_INDEX = 1_000_000_000


class _Allocator:
    def __init__(self):
        self.next_index = EMBEDDING_INDEX

    def allocate(self, num_tokens: int) -> int:
        idx = self.next_index
        self.next_index += num_tokens
        # ids must stay int32-safe for the device-side history buffers
        assert self.next_index < 2**31 - 1, "MM token-id space exhausted"
        return idx


global_allocator = _Allocator()


class MMEmbedding:
    """One embedded image or video and its metadata: ``embeddings`` [n, d]
    bf16 on the device of the tensor given (a numpy array goes to
    `device`, the card by default)."""

    def __init__(self, embeddings, text_alias: str | None = None,
                 thw_grid: tuple | None = None,
                 pre_tokens: int = 0, post_tokens: int = 0, *,
                 device=None):
        if isinstance(embeddings, torch.Tensor):
            dev = embeddings.device if device is None else device
            self.embeddings = embeddings.to(dev, torch.bfloat16)
        else:
            self.embeddings = torch.as_tensor(
                np.asarray(embeddings, np.float32),
                device=resolve_device(device)).to(torch.bfloat16)
        self.length = int(self.embeddings.shape[0])
        self.thw_grid = thw_grid
        self.pre_tokens = pre_tokens
        self.post_tokens = post_tokens
        self.metadata: dict = {}
        self.first_index = global_allocator.allocate(self.length)
        self.text_alias = text_alias or f"<$EMB_{self.first_index}$>"

    def get_ids(self) -> list[int]:
        return list(range(self.first_index, self.first_index + self.length))

    def get_ids_array(self) -> np.ndarray:
        return np.arange(self.first_index, self.first_index + self.length,
                         dtype=np.int64)

    def get_vision_token_range(self) -> tuple[int, int]:
        """Id range of the vision rows proper (without the marker rows
        before and after), for MRoPE span detection."""
        return (self.first_index + self.pre_tokens,
                self.first_index + self.length - self.post_tokens)

    def get_size_in_bytes(self) -> int:
        return int(self.embeddings.numel()) * 2
