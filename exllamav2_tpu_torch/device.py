"""Device selection for the package's entry points."""

from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "sm_count"]


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device: ``None`` means ``cuda``
    and raises when no GPU is present (pass ``device="cpu"`` to run the
    plain versions on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card `device` (kernels size their
    grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
