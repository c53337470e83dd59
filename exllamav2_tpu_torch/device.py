"""Device selection for the package's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
