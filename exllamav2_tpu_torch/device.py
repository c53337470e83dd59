"""Device selection for the package's entry points."""

from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "sm_count", "stream_counters"]


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


# merge counters of the kernels, one buffer per (device, stream); a buffer
# that a larger one replaced stays allocated (a captured graph may hold it)
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}
_RETIRED: list[torch.Tensor] = []


def stream_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least n int32 zeros on `device` for the current stream, kept for
    every later launch on that stream.

    A kernel that merges its splits in the last block to arrive counts
    arrivals in these slots and leaves them at 0, so launches that run in
    order on one stream can share them; two streams never do (launches on
    two streams may be in flight together).

    Under capture the current stream is the capture stream: the step graphs
    of utils/graphs.py all capture on one stream per device, after an eager
    warm-up on that stream has made its buffer, so every captured kernel-2
    launch holds that one buffer's address. That is safe because the graphs
    replay one after another on one stream and each launch leaves its slots
    at 0, as eager launches in order do. A buffer is never freed, since a
    captured graph may still hold it."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        if c is not None:
            _RETIRED.append(c)
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c
