"""Profiling helpers (counterpart of exllamav2_tpu/utils/profiling.py).

`trace(logdir)` captures a torch.profiler trace of the enclosed region, host
and card, and writes it as a Chrome trace into `logdir` (open it in Perfetto or
chrome://tracing); `annotate(name)` marks a named region that shows on that
timeline, so generator phases (prefill, decode, sampling) can be told apart.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "annotate", "start_server"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed region:

        with profiling.trace("traces"):
            generator.iterate()

    Yields the torch.profiler.profile object (its key_averages() hold the
    device time by kernel); the Chrome trace lands in `logdir` on exit."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region on the profiler timeline (context manager)."""
    return torch.profiler.record_function(name)


def start_server(port: int = 9999):
    """The reference starts an on-demand profiling server here."""
    raise NotImplementedError(
        "start_server has no counterpart in PyTorch: torch.profiler has no "
        "on-demand capture server; wrap the region in trace(logdir) instead")
