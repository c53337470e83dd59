"""Device timing.

Counterpart of exllamav2_tpu/utils/timing.py. A CUDA stream runs its launches
in order, so a chain of calls needs no data dependency: `device_time` captures
``lo`` and ``hi`` calls of ``f(x)`` in two CUDA graphs, times replays between
CUDA events and reports the slope between the two counts, which cancels what a
replay costs beyond its kernels (the graph launch, the event pair). On a CPU
tensor the same two loops run under ``time.perf_counter``.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["device_time"]


def _best_of(run: Callable[[], float], reps: int) -> float:
    return min(run() for _ in range(reps))


def _cpu_loop(f: Callable, x, n: int) -> Callable[[], float]:
    def run() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            f(x)
        return time.perf_counter() - t0
    return run


def _graph_replay(f: Callable, x, n: int) -> Callable[[], float]:
    """`n` calls of f(x) captured in one CUDA graph; the returned function
    replays it once between two events and returns the seconds."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            f(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run() -> float:
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    run.graph = graph                      # keeps the capture alive
    return run


def device_time(f: Callable, x: torch.Tensor, iters: int = 32,
                reps: int = 3) -> float:
    """Seconds per call of f(x), overhead-cancelled: the best of `reps`
    timings at ``iters`` calls less the best at ``iters // 4``, over the
    difference of the counts. `f` may allocate its outputs (the capture owns
    a memory pool); it must not synchronize."""
    lo, hi = max(1, iters // 4), iters
    if hi <= lo:
        raise ValueError(f"iters {iters}: need two distinct call counts")
    if not x.is_cuda:
        f(x)                                            # warm up
        run_lo, run_hi = _cpu_loop(f, x, lo), _cpu_loop(f, x, hi)
    else:
        # warm up on a side stream, as graph capture wants its first
        # allocations and lazy initializations done before it starts
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                f(x)
        torch.cuda.current_stream(x.device).wait_stream(side)
        torch.cuda.synchronize(x.device)
        run_lo, run_hi = _graph_replay(f, x, lo), _graph_replay(f, x, hi)
        run_lo()
        run_hi()                                        # first replays
    return (_best_of(run_hi, reps) - _best_of(run_lo, reps)) / (hi - lo)
