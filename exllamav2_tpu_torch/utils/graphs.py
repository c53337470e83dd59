"""Step graphs: the decode steps the reference compiles, as CUDA graphs.

The reference compiles each decode step once per static shape with
``jax.jit`` (``exllamav2_tpu/models/model.py _decode_step``,
``generator/dynamic.py _get_decode_fn`` and ``_get_decode_burst_fn``). The
port captures the same step once per key in a ``torch.cuda.CUDAGraph`` and
replays it: one graph launch in place of the ~2,000 kernel launches of an
eager 7B step.

``StepGraphs`` holds, per key (a tuple), the step function, its static input
buffers, the captured graph and its static outputs. A call copies the
caller's inputs into the key's buffers, replays the graph and returns the
static outputs, which the next replay of any graph of the runner may
overwrite: the caller reads them (or copies them) first. The graphs of a
runner share one memory pool, which is safe because they replay one after
another on one stream and their outputs are read before the next replay.

The first call of a key:
  1. copies the inputs into new static buffers;
  2. runs the step once eagerly on the capture stream: this builds and loads
     the kernel libraries, makes each kernel's first
     ``cudaFuncSetAttribute`` call and the kernel-2 counter buffer of the
     capture stream (device.stream_counters), none of which may happen
     inside a capture;
  3. captures the step on that stream, its random generators registered
     with the graph;
  4. replays it.
Together these leave the state of one step: the warm-up writes the same
cache rows and history entries the replay writes again (every kernel reduces
in a fixed order), the generators are set back to where they stood before
the warm-up (the replay draws what one eager step draws), and the kernel
launch counters are set back too.

Launch counters: the wrappers count their launches when they run, which a
replay does not do. At capture the runner records what the counters of
ops/qmm.py, ops/decode_attn.py and ops/paged_attn.py counted (the capture
runs the wrappers once), and every replay adds that record back, so the
counters keep counting kernel launches executed. ``captures``,
``replays`` and ``capture_ms`` count per key.

Under a torch.profiler session a key's first call (warm-up and capture)
is the span ``graphs.capture.<kind>`` (utils/profiling.span), its kind the
key's leading string where it has one (the generator's keys), else
``graphs.capture``; a later call's copy of its inputs into the static
buffers is ``graphs.load`` (a copy from pageable host memory waits for
the stream to drain) and its graph launch ``graphs.replay``.

Runners may share one memory pool (``share_pool=``: the prefill graphs of
a model or generator beside its decode graphs, each runner with its own
cap, so that prefill keys never push out the decode keys a round replays);
a pool is given up only when no runner sharing it holds a graph.

A capture that fails raises; nothing runs the step eagerly in its place.
On a CPU device there is nothing to capture: the runner keeps the static
buffers, runs the same warm-up and calls the step on the buffers for each
call, so the CPU tests hold the static-buffer path (stale buffers, pad
rows, the warm-up) against the eager step.
"""

from __future__ import annotations

import gc
import time
import weakref
from collections import Counter, OrderedDict
from typing import Callable

import torch

from exllamav2_tpu_torch.utils import profiling

__all__ = ["StepGraphs", "capture_stream"]

# one capture stream per device, for every runner (device.stream_counters)
_STREAMS: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every step graph of `device` is captured on."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    s = _STREAMS.get(idx)
    if s is None:
        s = _STREAMS[idx] = torch.cuda.Stream(idx)
    return s


def _counters() -> tuple[dict, ...]:
    from exllamav2_tpu_torch.ops import decode_attn, paged_attn, qmm
    return (qmm.LAUNCHES, qmm.GATED_LAUNCHES, decode_attn.LAUNCHES,
            paged_attn.LAUNCHES, paged_attn.KIND_LAUNCHES)


def _snapshot() -> list[dict]:
    return [dict(d) for d in _counters()]


def _restore(snap: list[dict]) -> None:
    for d, s in zip(_counters(), snap):
        d.clear()
        d.update(s)


def _delta(before: list[dict], after: list[dict]) -> list[dict]:
    return [{k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}
            for b, a in zip(before, after)]


def _credit(delta: list[dict]) -> None:
    for d, dd in zip(_counters(), delta):
        for k, v in dd.items():
            d[k] = d.get(k, 0) + v


class _Entry:
    __slots__ = ("fn", "inputs", "outputs", "graph", "credit")

    def __init__(self, fn, inputs, outputs, graph, credit):
        self.fn = fn              # holds what the graph reads (the cache)
        self.inputs = inputs
        self.outputs = outputs
        self.graph = graph
        self.credit = credit


class _Pool:
    """A graph memory pool and the runners that capture into it."""

    def __init__(self, device: torch.device):
        self.handle = (torch.cuda.graph_pool_handle()
                       if device.type == "cuda" else None)
        self.runners: weakref.WeakSet = weakref.WeakSet()

    def renew(self) -> None:
        if self.handle is not None:
            self.handle = torch.cuda.graph_pool_handle()


class StepGraphs:
    """Captured step graphs of one device, keyed by tuples, at most
    `max_graphs` of them (the least recently used one goes first).

    `generators` are the torch.Generators the steps draw from: saved and
    restored around each warm-up, registered with each graph. `share_pool`
    (another runner of the device) captures into that runner's pool."""

    def __init__(self, device, max_graphs: int, generators=(),
                 share_pool: "StepGraphs | None" = None):
        self.device = torch.device(device)
        self.max_graphs = max_graphs
        self.generators = list(generators)
        self.entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self.captures: Counter = Counter()
        self.replays: Counter = Counter()
        self.capture_ms: dict[tuple, float] = {}
        self._pool = share_pool._pool if share_pool is not None \
            else _Pool(self.device)
        self._pool.runners.add(self)

    def __contains__(self, key) -> bool:
        return key in self.entries

    def drop(self, pred: Callable[[tuple], bool]) -> None:
        """Forget every graph whose key satisfies `pred`. With no graph
        left in any runner of the pool, later captures go to a new pool:
        the allocator keeps a pool whose graphs are all gone while a static
        output of theirs lives, and takes no capture into it (torch
        2.11)."""
        for key in [k for k in self.entries if pred(k)]:
            del self.entries[key]
        if not any(r.entries for r in self._pool.runners):
            self._pool.renew()

    def __call__(self, key: tuple, fn: Callable, *args):
        """fn(*static inputs) for `key`, with `args` (tensors, copied; ints,
        filled into 0-d int32 buffers) as the inputs: the key's graph
        replayed, captured first when the key is new. Returns the static
        outputs."""
        with torch.inference_mode():
            entry = self.entries.get(key)
            if entry is None:
                kind = key[0] if key and isinstance(key[0], str) else None
                with profiling.span("graphs.capture" if kind is None
                                    else "graphs.capture." + kind):
                    entry = self._capture(key, fn, args)
            else:
                self.entries.move_to_end(key)
                with profiling.span("graphs.load"):
                    self._load(entry.inputs, args)
            if entry.graph is None:
                entry.outputs = entry.fn(*entry.inputs)
            else:
                with profiling.span("graphs.replay"):
                    entry.graph.replay()
                _credit(entry.credit)
            self.replays[key] += 1
            return entry.outputs

    def _static(self, a):
        if isinstance(a, torch.Tensor):
            return torch.empty(a.shape, dtype=a.dtype,
                               device=self.device).copy_(a)
        return torch.full((), int(a), dtype=torch.int32, device=self.device)

    @staticmethod
    def _load(inputs, args) -> None:
        if len(args) != len(inputs):
            raise ValueError(f"{len(args)} inputs for a step of "
                             f"{len(inputs)}")
        for s, a in zip(inputs, args):
            if isinstance(a, torch.Tensor):
                if a.shape != s.shape or a.dtype != s.dtype:
                    raise ValueError(f"input {a.dtype} {tuple(a.shape)} for "
                                     f"a buffer {s.dtype} {tuple(s.shape)}")
                s.copy_(a)
            else:
                s.fill_(int(a))

    def _capture(self, key, fn, args) -> _Entry:
        t0 = time.perf_counter()
        inputs = [self._static(a) for a in args]
        before = _snapshot()
        states = [g.get_state() for g in self.generators]
        graph = outputs = credit = None
        try:
            if self.device.type != "cuda":
                fn(*inputs)                               # the warm-up
                for g, s in zip(self.generators, states):
                    g.set_state(s)
            else:
                graph, outputs, credit = self._record(fn, inputs, states)
        finally:
            _restore(before)
        entry = _Entry(fn, inputs, outputs, graph, credit)
        self.entries[key] = entry
        while len(self.entries) > self.max_graphs:
            self.entries.popitem(last=False)
        self.captures[key] += 1
        self.capture_ms[key] = (time.perf_counter() - t0) * 1e3
        return entry

    def _record(self, fn, inputs, states):
        """Warm-up, then capture, on the capture stream: -> (graph, static
        outputs, the launches the capture counted)."""
        stream = capture_stream(self.device)
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(stream):
            fn(*inputs)                                   # the warm-up
        torch.cuda.synchronize(self.device)
        for g, s in zip(self.generators, states):
            g.set_state(s)
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        mid = _snapshot()
        # no cyclic collection inside the capture: a CUDA graph it destroyed
        # there would void the capture
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self._pool.handle,
                                    capture_error_mode="thread_local")
                try:
                    outputs = fn(*inputs)
                except BaseException:
                    self._abandon(graph)
                    raise
                graph.capture_end()
        finally:
            if gc_on:
                gc.enable()
        return graph, outputs, _delta(mid, _snapshot())

    def _abandon(self, graph) -> None:
        """End a capture whose step raised, so that the stream and the
        allocator serve the next capture; the step's error is what the
        caller sees."""
        try:
            graph.capture_end()
        except RuntimeError:
            # the capture was void (a host sync inside it): the stream has
            # left capture mode, but the allocator still sends the stream's
            # allocations to the pool, and the pool takes no new capture
            # (torch 2.11): stop the one, and capture into a new pool
            torch._C._cuda_endAllocateToPool(
                capture_stream(self.device).device_index, self._pool.handle)
            self._pool.renew()
