"""Host helpers: the generator's stop-string matching and the converter's
annealer.

Counterparts of exllamav2_tpu/native/__init__.py. find_first_match and
max_partial_overlap are in their pure-Python form (this package compiles no
string helper). sim_anneal runs csrc/native_host.cpp, a copy of the
reference's C++ annealer, compiled with g++ at first use into build/native/
at the root of the checkout (the source's hash names the library) and bound
through ctypes; like the reference's, it returns None when no host compiler
builds it, and the caller (convert/pipeline.optimize_allocation) then runs
its numpy annealer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

__all__ = ["find_first_match", "max_partial_overlap", "sim_anneal",
           "host_library"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "native_host.cpp")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "native")
_LOCK = threading.Lock()
_LIB: list = []                 # [CDLL or None] once tried


def find_first_match(haystack: str, needles: list[str]) -> tuple[int, int]:
    """-> (pos, needle_idx) of the earliest full match, or (-1, -1)."""
    best = (-1, -1)
    for i, s in enumerate(needles):
        p = haystack.find(s)
        if p >= 0 and (best[0] < 0 or p < best[0]):
            best = (p, i)
    return best


def max_partial_overlap(haystack: str, needles: list[str]) -> int:
    """Longest suffix of haystack that prefixes any needle."""
    best = 0
    for s in needles:
        for k in range(min(len(s), len(haystack)), best, -1):
            if haystack.endswith(s[:k]):
                best = k
                break
    return best


def host_library():
    """The compiled csrc/native_host.cpp, or None when g++ cannot build it
    (tried once a process)."""
    with _LOCK:
        if not _LIB:
            _LIB.append(_compile())
        return _LIB[0]


def _compile():
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha1(f.read()).hexdigest()[:12]
        so = os.path.join(_BUILD, f"libnative_host-{tag}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            try:
                subprocess.run(["g++", "-O3", "-shared", "-fPIC",
                                "-std=c++17", _SRC, "-o", tmp], check=True,
                               capture_output=True, timeout=120)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(so)
        lib.sim_anneal.restype = None
        lib.sim_anneal.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_float, ctypes.c_void_p]
        return lib
    except (OSError, subprocess.SubprocessError):
        return None


def sim_anneal(slots: list[list[tuple[int, float]]], budget: int,
               iters: int = 20000, seed: int = 0) -> list[int] | None:
    """Native annealer over slots[i] = [(cost_bits, err), ...] (options
    sorted by cost, choice 0 the cheapest) -> chosen index per slot, or
    None if the library is unavailable."""
    lib = host_library()
    if lib is None:
        return None
    offs = [0]
    costs: list[int] = []
    errs: list[float] = []
    for sl in slots:
        for c, e in sl:
            costs.append(c)
            errs.append(e)
        offs.append(len(costs))
    offsets = np.asarray(offs, np.int64)
    costs_a = np.asarray(costs, np.int64)
    errs_a = np.asarray(errs, np.float32)
    choice = np.zeros(len(slots), np.int64)
    temp0 = float(max(errs) + 1e-9) if errs else 1.0
    lib.sim_anneal(len(slots), offsets.ctypes.data, costs_a.ctypes.data,
                   errs_a.ctypes.data, budget, iters, seed, temp0,
                   choice.ctypes.data)
    return choice.tolist()
