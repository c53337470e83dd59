"""Build the package's CUDA kernels at first use and load them with ctypes.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the root
of the checkout; the hash of the source names the library, so an edited source
is rebuilt and an unchanged one is loaded as it is. Nothing here runs at
import time: the CPU tests import every module on machines with no toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

__all__ = ["SOURCES", "library", "function", "build_all", "check"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("qmm", "decode_attn")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], object] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels (set CUDA_HOME)")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return src, os.path.join(_BUILD, f"lib{name}-{digest}.so")


def _compile_cmd(src: str, out: str) -> list[str]:
    return [_nvcc(), *_ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, src]


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, one nvcc per source, all at once.

    Returns the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) per source that was built. Raises if any compile fails."""
    os.makedirs(_BUILD, exist_ok=True)
    procs = {}
    for name in names:
        src, so = _target(name)
        if os.path.exists(so):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        procs[name] = (subprocess.Popen(
            _compile_cmd(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, so)
    reports, failed = {}, []
    for name, (p, tmp, so) in procs.items():
        out, _ = p.communicate()
        reports[name] = out
        if p.returncode != 0:
            failed.append(f"{name}:\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            _, so = _target(name)
            if not os.path.exists(so):
                build_all((name,))
            _LIBS[name] = ctypes.CDLL(so)
        return _LIBS[name]


def function(name: str, symbol: str, argtypes):
    """The C entry `symbol` of library `name`, returning int (a
    cudaError_t), with its argument types set once."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[(name, symbol)] = fn
    return fn


def check(name: str, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry of library
    `name` (every source exports ``error_string`` for the message)."""
    if rc != 0:
        lib = library(name)
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
