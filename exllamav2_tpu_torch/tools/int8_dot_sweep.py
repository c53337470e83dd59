"""Time the int8 / int4 dot probe kernel in its two designs, side by side.

csrc/probe_features.cu `int8_dot_kernel` (the design the probes use) loads A
and B straight into the fragment registers; tools/int8_dot_sweep.cu holds the
same function, grid, warps and fragment map with A and B staged in shared
memory by cp.async. This script builds both on the card, holds each against
the plain version (exact) at the three probes' shapes and at shapes that take
several passes, ragged rows and columns and the 4-byte copies (n % 16 != 0),
and times each probe with both designs in the order direct, staged, staged,
direct (`utils.timing.device_time`, 64 calls), with `int8_dot` also at the
bf16 dot probe's 16 rows, beside that probe and the launch floor (`add_` on
a one-element tensor). It prints the card's name and power limit, one line a
timing and, last, one JSON object with every time in microseconds; it exits
non-zero if a design disagrees with the plain version.

Usage: python -m exllamav2_tpu_torch.tools.int8_dot_sweep   (needs a card)
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

__all__ = ["main"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "int8_dot_sweep.cu")
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_PROBES = {"int8_dot": False, "int4_dot": True, "int8_dot_batched": False}
# (g, m, k, n): several passes, ragged rows and columns, one warp, n % 16 != 0
_SHAPES = [(1, 5, 1024, 40), (3, 17, 96, 264), (2, 16, 4096, 8),
           (1, 32, 64, 256), (1, 16, 2048, 256)]


def _staged_fn():
    """Build tools/int8_dot_sweep.cu into build/kernels/ and return its
    entry."""
    from exllamav2_tpu_torch import _build
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    so = os.path.join(_build._BUILD, f"libint8_dot_sweep-{tag}.so")
    if not os.path.exists(so):
        os.makedirs(_build._BUILD, exist_ok=True)
        r = subprocess.run(_build._compile_cmd(_SRC, so), capture_output=True,
                           text=True)
        if r.returncode:
            raise RuntimeError("nvcc failed:\n" + r.stdout + r.stderr)
    fn = ctypes.CDLL(so).sweep_int8_dot
    fn.restype, fn.argtypes = ctypes.c_int, _ARGS
    return fn


def _call(fn, a, b, int4):
    g = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2:]
    n = b.shape[-1] * (2 if int4 else 1)
    out = torch.empty((*a.shape[:-1], n), dtype=torch.int32, device=a.device)
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), g, m, k, n, int(int4),
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc:
        raise RuntimeError(f"int8 dot launch: CUDA error {rc}")
    return out


def main(argv=None) -> int:
    from exllamav2_tpu_torch import _build
    from exllamav2_tpu_torch.tools import probe_features as PF
    from exllamav2_tpu_torch.utils.timing import device_time
    if not torch.cuda.is_available():
        print("int8_dot_sweep: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    designs = {"direct": _build.function("probe_features", "probe_int8_dot",
                                         _ARGS),
               "staged": _staged_fn()}
    bad = []
    for int4 in (False, True):
        for g, m, k, n in _SHAPES:
            rng = np.random.default_rng(k + n)
            a = rng.integers(-8, 8, (g, m, k)).astype(np.int8)
            bv = rng.integers(-8, 8, (g, k, n)).astype(np.int8)
            b = np.stack([PF.pack_int4(x) for x in bv]) if int4 else bv
            at, bt = torch.from_numpy(a), torch.from_numpy(b)
            plain = PF.PROBES["int4_dot" if int4 else "int8_dot"].plain
            want = torch.stack([plain(at[i], bt[i]) for i in range(g)])
            for name, fn in designs.items():
                got = _call(fn, at.to(dev), bt.to(dev), int4).cpu()
                if not torch.equal(got, want):
                    bad.append(f"{name} int4={int4} {(g, m, k, n)}")
    tensors = {p: PF.probe_tensors(p, dev) for p in _PROBES}
    for p, int4 in _PROBES.items():
        for name, fn in designs.items():
            if not torch.equal(_call(fn, *tensors[p], int4),
                               PF.PROBES[p].plain(*tensors[p])):
                bad.append(f"{name} {p}")
    if bad:
        print("FAIL: differs from the plain version: " + ", ".join(bad))
        return 1

    def us(call, like):
        return device_time(lambda _: call(), like, iters=64) * 1e6

    times: dict[str, list[float]] = {}
    one = torch.zeros(1, device=dev)
    ab = PF.probe_tensors("bf16_dot_bf16_acc_f32", dev)
    # int8_dot at the bf16 probe's shape, [16, 256] @ [256, 256]
    a16, b16 = tensors["int8_dot"][0][:16], tensors["int8_dot"][1]
    for order in (("direct", "staged"), ("staged", "direct")):
        times.setdefault("launch_floor", []).append(
            us(lambda: one.add_(1), one))
        times.setdefault("bf16_dot", []).append(
            us(lambda: PF._bf16_dot_kernel(*ab), ab[0]))
        for name in order:
            for p, int4 in _PROBES.items():
                t = us(lambda: _call(designs[name], *tensors[p], int4),
                       tensors[p][0])
                times.setdefault(f"{p} {name}", []).append(t)
            t = us(lambda: _call(designs[name], a16, b16, False), a16)
            times.setdefault(f"int8_dot m=16 {name}", []).append(t)
    for key, v in times.items():
        print(f"{key:26s} " + " ".join(f"{x:.4f}" for x in v)
              + f"  best {min(v):.4f} us", flush=True)
    print(json.dumps({"card": card, "us": times,
                      "best_us": {k: min(v) for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
