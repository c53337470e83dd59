"""Probe what the card's instructions do with low-precision data.

Counterpart of the JAX package's tools/probe_features.py. Each probe runs one
small kernel of csrc/probe_features.cu on inputs drawn with numpy, holds the
result against the plain PyTorch version beside it and reports a short string
(`exact`, `ok`, `shape (512, 256)`, `mapping A`). The answers inform the
redesign of the quantized-matmul kernels: int8 and bf16 tensor-core tiles
(mma.sync), sub-word shifts and masks on whole registers, register
reinterpretation and its element order, 4-bit operands. Each probe runs in a
subprocess, so a crash does not end the sweep; the tool exits non-zero if any
probe failed.

PyTorch has no 4-bit integer type: the int4 probes take two signed nibbles a
byte, low nibble first (`pack_int4`), and the kernel sign-extends.

Usage: python -m exllamav2_tpu_torch.tools.probe_features          # all probes
       python -m exllamav2_tpu_torch.tools.probe_features <name>   # one, in-process
       ... --device cpu    # the plain versions instead of the kernels
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys
from typing import Callable

import numpy as np
import torch

__all__ = ["PROBES", "LAUNCHES", "Probe", "run_probe", "probe_tensors",
           "pack_int4", "unpack_int4", "int8_dot_warps", "main"]

# launches of the kernels of csrc/probe_features.cu, counted by the wrappers
LAUNCHES = {"probe_features": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


def pack_int4(vals: np.ndarray) -> np.ndarray:
    """int values in [-8, 8) [R, C] -> uint8 [R, C/2]: element 2c in the low
    nibble of byte c, element 2c + 1 in the high nibble."""
    v = np.asarray(vals).astype(np.uint8) & 15
    return (v[:, 0::2] | (v[:, 1::2] << 4)).astype(np.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [R, C/2] -> int8 [R, C], sign-extended (plain version of the
    int4_array kernel)."""
    lo = ((packed & 15).to(torch.int8) ^ 8) - 8
    hi = ((packed >> 4).to(torch.int8) ^ 8) - 8
    return torch.stack([lo, hi], dim=2).reshape(packed.shape[0], -1)


def _launch(symbol: str, argtypes, *args) -> None:
    from exllamav2_tpu_torch import _build
    fn = _build.function("probe_features", symbol, argtypes)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check("probe_features", rc, symbol)
    LAUNCHES["probe_features"] += 1


def _as(dtype):
    """numpy array -> tensor of `dtype` with the same bits (torch has no
    unsigned 16- and 32-bit arithmetic: such words travel as int16 / int32)."""
    def convert(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(dtype))
    return convert


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)


@dataclasses.dataclass
class Probe:
    """`inputs(rng)` draws numpy arrays as the reference probe does and
    `convert` (one function per array) makes them tensors; `plain(*tensors)`
    is the plain PyTorch version and `kernel(*tensors)` launches the CUDA
    kernel (card tensors only); `verdict(tensors, out)` checks `out` and
    returns the probe's result string; `work` is (bytes, operations, operand
    type) for the probe's bound."""
    inputs: Callable
    convert: tuple
    plain: Callable
    kernel: Callable
    verdict: Callable
    work: tuple

    def to_torch(self, *arrays) -> tuple:
        return tuple(c(a) for c, a in zip(self.convert, arrays))


PROBES: dict[str, Probe] = {}
_I8, _U8 = _as(np.int8), _as(np.uint8)
_WORDS = _as(np.int32)


def _exact(plain):
    def verdict(tensors, out):
        assert torch.equal(out, plain(*tensors)), "kernel != plain version"
        return "exact"
    return verdict


# --- int8 dots on the tensor cores -----------------------------------------

def _int8_dot_plain(a, b):
    """The f32 product of small integers is exact (|sum| < 2^24)."""
    return torch.matmul(a.float(), b.float()).to(torch.int32)


def int8_dot_warps(k: int) -> int:
    """Warps a block of the int8 dot kernel holds at depth k: one for each
    64 rows of K (two 32-row k-steps a warp), 1 to 8 (probe_int8_dot in
    csrc/probe_features.cu)."""
    return max(1, min(8, k // 64))


def _int8_dot_kernel(a, b, int4: bool = False):
    batched = a.dim() == 3
    g = a.shape[0] if batched else 1
    m, k = a.shape[-2:]
    n = b.shape[-1] * (2 if int4 else 1)
    out = torch.empty((*a.shape[:-1], n), dtype=torch.int32, device=a.device)
    _launch("probe_int8_dot", [_P, _P, _P, _I, _I, _I, _I, _I, _P],
            a.data_ptr(), b.data_ptr(), out.data_ptr(), g, m, k, n, int(int4))
    return out


PROBES["int8_dot"] = Probe(
    inputs=lambda rng: (rng.integers(-8, 8, (32, 256)).astype(np.int8),
                        rng.integers(-8, 8, (256, 256)).astype(np.int8)),
    convert=(_I8, _I8), plain=_int8_dot_plain, kernel=_int8_dot_kernel,
    verdict=_exact(_int8_dot_plain),
    work=(32 * 256 + 256 * 256 + 32 * 256 * 4, 2 * 32 * 256 * 256, "int8"))

# the W4A8 kernel's group-of-32 partial: 8 groups of [8, 32] @ [32, 256]
PROBES["int8_dot_batched"] = Probe(
    inputs=lambda rng: (rng.integers(-8, 8, (8, 8, 32)).astype(np.int8),
                        rng.integers(-8, 8, (8, 32, 256)).astype(np.int8)),
    convert=(_I8, _I8), plain=_int8_dot_plain, kernel=_int8_dot_kernel,
    verdict=_exact(_int8_dot_plain),
    work=(8 * 8 * 32 + 8 * 32 * 256 + 8 * 8 * 256 * 4, 2 * 8 * 8 * 32 * 256,
          "int8"))


# --- casts, shifts and reinterpretations on whole registers ----------------

def _u32_to_int8_plain(a):
    return (a & 15).to(torch.int8)


def _u32_to_int8_kernel(a):
    out = torch.empty(a.shape, dtype=torch.int8, device=a.device)
    _launch("probe_u32_to_int8", [_P, _P, _I, _P], a.data_ptr(),
            out.data_ptr(), a.numel())
    return out


PROBES["u32_to_int8_cast"] = Probe(
    inputs=lambda rng: (rng.integers(0, 2 ** 31, (256, 256))
                        .astype(np.uint32),),
    convert=(_WORDS,), plain=_u32_to_int8_plain, kernel=_u32_to_int8_kernel,
    verdict=_exact(_u32_to_int8_plain),
    work=(256 * 256 * 5, 256 * 256, "int32"))


def _bitcast_plain(width):
    """[K, N] words -> [K * 4 / width, N]: sub-word j of word k at row
    (4 / width) k + j, little-endian (mapping A). width 2 gives the 16-bit
    halves (as int16), width 1 the int8 bytes of w & 0x0F0F0F0F."""
    per, bits = 4 // width, 8 * width

    def plain(a):
        w = a & 0x0F0F0F0F if width == 1 else a
        parts = [(w >> (bits * j)) & ((1 << bits) - 1) for j in range(per)]
        out = torch.stack(parts, dim=1).reshape(a.shape[0] * per, a.shape[1])
        return out.to(torch.int16 if width == 2 else torch.int8)
    return plain


def _bitcast_kernel(width):
    def kernel(a):
        k, n = a.shape
        out = torch.empty((k * 4 // width, n), device=a.device,
                          dtype=torch.int16 if width == 2 else torch.int8)
        _launch("probe_bitcast", [_P, _P, _I, _I, _I, _P], a.data_ptr(),
                out.data_ptr(), k, n, width)
        return out
    return kernel


def _bitcast_u16_verdict(tensors, out):
    assert torch.equal(out, _bitcast_plain(2)(*tensors)), \
        "kernel != plain version"
    return f"shape {tuple(out.shape)}"


PROBES["bitcast_u32_u16"] = Probe(
    inputs=lambda rng: (np.arange(256 * 256, dtype=np.uint32)
                        .reshape(256, 256),),
    convert=(_WORDS,), plain=_bitcast_plain(2), kernel=_bitcast_kernel(2),
    verdict=_bitcast_u16_verdict, work=(256 * 256 * 8, 256 * 256, "int32"))


def _shift_and_plain(a):
    """(v >> 4) & 15; on int16 words the arithmetic shift smears the sign
    only above the mask."""
    return (a >> 4) & 15


def _shift_and_kernel(width):
    def kernel(a):
        out = torch.empty_like(a)
        _launch("probe_shift_and", [_P, _P, _I, _I, _P], a.data_ptr(),
                out.data_ptr(), a.numel(), width)
        return out
    return kernel


PROBES["u16_shift_and"] = Probe(
    inputs=lambda rng: (rng.integers(0, 2 ** 16, (256, 256))
                        .astype(np.uint16),),
    convert=(_as(np.int16),), plain=_shift_and_plain,
    kernel=_shift_and_kernel(2), verdict=_exact(_shift_and_plain),
    work=(256 * 256 * 4, 256 * 256, "int32"))

PROBES["u8_shift_and"] = Probe(
    inputs=lambda rng: (rng.integers(0, 256, (256, 256)).astype(np.uint8),),
    convert=(_U8,), plain=_shift_and_plain, kernel=_shift_and_kernel(1),
    verdict=_exact(_shift_and_plain),
    work=(256 * 256 * 2, 256 * 256, "int32"))


# --- 4-bit operands ---------------------------------------------------------

def _int4_array_kernel(packed):
    out = torch.empty((packed.shape[0], packed.shape[1] * 2),
                      dtype=torch.int8, device=packed.device)
    _launch("probe_int4_array", [_P, _P, _I, _P], packed.data_ptr(),
            out.data_ptr(), packed.numel())
    return out


PROBES["int4_array"] = Probe(
    inputs=lambda rng: (pack_int4(rng.integers(-8, 8, (256, 256))),),
    convert=(_U8,), plain=unpack_int4, kernel=_int4_array_kernel,
    verdict=_exact(unpack_int4),
    work=(256 * 128 + 256 * 256, 256 * 256, "int32"))


def _int4_dot_plain(a, packed):
    return _int8_dot_plain(a, unpack_int4(packed))


PROBES["int4_dot"] = Probe(
    inputs=lambda rng: (rng.integers(-8, 8, (32, 256)).astype(np.int8),
                        pack_int4(rng.integers(-8, 8, (256, 256)))),
    convert=(_I8, _U8), plain=_int4_dot_plain,
    kernel=lambda a, packed: _int8_dot_kernel(a, packed, int4=True),
    verdict=_exact(_int4_dot_plain),
    work=(32 * 256 + 256 * 128 + 32 * 256 * 4, 2 * 32 * 256 * 256, "int8"))


# --- bf16 dot, f32 accumulation (the control) -------------------------------

def _bf16_dot_plain(a, b):
    """f32 product of the bf16 operands."""
    return torch.matmul(a.float(), b.float())


def _bf16_dot_kernel(a, b):
    k, n = b.shape
    out = torch.empty((a.shape[0], n), dtype=torch.float32, device=a.device)
    _launch("probe_bf16_dot", [_P, _P, _P, _I, _I, _P], a.data_ptr(),
            b.data_ptr(), out.data_ptr(), k, n)
    return out


# the kernel and the plain version sum the same exact products in another
# order: 1e-4 of max |plain|, as for the matmul kernels
BF16_DOT_TOL = 1e-4


def _bf16_dot_verdict(tensors, out):
    ref = _bf16_dot_plain(*tensors)
    assert torch.isfinite(out).all(), "not finite"
    assert (out - ref).abs().max() <= BF16_DOT_TOL * ref.abs().max(), \
        "kernel != plain version"
    return "ok"


PROBES["bf16_dot_bf16_acc_f32"] = Probe(
    inputs=lambda rng: (rng.standard_normal((16, 256)).astype(np.float32),
                        rng.standard_normal((256, 256)).astype(np.float32)),
    convert=(_bf16, _bf16), plain=_bf16_dot_plain, kernel=_bf16_dot_kernel,
    verdict=_bf16_dot_verdict,
    work=((16 * 256 + 256 * 256) * 2 + 16 * 256 * 4, 2 * 16 * 256 * 256,
          "bf16"))


def _bitcast_i8_verdict(tensors, out):
    """Which row the card gives byte j of word k, by the reference's three
    hypotheses."""
    o = out.cpu().numpy()
    w = tensors[0].cpu().numpy().view(np.uint32)
    k, n = w.shape
    rows = np.arange(k)
    guesses = {"A": (rows * 4, 1),                        # row 4k + j
               "B": (rows, k),                            # row k + K j
               "C": ((rows // 8) * 32 + rows % 8, 8)}     # 8-row blocks
    for name, (base, step) in guesses.items():
        h = np.zeros((4 * k, n), np.int8)
        for j in range(4):
            h[base + step * j] = ((w >> np.uint32(8 * j)) & 0x0F
                                  ).astype(np.int8)
        if (o == h).all():
            return f"mapping {name}"
    raise AssertionError(
        f"unknown mapping; out[0:9,0]={o[0:9, 0].tolist()} "
        f"w[0,0]={w[0, 0]:#x} w[1,0]={w[1, 0]:#x}")


PROBES["bitcast_u32_i8"] = Probe(
    inputs=lambda rng: (rng.integers(0, 2 ** 31, (64, 256))
                        .astype(np.uint32),),
    convert=(_WORDS,), plain=_bitcast_plain(1), kernel=_bitcast_kernel(1),
    verdict=_bitcast_i8_verdict, work=(64 * 256 * 8, 64 * 256, "int32"))


def probe_tensors(name: str, device, seed: int = 0) -> tuple:
    """The probe's inputs, drawn with numpy from `seed`, on `device`."""
    probe = PROBES[name]
    arrays = probe.inputs(np.random.default_rng(seed))
    return tuple(t.to(device) for t in probe.to_torch(*arrays))


def run_probe(name: str, device, seed: int = 0) -> str:
    """Draw the probe's inputs, run its kernel on the card (or its plain
    version on the CPU), check the result and return the result string."""
    probe = PROBES[name]
    device = torch.device(device)
    tensors = probe_tensors(name, device, seed)
    if device.type == "cuda":
        out = probe.kernel(*tensors)
        torch.cuda.synchronize(device)
    else:
        out = probe.plain(*tensors)
    return probe.verdict(tensors, out)


def main(argv=None) -> int:
    from exllamav2_tpu_torch.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", nargs="?", choices=sorted(PROBES))
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions; default: the card "
                         "(an error without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.name:
        print(args.name, "->", run_probe(args.name, device))
        return 0
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    failed = []
    for name in PROBES:
        r = subprocess.run(
            [sys.executable, "-m", "exllamav2_tpu_torch.tools.probe_features",
             name, "--device", str(device)],
            capture_output=True, text=True, timeout=300, cwd=root)
        if r.returncode == 0:
            print(r.stdout.strip(), flush=True)
        else:
            failed.append(name)
            tail = (r.stderr or r.stdout).strip().splitlines()
            print(f"{name} -> FAIL: {tail[-1] if tail else 'crash'}",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
