"""Experimental FPx (eXmY sub-byte float) weight emulation (PyTorch port of
exllamav2_tpu/experimental/fpx.py).

Rounds weights through an eXmY floating grid -- per-row absmax scaling to
the format's max normal, round-to-nearest-even in value space, clamp -- to
study sub-byte float formats (fp6_e3m2, fp5_e2m2, fp4_e2m1 ...) without a
packed kernel. The set of representable eXmY values is {± m·2^(e-mbits)}
plus denormals, so rounding |x| to its local quantum 2^(floor(log2|x|) -
mbits) (or the denormal quantum below min-normal) with a half-even round IS
the encode-decode round trip: elementwise torch ops (frexp, ldexp, round),
on whatever device the weight lies on.
"""

from __future__ import annotations

import torch

from exllamav2_tpu_torch.models.modules import ModelWeights
from exllamav2_tpu_torch.ops.dequant import replace_linears
from exllamav2_tpu_torch.quant.qtensor import DenseLinear

__all__ = ["fpx_round", "fpxify_tensor", "fpxify"]


def _max_normal(ebits: int, mbits: int) -> float:
    bias = (1 << (ebits - 1)) - 1
    max_exp = (1 << ebits) - 1 - bias      # all-ones exponent is a value
    return 2.0 ** max_exp * (2.0 - 2.0 ** (-mbits))


def fpx_round(x: torch.Tensor, ebits: int, mbits: int) -> torch.Tensor:
    """Round every element of x to the nearest eXmY-representable value
    (round-half-even; overflow clamps to ±max-normal, like the reference's
    clamp -- no inf/NaN encodings)."""
    assert 1 + ebits + mbits <= 8 and ebits >= 2
    bias = (1 << (ebits - 1)) - 1
    min_normal = 2.0 ** (1 - bias)
    xf = x.float()
    ax = xf.abs()
    _, e = torch.frexp(ax)                 # ax = m * 2^e, m in [0.5, 1)
    q_norm = torch.ldexp(torch.ones_like(ax), e - 1 - mbits)
    q = torch.where(ax < min_normal, min_normal * 2.0 ** (-mbits), q_norm)
    r = torch.round(ax / q) * q            # half-even on the local grid
    r = torch.clamp(r, max=_max_normal(ebits, mbits))
    return torch.copysign(r, xf).to(x.dtype)   # -0.0 stays -0.0


def fpxify_tensor(w: torch.Tensor, ebits: int, mbits: int) -> torch.Tensor:
    """The reference's to_scaled_tc_fpx / from_scaled_tc_fpx round trip:
    per-row absmax scale to max-normal, eXmY grid round, rescale."""
    wf = w.float()
    scale = wf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) \
        / _max_normal(ebits, mbits)
    return (fpx_round(wf / scale, ebits, mbits) * scale).to(w.dtype)


def fpxify(weights: ModelWeights, exponent: int, mantissa: int
           ) -> ModelWeights:
    """Copy of `weights` with every dense linear (attention, MLP, head)
    rounded through the eXmY grid; quantized linears are left untouched --
    they already carry their own format."""

    def conv(lin):
        if isinstance(lin, DenseLinear):
            return DenseLinear(fpxify_tensor(lin.weight, exponent, mantissa),
                               lin.bias)
        return lin

    return replace_linears(weights, conv)
