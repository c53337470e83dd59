"""Port vs reference: KV-cache quantization (ops/kvquant.py), bit for bit.

The same numpy-seeded bf16 K/V rows go through the reference's and the
port's kv_quant; codes, scales and the dequantized values must be identical
for every kind and for head dims whose rotation group is 32, 24, 20 and 16.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from exllamav2_tpu.ops import kvquant as RK

from exllamav2_tpu_torch.ops import kvquant as TK


def _bits(a) -> np.ndarray:
    """Raw bits of a reference array or a port tensor, as unsigned ints."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        if a.dtype == torch.float8_e5m2:
            return a.view(torch.uint8).numpy()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V" or \
            a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype.name == "float8_e5m2":
        return a.view(np.uint8)
    return a


def _rows(d: int, seed: int):
    x = np.random.default_rng(seed).standard_normal((8, 6, 4, d)) * 0.8
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj).view(np.int16).copy()).view(
        torch.bfloat16)
    return xj, xt


@pytest.mark.parametrize("kind", ["bf16", "fp8", "q4", "q8"])
@pytest.mark.parametrize("d", [128, 64, 96, 112, 80, 72])
def test_kv_quant_and_dequant_bitwise(kind, d):
    xj, xt = _rows(d, d)
    rd, rs = RK.kv_quant(xj, kind)
    td, ts = TK.kv_quant(xt, kind)
    assert td.shape == rd.shape
    np.testing.assert_array_equal(_bits(td), _bits(rd))
    if rs is None:
        assert ts is None
    else:
        assert ts.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(ts), _bits(rs))
    for rdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        ry = RK.kv_dequant(rd, rs, kind, rdt)
        ty = TK.kv_dequant(td, ts, kind, tdt)
        np.testing.assert_array_equal(_bits(ty), _bits(ry))


@pytest.mark.parametrize("g", [12, 16, 20, 24, 32])
def test_hadamard_tables_equal(g):
    h = TK.hadamard_for(g)
    np.testing.assert_array_equal(h.numpy(), np.asarray(RK.hadamard_for(g)))
    assert torch.equal(h @ h.T, g * torch.eye(g))


def test_group_widths_follow_the_code():
    """group_for follows the reference's code: 80 -> 20 (its docstring says
    16), 112 -> 16, 72 -> 24, 100 -> 20."""
    for d in (32, 64, 72, 80, 96, 100, 112, 128, 256):
        assert TK.group_for(d) == RK.group_for(d)
        assert TK.num_groups(d) == RK.num_groups(d)
    assert TK.group_for(80) == 20
    for kind in ("bf16", "fp8", "q4", "q8"):
        assert TK.data_shape(kind, 128) == RK.data_shape(kind, 128)
        assert TK.cache_bytes_per_el(kind) == RK.cache_bytes_per_el(kind)
        assert str(TK.data_dtype(kind)).split(".")[-1].replace(
            "uint8", "uint8") == {"bf16": "bfloat16", "fp8": "float8_e5m2",
                                  "q4": "uint8", "q8": "uint8"}[kind]
