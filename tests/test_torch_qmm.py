"""Port vs reference: qmm / linear_apply on the CPU (plain path).

The reference runs its fused Pallas kernel in interpret mode (m <= 32) or
the dequant + matmul path (m > 32); the port runs the fused kernel's plain
version or the same dequant + matmul. Both take bf16-rounded operands with
f32 products where the reference does, so the only difference is the order
of the f32 sums: max |diff| <= 1e-4 * max |ref|.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.quant import formats as F
from exllamav2_tpu.quant import qtensor as Q
from exllamav2_tpu.ops import qmm as M
from exllamav2_tpu.ops import dequant as D

from exllamav2_tpu_torch.ops import qmm as TM
from exllamav2_tpu_torch.interop import linear_from_reference

TOL = 1e-4


def _exl2(rng, k, n, pattern, act_order=False, bias=False):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    if act_order:
        perm = rng.permutation(k)
        t = F.exl2_pack(w[perm], pattern, group_rows=32,
                        invperm=np.argsort(perm))
    else:
        t = F.exl2_pack(w, pattern, group_rows=32)
    if bias:
        t.bias = (rng.standard_normal(n) * 0.1).astype(np.float16)
    return Q.from_exl2(t)


def _gptq(rng, k, n, gs=128):
    g = k // gs
    q = rng.integers(0, 16, size=(k, n)).astype(np.uint16)
    zeros = rng.integers(0, 15, size=(g, n)).astype(np.uint16)
    scales = rng.random((g, n)).astype(np.float32) * 0.02 + 0.001
    g_idx = (np.argsort(rng.permutation(k)) // gs).astype(np.int32)
    return Q.from_gptq(F.gptq_pack(q, zeros, scales, bits=4, g_idx=g_idx))


CASES = {
    "mixed": lambda rng: _exl2(rng, 320, 128, [8, 8, 6, 5, 4, 4, 3, 3, 2, 2]),
    "act_order": lambda rng: _exl2(rng, 256, 128, [4] * 8, act_order=True),
    "prescaled": lambda rng: D.precompute_scales_linear(
        _exl2(rng, 256, 256, [4, 4, 5, 3] * 2)),
    "gptq_act_order": lambda rng: _gptq(rng, 512, 128),
    "bias_n_orig": lambda rng: _exl2(rng, 256, 96, [4] * 8, bias=True),
}


def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, np.float32)
    got = got.numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max(), err


@pytest.mark.parametrize("m", [1, 5, 32, 40])
@pytest.mark.parametrize("case", sorted(CASES))
def test_linear_apply_matches_reference(case, m):
    rng = np.random.default_rng(m * 7 + len(case))
    ql = CASES[case](rng)
    tl = linear_from_reference(jax.tree_util.tree_map(np.asarray, ql),
                               "cpu")
    x = (rng.standard_normal((m, ql.k)) * 0.5).astype(np.float32)
    ref = M.qmm(jnp.asarray(x), ql)
    got = TM.linear_apply(torch.from_numpy(x), tl)
    # qmm returns the padded width, linear_apply the logical one
    _close(got, np.asarray(ref)[:, :ql.n_orig])
    assert got.shape[-1] == ql.n_orig


@pytest.mark.parametrize("fused", [True, False])
def test_qmm_forced_path(fused):
    rng = np.random.default_rng(11)
    ql = CASES["mixed"](rng)
    tl = linear_from_reference(jax.tree_util.tree_map(np.asarray, ql),
                               "cpu")
    x = rng.standard_normal((3, ql.k)).astype(np.float32)
    _close(TM.qmm(torch.from_numpy(x), tl, fused=fused),
           M.qmm(jnp.asarray(x), ql, fused=fused))


def test_dense_linear_matches_reference():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 32)).astype(np.float32) * 0.1
    b = rng.standard_normal((32,)).astype(np.float32)
    ql = Q.from_dense(w, b)
    tl = linear_from_reference(jax.tree_util.tree_map(np.asarray, ql),
                               "cpu")
    x = rng.standard_normal((5, 64)).astype(np.float32)
    _close(TM.linear_apply(torch.from_numpy(x), tl),
           M.linear_apply(jnp.asarray(x), ql))


def test_fused_segment_matmul_cpu_is_plain():
    """On a CPU tensor the kernel wrapper runs the plain version and does
    not count a launch."""
    rng = np.random.default_rng(5)
    tl = linear_from_reference(jax.tree_util.tree_map(
        np.asarray, CASES["act_order"](rng)), "cpu")
    seg = tl.segments[0]
    x = torch.from_numpy(rng.standard_normal((4, seg.rows_pad)).astype(
        np.float32)).to(torch.bfloat16)
    before = TM.LAUNCHES["qmm"]
    got = TM.fused_segment_matmul(x, seg)
    assert TM.LAUNCHES["qmm"] == before
    assert torch.equal(got, TM.qmm_plain(x, seg))
