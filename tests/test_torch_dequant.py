"""Port vs reference: plane layout and dequantization, bit for bit.

The same numpy-seeded checkpoints are parsed by both packages; plane words,
scales and dequantized weights must agree exactly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.quant import formats as F
from exllamav2_tpu.quant import qtensor as Q
from exllamav2_tpu.ops import dequant as D

from exllamav2_tpu_torch.quant import qtensor as TQ
from exllamav2_tpu_torch.ops import dequant as TD
from exllamav2_tpu_torch.interop import linear_from_reference


def _np(lin):
    return jax.tree_util.tree_map(np.asarray, lin)


def _exl2(rng, k, n, bits_per_group, act_order=False, gs=32):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    if act_order:
        perm = rng.permutation(k)
        return F.exl2_pack(w[perm], bits_per_group, group_rows=gs,
                           invperm=np.argsort(perm))
    return F.exl2_pack(w, bits_per_group, group_rows=gs)


def _gptq(rng, k, n, gs, bits=4, act_order=False):
    g = k // gs
    q = rng.integers(0, 2 ** bits, size=(k, n)).astype(np.uint16)
    zeros = rng.integers(0, 2 ** bits - 1, size=(g, n)).astype(np.uint16)
    scales = rng.random((g, n)).astype(np.float32) * 0.02 + 0.001
    g_idx = None
    if act_order:
        g_idx = (np.argsort(rng.permutation(k)) // gs).astype(np.int32)
    return F.gptq_pack(q, zeros, scales, bits=bits, g_idx=g_idx)


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw bits of a tensor as an unsigned numpy array."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view({1: np.uint8, 4: np.uint32}[t.element_size()])


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


@pytest.mark.parametrize("pattern", [
    [2] * 8, [3] * 8, [4] * 8, [5] * 8, [6] * 8, [8] * 8,
    [8, 8, 6, 5, 4, 4, 3, 2, 2, 3]])
@pytest.mark.parametrize("act_order", [False, True])
def test_from_exl2_same_words(pattern, act_order):
    rng = np.random.default_rng(len(pattern) * 10 + pattern[0])
    t = _exl2(rng, 32 * len(pattern), 96, pattern, act_order=act_order)
    ref, got = Q.from_exl2(t), TQ.from_exl2(t, device="cpu")
    assert (got.k, got.n, got.n_orig) == (ref.k, ref.n, ref.n_orig)
    assert len(got.segments) == len(ref.segments)
    for rs, gs in zip(ref.segments, got.segments):
        assert (gs.bits, gs.plane_bits, gs.rows, gs.group_rows) == \
            (rs.bits, rs.plane_bits, rs.rows, rs.group_rows)
        for rp, gp in zip(rs.planes, gs.planes):
            assert gp.dtype == torch.int32
            np.testing.assert_array_equal(_bits(gp), _ref_bits(rp))
        np.testing.assert_array_equal(_bits(gs.qscale), _ref_bits(rs.qscale))
        np.testing.assert_array_equal(_bits(gs.smax), _ref_bits(rs.smax))
    if act_order:
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
    else:
        assert got.perm is None and ref.perm is None


@pytest.mark.parametrize("act_order", [False, True])
def test_from_gptq_same_words(act_order):
    t = _gptq(np.random.default_rng(3), 256, 100, 32, act_order=act_order)
    ref, got = Q.from_gptq(t), TQ.from_gptq(t, device="cpu")
    rs, gs = ref.segments[0], got.segments[0]
    for rp, gp in zip(rs.planes, gs.planes):
        np.testing.assert_array_equal(_bits(gp), _ref_bits(rp))
    np.testing.assert_array_equal(_bits(gs.scale), _ref_bits(rs.scale))
    np.testing.assert_array_equal(gs.zero.numpy(), np.asarray(rs.zero))
    assert (got.perm is None) == (ref.perm is None) == (not act_order)
    if act_order:
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))


def test_exl2_scales_bitwise():
    rng = np.random.default_rng(0)
    qs = rng.integers(1, 17, size=(64, 128)).astype(np.uint8)
    # smax spans fp16 normals and subnormals of the product
    smax = np.concatenate([
        rng.random(32).astype(np.float16) * np.float16(3e-3),
        rng.random(32).astype(np.float16) * np.float16(1e-7)]
    ).astype(np.float32)[:, None]
    ref = np.asarray(D.exl2_scales(jnp.asarray(qs), jnp.asarray(smax)))
    got = TD.exl2_scales(torch.from_numpy(qs), torch.from_numpy(smax))
    np.testing.assert_array_equal(_bits(got), _ref_bits(ref))


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("prescaled", [False, True])
def test_exl2_dequant_segment_bitwise(bits, prescaled):
    rng = np.random.default_rng(bits + 100 * prescaled)
    ql = Q.from_exl2(_exl2(rng, 224, 128, [bits] * 7))
    if prescaled:
        ql = D.precompute_scales_linear(ql)
    tl = linear_from_reference(_np(ql), "cpu")
    if prescaled:
        # the port's own prescale gives the same bf16 rows
        raw = TD.precompute_scales_linear(linear_from_reference(
            _np(Q.from_exl2(_exl2(np.random.default_rng(bits + 100), 224,
                                  128, [bits] * 7))), "cpu"))
        np.testing.assert_array_equal(
            _bits(raw.segments[0].scale_f),
            _ref_bits(ql.segments[0].scale_f))
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        ref = D.dequant_segment(ql.segments[0], dt)
        got = TD.dequant_segment(tl.segments[0], tdt)
        np.testing.assert_array_equal(_bits(got), _ref_bits(ref))


def test_mixed_and_act_order_dequant_linear_bitwise():
    rng = np.random.default_rng(7)
    ql = Q.from_exl2(_exl2(rng, 320, 64, [8, 8, 6, 6, 5, 4, 4, 3, 2, 2],
                           act_order=True))
    tl = linear_from_reference(_np(ql), "cpu")
    for order in (False, True):
        ref = D.dequant_linear(ql, jnp.float32, original_order=order)
        got = TD.dequant_linear(tl, torch.float32, original_order=order)
        np.testing.assert_array_equal(_bits(got), _ref_bits(ref))


@pytest.mark.parametrize("gs", [32, 128])
def test_gptq_act_order_dequant_bitwise(gs):
    ql = Q.from_gptq(_gptq(np.random.default_rng(gs), 256, 128, gs,
                           act_order=True))
    tl = linear_from_reference(_np(ql), "cpu")
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        ref = D.dequant_linear(ql, dt, original_order=True)
        got = TD.dequant_linear(tl, tdt, original_order=True)
        np.testing.assert_array_equal(_bits(got), _ref_bits(ref))


def test_slice_and_gather_columns_same_words():
    rng = np.random.default_rng(12)
    t = _exl2(rng, 256, 384, [4, 4, 5, 3] * 2)
    ref, got = Q.from_exl2(t), TQ.from_exl2(t, device="cpu")
    idx = np.concatenate([np.arange(256, 384), np.arange(0, 128)])
    pairs = [(Q.slice_columns(ref, 128, 256), TQ.slice_columns(got, 128, 256)),
             (Q.gather_columns(ref, idx), TQ.gather_columns(got, idx))]
    for r, g in pairs:
        assert (g.k, g.n, g.n_orig) == (r.k, r.n, r.n_orig)
        for rs, gs in zip(r.segments, g.segments):
            for rp, gp in zip(rs.planes, gs.planes):
                np.testing.assert_array_equal(_bits(gp), _ref_bits(rp))
            np.testing.assert_array_equal(_bits(gs.qscale),
                                          _ref_bits(rs.qscale))
