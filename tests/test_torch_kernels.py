"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips (with the reason) where no GPU is present,
as on CPU-only machines; `python3 chip_smoke.py` runs the same checks at the
Llama-2-7B shapes. On a card: `python -m pytest tests/test_torch_kernels.py`.
"""

import pytest
import torch

from exllamav2_tpu_torch.ops import decode_attn as A
from exllamav2_tpu_torch.ops import qmm as Q
from exllamav2_tpu_torch.ops.dequant import (
    enable_w4a8_linear, merge_linears, precompute_scales_linear)
from exllamav2_tpu_torch.quant.qtensor import QuantLinear
from exllamav2_tpu_torch.utils.testing import (
    random_gptq_linear, random_quant_linear)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


QMM_ROWS = [1, 2, 3, 4, 7, 8, 9, 16, 17, 24, 32]   # both templates


def _qmm_linear(kind, k, n, gen, dev):
    """A linear of `kind`: exl2_<bits>[_prescaled][_gs<rows>] or
    gptq_<bits>[_gs<rows>]."""
    parts = kind.split("_")
    bits = int(parts[1])
    gs = [int(p[2:]) for p in parts if p.startswith("gs")]
    if parts[0] == "gptq":
        return random_gptq_linear(gen, k, n, bits=bits,
                                  group_rows=gs[0] if gs else 64, device=dev)
    lin = random_quant_linear(gen, k, n, bits=bits,
                              group_rows=gs[0] if gs else 32, device=dev)
    return precompute_scales_linear(lin) if "prescaled" in parts else lin


def _check_qmm(x, seg):
    before = dict(Q.LAUNCHES)
    got = Q.fused_segment_matmul(x, seg)
    assert Q.LAUNCHES == dict(before, qmm=before["qmm"] + 1)
    ref = Q.qmm_plain(x, seg)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("m", QMM_ROWS)
@pytest.mark.parametrize("kind", [
    "exl2_2", "exl2_3", "exl2_4_prescaled", "exl2_5", "exl2_6", "exl2_8",
    "gptq_4", "exl2_2_prescaled", "exl2_3_prescaled", "exl2_5_prescaled",
    "exl2_6_prescaled", "exl2_8_prescaled", "exl2_4_prescaled_gs16",
    "exl2_4_gs128", "gptq_2", "gptq_3", "gptq_8", "gptq_4_gs16"])
def test_qmm_kernel_matches_plain(dev, kind, m):
    """Every meta kind and plane pair on both templates (gemv below 8 rows,
    mma from 8; m = 17-32 two m16 tiles)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m)
    seg = _qmm_linear(kind, 768, 384, gen, dev).segments[0]
    x = torch.randn((m, seg.rows_pad), generator=gen, device=dev).to(
        torch.bfloat16)
    _check_qmm(x, seg)


@pytest.mark.parametrize("m", [1, 5, 8, 20])
@pytest.mark.parametrize("kind", ["exl2_4_prescaled", "exl2_6", "gptq_8"])
@pytest.mark.parametrize("k,n", [(2816, 200), (256, 72), (4096, 4100)])
def test_qmm_kernel_ragged_columns_and_splits(dev, k, n, kind, m):
    """n % 128 != 0 (a partial column block, a partial warp), one sub-block
    of K, and K over the most splits a cluster takes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + m)
    seg = _qmm_linear(kind, k, n, gen, dev).segments[0]
    x = torch.randn((m, seg.rows_pad), generator=gen, device=dev).to(
        torch.bfloat16)
    _check_qmm(x, seg)
    # deterministic: the cluster merges its splits in rank order
    assert torch.equal(Q.fused_segment_matmul(x, seg),
                       Q.fused_segment_matmul(x, seg))


def test_qmm_kernel_unaligned_activation_view(dev):
    """A contiguous view of x at an offset that is not 16-byte aligned."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    seg = _qmm_linear("exl2_4_prescaled", 512, 256, gen, dev).segments[0]
    base = torch.randn(512 + 3, generator=gen, device=dev).to(torch.bfloat16)
    x = base[3:].view(1, 512)
    assert x.is_contiguous() and x.data_ptr() % 16
    _check_qmm(x, seg)


@pytest.mark.parametrize("m", [1, 4, 8, 17, 32])
@pytest.mark.parametrize("nsrc", [2, 3])
def test_qmm_kernel_merged_meta_matches_plain(dev, nsrc, m):
    """The src_cols meta kind: unprescaled EXL2 sources merged by columns,
    with a 128-column block straddling two sources (widths 192 and 320)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(nsrc * 10 + m)
    widths = (192, 320, 128)[:nsrc]
    lin = merge_linears([random_quant_linear(gen, 512, w, bits=4, device=dev)
                         for w in widths])
    seg = lin.segments[0]
    assert seg.src_cols and seg.scale_f is None
    x = torch.randn((m, 512), generator=gen, device=dev).to(torch.bfloat16)
    _check_qmm(x, seg)


@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("m", [1, 4, 8, 32])
@pytest.mark.parametrize("kind,k,n", [
    ("exl2_4_prescaled", 4096, 1024), ("gptq_4", 1024, 4100),
    ("exl2_3", 512, 256)])
def test_qmm_gated_kernel_matches_plain(dev, kind, k, n, m, on):
    """The gated entry (the MoE decode's device flag) against its plain
    version: the kernel's product where the flag is 1, exact zeros where it
    is 0 (over an output buffer that held garbage), with K split over a
    cluster (k = 4096) whose blocks all leave together; one launch each."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(k + n + m)
    seg = _qmm_linear(kind, k, n, gen, dev).segments[0]
    x = torch.randn((m, seg.rows_pad), generator=gen, device=dev).to(
        torch.bfloat16)
    gate = torch.tensor([1 if on else 0], dtype=torch.int32, device=dev)
    torch.empty((m, n), device=dev).fill_(float("nan"))   # a dirty pool
    before = Q.LAUNCHES["qmm"]
    got = Q.fused_segment_matmul(x, seg, gate)
    assert Q.LAUNCHES["qmm"] == before + 1
    ref = Q.qmm_gated_plain(x, seg, gate)
    if on:
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    else:
        assert torch.equal(got, torch.zeros_like(got))


def test_qmm_gated_mixed_bit_linear_reads_one_gate(dev):
    """Every segment of a 3/5/6-bit EXL2 linear reads the same flag; a flag
    flipped on the device between two launches changes the next result
    (read when the kernel runs, not when it is queued)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    segs = [random_quant_linear(gen, r, 512, bits=b, device=dev).segments[0]
            for r, b in ((512, 3), (768, 5), (256, 6))]
    lin = precompute_scales_linear(QuantLinear(segs, None, None, k=1536,
                                               n=512, n_orig=512))
    x = torch.randn((4, 1536), generator=gen, device=dev).to(torch.bfloat16)
    gate = torch.ones((1,), dtype=torch.int32, device=dev)
    before = Q.LAUNCHES["qmm"]
    on = Q.linear_apply(x, lin, gate=gate)
    gate.zero_()
    off = Q.linear_apply(x, lin, gate=gate)
    assert Q.LAUNCHES["qmm"] == before + 6
    ref = Q.linear_apply(x, lin)
    assert torch.equal(on, ref)
    assert torch.equal(off, torch.zeros_like(off))


@pytest.mark.parametrize("m", [1, 3, 8, 16, 17, 24, 32])
@pytest.mark.parametrize("kind", [
    "exl2_2", "exl2_3", "exl2_4", "exl2_5", "exl2_6", "exl2_8",
    "exl2_4_gs32", "exl2_4_gs16",
    "gptq_4_gs64_bf16meta", "gptq_4_gs128_f32meta", "gptq_4_gs512_bf16meta",
    "gptq_8_gs128_bf16meta"])
def test_w4a8_kernel_matches_plain(dev, kind, m):
    """Both templates: dp4a below 8 rows and for 16-row groups, the int8
    mma tiles from 8 rows (m = 16 one tile, 17-32 two)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m)
    k, n = 1024, 384
    parts = kind.split("_")
    bits = int(parts[1])
    if parts[0] == "gptq":
        lin = random_gptq_linear(gen, k, n, bits=bits,
                                 group_rows=int(parts[2][2:]), device=dev)
        if parts[3] == "f32meta":
            lin = QuantLinear([s.replace(act8=True) for s in lin.segments],
                              None, None, k, n, n)
        else:
            lin = enable_w4a8_linear(lin)
    else:
        gr = int(parts[2][2:]) if len(parts) > 2 else 32
        lin = enable_w4a8_linear(random_quant_linear(
            gen, k, n, bits=bits, group_rows=gr, device=dev))
    seg = lin.segments[0]
    assert seg.act8
    assert Q.w4a8_template(m, seg.group_rows, n) == (
        "mma" if m >= 8 and seg.group_rows >= 32 else "dp4a")
    x = torch.randn((m, seg.rows_pad), generator=gen, device=dev)
    before = dict(Q.LAUNCHES)
    got = Q.fused_segment_matmul(x, seg)
    assert Q.LAUNCHES == dict(before, qmm_w4a8=before["qmm_w4a8"] + 1)
    ref = Q.qmm_w4a8_plain(x, seg)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("m", [1, 4, 16, 17, 32])
@pytest.mark.parametrize("bits,gs", [(4, 128), (4, 256), (4, 512), (3, 128),
                                     (8, 128), (2, 128)])
def test_partials_kernel_matches_plain(dev, bits, gs, m, monkeypatch):
    monkeypatch.setenv("QMM_PARTIALS", "1")
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + gs)
    lin = random_gptq_linear(gen, 1024, 384, bits=bits, group_rows=gs,
                             device=dev)
    seg = lin.segments[0]
    x = torch.randn((m, seg.rows_pad), generator=gen, device=dev).to(
        torch.bfloat16)
    before = dict(Q.LAUNCHES)
    got = Q.fused_segment_matmul(x, seg)          # dispatch by QMM_PARTIALS
    assert Q.LAUNCHES == dict(before,
                              qmm_partials=before["qmm_partials"] + 1)
    ref = Q.qmm_partials_plain(x, seg)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    # the exact form agrees with the fused kernel to its bf16 weight rounding
    fused = Q.qmm_plain(x, seg)
    assert (got - fused).abs().max() <= 5e-3 * fused.abs().max()


@pytest.mark.parametrize("hq,hkv,d,past,cap,win", [
    (8, 8, 128, 0, 0.0, 0), (8, 2, 128, 100, 0.0, 0),
    (8, 2, 128, 255, 20.0, 0), (16, 4, 128, 300, 0.0, 64),
    (8, 1, 64, 77, 0.0, 0), (4, 2, 256, 130, 0.0, 0),
    (48, 1, 128, 300, 0.0, 0), (22, 1, 128, 511, 20.0, 0),
    (40, 2, 256, 200, 0.0, 64)])
def test_decode_attention_kernel_matches_plain(dev, hq, hkv, d, past, cap,
                                               win):
    gen = torch.Generator(device=dev)
    gen.manual_seed(past)
    shape = (2, 2, hkv, 512, d)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((2, hq, d), generator=gen, device=dev).to(
        torch.bfloat16)
    limit = 512
    got = A.decode_attention(q, k, v, 1, past, limit, 0.09, cap, win)
    ref = A.decode_attention_plain(q, k, v, 1, past, limit, 0.09, cap, win)
    assert (got - ref).abs().max() <= 1e-4 * v.float().abs().max()


@pytest.mark.parametrize("hkv,g,limit,past,win", [
    (2, 4, 256, 0, 0), (4, 2, 512, 300, 0), (8, 4, 1024, 700, 0),
    (16, 1, 2048, 2000, 0), (8, 4, 2048, 1500, 512), (2, 8, 1024, 1000, 100),
    (16, 2, 256, 255, 0), (1, 48, 2048, 1500, 0), (1, 22, 1024, 1000, 100),
    (2, 17, 1024, 0, 0)])
def test_decode_attention_kernel_splits_match_plain(dev, hkv, g, limit, past,
                                                    win):
    """Batch 1 over more than one split: an empty split (past_len 0), a
    window whose first row lies inside a split, rows past the attended end;
    more than 16 query heads a KV head (48 and 22, StarCoder's multi-query
    attention; 17 with a second m16 tile of one head) on the mma template."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(limit + past)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, per = A.grid(1, hkv, g, limit, sms)[3:]
    assert splits > 1 and splits * per >= limit
    shape = (2, 1, hkv, 2048, 128)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((1, hkv * g, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    before = A.LAUNCHES["decode_attn"]
    got = A.decode_attention(q, k, v, 1, past, limit, 0.09, 0.0, win)
    assert A.LAUNCHES["decode_attn"] == before + 1
    ref = A.decode_attention_plain(q, k, v, 1, past, limit, 0.09, 0.0, win)
    assert (got - ref).abs().max() <= 1e-4 * v.float().abs().max()
    # the counters are back at 0: a second launch gives the same bits
    again = A.decode_attention(q, k, v, 1, past, limit, 0.09, 0.0, win)
    assert torch.equal(got, again)


def test_decode_attention_graph_replay_at_new_positions(dev):
    """A CUDA graph of kernel 2 over 4 layers (batch 2, 32/8 heads, limit
    1024: more than one split) captured with past_len in device memory,
    replayed after the position changes in place within the bucket, shared
    and per row: every replay equals the plain version at the new
    positions within 1e-4 of max |v|."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    b, hkv, g, limit = 2, 8, 4, 1024
    shape = (4, b, hkv, 2048, 128)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    qs = [torch.randn((b, hkv * g, 128), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4)]
    shared = torch.zeros((), dtype=torch.int32, device=dev)
    rows = torch.zeros((b,), dtype=torch.int32, device=dev)

    def step():
        return ([A.decode_attention(q, k, v, l, shared, limit, 0.09)
                 for l, q in enumerate(qs)]
                + [A.decode_attention(qs[0], k, v, 2, rows, limit, 0.09,
                                      0.0, 300)])

    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        step()                                        # warm-up
    torch.cuda.current_stream(dev).wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    before = A.LAUNCHES["decode_attn"]
    for pos, per_row in ((0, (5, 700)), (513, (1023, 0)), (1023, (300, 301))):
        shared.fill_(pos)
        rows.copy_(torch.tensor(per_row, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize(dev)
        refs = [A.decode_attention_plain(q, k, v, l, pos, limit, 0.09)
                for l, q in enumerate(qs)]
        refs.append(torch.cat([A.decode_attention_plain(
            qs[0][i:i + 1], k[:, i:i + 1], v[:, i:i + 1], 2, p, limit, 0.09,
            0.0, 300) for i, p in enumerate(per_row)]))
        for got, ref in zip(outs, refs):
            assert (got - ref).abs().max() <= 1e-4 * v.float().abs().max()
    assert A.LAUNCHES["decode_attn"] == before      # a replay counts nothing


def test_decode_attention_past_len_tensor_checks(dev):
    q = torch.zeros((2, 8, 128), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((1, 2, 2, 256, 128), dtype=torch.bfloat16, device=dev)
    for bad in (torch.zeros((3,), dtype=torch.int32, device=dev),
                torch.zeros((2,), dtype=torch.int64, device=dev),
                torch.zeros((2,), dtype=torch.int32)):
        with pytest.raises(ValueError, match="past_len"):
            A.decode_attention(q, k, k, 0, bad, 256, 0.1)
    with pytest.raises(ValueError, match="past_len"):
        A.decode_attention(q, k, k, 0, 256, 256, 0.1)


@pytest.mark.parametrize("kind", ["bf16", "fp8", "q8", "q4", "q6"])
@pytest.mark.parametrize("hq,hkv,d,cap,win", [
    (8, 8, 128, 0.0, 0), (8, 2, 128, 0.0, 0), (8, 2, 128, 20.0, 0),
    (16, 4, 128, 0.0, 300), (8, 1, 64, 0.0, 0), (4, 2, 256, 0.0, 0),
    (48, 1, 128, 0.0, 0), (22, 1, 128, 20.0, 0), (24, 1, 256, 0.0, 300)])
def test_paged_decode_attention_kernel_matches_plain(dev, kind, hq, hkv, d,
                                                     cap, win):
    from exllamav2_tpu_torch.cache_paged import PagedKVCache, _kinds
    from exllamav2_tpu_torch.ops import paged_attn as P
    gen = torch.Generator(device=dev)
    gen.manual_seed(hq + d)
    cache = PagedKVCache.alloc(2, 8, hkv, d, kind, device=dev)
    # rows 0..699 of sequence 0 and 0..299 of sequence 1 through shuffled
    # tables; sequence 2 is a pad row on the null page
    bt = torch.tensor([[5, 2, 7, 0], [3, 6, 0, 0], [0, 0, 0, 0]],
                      dtype=torch.int32, device=dev)
    seqlens = torch.zeros(3, dtype=torch.int32, device=dev)
    k = torch.randn((3, 700, hkv, d), generator=gen, device=dev)
    v = torch.randn((3, 700, hkv, d), generator=gen, device=dev)
    cache.append(1, bt, seqlens, k.bfloat16(), v.bfloat16())
    q = torch.randn((3, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    vl = torch.tensor([700, 257, 1], dtype=torch.int32, device=dev)
    # the scale paged_attention passes: q4 / q8 keys carry the Hadamard
    # gain of 32 in the kernel's domain
    scale = d ** -0.5 / (32 if _kinds(kind)[0] in ("q4", "q8") else 1)
    args = (q, cache.k_data, cache.v_data, 1, bt, vl, cache.k_scales,
            cache.v_scales, scale, 256, hq, _kinds(kind), cap, win)
    before = P.LAUNCHES["paged_decode_attn"]
    got = P.paged_decode_attention(*args)
    assert P.LAUNCHES["paged_decode_attn"] == before + 1
    ref = P.paged_decode_attention_plain(*args)
    vk = _kinds(kind)[1]
    vmax = P._dq_page(cache.v_data[1].view(torch.uint8).view(
        cache.v_data.dtype), None if cache.v_scales is None
        else cache.v_scales[1], vk).abs().max()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * vmax


@pytest.mark.parametrize("kq,n", [(512, 256), (1376, 4096), (600, 132)])
def test_perf_dma_only_kernel_matches_plain(dev, kq, n):
    """Every K tile's sums, a ragged last tile and a ragged column block."""
    from exllamav2_tpu_torch.tools import perf_qmm as T
    gen = torch.Generator(device=dev)
    gen.manual_seed(kq)
    plane = torch.randint(-2 ** 31, 2 ** 31, (kq, n), dtype=torch.int32,
                          generator=gen, device=dev)
    before = T.LAUNCHES["perf_qmm_dma_only"]
    got = T.dma_only_tiles(plane)
    assert T.LAUNCHES["perf_qmm_dma_only"] == before + 1
    ref = T.dma_only_tiles_plain(plane)
    assert got.shape == ref.shape == (-(-kq // 512), n)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(T.dma_only(plane), got[kq // 512 - 1].expand(8, n))


@pytest.mark.parametrize("gr", [16, 32, 128, 256])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_perf_gp_kernel_matches_plain(dev, mode, bits, gr):
    from exllamav2_tpu_torch.tools import perf_qmm as T
    k, n = 1024, 392                      # a ragged column block
    plane, qs, smax, x = T.mk_inputs(k, n, dev, seed=bits, bits=bits, gr=gr)
    xa = T.quantize_x(x) if mode == "int8" else x.to(torch.bfloat16)
    key = "perf_qmm_gp_" + mode
    before = T.LAUNCHES[key]
    got = T.gp(xa, plane, qs, smax, bits=bits, gr=gr)
    assert T.LAUNCHES[key] == before + 1
    ref = T.gp_plain(xa, plane, qs, smax, bits, gr)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("gr", [16, 64])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_perf_gp_kernel_columns_not_a_multiple_of_four(dev, mode, bits, gr):
    """n % 4 != 0: the plane's rows are not 16-byte aligned, so the kernel
    takes its word-by-word template; one launch, the plain values."""
    from exllamav2_tpu_torch.tools import perf_qmm as T
    k, n = 2048, 390
    plane, qs, smax, x = T.mk_inputs(k, n, dev, seed=gr, bits=bits, gr=gr)
    xa = T.quantize_x(x) if mode == "int8" else x.to(torch.bfloat16)
    key = "perf_qmm_gp_" + mode
    before = T.LAUNCHES[key]
    got = T.gp(xa, plane, qs, smax, bits=bits, gr=gr)
    assert T.LAUNCHES[key] == before + 1
    ref = T.gp_plain(xa, plane, qs, smax, bits, gr)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def _device_kernels(call, calls=8):
    """{kernel name: count} of the device kernels of `calls` calls of
    `call` under torch.profiler, after a warm-up call."""
    from torch.profiler import profile, ProfilerActivity
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_perf_gp_kernel_is_one_launch(dev, mode):
    """A gp call is one LAUNCHES step and one device kernel, gp_kernel alone:
    the K splits meet inside the launch (no reduce_splits, no partials
    buffer)."""
    from exllamav2_tpu_torch.tools import perf_qmm as T
    plane, qs, smax, x = T.mk_inputs(4096, 4096, dev, seed=3, bits=4, gr=32)
    xa = T.quantize_x(x) if mode == "int8" else x.to(torch.bfloat16)
    key = "perf_qmm_gp_" + mode
    before = T.LAUNCHES[key]
    T.gp(xa, plane, qs, smax, bits=4, gr=32)
    assert T.LAUNCHES[key] == before + 1
    kern = _device_kernels(lambda: T.gp(xa, plane, qs, smax, bits=4, gr=32))
    assert len(kern) == 1, kern
    ((name, count),) = kern.items()
    assert "gp_kernel" in name and 0 < count <= 8


@pytest.mark.parametrize("name", ["int8_dot", "int4_dot",
                                  "int8_dot_batched"])
def test_int8_dot_probe_is_one_launch(dev, name):
    from exllamav2_tpu_torch.tools import probe_features as PF
    tensors = PF.probe_tensors(name, dev)
    kern = _device_kernels(lambda: PF.PROBES[name].kernel(*tensors))
    assert len(kern) == 1, kern
    ((kname, count),) = kern.items()
    assert "int8_dot_kernel" in kname and 0 < count <= 8


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("g,m,k,n", [(1, 5, 1024, 40), (3, 17, 96, 264),
                                     (2, 16, 4096, 8), (1, 32, 64, 256)])
def test_int8_dot_probe_kernel_shapes(dev, g, m, k, n, int4):
    """The int8 dot kernel's contract beyond the probes' shapes: any g and
    m, k % 32 == 0, n % 8 == 0 (ragged rows and columns, one warp, several
    passes); exact against the plain version."""
    import numpy as np
    from exllamav2_tpu_torch.tools import probe_features as PF
    rng = np.random.default_rng(k + n)
    a = rng.integers(-8, 8, (g, m, k)).astype(np.int8)
    bv = rng.integers(-8, 8, (g, k, n)).astype(np.int8)
    b = np.stack([PF.pack_int4(x) for x in bv]) if int4 else bv
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = PF._int8_dot_kernel(at.to(dev), bt.to(dev), int4=int4).cpu()
    plain = PF._int4_dot_plain if int4 else PF._int8_dot_plain
    want = torch.stack([plain(at[i], bt[i]) for i in range(g)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("gr", [16, 32, 128, 256])
@pytest.mark.parametrize("hints", [{}, {"kt0": 2048}, {"nt0": 4096},
                                   {"kt0": 256, "nt0": 512}])
def test_perf_nibble_kernel_matches_plain(dev, hints, gr):
    from exllamav2_tpu_torch.tools import perf_qmm as T
    k, n = 2048, 392
    plane, qs, smax, x = T.mk_inputs(k, n, dev, seed=gr, bits=4, gr=gr)
    xq = T.quantize_x(x)
    x1 = T.group_sums(xq, gr)
    before = T.LAUNCHES["perf_qmm_nibble_i8"]
    got = T.nibble_i8(xq, x1, plane, qs, smax, gr=gr, **hints)
    assert T.LAUNCHES["perf_qmm_nibble_i8"] == before + 1
    ref = T.nibble_i8_plain(xq, x1, plane, qs, smax, gr)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("gr", [32, 128])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096)])
def test_perf_nibble_kernel_7b_shapes(dev, k, n, gr):
    """The three 7B shapes under the three tilings of the tool's variants:
    one launch a call, K split over a cluster of up to 16 blocks."""
    from exllamav2_tpu_torch.tools import perf_qmm as T
    plane, qs, smax, x = T.mk_inputs(k, n, dev, seed=k + n, bits=4, gr=gr)
    xq = T.quantize_x(x)
    x1 = T.group_sums(xq, gr)
    ref = T.nibble_i8_plain(xq, x1, plane, qs, smax, gr)
    for hints in ({}, {"kt0": 2048}, {"nt0": 4096}):
        before = T.LAUNCHES["perf_qmm_nibble_i8"]
        got = T.nibble_i8(xq, x1, plane, qs, smax, gr=gr, **hints)
        assert T.LAUNCHES["perf_qmm_nibble_i8"] == before + 1
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("gr", [16, 128])
def test_perf_nibble_kernel_columns_not_a_multiple_of_four(dev, gr):
    """n % 4 != 0: the rows of the plane are not 16-byte aligned, so the
    kernel takes its word-by-word loads; one launch, the plain values."""
    from exllamav2_tpu_torch.tools import perf_qmm as T
    k, n = 2048, 390
    plane, qs, smax, x = T.mk_inputs(k, n, dev, seed=gr + 1, bits=4, gr=gr)
    xq = T.quantize_x(x)
    x1 = T.group_sums(xq, gr)
    before = T.LAUNCHES["perf_qmm_nibble_i8"]
    got = T.nibble_i8(xq, x1, plane, qs, smax, gr=gr)
    assert T.LAUNCHES["perf_qmm_nibble_i8"] == before + 1
    ref = T.nibble_i8_plain(xq, x1, plane, qs, smax, gr)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def _nibble_case(dev, k, n, gr, seed):
    from exllamav2_tpu_torch.tools import perf_qmm as T
    plane, qs, smax, x = T.mk_inputs(k, n, dev, seed=seed, bits=4, gr=gr)
    xq = T.quantize_x(x)
    return [xq, T.group_sums(xq, gr), plane, qs, smax]


def test_perf_nibble_kernel_graph_replay_with_new_activations(dev):
    """A CUDA graph of nibble_i8 calls replayed after xq and x1 change in
    place: the kernel holds no global scratch, so every replay equals the
    plain version on the new activations."""
    from exllamav2_tpu_torch.tools import perf_qmm as T
    k, n, gr = 11008, 4096, 32
    args = _nibble_case(dev, k, n, gr, seed=7)

    def step():
        return [T.nibble_i8(*args, gr=gr, **hints)
                for hints in ({}, {"kt0": 2048}, {"nt0": 4096})]

    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        step()                                        # warm-up
    torch.cuda.current_stream(dev).wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    gen = torch.Generator(device=dev)
    for seed in (1, 2, 3):
        gen.manual_seed(seed)
        x = torch.randn((T.M, k), generator=gen, device=dev)
        args[0].copy_(T.quantize_x(x))
        args[1].copy_(T.group_sums(args[0], gr))
        graph.replay()
        torch.cuda.synchronize(dev)
        ref = T.nibble_i8_plain(*args, gr)
        for got in outs:
            assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_perf_nibble_kernel_two_streams(dev):
    """Launches with different inputs in flight on two streams: both match
    their plain versions."""
    from exllamav2_tpu_torch.tools import perf_qmm as T
    cases = [(_nibble_case(dev, 11008, 4096, 32, seed=11), 32),
             (_nibble_case(dev, 4096, 4096, 128, seed=12), 128)]
    streams = [torch.cuda.Stream(dev) for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[] for _ in cases]
    for _ in range(20):              # interleaved launches on both streams
        for (args, gr), st, o in zip(cases, streams, outs):
            with torch.cuda.stream(st):
                o.append(T.nibble_i8(*args, gr=gr))
    torch.cuda.synchronize(dev)
    for (args, gr), o in zip(cases, outs):
        ref = T.nibble_i8_plain(*args, gr)
        for got in o:
            assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("k,n", [(256, 256), (1024, 256), (1040, 24)])
def test_bf16_dot_probe_kernel_depths(dev, k, n):
    """The bf16 dot probe's kernel at the probe's depth, at two 512-row
    passes and at a short last pass with a ragged column block."""
    import numpy as np
    from exllamav2_tpu_torch.tools import probe_features as PF
    rng = np.random.default_rng(k)
    a = PF._bf16(rng.standard_normal((16, k))).to(dev)
    b = PF._bf16(rng.standard_normal((k, n))).to(dev)
    before = PF.LAUNCHES["probe_features"]
    got = PF._bf16_dot_kernel(a, b)
    assert PF.LAUNCHES["probe_features"] == before + 1
    torch.cuda.synchronize(dev)
    assert PF._bf16_dot_verdict((a, b), got) == "ok"


@pytest.mark.parametrize("name", [
    "int8_dot", "int8_dot_batched", "u32_to_int8_cast", "bitcast_u32_u16",
    "u16_shift_and", "u8_shift_and", "int4_array", "int4_dot",
    "bf16_dot_bf16_acc_f32", "bitcast_u32_i8"])
def test_probe_kernel_matches_plain(dev, name):
    from exllamav2_tpu_torch.tools import probe_features as PF
    before = PF.LAUNCHES["probe_features"]
    on_card = PF.run_probe(name, dev, seed=5)       # asserts kernel == plain
    assert PF.LAUNCHES["probe_features"] == before + 1
    assert on_card == PF.run_probe(name, "cpu", seed=5)


def test_device_time_on_the_card(dev):
    from exllamav2_tpu_torch.utils.timing import device_time
    x = torch.randn((2048, 2048), device=dev)
    t = device_time(lambda a: a @ a, x, iters=32)
    assert 1e-6 < t < 1e-2


def test_w4a8_kernel_takes_prequantized_activations(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    lin = enable_w4a8_linear(random_gptq_linear(gen, 1024, 384, device=dev))
    seg = lin.segments[0]
    x = torch.randn((8, seg.rows_pad), generator=gen, device=dev)
    q = Q.w4a8_quantize(x, seg.group_rows)
    before = Q.LAUNCHES["qmm_w4a8"]
    got = Q.w4a8_segment_matmul(x, seg, quantized=q)
    assert Q.LAUNCHES["qmm_w4a8"] == before + 1
    ref = Q.qmm_w4a8_plain(x, seg)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_decode_attention_two_streams(dev):
    """Two launches with different inputs in flight on two streams: each has
    its own merge counters (device.stream_counters), so both match their
    plain versions."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    hkv, g, limit = 8, 4, 2048
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert A.grid(1, hkv, g, limit, sms)[3] > 1
    cases = []
    for past in (1900, 1300):
        shape = (2, 1, hkv, 2048, 128)
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        q = torch.randn((1, hkv * g, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        cases.append((q, k, v, past))
    streams = [torch.cuda.Stream(dev) for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[] for _ in cases]
    for _ in range(20):              # interleaved launches on both streams
        for (q, k, v, past), st, o in zip(cases, streams, outs):
            with torch.cuda.stream(st):
                o.append(A.decode_attention(q, k, v, 1, past, limit, 0.09))
    torch.cuda.synchronize(dev)
    from exllamav2_tpu_torch import device as DV
    keys = {(st.device_index, st.cuda_stream) for st in streams}
    assert keys <= set(DV._COUNTERS)
    for (q, k, v, past), o in zip(cases, outs):
        ref = A.decode_attention_plain(q, k, v, 1, past, limit, 0.09)
        for got in o:
            assert (got - ref).abs().max() <= 1e-4 * v.float().abs().max()


def test_prefill_dot_is_bf16_on_tensor_cores(dev):
    """The prefill product: bf16 operands, an f32 result, and no f32 GEMM
    in the profiler's kernels."""
    from torch.profiler import profile, ProfilerActivity
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    a = torch.randn((2, 64, 512), generator=gen, device=dev)
    b = torch.randn((512, 384), generator=gen, device=dev).to(torch.bfloat16)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = Q._dot(a, b)
        torch.cuda.synchronize(dev)
    assert y.dtype == torch.float32 and y.shape == (2, 64, 384)
    ref = torch.matmul(a.to(torch.bfloat16).double(), b.double())
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and not any("f32f32" in k or "sgemm" in k.lower()
                             for k in names), names


def test_prefill_attention_products_are_bf16(dev):
    """The t > 1 attention's two products (both caches): bf16 operands, f32
    results equal to the einsums on the rounded operands, and no f32 GEMM in
    the profiler's kernels."""
    from torch.profiler import profile, ProfilerActivity
    from exllamav2_tpu_torch.ops.paged_attn import gqa_scores, gqa_values
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    q = torch.randn((2, 16, 4, 2, 128), generator=gen, device=dev)
    k = torch.randn((2, 4, 300, 128), generator=gen, device=dev)[:, :, :272]
    v = torch.randn((2, 4, 272, 128), generator=gen, device=dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sc = gqa_scores(q, k)
        out = gqa_values(torch.softmax(sc, dim=-1), v)
        torch.cuda.synchronize(dev)
    b16 = torch.bfloat16
    ref = torch.einsum("btkgd,bksd->bkgts", q.to(b16).double(),
                       k.to(b16).double())
    assert sc.dtype == torch.float32 and sc.shape == ref.shape
    assert (sc - ref).abs().max() <= 1e-4 * ref.abs().max()
    p = torch.softmax(sc, dim=-1)
    ref = torch.einsum("bkgts,bksd->btkgd", p.to(b16).double(),
                       v.to(b16).double())
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not any("f32f32" in n or "sgemm" in n.lower() for n in names), \
        names


def _paged_pool(dev, kind, hkv, d, npages, page, gen):
    """A pool of `npages` pages whose every row holds random K/V stored by
    the cache's own codec, and its (k kind, v kind)."""
    from exllamav2_tpu_torch.cache_paged import PagedKVCache, _kinds, _raw
    from exllamav2_tpu_torch.ops.kvquant import kv_quant
    cache = PagedKVCache.alloc(2, npages, hkv, d, kind, page_size=page,
                               device=dev)
    kinds = _kinds(kind)
    for data, scales, k in ((cache.k_data, cache.k_scales, kinds[0]),
                            (cache.v_data, cache.v_scales, kinds[1])):
        x = torch.randn((hkv, data.shape[2], d), generator=gen, device=dev)
        qd, qs = kv_quant(x, k)
        _raw(data)[1] = _raw(qd)
        if scales is not None:
            scales[1] = qs
    return cache, kinds


def _paged_args(cache, kinds, q, bt, vl, page, cap=0.0, win=0):
    d = q.shape[-1]
    # the scale paged_attention passes: q4 / q8 keys carry the Hadamard
    # gain of 32 in the kernel's domain
    scale = d ** -0.5 / (32 if kinds[0] in ("q4", "q8") else 1)
    return (q, cache.k_data, cache.v_data, 1, bt, vl, cache.k_scales,
            cache.v_scales, scale, page, q.shape[1], kinds, cap, win)


def _paged_vmax(cache, kinds):
    from exllamav2_tpu_torch.cache_paged import _raw
    from exllamav2_tpu_torch.ops import paged_attn as P
    vdata = _raw(cache.v_data)[1].view(cache.v_data.dtype)
    return P._dq_page(vdata, None if cache.v_scales is None
                      else cache.v_scales[1], kinds[1]).abs().max()


@pytest.mark.parametrize("kind", ["bf16", "fp8", "q8", "q4", "q6"])
@pytest.mark.parametrize("g,batch,pw,page", [
    (1, 1, 8, 256), (4, 1, 8, 256), (16, 1, 8, 256), (1, 16, 2, 256),
    (4, 3, 24, 64), (16, 2, 40, 256), (1, 1, 64, 16), (48, 1, 8, 256),
    (22, 3, 24, 64), (17, 2, 40, 256)])
def test_paged_kernel_splits_match_plain(dev, kind, g, batch, pw, page):
    """Every kind and G bucket over the split counts of their buckets: one
    split row of 16-256 positions, splits crossing page edges, several
    splits in one page, 16 splits (a non-portable cluster), and a bucket
    whose scores outgrow the block at G = 16 (10,240 positions: the P.V
    pass scores its rows again). Rows end at 1, 17, a page edge and the
    bucket's end; the last row is a pad row on the null page. G of 48, 22
    and 17 run on the mma template (three and two m16 tiles)."""
    from exllamav2_tpu_torch.ops import paged_attn as P
    gen = torch.Generator(device=dev)
    gen.manual_seed(g * 100 + pw)
    hkv = 2
    cache, kinds = _paged_pool(dev, kind, hkv, 128, pw + 1, page, gen)
    table = torch.randperm(pw, generator=gen, device=dev).to(torch.int32) + 1
    ends = [pw * page, 17, page, 1, pw * page - 5, 1 + pw * page // 2]
    lens = [ends[i % len(ends)] for i in range(batch - 1)] + [1]
    bt = table[None].repeat(batch, 1)
    if batch > 1:
        bt[-1] = 0                                   # pad row
    else:
        lens = [pw * page - 3]
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((batch, hkv * g, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, per = P.grid(batch, hkv, g, pw, page, sms)[3:]
    assert 1 <= splits <= P.MAX_SPLITS
    args = _paged_args(cache, kinds, q, bt, vl, page)
    before = P.LAUNCHES["paged_decode_attn"]
    got = P.paged_decode_attention(*args)
    assert P.LAUNCHES["paged_decode_attn"] == before + 1
    ref = P.paged_decode_attention_plain(*args)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * _paged_vmax(cache, kinds)
    # no global state: a second launch gives the same bits
    assert torch.equal(got, P.paged_decode_attention(*args))


@pytest.mark.parametrize("kind", ["bf16", "fp8", "q8", "q4", "q6"])
@pytest.mark.parametrize("hq,hkv", [(48, 1), (28, 4)])
@pytest.mark.parametrize("batch", [1, 16])
def test_paged_kernel_gqa_heads_every_kind(dev, kind, hq, hkv, batch):
    """Kernel 3's mma template at StarCoder-15B's 48 query heads on one KV
    head and Qwen2.5-VL's 28 on 4, every cache kind, over phase 6's shapes
    (8 pages of 256; batch 1 at 1,500 positions, batch 16 at lengths 1 to
    2,048 and a pad row): within 1e-4 of max |v| of the plain version. A
    q4 K pool is scored from its staged nibbles, dequantized into the
    tensor-core fragments; the other kinds from bf16 rows."""
    from exllamav2_tpu_torch.ops import paged_attn as P
    gen = torch.Generator(device=dev)
    gen.manual_seed(hq * 10 + batch)
    page, pw = 256, 8
    cache, kinds = _paged_pool(dev, kind, hkv, 128, 2 * pw + 1, page, gen)
    if batch == 1:
        lens = [1500]
    else:
        ends = [1, 255, 256, 257, 1500, 2048]
        lens = [ends[i % len(ends)] for i in range(batch - 1)] + [1]
    bt = torch.stack([torch.randperm(2 * pw, generator=gen, device=dev)[:pw]
                      for _ in lens]).to(torch.int32) + 1
    if batch > 1:
        bt[-1] = 0                                   # pad row
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((batch, hq, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    assert P.grid(batch, hkv, hq // hkv, pw, page,
                  torch.cuda.get_device_properties(dev)
                  .multi_processor_count)[2] > 0      # the mma template
    args = _paged_args(cache, kinds, q, bt, vl, page)
    got = P.paged_decode_attention(*args)
    ref = P.paged_decode_attention_plain(*args)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * _paged_vmax(cache, kinds)
    assert torch.equal(got, P.paged_decode_attention(*args))


def test_paged_kernel_graph_replay_with_new_lengths(dev):
    """A CUDA graph of one serving decode step's kernel 3 launches (16 rows,
    bucket of 2 pages, 4 layers) replayed after valid_lens changes in place
    within the bucket: the grid depends on the bucket only, so every replay
    equals the plain version on the new lengths."""
    from exllamav2_tpu_torch.ops import paged_attn as P
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    hkv, g, page, pw, b = 8, 4, 256, 2, 16
    cache, kinds = _paged_pool(dev, "bf16", hkv, 128, 2 * b + 1, page, gen)
    bt = (torch.arange(2 * b, device=dev, dtype=torch.int32) + 1).reshape(
        b, pw)
    vl = torch.full((b,), 130, dtype=torch.int32, device=dev)
    qs = [torch.randn((b, hkv * g, 128), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4)]

    def step():
        return [P.paged_decode_attention(
            *_paged_args(cache, kinds, q, bt, vl, page)) for q in qs]

    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        step()                                        # warm-up
    torch.cuda.current_stream(dev).wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for lens in ([130] * b, [1, 17, 255, 256, 257, 511, 512, 300] * 2,
                 [512] * b):
        vl.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize(dev)
        for q, got in zip(qs, outs):
            ref = P.paged_decode_attention_plain(
                *_paged_args(cache, kinds, q, bt, vl, page))
            assert (got - ref).abs().max() <= 1e-4 * _paged_vmax(cache,
                                                                 kinds)


def test_paged_kernel_two_streams(dev):
    """Launches with different inputs in flight on two streams (the kernel
    holds no global scratch): both match their plain versions."""
    from exllamav2_tpu_torch.ops import paged_attn as P
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    hkv, g, page, pw = 8, 4, 256, 8
    cache, kinds = _paged_pool(dev, "q6", hkv, 128, pw + 1, page, gen)
    bt = (torch.randperm(pw, generator=gen, device=dev).to(torch.int32)
          + 1)[None]
    cases = []
    for n in (1900, 1300):
        q = torch.randn((1, hkv * g, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        vl = torch.tensor([n], dtype=torch.int32, device=dev)
        cases.append(_paged_args(cache, kinds, q, bt, vl, page))
    streams = [torch.cuda.Stream(dev) for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[] for _ in cases]
    for _ in range(20):              # interleaved launches on both streams
        for args, st, o in zip(cases, streams, outs):
            with torch.cuda.stream(st):
                o.append(P.paged_decode_attention(*args))
    torch.cuda.synchronize(dev)
    for args, o in zip(cases, outs):
        ref = P.paged_decode_attention_plain(*args)
        for got in o:
            assert (got - ref).abs().max() <= 1e-4 * _paged_vmax(cache,
                                                                 kinds)


# The mma templates of kernels 2 and 3 (G >= 2: a KV head's query heads as
# bf16 tensor-core tiles) at the query-head counts and head dims the CPU
# emulation of their tile order covers (tests/test_torch_gqa_tiles.py).
GQA_G = [2, 4, 7, 8, 16, 17, 22, 48]
GQA_D = [64, 128, 256]


@pytest.mark.parametrize("d", GQA_D)
@pytest.mark.parametrize("g", GQA_G)
@pytest.mark.parametrize("batch,limit,past", [(1, 1024, 900), (3, 64, 50)])
def test_decode_attention_mma_template_matches_plain(dev, g, d, batch, limit,
                                                     past):
    """Kernel 2's mma template over several splits (batch 1, limit 1024)
    and one (limit 64), within 1e-4 of max |v|: p enters P.V as two bf16
    parts, so the error stays near f32 summation order."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(g * 1000 + d + batch)
    hkv = 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gc, _, mt, splits, _ = A.grid(batch, hkv, g, limit, sms)
    assert mt == -(-gc // 16) >= 1
    assert (splits > 1) == (limit > 64)
    shape = (2, batch, hkv, 1024, d)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((batch, hkv * g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    before = A.LAUNCHES["decode_attn"]
    got = A.decode_attention(q, k, v, 1, past, limit, d ** -0.5, 0.0, 0)
    assert A.LAUNCHES["decode_attn"] == before + 1
    ref = A.decode_attention_plain(q, k, v, 1, past, limit, d ** -0.5)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * v.float().abs().max()


@pytest.mark.parametrize("kind", ["bf16", "fp8", "q8", "q4", "q6"])
@pytest.mark.parametrize("d", GQA_D)
@pytest.mark.parametrize("g", GQA_G)
@pytest.mark.parametrize("pw,page", [(8, 64), (24, 16), (1, 16)])
def test_paged_mma_template_matches_plain(dev, kind, g, d, pw, page):
    """Kernel 3's mma template (from MMA_MIN_G query heads a KV head; G =
    2 and 4 take the CUDA-core template) for every cache kind, over a
    cluster of splits inside pages (8 pages of 64), of splits whose rows
    straddle pages (24 pages of 16) and over one split (one page of 16),
    within 1e-4 of max |v|; the last row is a pad row on the null page."""
    from exllamav2_tpu_torch.ops import paged_attn as P
    gen = torch.Generator(device=dev)
    gen.manual_seed(g * 1000 + d + pw)
    hkv, batch = 2, 3
    cache, kinds = _paged_pool(dev, kind, hkv, d, batch * pw + 1, page, gen)
    bt = (torch.randperm(batch * pw, generator=gen, device=dev)
          .to(torch.int32) + 1).reshape(batch, pw)
    bt[-1] = 0                                   # pad row
    lens = [pw * page - 7, min(17, pw * page), 1]
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, _, mt, splits, _ = P.grid(batch, hkv, g, pw, page, sms)
    assert (mt >= 1) == (g >= P.MMA_MIN_G) and (splits > 1) == (pw > 1)
    q = torch.randn((batch, hkv * g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    args = _paged_args(cache, kinds, q, bt, vl, page)
    before = P.LAUNCHES["paged_decode_attn"]
    got = P.paged_decode_attention(*args)
    assert P.LAUNCHES["paged_decode_attn"] == before + 1
    ref = P.paged_decode_attention_plain(*args)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * _paged_vmax(cache, kinds)


@pytest.mark.parametrize("m", [1, 2, 4, 7, 8, 9, 16, 17, 32])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("gs,n", [(128, 384), (256, 200), (128, 72),
                                  (256, 4100)])
def test_partials_kernel_rows_bits_ragged(dev, bits, gs, n, m, monkeypatch):
    """The scales-on-partials kernel on its bf16 tile: every m template (8,
    16 and 32 rows), GPTQ 2/3/4/8 bits, groups of 128 and 256, and n % 128
    != 0 (a partial column block, a partial warp); one launch a call."""
    monkeypatch.setenv("QMM_PARTIALS", "1")
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 10 + bits + n)
    seg = random_gptq_linear(gen, 2048, n, bits=bits, group_rows=gs,
                             device=dev).segments[0]
    x = torch.randn((m, seg.rows_pad), generator=gen, device=dev).to(
        torch.bfloat16)
    before = dict(Q.LAUNCHES)
    got = Q.fused_segment_matmul(x, seg)
    assert Q.LAUNCHES == dict(before,
                              qmm_partials=before["qmm_partials"] + 1)
    ref = Q.qmm_partials_plain(x, seg)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("blk,a", [(32, 64), (17, 0), (64, 128),
                                   (128, 64), (100, 92)])
@pytest.mark.parametrize("bits,n", [(2, 96), (4, 200), (8, 64)])
def test_gptq_rows_kernel_matches_plain(dev, blk, a, bits, n):
    """Kernel G1 (csrc/gptq.cu) against its plain loop on a Hessian factor of
    correlated rows: every template (32, 64, 128 rows) and a ragged group,
    n % 64 != 0; codes, dq and err bit for bit; one launch a call; w left
    as it was; a group of more than 128 rows refused."""
    from exllamav2_tpu_torch.convert import gptq as G
    gen = torch.Generator(device=dev)
    gen.manual_seed(blk * 100 + bits + n)
    k = 256
    x = (torch.randn((512, 8), generator=gen, device=dev)
         @ torch.randn((8, k), generator=gen, device=dev)
         + 0.1 * torch.randn((512, k), generator=gen, device=dev))
    g = G.AdaptiveGPTQ(torch.zeros((k, 1), device=dev))
    g.add_batch(x)
    g.prepare()
    w = 0.05 * torch.randn((k, n), generator=gen, device=dev)
    qz = G.AdaptiveQuantizer(bits=bits)
    scale = qz.find_params(w[a:a + blk])[0]
    args = (w, g.hessian_inv, scale, qz.qzero, qz.maxq, a, blk)
    w0 = w.clone()
    before = G.LAUNCHES["gptq"]
    q, dq, err = G.gptq_rows(*args)
    assert G.LAUNCHES["gptq"] == before + 1
    pq, pdq, perr = G.gptq_rows_plain(*args)
    torch.cuda.synchronize(dev)
    assert torch.equal(w, w0)
    assert q.dtype == torch.uint16 and torch.equal(q, pq)
    assert torch.equal(dq, pdq) and torch.equal(err, perr)
    with pytest.raises(NotImplementedError):
        G.gptq_rows(w, g.hessian_inv, scale, qz.qzero, qz.maxq, 0, 129)
