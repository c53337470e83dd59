"""Bytes and FLOPs counted from the shapes."""

from bench_port import roofline as R
from bench_port import spec, weights


def _dims(name):
    return weights.dims(spec.load("configs", name.split(".")[0]))


def test_mixtral_batch1_expert_launches_stream_6_38_gb():
    d = _dims("mixtral-8x7b.stream")
    experts_only = R.qmm_step_bytes(d, 1, head=False) - sum(
        R.linear_bytes(k, n, 1) for k, n, e in R.step_linears(d, False)
        if not e)
    # 2 routed experts a layer stream their words, scales and rows; the 6
    # others' gated launches write zeros (PERF.md's 6.38 GB, PR 12)
    assert round(experts_only / 1e9, 2) == 6.38
    per_expert = 3 * (4096 * 14336 // 2 + 4096 // 32 * 14336 * 2)
    assert experts_only > 2 * 32 * per_expert
    whole = R.qmm_step_bytes(d, 1)
    attn = 32 * (2 * 4096 * 4096 + 2 * 4096 * 1024) * (0.5 + 2 / 32)
    head = 4096 * 32000 * (0.5 + 2 / 32)
    assert abs(whole - experts_only - attn - head) / whole < 0.005


def test_mixtral_batch1_flops_count_top2():
    d = _dims("mixtral-8x7b.stream")
    f = R.qmm_step_flops(d, 1)
    active = 32 * (2 * 4096 * 4096 + 2 * 4096 * 1024
                   + 2 * 3 * 4096 * 14336) + 4096 * 32000
    assert f == 2 * active
    assert R.token_flops(d, 0, True) == f + 2 * 4096 * 8 * 32


def test_mistral_batch1_bytes():
    d = _dims("mistral-7b.stream")
    params = 32 * (2 * 4096 * 4096 + 2 * 4096 * 1024
                   + 3 * 4096 * 14336) + 4096 * 32768
    b = R.qmm_step_bytes(d, 1)
    assert abs(b - params * (0.5 + 2 / 32)) / b < 0.005
    assert round(b / 1e9, 2) == 4.01


def test_attention_bytes_and_bound():
    d = _dims("mistral-7b.stream")
    ctx = 1000
    b = R.attn_step_bytes(d, ctx)
    assert b == 32 * (2 * 8 * 128 * 2 * ctx + 32 * 128 * 6)
    assert R.attn_step_flops(d, ctx) == 4 * ctx * 32 * 128 * 32
    # attention at one query row is bound by bytes
    assert R.bound_seconds(R.attn_step_flops(d, ctx), b) == b / R.PEAK_BYTES
