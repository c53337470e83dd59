"""The model step's share of the card's bf16 peak over the traced part of
the window: model FLOPs of every output token handed over in it (linears of
the active experts and the head, attention over its context) and of every
prompt token prefilled for the requests whose first token came in it
(attention over their causal context), over the traced seconds x 989
TFLOP/s."""

from bench_port import roofline as R


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    d, flops = run.dims, 0
    dec = R.token_flops(d, 0, head=True)          # linears, router, head
    pre = R.token_flops(d, 0, head=False)
    for r in run.requests:
        base = len(r.prompt)
        i = 0
        for when, n in r.deliveries:
            if run.ta < when <= run.tb:
                for j in range(i, i + n):
                    flops += dec + R.attn_step_flops(d, base + j)
            i += n
        first = r.t_first
        if first is not None and run.ta < first <= run.tb:
            for p in range(r.cached, base - 1):
                flops += pre + R.attn_step_flops(d, p + 1)
    if flops <= 0:
        return None
    return 100.0 * flops / (t.window_s * R.PEAK_FLOPS)
