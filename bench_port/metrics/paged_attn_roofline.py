"""Kernel 3 (ops/paged_attn.py -> csrc/paged_attn.cu) against its roofline
over the traced part: for every output token handed over there, the decode
step that made it read K and V over the job's context then (its prompt and
the tokens before it), once a layer; the least time the card could take
for those bytes and FLOPs, over the kernel's device time."""

from bench_port import roofline as R


def read(run):
    t = run.trace
    if t is None:
        return None
    secs = t.seconds("paged_attn")
    if secs <= 0:
        return None
    d = run.dims
    nbytes = flops = 0
    for r in run.requests:
        i = 0
        for when, n in r.deliveries:
            if run.ta < when <= run.tb:
                for j in range(i, i + n):
                    ctx = len(r.prompt) + j
                    nbytes += R.attn_step_bytes(d, ctx, run.kv_bytes)
                    flops += R.attn_step_flops(d, ctx)
            i += n
    if nbytes <= 0:
        return None
    return 100.0 * R.bound_seconds(flops, nbytes) / secs
