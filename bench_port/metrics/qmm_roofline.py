"""Kernel 1 (ops/qmm.py -> csrc/qmm.cu) against its roofline over the traced
part: the bytes and FLOPs its launches there need, from the replays of each
step graph (a decode step or burst of k steps at its row bucket; a prefill
of t x b <= 32 rows, which kernel 1 serves) and the model's shapes, as the
least time the card could take, over the kernels' device time. An MoE
layer counts top-k experts streamed a step: exact at one row; at more
rows the fewest any routing needs, so the share is never overstated."""

from bench_port import roofline as R


def read(run):
    t = run.trace
    if t is None:
        return None
    secs = t.seconds("qmm_kernel")
    if secs <= 0:
        return None
    d = run.dims
    nbytes = flops = 0
    for key, n in run.cb["replays"].items():
        n -= run.ca["replays"].get(key, 0)
        if n <= 0:
            continue
        if key[0] in ("decode", "decode_burst"):
            m, steps = key[1], key[3] if key[0] == "decode_burst" else 1
            nbytes += n * steps * R.qmm_step_bytes(d, m, head=True)
            flops += n * steps * R.qmm_step_flops(d, m, head=True)
        elif key[0] == "prefill" and key[1] * key[3] <= 32:
            m = key[1] * key[3]
            nbytes += n * R.qmm_step_bytes(d, m, head=False)
            flops += n * R.qmm_step_flops(d, m, head=False)
    if nbytes <= 0:
        return None
    return 100.0 * R.bound_seconds(flops, nbytes) / secs
