"""Kernel-1 launches (ops/qmm LAUNCHES["qmm"], which counts the gated MoE
entry's launches too; a graph replay credits what its capture counted) over
the window, per output token handed over in it."""

from bench_port.tails import delivered


def read(run):
    n = delivered(run.requests, run.t0, run.t1)
    if n <= 0:
        return None
    return (run.c1["qmm"] - run.c0["qmm"]) / n
