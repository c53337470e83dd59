"""Step and prefill graphs the generator captured inside the window (its two
StepGraphs runners' ``captures``): each one stalls the step that needs it."""


def read(run):
    return run.c1["captures"] - run.c0["captures"]
