"""Share of the traced part of the window in which no operation ran on the
card: 100 x (1 - union of device intervals / traced seconds)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
