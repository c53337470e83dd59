"""The generator's own host time per step in the traced part: the mean,
over the program's ``dyn.iterate`` spans there, of the span's duration
less the spans inside it that belong to the card or to the graph runner:
``dyn.readback`` (the wait for the step's tokens) and the ``graphs.*``
spans of utils/graphs.py (an input copy that synchronizes the stream, a
graph launch that blocks while the card's queue is full, a capture). What
is left is the scheduler's Python: admission, building the prefill and
step inputs, accepting and emitting tokens, reaping. None where the
program records no spans, or none ran."""


def _outside(rec) -> bool:
    return rec.name == "dyn.readback" or rec.name.startswith("graphs.")


def read(run):
    from exllamav2_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    recs = spans(run.ta, run.tb)
    own = {id(r): r.end_ns - r.start_ns for r in recs
           if r.name == "dyn.iterate"}
    if not own:
        return None
    for r in recs:
        if not _outside(r):
            continue
        p = r.parent
        while p is not None and p.name != "dyn.iterate" and not _outside(p):
            p = p.parent
        if p is not None and id(p) in own:      # not inside another one
            own[id(p)] -= r.end_ns - r.start_ns
    return sum(own.values()) / len(own) / 1e6
