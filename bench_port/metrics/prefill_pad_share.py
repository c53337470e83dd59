"""Share of the prefill rows computed in the traced part that are padding:
100 x (1 - sum of ``rows`` / sum of ``rows_computed``) over the program's
``dyn.prefill`` spans there (each prefill forward: its real prompt tokens
against B x T of its bucketed ids). None where the program records no
spans, or none ran."""


def read(run):
    from exllamav2_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    rows = computed = 0
    for rec in spans(run.ta, run.tb):
        if rec.name == "dyn.prefill":
            rows += rec.counts["rows"]
            computed += rec.counts["rows_computed"]
    if computed <= 0:
        return None
    return 100.0 * (1.0 - rows / computed)
