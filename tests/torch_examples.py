"""Helpers of the example and tool twin tests: the reference's script run
as __main__ through runpy with sys.argv (and stdin) set, the twin's
main(argv) in process, and Settings made greedy in both packages (the
port's torch.Generator draws differ from jax.random's, so sampled texts
cannot agree; greedy ones can)."""

import contextlib
import importlib
import io
import os
import runpy
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "tests", "fixtures", "trained_tiny")
CPU = ["--device", "cpu"]
GREEDY = dict(temperature=1.0, token_repetition_penalty=1.0, top_p=0.0,
              top_k=1)


def _greedy(real):
    """A stand-in for a Settings class: every instance greedy (cfg_scale
    kept), Settings.greedy() as before."""
    class Greedy:
        @staticmethod
        def greedy(**kw):
            return real(**{**GREEDY, **kw})

        def __new__(cls, *a, **kw):
            return real(**GREEDY, **{k: v for k, v in kw.items()
                                     if k == "cfg_scale"})
    return Greedy


def greedy_settings(monkeypatch) -> None:
    """Settings(...) greedy in both packages' sampler modules (the scripts
    import the name when they run)."""
    import exllamav2_tpu.generator.sampler as ref_sampler
    import exllamav2_tpu_torch.generator.sampler as port_sampler
    for mod in (ref_sampler, port_sampler):
        monkeypatch.setattr(mod, "Settings", _greedy(mod.Settings))


def run_ref(script: str, argv, monkeypatch, stdin: str | None = None) -> str:
    """The reference's script (a path under the repository) as __main__ ->
    its stdout."""
    buf = io.StringIO()
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [script] + list(argv))
        if stdin is not None:
            m.setattr(sys, "stdin", io.StringIO(stdin))
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, script), run_name="__main__")
    return buf.getvalue()


def run_port(name: str, argv, monkeypatch, stdin: str | None = None,
             device=CPU):
    """exllamav2_tpu_torch.cli.<name>.main(argv + device) -> (its return
    value, its stdout)."""
    main = importlib.import_module(f"exllamav2_tpu_torch.cli.{name}").main
    buf = io.StringIO()
    with monkeypatch.context() as m:
        if stdin is not None:
            m.setattr(sys, "stdin", io.StringIO(stdin))
        with contextlib.redirect_stdout(buf):
            out = main(list(argv) + list(device))
    return out, buf.getvalue()


def without_rates(text: str) -> str:
    """The text less its lines that report a rate or a time."""
    return "\n".join(l for l in text.splitlines()
                     if "t/s" not in l and "tokens in" not in l)


def tie_gap(model_dir: str, ids, a: int, b: int) -> float:
    """Greedy parting at a near-tie: the port's logits after `ids` (the
    prompt and the common tokens, teacher-forced on the CPU) must rank `a`
    and `b` first and second in some order; returns their gap over max
    |logit|."""
    import numpy as np
    import torch
    from exllamav2_tpu_torch.models.model import Model
    m = Model.from_dir(model_dir, device="cpu")
    ids = np.asarray(ids, np.int32)[None]
    logits, _ = m.forward(ids, m.new_cache(1, ids.shape[1] + 8), 0)
    row = logits[0, -1].float()
    top = torch.topk(row, 2).indices.tolist()
    assert sorted(top) == sorted([a, b]), (top, a, b)
    return ((row[top[0]] - row[top[1]]) / row.abs().max()).item()


def same_or_tie(model_dir: str, prompt_ids, got: str, want: str,
                limit: float) -> float | None:
    """Two greedy texts of a byte-level model after `prompt_ids`: None where
    they are equal, else the tie_gap at the first differing byte (which
    must be under `limit`); the common text must be ASCII, so its bytes are
    its token ids."""
    if got == want:
        return None
    a, b = got.encode(), want.encode()
    n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    assert n < min(len(a), len(b)), "one text ends where the other goes on"
    common = a[:n]
    assert common.isascii(), common
    gap = tie_gap(model_dir, list(prompt_ids) + list(common), a[n], b[n])
    assert gap < limit, (n, gap)
    return gap
