"""The comparison that decides ``correct`` fails what it must: a whole run
of a tiny cell on the CPU (the harness's look for a card skipped, the
port's plain paths) passes, and the same run with the timed path broken
underneath does not. (The control, a lower precision, is held on the card
at the cells' own size: test_bench_port_control.py; at this size it moves
too few tokens to read apart from rounding.)

Faults a served cell can have: a step that returns its state unchanged (the
cache is never written), half of a batch left out (its rows take the other
half's logits), and a token altered where it is produced. A one-card cell
has no exchange between cards to leave out.
"""

import pytest
import torch

from bench_port import serve
from bench_port.tests.tiny import tiny_cell

CELLS = ["mistral-7b.chat", "mixtral-8x7b.chat", "mistral-7b.stream",
         "mixtral-8x7b.stream"]
SEED = 2 ** 32 + 77


def _run(cell, **kw):
    return serve.run_cell(cell, SEED, 8.0, False, device="cpu",
                          cell_spec=tiny_cell(cell), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "check"


def _cache_unchanged(monkeypatch):
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    monkeypatch.setattr(PagedKVCache, "append", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from exllamav2_tpu_torch.generator import dynamic
    real = dynamic.model_forward_paged

    def half(w, st, ids, *a, **k):
        logits, cache = real(w, st, ids, *a, **k)
        b = ids.shape[0]
        if logits is not None and ids.shape[1] == 1 and b >= 2:
            logits = logits.clone()
            logits[b // 2:] = logits[:b - b // 2][:b // 2]
        return logits, cache

    monkeypatch.setattr(dynamic, "model_forward_paged", half)


def _token_altered(monkeypatch):
    from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
    real = DynamicGenerator._accept

    def accept(self, job, tok, now, results):
        if job.new_tokens % 3 == 2:
            tok = (tok + 1) % self.model.static.vocab_size
        return real(self, job, tok, now, results)

    monkeypatch.setattr(DynamicGenerator, "_accept", accept)


@pytest.mark.parametrize("fault", [_cache_unchanged, _half_batch,
                                   _token_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault, monkeypatch):
    if fault is _half_batch and tiny_cell(cell)["traffic"]["clients"] < 2:
        pytest.skip("one client: no batch to halve")
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["check"]
