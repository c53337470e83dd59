"""The twins of the reference's batching examples (inference_async,
bulk_inference, dynamic_gen, inference_dedup; CPU), Settings greedy in both
packages (tests/torch_examples.py): the same standard output less the
lines that report a rate or a time; the twins also return what they print.

inference_dedup's shared context is 3,280 tokens, past the trained
fixture's 2,048 positions (the reference's jnp.take clamps a position past
its rope table to the last row, the port's indexing raises), so it runs on
a random 4,096-position EXL2 model with -l 4096; the others on the trained
fixture.
"""

import pytest
import torch

from torch_examples import (TRAINED, greedy_settings, run_port, run_ref,
                            without_rates)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _greedy(monkeypatch):
    greedy_settings(monkeypatch)


@pytest.mark.parametrize("name, argv", [
    ("inference_async", []),
    ("bulk_inference", ["-n", "6"]),
    ("dynamic_gen", ["-n", "6"]),
])
def test_batching_example_matches_reference(name, argv, monkeypatch):
    argv = ["-m", TRAINED] + argv
    want = run_ref(f"examples/{name}.py", argv, monkeypatch)
    got, text = run_port(name, argv, monkeypatch)
    assert without_rates(text) == without_rates(want)
    assert len(without_rates(text).strip()) > 20
    assert got


def test_bulk_and_dynamic_return_what_they_print(monkeypatch):
    outs, text = run_port("bulk_inference", ["-m", TRAINED, "-n", "3"],
                          monkeypatch)
    assert len(outs) == 3 and all(repr(o) in text for o in outs)
    texts, text = run_port("dynamic_gen", ["-m", TRAINED, "-n", "3"],
                           monkeypatch)
    assert sorted(texts) == [0, 1, 2]
    assert all(f"[job {i}] {texts[i]!r}" in text for i in range(3))


def test_inference_dedup_matches_reference(tmp_path, monkeypatch):
    from exllamav2_tpu_torch.utils.testing import make_tiny_llama
    d = make_tiny_llama(str(tmp_path / "m4k"), quant="exl2", vocab=384,
                        max_pos=4096, seed=5, head_scale=6.0)
    argv = ["-m", d, "-l", "4096"]
    want = run_ref("examples/inference_dedup.py", argv, monkeypatch)
    got, text = run_port("inference_dedup", argv, monkeypatch)
    assert text == want
    assert len(got) == 4 and all(a.strip() for a, _ in got)
