"""The twins of the reference's text examples (exllamav2_tpu_torch/cli/
<example>.py against examples/<example>.py, CPU) on the trained fixture,
with Settings greedy in both packages (tests/torch_examples.py): the same
standard output, less the lines that report a rate or a time.

inference_streaming: the reference's example raises ("job exceeds
max_seq_len": begin_stream_ex's default max_new_tokens is 10**9 and the
generator refuses more than max_seq_len); the twin asks for the 200
tokens its loop reads, and its text is the reference's StreamingGenerator
streamed with that budget: the same tokens, or the first differing one
at a near-tie (the top two logits within TIE_GAP of max |logit|, the
port's model teacher-forced on the common prefix).
"""

import os

import numpy as np
import pytest
import torch

from torch_examples import (TRAINED, greedy_settings, run_port, run_ref,
                            tie_gap, without_rates)

# a near-tie: the two first-ranked logits within this share of max |logit|
# (chip_smoke.py's TIE_GAP)
TIE_GAP = 0.02


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
    ("inference", []),
    ("inference_banned_strings", []),
    ("inference_cfg", []),
    ("inference_cfg", ["--cfg-scale", "1.0"]),
    ("inference_filters", []),
    ("inference_grammar", []),
])
def test_example_matches_reference(name, argv, monkeypatch):
    argv = ["-m", TRAINED] + argv
    want = run_ref(f"examples/{name}.py", argv, monkeypatch)
    got, text = run_port(name, argv, monkeypatch)
    assert without_rates(text) == without_rates(want)
    assert len(without_rates(text).strip()) > 20
    assert got


def _stream(pkg, extra, settings_cls):
    """The example's stream through `pkg`'s StreamingGenerator with the 200
    tokens its loop reads -> (text, token ids, prompt ids)."""
    import argparse
    import importlib
    mi = importlib.import_module(pkg + ".model_init")
    sg = importlib.import_module(pkg + ".generator.streaming")
    ap = argparse.ArgumentParser()
    mi.add_args(ap)
    _, tok, gen = mi.init(ap.parse_args(["-m", TRAINED] + extra))
    stream = sg.StreamingGenerator(gen.model, gen.cache, tok)
    prompt = tok.encode("The old lighthouse keeper")
    stream.begin_stream_ex(prompt, settings_cls(temperature=0.8),
                           max_new_tokens=200)
    text, ids = "", []
    for _ in range(200):
        chunk, eos, t = stream.stream()
        text += chunk
        ids += [int(i) for i in np.asarray(t).ravel()]
        if eos:
            break
    return text, ids, [int(i) for i in np.asarray(prompt).ravel()]


def test_inference_streaming_reads_the_budget_of_its_loop(monkeypatch):
    import exllamav2_tpu.generator.sampler as RS
    import exllamav2_tpu_torch.generator.sampler as PS
    with pytest.raises(AssertionError, match="exceeds max_seq_len"):
        run_ref("examples/inference_streaming.py", ["-m", TRAINED],
                monkeypatch)
    got, text = run_port("inference_streaming", ["-m", TRAINED],
                         monkeypatch)
    assert text == got + "\n" and len(got) > 20
    mine, ids, prompt = _stream("exllamav2_tpu_torch", ["--device", "cpu"],
                                PS.Settings)
    assert mine == got and len(ids) == 200
    _, want, _ = _stream("exllamav2_tpu", [], RS.Settings)
    # the trained fixture has not seen this prompt: its greedy text is
    # uncertain enough to part at a near-tie (token 164 of 200 at the
    # time of writing)
    n = next((i for i, (a, b) in enumerate(zip(ids, want)) if a != b),
             None)
    if n is not None:
        gap = tie_gap(TRAINED, prompt + ids[:n], ids[n], want[n])
        assert gap < TIE_GAP, (n, gap)


def test_inference_lora_matches_reference(tmp_path, monkeypatch):
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.utils.testing import write_random_lora
    lora = write_random_lora(str(tmp_path / "lora"),
                             Model.from_dir(TRAINED, device="cpu").weights,
                             rank=4, seed=3)
    argv = ["-m", TRAINED, "--lora_dir", lora]
    want = run_ref("examples/inference_lora.py", argv, monkeypatch)
    got, text = run_port("inference_lora", argv, monkeypatch)
    assert text == want
    base, _ = run_port("inference", ["-m", TRAINED], monkeypatch)
    assert got.startswith("Our story begins") and got != base
    assert os.path.isfile(os.path.join(lora, "adapter_config.json"))


@pytest.mark.parametrize("new_api", [False, True], ids=["0.10", "0.11"])
def test_lmfe_filter_takes_both_token_enforcer_apis(new_api, monkeypatch):
    """inference_grammar's LMFormatEnforcerFilter against a stand-in of
    lm-format-enforcer (not installed here): 0.11 takes use_bitmask and
    vocab_size and returns a TokenList, earlier versions neither."""
    import sys
    import types
    from exllamav2_tpu_torch.generator.filters.external import \
        LMFormatEnforcerFilter
    from exllamav2_tpu_torch.tokenizer import load_tokenizer
    seen = {}

    class TokenList:
        def __init__(self, ids):
            self.allowed_tokens = list(ids)

    if new_api:
        class Data:
            def __init__(self, regular_tokens, decoder, eos_token_id,
                         use_bitmask, vocab_size):
                seen.update(n=len(regular_tokens), bitmask=use_bitmask,
                            vocab=vocab_size)
    else:
        class Data:
            def __init__(self, regular_tokens, decoder, eos_token_id):
                seen.update(n=len(regular_tokens))

    class Enforcer:
        def __init__(self, data, parser):
            pass

        def get_allowed_tokens(self, fed):
            ids = [48 + len(fed), 257]
            return TokenList(ids) if new_api else ids

    mod = types.SimpleNamespace(TokenEnforcer=Enforcer,
                                TokenEnforcerTokenizerData=Data)
    monkeypatch.setitem(sys.modules, "lmformatenforcer", mod)
    tok = load_tokenizer(TRAINED)
    f = LMFormatEnforcerFilter(tok, object())
    f.begin()
    assert f.next() == ({48, 257}, {257})
    f.feed(48)
    assert f.next() == ({49, 257}, {257})
    assert seen["n"] == tok.vocab_size
    if new_api:
        assert seen["bitmask"] is False and seen["vocab"] == tok.vocab_size
