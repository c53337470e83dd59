"""The twins of the reference's serving examples (CPU), Settings greedy in
both packages (tests/torch_examples.py): the same standard output less the
lines that report a rate or a time.

* inference_speculative: n-gram drafting and a draft model (the trained
  fixture as its own draft), each the same text as the reference's and as
  plain greedy decoding of the same prompt.
* minimal_chat: two turns piped on standard input, each reply the
  reference's or parting at a near-tie (the top two logits within TIE_GAP
  of max |logit|, the port's model teacher-forced on the common bytes).
"""

import pytest
import torch

from torch_examples import (TRAINED, greedy_settings, run_port, run_ref,
                            same_or_tie, without_rates)

TIE_GAP = 0.02      # chip_smoke.py's near-tie: of max |logit|


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _greedy(monkeypatch):
    greedy_settings(monkeypatch)


@pytest.mark.parametrize("argv", [[], ["-dm", TRAINED]],
                         ids=["ngram", "draft_model"])
def test_inference_speculative_matches_reference(argv, monkeypatch):
    from exllamav2_tpu_torch import model_init
    argv = ["-m", TRAINED] + argv
    want = run_ref("examples/inference_speculative.py", argv, monkeypatch)
    got, text = run_port("inference_speculative", argv, monkeypatch)
    assert without_rates(text) == without_rates(want)
    import argparse
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    _, _, gen = model_init.init(ap.parse_args(["-m", TRAINED, "--device",
                                               "cpu"]))
    from exllamav2_tpu_torch.generator.sampler import Settings
    prompt = "Here is a list of the first 20 prime numbers: 2, 3, 5,"
    plain = gen.generate(prompt, max_new_tokens=200,
                         settings=Settings.greedy())
    assert got == prompt + plain


def test_minimal_chat_matches_reference(monkeypatch):
    from exllamav2_tpu_torch.tokenizer import load_tokenizer
    qs = ["What did the keeper write?", "And then?"]
    stdin = "".join(q + "\n" for q in qs)
    want = run_ref("examples/minimal_chat.py", ["-m", TRAINED], monkeypatch,
                   stdin=stdin)
    got, text = run_port("minimal_chat", ["-m", TRAINED], monkeypatch,
                         stdin=stdin)
    assert len(got) == 2 and all(r.strip() for r in got)
    assert text == "".join(f"\nYou: Bot:{r}\n" for r in got) + "\nYou: "
    # each turn is its own job: its reply equals the reference's, or parts
    # at a near-tie (the chat prompt is not corpus text)
    ref_replies = [t[len("Bot:"):-1] for t in want.split("\nYou: ")[1:-1]]
    tok = load_tokenizer(TRAINED)
    for q, g, w in zip(qs, got, ref_replies):
        ids = tok.encode(f"User: {q}\nAssistant:", add_bos=True)
        same_or_tie(TRAINED, [int(i) for i in ids.ravel()], g, w, TIE_GAP)
