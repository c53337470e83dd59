"""model_init, port against reference (CPU):
exllamav2_tpu_torch/model_init.py against exllamav2_tpu/model_init.py.

* cache_kind: the same kind for every cache flag.
* init: the same max_len, page count (max(ceil(max_len / 256) * batch + 1,
  8)), cache kind and draft wiring, and the same greedy text from the
  trained fixture.
* -tp over more than one device raises NotImplementedError; -tp -1 on the
  CPU is one device. With no --device and no GPU, init raises.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from exllamav2_tpu import model_init as R
from exllamav2_tpu.generator.sampler import Settings as RefSettings

from exllamav2_tpu_torch import model_init as P
from exllamav2_tpu_torch.generator.sampler import Settings

TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "trained_tiny")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(mod, extra=(), device=True):
    ap = argparse.ArgumentParser()
    mod.add_args(ap)
    argv = ["-m", TRAINED, *extra]
    if mod is P and device:
        argv += ["--device", "cpu"]
    return ap.parse_args(argv)


@pytest.mark.parametrize("flags", [[], ["-cq4"], ["-cq6"], ["-cq8"],
                                   ["-c8"], ["-cq4", "-c8"], ["-cq8", "-c8"]])
def test_cache_kind_matches_reference(flags):
    assert P.cache_kind(_args(P, flags)) == R.cache_kind(_args(R, flags))


@pytest.mark.parametrize("flags,batch", [
    (["-l", "256"], 2), (["-l", "1000", "-cq4"], 8), ([], 1),
    (["-l", "300", "-c8"], 3), (["-l", "512", "-cq6", "-tp", "1"], 16)])
def test_init_sizes_match_reference(flags, batch):
    _, _, rg = R.init(_args(R, flags), max_batch_size=batch)
    model, tok, gen = P.init(_args(P, flags), max_batch_size=batch)
    assert gen.max_seq_len == rg.max_seq_len
    assert gen.cache.num_pages == rg.cache.num_pages
    assert gen.cache.kind == rg.cache.kind
    assert gen.max_batch_size == rg.max_batch_size == batch
    assert model.device.type == "cpu"
    assert type(tok).__name__ == type(rg.tokenizer).__name__


def test_init_draft_wiring_matches_reference():
    flags = ["-l", "256"]
    _, _, rg = R.init(_args(R, flags), max_batch_size=2,
                      draft_model_dir=TRAINED, num_draft_tokens=3)
    _, _, gen = P.init(_args(P, flags), max_batch_size=2,
                       draft_model_dir=TRAINED, num_draft_tokens=3)
    assert gen.draft_model is not None and rg.draft_model is not None
    assert gen.draft_cache.num_pages == rg.draft_cache.num_pages
    assert gen.num_draft_tokens == rg.num_draft_tokens == 3
    _, _, rg = R.init(_args(R, flags), max_batch_size=2,
                      use_ngram_draft=True)
    _, _, gen = P.init(_args(P, flags), max_batch_size=2,
                       use_ngram_draft=True)
    assert gen.use_ngram_draft and rg.use_ngram_draft
    assert gen.draft_model is None and rg.draft_model is None


def test_init_greedy_text_matches_reference():
    _, rtok, rg = R.init(_args(R, ["-l", "256"]), max_batch_size=2)
    _, tok, gen = P.init(_args(P, ["-l", "256"]), max_batch_size=2)
    for prompt in ("The quick brown", "def main("):
        want = rg.generate(prompt, max_new_tokens=16,
                           settings=RefSettings.greedy())
        got = gen.generate(prompt, max_new_tokens=16,
                           settings=Settings.greedy())
        assert got == want and len(got) > 0


def test_tensor_parallel_over_devices_raises():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        P.init(_args(P, ["-l", "256", "-tp", "2"]))
    # -tp -1 on the CPU: one device, no mesh (the reference builds one per
    # chip it sees)
    _, _, gen = P.init(_args(P, ["-l", "256", "-tp", "-1"]),
                       max_batch_size=2)
    assert gen.device.type == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.init(_args(P, ["-l", "256"], device=False))
