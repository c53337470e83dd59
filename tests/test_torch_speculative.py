"""Port vs reference: speculative decoding on the CPU.

The reference's tests/test_speculative.py and test_generator.py's
test_ngram_spec_with_bursts_enabled, on both packages: the n-gram drafter
drafts what the reference's drafts on the same sequences; n-gram and
draft-model rounds give the reference's speculative tokens (exact) and the
port's own plain tokens. The checkpoint is the reference's speculative tests'
tiny EXL2 model (seed 5, sharpened head) at hidden 128, so that greedy
choices are decisive in both packages. The jobs of the reference's tests
run through one n-gram generator of each package, batched alike.
"""

import numpy as np
import pytest
import torch

from exllamav2_tpu.cache_paged import PagedKVCache as RefPagedCache
from exllamav2_tpu.generator.dynamic import DynamicGenerator as RefGen
from exllamav2_tpu.generator.dynamic import DynamicJob as RefJob
from exllamav2_tpu.generator.sampler import Settings as RefSettings
from exllamav2_tpu.generator.speculative import NgramDrafter as RefDrafter
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.utils.testing import make_tiny_llama

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.generator.speculative import NgramDrafter
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.tokenizer import ByteTokenizer

TOK = ByteTokenizer(384)

# (prompt, new tokens, repetition penalty) of the reference's tests:
# test_ngram_spec_matches_plain, test_spec_batch's two prompts,
# test_spec_penalty_equivalence and test_draft_model_spec_matches_plain
SPEC_JOBS = [("abcabcabcabcabc", 12, 1.0), ("xyxyxyxyxy", 8, 1.0),
             ("aaaa bbbb aaaa", 8, 1.0), ("penalty check", 12, 1.3),
             ("hello world", 10, 1.0)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that test workers running side
    by side do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("spec_model")),
                           quant="exl2", seed=5, vocab=384, max_pos=4096,
                           hidden=128, heads=2, kv_heads=1, inter=256,
                           head_scale=6.0)


@pytest.fixture(scope="module")
def model(model_dir):
    return Model.from_dir(model_dir, device="cpu")


@pytest.fixture(scope="module")
def ref_model(model_dir):
    return RefModel.from_dir(model_dir)


def _cache(model, pages=32):
    st = model.static
    return PagedKVCache.alloc(st.num_layers, pages, st.num_kv_heads,
                              st.head_dim, "bf16", device="cpu")


def _ref_cache(ref_model, pages=32):
    st = ref_model.static
    return RefPagedCache.alloc(st.num_layers, pages, st.num_kv_heads,
                               st.head_dim, "bf16")


def _jobs(job_cls, settings_cls, specs):
    return [job_cls(TOK.encode(p), max_new_tokens=n,
                    settings=settings_cls.greedy(
                        token_repetition_penalty=pen))
            for p, n, pen in specs]


def _run(gen, jobs):
    for j in jobs:
        gen.enqueue(j)
    while any(j.status != "done" for j in jobs):
        gen.iterate()
        gen._validate_cache()
    return jobs


@pytest.fixture(scope="module")
def ngram_rounds(model, ref_model):
    """The jobs through the reference's n-gram generator, the port's, and
    the port's plain generator, each in one batch."""
    ref = _run(RefGen(ref_model, _ref_cache(ref_model), TOK,
                      use_ngram_draft=True),
               _jobs(RefJob, RefSettings, SPEC_JOBS))
    spec = _run(DynamicGenerator(model, _cache(model), TOK,
                                 use_ngram_draft=True),
                _jobs(DynamicJob, Settings, SPEC_JOBS))
    plain = _run(DynamicGenerator(model, _cache(model), TOK),
                 _jobs(DynamicJob, Settings, SPEC_JOBS))
    return ref, spec, plain


def test_ngram_drafter_matches_reference():
    """The same drafts, table for table, over seeded sequences that grow,
    with a reset between them."""
    rng = np.random.default_rng(0)
    ours, ref = NgramDrafter(4), RefDrafter(4)
    for key in range(3):
        pat = rng.integers(0, 9, int(rng.integers(2, 6)))
        seq = np.tile(pat, 6)[:int(rng.integers(5, 30))].astype(np.int32)
        for _ in range(6):
            for d in (ours, ref):
                d.update(key, seq)
            for k in (1, 4, 7):
                np.testing.assert_array_equal(ours.draft(key, seq, k),
                                              ref.draft(key, seq, k))
            seq = np.append(seq, rng.integers(0, 9, int(rng.integers(1, 4)))
                            ).astype(np.int32)
        assert ours.positions[key] == ref.positions[key]
        ours.reset(key)
        ref.reset(key)
        assert key not in ours.tables and ours.draft(key, seq, 3).size == 0


def test_ngram_spec_matches_plain(ngram_rounds):
    ref, spec, plain = ngram_rounds
    np.testing.assert_array_equal(spec[0].sequence, ref[0].sequence)
    np.testing.assert_array_equal(spec[0].sequence, plain[0].sequence)
    assert spec[0].emitted_text == plain[0].emitted_text
    assert spec[0].draft_accepted == ref[0].draft_accepted > 0


def test_spec_batch(ngram_rounds):
    ref, spec, plain = ngram_rounds
    for i in (1, 2):
        np.testing.assert_array_equal(spec[i].sequence, ref[i].sequence)
        assert spec[i].emitted_text == plain[i].emitted_text


def test_spec_penalty_equivalence(ngram_rounds):
    """Under a repetition penalty the verify step takes the pre-draft
    context at every position (the reference's approximation): the
    reference's speculative tokens exactly, and the plain text's first two
    characters (always sampled with the exact context)."""
    ref, spec, plain = ngram_rounds
    np.testing.assert_array_equal(spec[3].sequence, ref[3].sequence)
    assert spec[3].emitted_text[:2] == plain[3].emitted_text[:2]
    assert spec[3].emitted_text and plain[3].emitted_text


def test_ngram_spec_with_bursts_enabled(model, ngram_rounds):
    """The n-gram drafter beside decode_burst=8: the speculative round
    serves the job (bursts only where no draft runs), and its text is the
    per-token plain text."""
    gen = DynamicGenerator(model, _cache(model), TOK, decode_burst=8,
                           use_ngram_draft=True)
    (job,) = _run(gen, _jobs(DynamicJob, Settings, SPEC_JOBS[:1]))
    assert job.emitted_text == ngram_rounds[2][0].emitted_text
    assert job.draft_accepted > 0


def test_draft_model_spec_matches_plain(model, ngram_rounds, tmp_path):
    """The model as its own draft, and a 1-layer dense draft of another
    seed: the reference's speculative tokens (its n-gram round's; its own
    test holds every drafter to the plain tokens) and the port's plain
    tokens."""
    ref, _, plain = (r[4] for r in ngram_rounds)
    own = _run(DynamicGenerator(model, _cache(model), TOK,
                                draft_model=model, draft_cache=_cache(model)),
               _jobs(DynamicJob, Settings, SPEC_JOBS[4:]))[0]
    np.testing.assert_array_equal(own.sequence, ref.sequence)
    np.testing.assert_array_equal(own.sequence, plain.sequence)
    assert own.draft_accepted > 0

    d2 = make_tiny_llama(str(tmp_path / "draft"), quant=None, seed=99,
                         vocab=384, max_pos=4096, layers=1, hidden=128,
                         heads=2, kv_heads=2, inter=256)
    draft = Model.from_dir(d2, device="cpu")
    other = _run(DynamicGenerator(model, _cache(model), TOK,
                                  draft_model=draft,
                                  draft_cache=_cache(draft)),
                 _jobs(DynamicJob, Settings, SPEC_JOBS[4:]))[0]
    np.testing.assert_array_equal(other.sequence, plain.sequence)
