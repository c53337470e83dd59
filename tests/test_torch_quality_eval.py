"""The quality_eval twin (exllamav2_tpu_torch/cli/quality_eval.py) against
the reference's tools/quality_eval.py on the CPU: each table's function of
both packages on the same checkpoints (the port's conversions of the same
fixtures, read by both loaders) and the same rows.

The twin samples its self-generated rows through a torch.Generator, not
jax.random, so the random-init tables read other rows than the
reference's; here both score the trained fixture's corpus rows, and the
twin's run() is held to the tables' orderings.

Tolerances: perplexity within 1e-4 of itself at every cache kind; KLD
within 2e-4 absolute (max KLD 2e-3) and top-1 agreement within 1 % (2 of
256 positions); the W4A8 decode path's perplexities within 1e-4 of
themselves. Both packages round to bf16 at the same points, with f32 sums
in another order (tests/test_torch_model.py).
"""

import os

import numpy as np
import pytest
import torch

from torch_examples import TRAINED, run_port

PPL_REL = 1e-4
KLD_ABS = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    import importlib.util
    from torch_examples import REPO
    spec = importlib.util.spec_from_file_location(
        "ref_quality_eval", os.path.join(REPO, "tools", "quality_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from exllamav2_tpu_torch.cli import quality_eval as Q
    tmp = str(tmp_path_factory.mktemp("quality"))
    q4, q6 = Q.build_trained_quants(tmp, TRAINED, device="cpu")
    return {"dense": TRAINED, "q4": q4, "q6": q6}


def _models(d):
    from exllamav2_tpu.models.model import Model as RefModel
    from exllamav2_tpu_torch.models.model import Model
    return RefModel.from_dir(d), Model.from_dir(d, device="cpu")


def test_corpus_rows_and_cache_ppl_match_reference(ref, dirs):
    from exllamav2_tpu_torch.cli import quality_eval as Q
    rows = Q.corpus_rows()
    assert np.array_equal(rows, ref.corpus_rows())
    assert Q.CACHE_KINDS == ref.CACHE_KINDS
    for key in ("dense", "q4"):
        rm, pm = _models(dirs[key])
        want = ref.cache_ppl_table(rm, rows[:2, :129])
        got = Q.cache_ppl_table(pm, rows[:2, :129])
        for kind in Q.CACHE_KINDS:
            assert abs(got[kind] - want[kind]) <= PPL_REL * want[kind], \
                (key, kind)
        assert 1.0 < got["bf16"] < 1.5


def test_weight_kld_and_w4a8_match_reference(ref, dirs):
    from exllamav2_tpu_torch.cli import quality_eval as Q
    rows = Q.corpus_rows()[:2, :129]
    (rd, pd), (r4, p4) = _models(dirs["dense"]), _models(dirs["q4"])
    want, got = ref.weight_kld(rd, r4, rows), Q.weight_kld(pd, p4, rows)
    assert abs(got["kld_mean"] - want["kld_mean"]) <= KLD_ABS
    assert abs(got["kld_max"] - want["kld_max"]) <= 10 * KLD_ABS
    assert abs(got["top1_agree"] - want["top1_agree"]) <= 0.01
    assert 0 < got["kld_mean"] < 0.01
    w = ref.w4a8_quality(dirs["q4"], rows[:1, :33])
    g = Q.w4a8_quality(dirs["q4"], rows[:1, :33], device="cpu")
    for k in ("ppl_exact", "ppl_w4a8"):
        assert abs(g[k] - w[k]) <= PPL_REL * w[k], k
    assert abs(g["kld_mean"] - w["kld_mean"]) <= KLD_ABS


def test_run_writes_every_table(tmp_path, monkeypatch):
    path = str(tmp_path / "QUALITY.md")
    res, text = run_port("quality_eval", ["--write", path], monkeypatch)
    for k in ("ppl_dense", "ppl_q4", "ppl_peaked", "kld4", "kld6",
              "t_ppl_dense", "t_ppl_q4", "t_kld4", "t_kld6", "t_w4a8"):
        assert k in res, k
    assert res["t_kld6"]["kld_mean"] < res["t_kld4"]["kld_mean"]
    with open(path) as f:
        md = f.read()
    assert md in text and "| trained fp16 |" in md
    # the peaked fixture: q6's 8-bit K beats q4 (the reference's ordering)
    p = res["ppl_peaked"]
    assert p["q6"] < p["q4"]
