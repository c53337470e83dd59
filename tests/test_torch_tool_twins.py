"""The twins of the reference's tools/ scripts (exllamav2_tpu_torch/cli/
<tool>.py, CPU) against the scripts themselves on the same inputs.

* eval_trained on the trained fixture: the same completions, pass@1 line
  and accuracy line (the reference writes docs/sessions/, so it runs with
  its REPO pointed at a temporary tree that links eval/).
* convert_serve_check on a conversion the port made: the reference's
  greedy q4-cache serve against the twin's forced replay with --check
  (the twin's check), and the twin's greedy serve against the reference's
  forced replay (the reference's --check); both checks at the reference's
  tol of 0.08.
* bench_serving --small: every job ends, each with the same new tokens in
  both packages.
* decomp_flagship at a small geometry (random_model_weights patched in both
  packages: the script hardcodes 7B): the same components, MiB and the
  weight stream's bytes.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from torch_examples import REPO, run_port, run_ref


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_trained_matches_reference(tmp_path, monkeypatch, capsys):
    ref = _ref_module("eval_trained")
    os.symlink(os.path.join(REPO, "eval"), tmp_path / "eval")
    monkeypatch.setattr(ref, "REPO", str(tmp_path))
    ref.main()
    with open(tmp_path / "docs" / "sessions" / "r5_eval_trained.json") as f:
        want = json.load(f)
    out = str(tmp_path / "port.json")
    got, _ = run_port("eval_trained", ["--out", out], monkeypatch)
    with open(out) as f:
        assert json.load(f) == got
    assert got["humaneval"]["completions"] == \
        want["humaneval"]["completions"]
    assert got["humaneval"]["pass_at_1"] == want["humaneval"]["pass_at_1"]
    assert got["mmlu"]["accuracy_line"] == want["mmlu"]["accuracy_line"]
    assert got["humaneval"]["problems"] == 3
    assert float(re.findall(r"[\d.]+", got["humaneval"]["pass_at_1"])[-1]) \
        > 0


def test_convert_serve_check_both_ways(tmp_path, monkeypatch):
    from exllamav2_tpu_torch.cli import convert_serve_check as C
    root = str(tmp_path)
    C.prepare(root, device="cpu")
    a_ref, b_port = str(tmp_path / "a_ref.json"), str(tmp_path / "b.json")
    run_ref("tools/convert_serve_check.py", ["--serve", root, "--logits",
                                              a_ref], monkeypatch)
    got, _ = run_port("convert_serve_check",
                      ["--serve", root, "--force", a_ref, "--logits", b_port,
                       "--check", a_ref, b_port], monkeypatch)
    assert got["check"]["ok"] and got["check"]["checked_steps"] > 40
    assert got["serve"]["backend"] == "cpu"
    a_port, b_ref = str(tmp_path / "a_port.json"), str(tmp_path / "b_r.json")
    run_port("convert_serve_check", ["--serve", root, "--logits", a_port],
             monkeypatch)
    run_ref("tools/convert_serve_check.py",
            ["--serve", root, "--force", a_port, "--logits", b_ref],
            monkeypatch)
    out = run_ref("tools/convert_serve_check.py",
                  ["--check", a_port, b_ref], monkeypatch)
    res = json.loads(out.strip().splitlines()[-1])
    assert res["ok"] and res["rel_tol"] == 0.08
    assert res["checked_steps"] == got["check"]["checked_steps"]


def test_bench_serving_small_ends_every_job(monkeypatch):
    from exllamav2_tpu.generator import dynamic as RD
    argv = ["--small", "--jobs", "3", "--new-tokens", "6", "--prompt-len",
            "24"]
    seen = {}
    iterate = RD.DynamicGenerator.iterate

    def counted(self):
        results = iterate(self)
        for r in results:
            if r.get("stage") == "streaming" and r.get("eos"):
                seen[r["identifier"]] = r["new_tokens"]
        return results

    monkeypatch.setattr(RD.DynamicGenerator, "iterate", counted)
    want = json.loads(run_ref("tools/bench_serving.py", argv,
                              monkeypatch).strip().splitlines()[-1])
    got, text = run_port("bench_serving", argv, monkeypatch)
    assert got["job_tokens"] == seen == {0: 6, 1: 6, 2: 6}
    assert json.loads(text.strip()) == {k: v for k, v in got.items()
                                        if k != "job_tokens"}
    for k in ("jobs", "new_tokens", "prompt_len", "prefill_tokens",
              "cache_kind", "metric", "unit"):
        assert got[k] == want[k], k
    assert got["value"] > 0 and got["ttft_p50_ms"] > 0


def test_decomp_flagship_components_match_reference(monkeypatch):
    import exllamav2_tpu.utils.testing as RT
    import exllamav2_tpu_torch.utils.testing as PT
    small = dict(vocab=512, hidden=256, layers=2, heads=4, kv_heads=4,
                 inter=512)
    for mod in (RT, PT):
        real = mod.random_model_weights
        monkeypatch.setattr(mod, "random_model_weights",
                            lambda real=real, **kw: real(**{**kw, **small}))
    want = run_ref("tools/decomp_flagship.py", [], monkeypatch)
    got, text = run_port("decomp_flagship", [], monkeypatch)

    def mib(out):
        return [(l.split()[0], l.split()[3]) for l in out.splitlines()
                if " MiB " in l]

    assert mib(text) == mib(want) and len(mib(text)) == 5
    assert list(got["components"]) == ["qkv_merged", "o_proj",
                                       "gate_up_merged", "down_proj"]
    gib = [l.split()[2] for l in want.splitlines()
           if l.startswith("weight stream")]
    assert f"{got['weight_stream_bytes'] / 2 ** 30:.2f}" == gib[0]
    assert got["bound_ms"] is None and np.isfinite(got["step_ms"])
