"""One world of ranks, each its own process (parallel/launch.py,
parallel/sharding.make_multihost_mesh, cli/tp_worker.py), port against
reference.

Mirrors the reference's tests/test_multihost.py (two jax.distributed
processes, marked slow there): two gloo CPU ranks of cli/tp_worker.py on
the reference worker's geometry (random weights from one seed, built alike
on every rank) serve in lockstep, in the fused mode and in the fallback (a
single KV head: attention whole on every rank); both ranks print the same
token ids and the same logits bytes, and the tokens equal the port's
one-process run. On a checkpoint both packages load, the ranks' tokens are
the JAX package's greedy choices. The launcher's deadline and its
kill-on-failure hold every multi-process test to a bound, and the CLI twins
inference_tp / inference_dp run.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.parallel import sharding as S
from exllamav2_tpu_torch.parallel.launch import RankFailed, launch
from exllamav2_tpu_torch.tokenizer import ByteTokenizer
from exllamav2_tpu_torch.utils.testing import (
    make_tiny_llama, random_model_weights)

from test_torch_sharding import REPO, _agree, _ref, _steps

ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that this process leaves the
    cores to the ranks beside it and to other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranks(*args, n=2):
    outs = launch(["-m", *args], n, timeout=300, env=ENV, cwd=REPO)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def _one_process(mode):
    """The worker's two jobs on one process, no mesh."""
    w, st = random_model_weights(
        vocab=512, hidden=256, layers=2, heads=8,
        kv_heads=2 if mode == "fused" else 1, inter=512, max_seq=256,
        bits=4, seed=7, device="cpu")
    model, tok = Model(w, st), ByteTokenizer(512)
    out = []
    for prompt, pages, n in (("multi host hello", 16, 8), ("abc", 4, 4)):
        gen = DynamicGenerator(model, PagedKVCache.alloc(
            st.num_layers, pages, st.num_kv_heads, st.head_dim,
            page_size=16, device="cpu"), tok)
        job = gen.enqueue(DynamicJob(np.asarray(tok.encode(prompt),
                                                np.int32),
                                     max_new_tokens=n,
                                     settings=Settings.greedy()))
        while job.status != "done":
            gen.iterate()
        out.append(job.sequence[job.prompt_len:].tolist())
    return out


@pytest.mark.parametrize("mode", ["fused", "fallback"])
def test_two_process_serving_agrees(mode):
    """Reference test_two_process_fused_serving_agrees and
    test_two_process_gspmd_serving_agrees."""
    a, b = _ranks("exllamav2_tpu_torch.cli.tp_worker", "--device", "cpu",
                  "--mode", mode)
    assert (a["rank"], b["rank"], a["tp"]) == (0, 1, 2)
    assert a["fused"] == (mode == "fused")
    for key in ("tokens", "tokens2", "text", "text2", "sha1"):
        assert a[key] == b[key], key
    assert [a["tokens"], a["tokens2"]] == _one_process(mode)


def test_tp_worker_on_a_checkpoint_matches_reference(tmp_path):
    d = make_tiny_llama(str(tmp_path / "llama"), quant="exl2", seed=5,
                        vocab=384, heads=8, kv_heads=4, max_pos=2048,
                        head_scale=6.0)
    a, b = _ranks("exllamav2_tpu_torch.cli.tp_worker", "--device", "cpu",
                  "-m", d)
    assert a["tokens"] == b["tokens"] and a["sha1"] == b["sha1"]
    assert a["fused"]
    rm = _ref(str(tmp_path), "llama")
    for prompt, toks in (("multi host hello", a["tokens"]),
                         ("abc", a["tokens2"])):
        _agree(toks, _steps(rm, ByteTokenizer(384).encode(prompt), toks))


def test_cli_twins_serve(tmp_path):
    """inference_tp on two ranks (both print the same greedy text) and
    inference_dp with two replicas on one device."""
    d = make_tiny_llama(str(tmp_path / "llama"), quant="exl2", seed=5,
                        vocab=384, heads=8, kv_heads=4, max_pos=2048)
    outs = launch(["-m", "exllamav2_tpu_torch.cli.inference_tp", "-m", d,
                   "--device", "cpu", "--greedy", "--tokens", "6"], 2,
                  timeout=300, env=ENV, cwd=REPO)
    assert outs[0] == outs[1] and outs[0].startswith("TP=2 fused=True")
    from exllamav2_tpu_torch.cli import inference_dp
    texts = inference_dp.main(["-m", d, "--device", "cpu", "-dp", "2",
                               "--greedy", "--tokens", "4"])
    assert len(texts) == 4 and all(isinstance(t, str) for t in texts)


def test_a_failed_rank_stops_the_world():
    """A rank that raises ends the launch at once, the rank waiting beside
    it killed; a world past its deadline is killed too."""
    code = ("import os, sys, time; r = int(os.environ['RANK']); "
            "time.sleep(60) if r == 0 else sys.exit('rank 1 failed')")
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="rank 1 exited"):
        launch(["-c", code], 2, timeout=60)
    with pytest.raises(RankFailed, match="deadline"):
        launch(["-c", "import time; time.sleep(60)"], 2, timeout=2)
    assert time.monotonic() - t0 < 30


def test_no_world_and_no_fallback(monkeypatch):
    """Outside a world the mesh names torchrun; NCCL on the CPU is an
    error, never a quiet change of backend."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        S.make_multihost_mesh(device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        S.make_mesh(2, device="cpu", backend="nccl")
    out = subprocess.run(
        [sys.executable, "-m", "exllamav2_tpu_torch.cli.inference_tp", "-m",
         "unused", "--device", "cpu"], env={k: v for k, v in ENV.items()
                                            if k not in ("RANK",
                                                         "WORLD_SIZE")},
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "torchrun" in out.stderr
