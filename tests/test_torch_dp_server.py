"""Data-parallel serving (parallel/dp_server.py), port against reference.

Mirrors the reference's tests/test_dp_server.py (marked slow there): four
gloo CPU ranks (parallel/launch.py, 300 s deadline, every rank killed when
one fails) run DataParallelGenerator(dp=2, tp=2) through
tests/torch_tp_cases.py: every rank gets every text, the texts equal the
port's one-process generator's on the same checkpoint (the one whose tokens
tests/test_torch_sharding.py holds to the JAX package's), and both replicas
serve. In process: dp = 2 replicas on one device (tp = 1),
the same texts, both replicas serving.
"""

import os

import numpy as np
import pytest
import torch

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.parallel.dp_server import DataParallelGenerator
from exllamav2_tpu_torch.parallel.launch import launch
from exllamav2_tpu_torch.utils.testing import make_tiny_llama

import torch_tp_cases as C
from test_torch_sharding import REPO


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that this process leaves the
    cores to the ranks beside it and to other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dp"))
    make_tiny_llama(os.path.join(work, "llama"), quant="exl2", seed=5,
                    vocab=384, heads=8, kv_heads=4, max_pos=2048,
                    head_scale=6.0)
    return work


def _plain(work):
    """The one-process generator's texts of the prompts."""
    model = Model.from_dir(os.path.join(work, "llama"), device="cpu")
    st = model.static
    gen = DynamicGenerator(model, PagedKVCache.alloc(
        st.num_layers, 16, st.num_kv_heads, st.head_dim, device="cpu"),
        C.TOK, max_batch_size=4)
    texts = []
    for p in C.DP_PROMPTS:
        job = gen.enqueue(DynamicJob(C.TOK.encode(p), max_new_tokens=C.NEW,
                                     settings=Settings.greedy()))
        while job.status != "done":
            gen.iterate()
        texts.append(job.emitted_text)
    return texts


def test_dp2_tp2_over_four_ranks(llama):
    """Reference test_dp_replicated_fused_serving: each replica a fused
    tp = 2 shard, the dispatcher in lockstep on every rank."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    launch([os.path.join(REPO, "tests", "torch_tp_cases.py"), llama], 4,
           timeout=300, env=env, cwd=REPO)
    outs = [torch.load(os.path.join(llama, f"dp_server.{r}.pt"),
                       weights_only=False) for r in range(4)]
    texts = _plain(llama)
    for o in outs:
        assert o["texts"] == texts and o["fused"] and o["finished"]
        assert o["served"] == [2, 2]         # both replicas served
    assert sorted(o["dp_rank"] for o in outs) == [0, 0, 1, 1]


def test_dp2_replicas_in_one_process(llama):
    """tp = 1: two replicas on one device (as on one card), step graphs
    and all; the same texts, and both replicas run jobs."""
    model = Model.from_dir(os.path.join(llama, "llama"), device="cpu")
    gen = DataParallelGenerator(model, C.TOK, num_pages=16, dp=2,
                                devices=["cpu", "cpu"], max_batch_size=4)
    assert len(gen.replicas) == 2 and not gen.tp_fused
    texts = gen.generate(C.DP_PROMPTS, max_new_tokens=C.NEW,
                         settings=Settings.greedy())
    assert texts == _plain(llama)
    assert gen.served == [2, 2]
    # enqueue / iterate: the lighter replica takes each job
    jobs = [gen.enqueue(DynamicJob(np.asarray(C.TOK.encode(p), np.int32),
                                   max_new_tokens=2,
                                   settings=Settings.greedy()))
            for p in C.DP_PROMPTS[:3]]
    assert [len(r.pending) for r in gen.replicas] == [2, 1]
    while any(j.status != "done" for j in jobs):
        gen.iterate()
