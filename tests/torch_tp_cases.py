"""One rank of the tensor-parallel test world (tests/test_torch_sharding.py).

Run by parallel/launch.py as two gloo CPU ranks (four for
tests/test_torch_dp_server.py):

    python tests/torch_tp_cases.py <workdir> [case ...]

Each rank builds every case's model from the checkpoints the test wrote
into <workdir> (or the port model it saved there as <name>.pt), serves it
on a tp = 2 mesh and saves what it saw as <workdir>/<case>.<rank>.pt: greedy
tokens and their per-step logits, one paged forward's logits, and the
generator's `_tp_fused`. The test compares the ranks with each other and
with the JAX package on the same checkpoints. Imports torch and the port
only.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from exllamav2_tpu_torch.cache_paged import PagedKVCache  # noqa: E402
from exllamav2_tpu_torch.generator.dynamic import (  # noqa: E402
    DynamicGenerator, DynamicJob)
from exllamav2_tpu_torch.generator.sampler import Settings  # noqa: E402
from exllamav2_tpu_torch.models.forward import (  # noqa: E402
    model_forward_paged)
from exllamav2_tpu_torch.models.model import Model  # noqa: E402
from exllamav2_tpu_torch.parallel import sharding as S  # noqa: E402
from exllamav2_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402

TOK = ByteTokenizer(384)
PROMPT = "hello world"
NEW = 6
FWD_IDS = np.array([[5, 9, 100, 7, 30, 40, 50, 60]], np.int32)
# the capacity dispatch's prefill: 128 rows of 8 experts top 2
DISPATCH_IDS = np.random.default_rng(0).integers(3, 380, (1, 128)).astype(
    np.int32)


def _model(work, name):
    pt = os.path.join(work, f"{name}.pt")
    if os.path.exists(pt):
        return Model(*torch.load(pt, weights_only=False))
    return Model.from_dir(os.path.join(work, name), device="cpu")


def _cache(model, kind="bf16", pages=16):
    st = model.static
    return PagedKVCache.alloc(st.num_layers, pages, st.num_kv_heads,
                              st.head_dim, kind, device="cpu")


def greedy_run(gen, ids, n=NEW, embeddings=None, **kw):
    """One greedy job -> (tokens, per-step logits [vocab] f64)."""
    job = gen.enqueue(DynamicJob(np.asarray(ids, np.int32),
                                 max_new_tokens=n, return_logits=True,
                                 settings=kw.pop("settings", None)
                                 or Settings.greedy(),
                                 embeddings=embeddings, **kw))
    logits = []
    while job.status != "done":
        for r in gen.iterate():
            if r.get("logits") is not None and r["job"] is job:
                logits.append(np.asarray(r["logits"], np.float64).ravel())
    return job.sequence[job.prompt_len:].tolist(), logits


def paged_logits(gen, ids):
    """One paged prefill forward of the generator's (sharded) model over a
    fresh cache of its kind -> last-token logits [vocab] f32."""
    model, mesh = gen.model, gen.mesh
    full = PagedKVCache.alloc(model.static.num_layers, 4,
                              gen.cache.kv_heads * (
                                  mesh.tp if S.heads_split(model.weights)
                                  else 1),
                              model.static.head_dim, gen.cache.kind,
                              device="cpu")
    cache = (S.shard_paged_cache(full, mesh) if S.heads_split(model.weights)
             else full)
    pages = -(-ids.shape[1] // cache.page_size)
    bt = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    logits, _ = model_forward_paged(
        model.weights, model.static, torch.from_numpy(ids), cache, bt,
        torch.zeros((1,), dtype=torch.int32), last_token_only=True)
    return logits[0, -1].numpy()


def _serve(work, mesh, name, kind="bf16", fwd=None, **kw):
    model = _model(work, name)
    gen = DynamicGenerator(model, _cache(model, kind), TOK, mesh=mesh,
                           max_batch_size=4, **kw)
    toks, steps = greedy_run(gen, TOK.encode(PROMPT))
    out = {"tokens": toks, "steps": steps, "fused": gen._tp_fused}
    if fwd is not None:
        out["logits"] = paged_logits(gen, fwd)
    return out


def case_serve(work, mesh):
    return _serve(work, mesh, "llama", fwd=FWD_IDS)


def case_act_order(work, mesh):
    return _serve(work, mesh, "act_order", fwd=FWD_IDS)


def case_q4_cache(work, mesh):
    return _serve(work, mesh, "llama", kind="q4")


def case_q8_cache(work, mesh):
    return _serve(work, mesh, "llama", kind="q8")


def case_fallback_heads(work, mesh):
    return _serve(work, mesh, "mqa", fwd=FWD_IDS)


def linear_steps(model):
    """Model.forward over the linear cache: a 2 x 8 prefill, then two
    one-token steps of the argmax -> the three last-token logits."""
    ids = np.repeat(FWD_IDS, 2, axis=0)
    ids[1] = ids[1][::-1]
    cache = model.new_cache(2, 64)
    out = []
    for past in (0, 8, 9):
        lg, cache = model.forward(ids, cache, past, last_token_only=True)
        out.append(lg[:, -1].numpy())
        ids = out[-1].argmax(-1).astype(np.int32)[:, None]
    return np.stack(out)


def case_linear(work, mesh):
    """The linear-cache forward of the rank's shard (its cache holds the
    rank's KV heads): prefill and decode steps."""
    model = _model(work, "llama")
    w, st = S.shard_model(model.weights, model.static, mesh)
    return {"logits": linear_steps(Model(w, st, graphs=False))}


def case_moe_ep(work, mesh):
    out = _serve(work, mesh, "mixtral", fwd=FWD_IDS)
    model = _model(work, "mixtral")
    w, _ = S.shard_model(model.weights, model.static, mesh)
    out["ep"] = type(w.layers[0].mlp).__name__
    return out


def case_moe_ep_dispatch(work, mesh):
    model = _model(work, "mixtral8")
    gen = DynamicGenerator(model, _cache(model), TOK, mesh=mesh)
    return {"logits": paged_logits(gen, DISPATCH_IDS),
            "fused": gen._tp_fused}


def case_moe_quantized_router(work, mesh):
    return _serve(work, mesh, "qrouter")


def case_spec_draft(work, mesh):
    model = _model(work, "llama")
    gen = DynamicGenerator(model, _cache(model), TOK, mesh=mesh,
                           draft_model=model, draft_cache=_cache(model))
    toks, _ = greedy_run(gen, TOK.encode(PROMPT), 8)
    return {"tokens": toks, "fused": gen._tp_fused,
            "draft_whole": gen.draft_model is model}


def case_spec_ngram(work, mesh):
    model = _model(work, "llama")
    gen = DynamicGenerator(model, _cache(model), TOK, mesh=mesh,
                           use_ngram_draft=True)
    toks, _ = greedy_run(gen, TOK.encode("abcabcabcabc"), 8)
    return {"tokens": toks, "fused": gen._tp_fused}


def case_cfg(work, mesh):
    model = _model(work, "llama")
    gen = DynamicGenerator(model, _cache(model), TOK, mesh=mesh,
                           max_batch_size=4)
    s = Settings.greedy()
    s.cfg_scale = 1.5
    toks, _ = greedy_run(gen, TOK.encode(PROMPT), settings=s,
                         negative_prompt_ids=TOK.encode("goodbye"))
    return {"tokens": toks, "fused": gen._tp_fused}


def case_lora(work, mesh):
    from exllamav2_tpu_torch.lora import Lora
    model = _model(work, "llama")
    gen = DynamicGenerator(model, _cache(model), TOK, mesh=mesh)
    gen.set_loras([Lora(os.path.join(work, "lora"))])
    toks, steps = greedy_run(gen, TOK.encode(PROMPT))
    gen.set_loras(None)
    plain, _ = greedy_run(gen, TOK.encode(PROMPT))
    return {"tokens": toks, "steps": steps, "plain": plain,
            "fused": gen._tp_fused}


def case_dp2(work, mesh):
    """A (dp = 2, tp = 1) mesh over the two ranks: nothing splits."""
    model = _model(work, "llama")
    dmesh = S.make_mesh(1, dp=2, device="cpu")
    gen = DynamicGenerator(model, _cache(model), TOK, mesh=dmesh)
    toks, _ = greedy_run(gen, TOK.encode(PROMPT))
    return {"tokens": toks, "fused": gen._tp_fused}


def case_model_init(work, mesh):
    import argparse
    from exllamav2_tpu_torch import model_init
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    args = ap.parse_args(["-m", os.path.join(work, "llama"), "-l", "256",
                          "-tp", "2", "--device", "cpu"])
    _, _, gen = model_init.init(args, max_batch_size=2)
    toks, _ = greedy_run(gen, TOK.encode(PROMPT))
    return {"tokens": toks, "fused": gen._tp_fused,
            "tp": gen.mesh.tp if gen.mesh is not None else 1}


def _vlm(work, mesh, kind, text):
    from exllamav2_tpu_torch.vlm import VisionTower
    model = _model(work, kind)
    tower = VisionTower(model.config, device="cpu")
    img = (np.random.default_rng(3).random((16, 16, 3)) * 255).astype(
        np.uint8)
    mme = tower.get_image_embeddings(model, TOK, img, text_alias="<img>")
    gen = DynamicGenerator(model, _cache(model, pages=32), TOK, mesh=mesh)
    ids = gen.encode_with_embeddings(text, [mme])
    toks, steps = greedy_run(gen, ids, embeddings=[mme])
    return {"tokens": toks, "steps": steps, "fused": gen._tp_fused}


def case_pixtral(work, mesh):
    return _vlm(work, mesh, "pixtral", "look <img> here")


def case_qwen2vl(work, mesh):
    return _vlm(work, mesh, "qwen2", "scene <img> is")


DP_PROMPTS = ["hello world", "the quick brown", "abcabc", "numbers 123"]


def dp_server(work, mesh):
    """DataParallelGenerator over the (dp = 2, tp = 2) mesh of four ranks:
    the texts (gathered to every rank), the jobs sent to each replica and
    the jobs this rank's replica finished."""
    from exllamav2_tpu_torch.parallel.dp_server import DataParallelGenerator
    model = _model(work, "llama")
    gen = DataParallelGenerator(model, TOK, num_pages=16, dp=2, tp=2,
                                mesh=mesh)
    texts = gen.generate(DP_PROMPTS, max_new_tokens=NEW,
                         settings=Settings.greedy())
    return {"texts": texts, "fused": gen.tp_fused, "served": gen.served,
            "dp_rank": gen.dp_rank,
            "finished": len(gen.replicas[0].active) == 0}


CASES = {k[5:]: v for k, v in list(globals().items())
         if k.startswith("case_")}


def main():
    """Two ranks: every case (or those named) on a tp = 2 mesh; four ranks:
    dp_server on a dp = 2 x tp = 2 mesh."""
    torch.set_num_threads(1)
    work, names = sys.argv[1], sys.argv[2:] or list(CASES)
    if int(os.environ["WORLD_SIZE"]) == 4:
        mesh = S.make_mesh(2, dp=2, device="cpu", timeout=300)
        runs = {"dp_server": dp_server}
    else:
        mesh = S.make_mesh(2, device="cpu", timeout=300)
        runs = {n: CASES[n] for n in names}
    for name, fn in runs.items():
        torch.save(fn(work, mesh),
                   os.path.join(work, f"{name}.{mesh.rank}.pt"))


if __name__ == "__main__":
    main()
