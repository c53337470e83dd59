"""One rank of a tensor-parallel world, for checking that ranks agree (twin
of the reference's tools/multihost_worker.py).

Every rank builds the same model (a checkpoint with -m, else random
weights from --seed, the reference worker's geometry), shards it over the
world's mesh (parallel/sharding.make_multihost_mesh), serves two greedy
jobs in lockstep and prints one JSON line: their token ids and texts, and
a checksum of one paged forward's logits (their sum, and a hash of their
bytes for bitwise agreement across ranks).

    python -m exllamav2_tpu_torch.parallel.launch -n 2 -- \\
        -m exllamav2_tpu_torch.cli.tp_worker --device cpu
    torchrun --nproc-per-node 2 -m exllamav2_tpu_torch.cli.tp_worker

--mode fused takes a model whose heads split over the ranks (the fused
path); --mode fallback one with a single KV head, whose attention (and its
cache) stays whole on every rank while the linears split.
"""

import argparse
import hashlib
import json


def main(argv=None) -> dict:
    """-> the dict printed as the JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model_dir", default=None)
    ap.add_argument("--mode", choices=("fused", "fallback"), default="fused")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import (
        DynamicGenerator, DynamicJob)
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.models.forward import model_forward_paged
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.parallel.sharding import make_multihost_mesh
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer, load_tokenizer
    from exllamav2_tpu_torch.utils.testing import random_model_weights

    mesh = make_multihost_mesh(dp=1, device=args.device,
                               backend=args.backend)
    if args.model_dir:
        model = Model.from_dir(args.model_dir, device=mesh.device)
        tok = load_tokenizer(args.model_dir)
    else:
        w, st = random_model_weights(
            vocab=512, hidden=256, layers=2, heads=8,
            kv_heads=mesh.tp if args.mode == "fused" else 1, inter=512,
            max_seq=256, bits=4, seed=args.seed, device=mesh.device)
        model = Model(w, st)
        tok = ByteTokenizer(512)

    def gen(pages):
        st = model.static
        return DynamicGenerator(model, PagedKVCache.alloc(
            st.num_layers, pages, st.num_kv_heads, st.head_dim, "bf16",
            page_size=16, device=mesh.device), tok, mesh=mesh)

    def run(g, prompt, n):
        job = g.enqueue(DynamicJob(np.asarray(tok.encode(prompt), np.int32),
                                   max_new_tokens=n,
                                   settings=Settings.greedy()))
        while job.status != "done":
            g.iterate()
        return job.sequence[job.prompt_len:].tolist(), job.emitted_text

    g1 = gen(16)
    tokens, text = run(g1, "multi host hello", 8)
    g2 = gen(4)
    tokens2, text2 = run(g2, "abc", 4)
    # one paged forward of the served (sharded) model
    ids = np.asarray(tok.encode("checksum row"), np.int32).reshape(1, -1)
    cache = g2.cache
    pages = -(-ids.shape[1] // cache.page_size)
    bt = torch.arange(1, pages + 1, dtype=torch.int32,
                      device=mesh.device)[None]
    logits, _ = model_forward_paged(
        g2.model.weights, g2.model.static,
        torch.from_numpy(ids).to(mesh.device), cache, bt,
        torch.zeros((1,), dtype=torch.int32, device=mesh.device),
        last_token_only=True)
    lg = logits.float().cpu().numpy()
    out = {"rank": mesh.rank, "tp": mesh.tp, "mode": args.mode,
           "fused": g1._tp_fused, "tokens": tokens, "tokens2": tokens2,
           "text": text, "text2": text2,
           "checksum": float(lg.sum()),
           "sha1": hashlib.sha1(lg.tobytes()).hexdigest()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
