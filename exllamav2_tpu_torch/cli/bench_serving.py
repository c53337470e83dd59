"""Serving-path benchmark: DynamicGenerator throughput on the card (twin of
the reference's tools/bench_serving.py).

Drives the whole continuous-batching stack (paged KV cache, the step
graphs, sampling on the device, the host scheduler) with N concurrent jobs
on the 7B-geometry random model, and reports aggregate tokens/s and the
jobs' TTFT percentiles from submission, after a warm-up round that
captures every step graph.

    python -m exllamav2_tpu_torch.cli.bench_serving [--jobs 16]
        [--new-tokens 64] [--prompt-len 256] [--cache-kind bf16|q4|q6|q8|fp8]
        [--device cpu]
"""

import argparse
import json
import time

import numpy as np


def main(argv=None) -> dict:
    """-> the printed JSON line's dict, plus "job_tokens" (each job's new
    tokens, by identifier)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--cache-kind", default="bf16")
    ap.add_argument("--pages", type=int, default=0,
                    help="0 = sized to jobs")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--small", action="store_true",
                    help="tiny geometry (smoke test)")
    ap.add_argument("--fmt", default="exl2", choices=("exl2", "gptq"),
                    help="weight format (gptq = gs128)")
    ap.add_argument("--w4a8", action="store_true",
                    help="serve with the W4A8 decode mode (pays at "
                         "gs >= 128)")
    ap.add_argument("--burst", type=int, default=None,
                    help="decode burst width (default: env/8)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.device import resolve_device
    from exllamav2_tpu_torch.generator.dynamic import (DynamicGenerator,
                                                       DynamicJob)
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    from exllamav2_tpu_torch.utils.testing import random_model_weights

    dev = resolve_device(args.device)
    if args.small:
        w, st = random_model_weights(
            vocab=2048, hidden=512, layers=4, heads=8, kv_heads=4,
            inter=1024, max_seq=2048, bits=4, seed=0, fmt=args.fmt,
            device=dev)
    else:
        w, st = random_model_weights(
            vocab=32000, hidden=4096, layers=32, heads=32, kv_heads=32,
            inter=11008, max_seq=2048, bits=4, seed=0, fmt=args.fmt,
            device=dev)
    model = Model(w, st)
    tok = ByteTokenizer(min(st.vocab_size, 384))
    pages = args.pages or (
        args.jobs * (-(-(args.prompt_len + args.new_tokens + 4) // 256))
        + 2)
    cache = PagedKVCache.alloc(st.num_layers, pages, st.num_kv_heads,
                               st.head_dim, args.cache_kind, device=dev)
    gen = DynamicGenerator(model, cache, tok,
                           max_batch_size=args.max_batch,
                           max_chunk_size=512, w4a8=args.w4a8,
                           decode_burst=args.burst)

    def run_once(seed):
        rng = np.random.default_rng(seed)
        jobs = []
        t_submit = time.perf_counter()
        for i in range(args.jobs):
            ids = rng.integers(3, 250, args.prompt_len).astype(np.int32)
            job = DynamicJob(ids, max_new_tokens=args.new_tokens,
                             settings=Settings.greedy(), identifier=i)
            gen.enqueue(job)
            jobs.append(job)
        done = {}
        guard = 0
        while len(done) < args.jobs:
            for r in gen.iterate():
                if r["stage"] == "streaming" and r["eos"]:
                    done[r["identifier"]] = r
            guard += 1
            assert guard < 200000, "generator stuck"
        wall = time.perf_counter() - t_submit
        return jobs, done, wall, t_submit

    run_once(99)                        # warm-up: capture every step graph
    jobs, done, wall, t_submit = run_once(0)

    total_new = sum(r["new_tokens"] for r in done.values())
    ttfts = sorted((j.time_first_token - t_submit) for j in jobs)
    out = {
        "metric": "serving_tokens_per_s",
        "value": round(total_new / wall, 1),
        "unit": "tokens/s",
        "jobs": args.jobs,
        "new_tokens": args.new_tokens,
        "prompt_len": args.prompt_len,
        "cache_kind": args.cache_kind,
        "wall_s": round(wall, 2),
        "ttft_p50_ms": round(ttfts[len(ttfts) // 2] * 1000, 1),
        "ttft_p95_ms": round(ttfts[int(len(ttfts) * 0.95)] * 1000, 1),
        "prefill_tokens": args.jobs * args.prompt_len,
        "device": str(dev),
    }
    print(json.dumps(out))
    out["job_tokens"] = {i: r["new_tokens"] for i, r in done.items()}
    return out


if __name__ == "__main__":
    main()
