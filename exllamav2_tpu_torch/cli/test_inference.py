"""Inference CLI: perplexity eval, prompt generation, speed benchmark (twin
of the reference's root test_inference.py).

    python -m exllamav2_tpu_torch.cli.test_inference -m <model_dir> ...
  -ed <file|'random'>   perplexity eval (with any cache mode)
  -p  <prompt>          generate from a prompt
  -ps                   decode speed benchmark
  -rr <fraction>        rank-reduce the dense MLP weights first
Cache modes: -cq4 / -cq6 / -cq8 / -c8 (FP8) / default BF16; --device cpu
runs on the CPU.
"""

import argparse
import time

import numpy as np

from exllamav2_tpu_torch import model_init


def main(argv=None) -> dict:
    """-> {"perplexity", "text", "prompt_tokens_per_s",
    "speed_tokens_per_s"}, each present when its mode ran."""
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    ap.add_argument("-ed", "--eval_dataset", default=None,
                    help="text file for ppl eval, or 'random'")
    ap.add_argument("-er", "--eval_rows", type=int, default=8)
    ap.add_argument("-el", "--eval_length", type=int, default=512)
    ap.add_argument("-p", "--prompt", default=None)
    ap.add_argument("-t", "--tokens", type=int, default=128)
    ap.add_argument("-ps", "--prompt_speed", action="store_true")
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("-rr", "--rank_reduce", type=float, default=0.0,
                    help="keep this fraction of singular directions in "
                         "dense MLP weights (reference -rr)")
    args = ap.parse_args(argv)
    out = {}

    model, tokenizer, generator = model_init.init(args)
    if args.rank_reduce:
        # the generator serves its own copy of the model (prescaled): rank-
        # reduce that one and score it too, so that -p and -ps see the
        # reduction as -ed does (the reference reduces only the caller's
        # model, which its generator does not read)
        from exllamav2_tpu_torch.utils.rank_reduce import rank_reduce_model
        model = generator.model
        model.weights = rank_reduce_model(model.weights, args.rank_reduce)
        print(f" -- rank-reduced dense MLPs to {args.rank_reduce:.2f}")
    kind = model_init.cache_kind(args)
    print(f" -- model: {args.model_dir} (quant={model.config.quant_method})")
    print(f" -- cache: {kind}")

    if args.eval_dataset:
        from exllamav2_tpu_torch.evals import perplexity
        r, t = args.eval_rows, args.eval_length
        if args.eval_dataset == "random":
            rng = np.random.default_rng(0)
            rows = rng.integers(0, model.static.vocab_size,
                                (r, t)).astype(np.int32)
        else:
            with open(args.eval_dataset) as f:
                ids = tokenizer.encode(f.read())
            rows = ids[:r * t].reshape(-1, t)
        ppl = perplexity(model, rows, cache_kind=kind,
                         progress=lambda a, b: print(f"  {a}/{b}", end="\r"))
        print(f" -- perplexity: {ppl:.4f}")
        out["perplexity"] = ppl

    from exllamav2_tpu_torch.generator.sampler import Settings
    if args.prompt:
        s = Settings.greedy() if args.greedy else Settings()
        t0 = time.perf_counter()
        text = generator.generate(args.prompt, max_new_tokens=args.tokens,
                                  settings=s)
        dt = time.perf_counter() - t0
        print(text)
        print(f" -- {args.tokens} tokens in {dt:.2f}s, "
              f"{args.tokens / dt:.2f} t/s")
        out["text"] = text
        out["prompt_tokens_per_s"] = args.tokens / dt

    if args.prompt_speed:
        prompt_ids = np.ones((1, 128), np.int32)
        # warmup
        generator.generate(prompt_ids[0], max_new_tokens=8,
                           settings=Settings.greedy())
        t0 = time.perf_counter()
        n = 128
        generator.generate(prompt_ids[0], max_new_tokens=n,
                           settings=Settings.greedy())
        dt = time.perf_counter() - t0
        print(f" -- speed: {n / dt:.2f} t/s (single sequence, greedy)")
        out["speed_tokens_per_s"] = n / dt
    return out


if __name__ == "__main__":
    main()
