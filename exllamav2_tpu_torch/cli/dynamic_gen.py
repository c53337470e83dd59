"""Continuous-batching stress demo (twin of the reference's examples/
dynamic_gen.py): queue jobs of different lengths, stream results as they
arrive, and show prompt-page reuse and per-job metrics.

    python -m exllamav2_tpu_torch.cli.dynamic_gen -m <model_dir> [-n jobs]
"""

import argparse
import time


def main(argv=None) -> dict:
    """-> {job identifier: its streamed text}."""
    from exllamav2_tpu_torch import model_init
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    ap.add_argument("-n", type=int, default=16, help="number of jobs")
    args = ap.parse_args(argv)

    model, tokenizer, generator = model_init.init(args, max_batch_size=16)

    # a shared prefix: later jobs reuse the cached pages
    shared = "You are a helpful assistant. Answer briefly.\n\n"
    jobs = []
    for i in range(args.n):
        prompt = shared + f"Q{i}: count from {i} to {i + 4}.\nA:"
        job = DynamicJob(tokenizer.encode(prompt, add_bos=True),
                         max_new_tokens=16 + 8 * (i % 4),
                         settings=Settings.greedy(), identifier=i)
        jobs.append(job)
        generator.enqueue(job)

    texts = {i: "" for i in range(args.n)}
    done = 0
    t0 = time.perf_counter()
    while done < args.n:
        for r in generator.iterate():
            ident = r.get("identifier")
            if r["stage"] == "streaming":
                texts[ident] += r.get("text", "")
                if r["eos"]:
                    done += 1
                    m = r.get("new_tokens", 0)
                    cached = r.get("cached_tokens", 0)
                    print(f" -- job {ident}: {m} new tokens, "
                          f"{cached} cached (dedup)")
    dt = time.perf_counter() - t0

    total = sum(len(tokenizer.encode(t)) for t in texts.values())
    print(f"\n ** {args.n} jobs in {dt:.1f}s, ~{total / dt:.1f} t/s "
          f"aggregate")
    for i in range(min(3, args.n)):
        print(f"\n[job {i}] {texts[i]!r}")
    return texts


if __name__ == "__main__":
    main()
