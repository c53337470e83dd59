"""Bulk batched inference (twin of the reference's examples/
bulk_inference.py): queue many prompts at once and let continuous batching
fill the device.

    python -m exllamav2_tpu_torch.cli.bulk_inference -m <model_dir> [-n 32]
"""

import argparse
import time


def main(argv=None) -> list[str]:
    """-> the completions, one a prompt."""
    from exllamav2_tpu_torch import model_init
    from exllamav2_tpu_torch.generator.sampler import Settings
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    ap.add_argument("-n", type=int, default=32, help="number of prompts")
    args = ap.parse_args(argv)

    model, tokenizer, generator = model_init.init(args, max_batch_size=32)

    prompts = [f"Question {i}: what comes after {i}? Answer:"
               for i in range(args.n)]
    t0 = time.perf_counter()
    outs = generator.generate(prompts, max_new_tokens=32,
                              settings=Settings.greedy())
    dt = time.perf_counter() - t0
    total = 32 * len(prompts)
    print(f" -- {len(prompts)} prompts, {total} tokens in {dt:.1f}s "
          f"({total / dt:.1f} t/s aggregate)")
    for p, o in list(zip(prompts, outs))[:3]:
        print(f"{p!r} -> {o!r}")
    return outs


if __name__ == "__main__":
    main()
