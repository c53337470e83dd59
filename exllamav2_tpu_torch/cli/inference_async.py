"""Async generator demo (twin of the reference's examples/
inference_async.py): drive several jobs concurrently with asyncio and
stream each one.

    python -m exllamav2_tpu_torch.cli.inference_async -m <model_dir>
"""

import argparse
import asyncio


async def run_one(agen, tokenizer, prompt, tag):
    from exllamav2_tpu_torch.generator.dynamic_async import DynamicJobAsync
    from exllamav2_tpu_torch.generator.sampler import Settings
    job = DynamicJobAsync(agen, tokenizer.encode(prompt, add_bos=True),
                          max_new_tokens=32, settings=Settings.greedy())
    await agen.enqueue(job)
    text = ""
    async for r in job:
        text += r.get("text", "")
    print(f"[{tag}] {prompt!r} -> {text!r}")
    return text


async def amain(args) -> list[str]:
    from exllamav2_tpu_torch import model_init
    from exllamav2_tpu_torch.generator.dynamic_async import (
        DynamicGeneratorAsync)
    model, tokenizer, generator = model_init.init(args, max_batch_size=4)
    agen = DynamicGeneratorAsync(generator)
    prompts = ["Once upon a time", "The capital of France is",
               "def fibonacci(n):", "Roses are red"]
    texts = await asyncio.gather(*(run_one(agen, tokenizer, p, i)
                                   for i, p in enumerate(prompts)))
    await agen.close()
    return list(texts)


def main(argv=None) -> list[str]:
    """-> the four jobs' texts."""
    from exllamav2_tpu_torch import model_init
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    return asyncio.run(amain(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
