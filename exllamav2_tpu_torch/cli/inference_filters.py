"""Constrained generation with filters (twin of the reference's examples/
inference_filters.py).

    python -m exllamav2_tpu_torch.cli.inference_filters -m <model_dir>
"""

import argparse


def main(argv=None) -> str:
    """-> the prompt and the constrained answer."""
    from exllamav2_tpu_torch import model_init
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.filters.select import SelectFilter
    from exllamav2_tpu_torch.generator.sampler import Settings
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    args = ap.parse_args(argv)

    model, tokenizer, generator = model_init.init(args)

    prompt = "Is the sky blue? Answer:"
    job = generator.enqueue(DynamicJob(
        tokenizer.encode(prompt), max_new_tokens=10,
        settings=Settings.greedy(),
        filters=[SelectFilter(tokenizer, [" yes", " no", " maybe"])]))
    while job.status != "done":
        generator.iterate()
    print(prompt + job.emitted_text)
    return prompt + job.emitted_text


if __name__ == "__main__":
    main()
