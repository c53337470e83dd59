"""Prompt-cache / dedup demo (twin of the reference's examples/
inference_dedup.py): jobs sharing a long common prefix reuse the same
cache pages.

    python -m exllamav2_tpu_torch.cli.inference_dedup -m <model_dir>
"""

import argparse


def main(argv=None) -> list[tuple[str, int]]:
    """-> (answer, reused prompt tokens) a question."""
    from exllamav2_tpu_torch import model_init
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    args = ap.parse_args(argv)

    model, tokenizer, generator = model_init.init(args, max_batch_size=8)

    common = "The following is a long shared context. " * 80
    questions = ["What color is the sky?", "Name three fruits.",
                 "What is 2+2?", "Describe water."]

    jobs = []
    for q in questions:
        jobs.append(generator.enqueue(DynamicJob(
            tokenizer.encode(common + "\nQ: " + q + "\nA:"),
            max_new_tokens=32, settings=Settings.greedy())))

    while any(j.status != "done" for j in jobs):
        generator.iterate()

    for q, j in zip(questions, jobs):
        print(f"Q: {q}\nA: {j.emitted_text.strip()}")
        print(f"   (reused {j.reused_tokens} cached prompt tokens)\n")
    return [(j.emitted_text, int(j.reused_tokens)) for j in jobs]


if __name__ == "__main__":
    main()
