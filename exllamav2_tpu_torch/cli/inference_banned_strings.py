"""Banned strings and stop conditions (twin of the reference's examples/
inference_banned_strings.py).

    python -m exllamav2_tpu_torch.cli.inference_banned_strings -m <model_dir>
"""

import argparse


def main(argv=None) -> str:
    """-> the streamed text."""
    from exllamav2_tpu_torch.model_init import add_args, init
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings
    ap = argparse.ArgumentParser()
    add_args(ap)
    args = ap.parse_args(argv)

    model, tokenizer, generator = init(args)
    job = DynamicJob(
        tokenizer.encode("Here is a story about dragons:"),
        max_new_tokens=200,
        settings=Settings(temperature=0.8),
        banned_strings=["however", "as an ai"],
        stop_conditions=["\n\n"])
    generator.enqueue(job)
    text = ""
    while job.status != "done":
        for r in generator.iterate():
            if r["stage"] == "streaming":
                text += r.get("text", "")
                print(r.get("text", ""), end="", flush=True)
    print()
    return text


if __name__ == "__main__":
    main()
