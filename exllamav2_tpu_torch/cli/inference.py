"""Minimal generation example (twin of the reference's examples/
inference.py).

    python -m exllamav2_tpu_torch.cli.inference -m <model_dir>
"""

import argparse


def main(argv=None) -> str:
    """-> the prompt and its completion."""
    from exllamav2_tpu_torch.model_init import add_args, init
    from exllamav2_tpu_torch.generator.sampler import Settings
    ap = argparse.ArgumentParser()
    add_args(ap)
    args = ap.parse_args(argv)

    model, tokenizer, generator = init(args)

    prompt = "Once upon a time,"
    output = generator.generate(prompt, max_new_tokens=150,
                                settings=Settings(temperature=0.8,
                                                  top_p=0.9),
                                completion_only=False)
    print(output)
    return output


if __name__ == "__main__":
    main()
