"""Constrained output through a grammar-engine filter (twin of the
reference's examples/inference_grammar.py).

Uses lm-format-enforcer when installed; otherwise the built-in
CallableFilter with a digits-only grammar, so the example runs everywhere.

    python -m exllamav2_tpu_torch.cli.inference_grammar -m <model_dir>
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

    try:
        from lmformatenforcer import JsonSchemaParser
        from exllamav2_tpu_torch.generator.filters.external import \
            LMFormatEnforcerFilter
        schema = {"type": "object",
                  "properties": {"name": {"type": "string"},
                                 "age": {"type": "integer"}},
                  "required": ["name", "age"]}
        filt = LMFormatEnforcerFilter(tokenizer, JsonSchemaParser(schema))
        print("using lm-format-enforcer")
    except ImportError:
        from exllamav2_tpu_torch.generator.filters.external import \
            CallableFilter
        digits = set()
        for t in range(tokenizer.vocab_size):
            p = tokenizer.id_to_piece(t)
            if p and all(c.isdigit() for c in p):
                digits.add(t)

        filt = CallableFilter(tokenizer, lambda fed: digits)
        print("lm-format-enforcer not installed; digits-only fallback")

    job = DynamicJob(tokenizer.encode("The answer as JSON: "),
                     max_new_tokens=60, settings=Settings.greedy(),
                     filters=[filt])
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
