"""Classifier-free guidance example (twin of the reference's examples/
inference_cfg.py).

    python -m exllamav2_tpu_torch.cli.inference_cfg -m <model_dir>
        [--cfg-scale 1.5]
"""

import argparse


def main(argv=None) -> str:
    """-> the positive prompt and its guided completion."""
    from exllamav2_tpu_torch.model_init import add_args, init
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings
    ap = argparse.ArgumentParser()
    add_args(ap)
    ap.add_argument("--cfg-scale", type=float, default=1.5)
    args = ap.parse_args(argv)

    model, tokenizer, generator = init(args)

    positive = "You are an enthusiastic pirate. User: Tell me about maps. You:"
    negative = "You are a bored clerk. User: Tell me about maps. You:"

    sett = Settings(temperature=0.8, cfg_scale=args.cfg_scale)
    job = DynamicJob(tokenizer.encode(positive), max_new_tokens=120,
                     settings=sett,
                     negative_prompt_ids=tokenizer.encode(negative))
    generator.enqueue(job)
    text = ""
    while job.status != "done":
        for r in generator.iterate():
            if r["stage"] == "streaming":
                text += r.get("text", "")
    print(positive + text)
    return positive + text


if __name__ == "__main__":
    main()
