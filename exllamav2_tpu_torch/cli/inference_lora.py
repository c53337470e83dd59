"""LoRA adapter example (twin of the reference's examples/
inference_lora.py).

    python -m exllamav2_tpu_torch.cli.inference_lora -m <model_dir>
        --lora_dir <peft adapter dir>
"""

import argparse


def main(argv=None) -> str:
    """-> the prompt and its completion through the adapted model."""
    from exllamav2_tpu_torch.model_init import add_args, init
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.lora import Lora, apply_lora
    ap = argparse.ArgumentParser()
    add_args(ap)
    ap.add_argument("--lora_dir", required=True,
                    help="PEFT adapter directory (adapter_config.json)")
    args = ap.parse_args(argv)

    model, tokenizer, generator = init(args)
    lora = Lora(args.lora_dir)
    model.weights = apply_lora(model.weights, lora)

    out = generator.generate("Our story begins in the Scottish town of",
                             max_new_tokens=120,
                             settings=Settings(temperature=0.8),
                             completion_only=False)
    print(out)
    return out


if __name__ == "__main__":
    main()
