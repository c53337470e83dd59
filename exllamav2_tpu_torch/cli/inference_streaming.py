"""The streaming-generator API (twin of the reference's examples/
inference_streaming.py).

The reference's example starts its stream with begin_stream_ex's default
max_new_tokens (10**9), which the generator refuses for any max_seq_len
("job exceeds max_seq_len"); the twin asks for the 200 tokens its loop
reads.

    python -m exllamav2_tpu_torch.cli.inference_streaming -m <model_dir>
"""

import argparse


def main(argv=None) -> str:
    """-> the streamed text."""
    from exllamav2_tpu_torch.model_init import add_args, init
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.generator.streaming import StreamingGenerator
    ap = argparse.ArgumentParser()
    add_args(ap)
    args = ap.parse_args(argv)

    model, tokenizer, generator = init(args)
    stream = StreamingGenerator(model, generator.cache, tokenizer)
    stream.begin_stream_ex(tokenizer.encode("The old lighthouse keeper"),
                           Settings(temperature=0.8), max_new_tokens=200)
    text = ""
    for _ in range(200):
        chunk, eos, _ = stream.stream()
        text += chunk
        print(chunk, end="", flush=True)
        if eos:
            break
    print()
    return text


if __name__ == "__main__":
    main()
