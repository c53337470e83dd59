"""The smallest chat loop (twin of the reference's examples/
minimal_chat.py): load, ask, stream, repeat, no prompt formatting.

    python -m exllamav2_tpu_torch.cli.minimal_chat -m <model_dir>
"""

import argparse


def main(argv=None) -> list[str]:
    """-> the replies, one a line read from standard input."""
    from exllamav2_tpu_torch import model_init
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    args = ap.parse_args(argv)
    model, tokenizer, generator = model_init.init(args)
    settings = Settings(temperature=0.8, top_p=0.9)

    replies = []
    while True:
        try:
            q = input("\nYou: ")
        except (KeyboardInterrupt, EOFError):
            break
        job = generator.enqueue(DynamicJob(
            tokenizer.encode(f"User: {q}\nAssistant:", add_bos=True),
            max_new_tokens=256, settings=settings,
            stop_conditions=["User:"]))
        print("Bot:", end="", flush=True)
        reply = ""
        while job.status != "done":
            for r in generator.iterate():
                reply += r.get("text", "")
                print(r.get("text", ""), end="", flush=True)
        print()
        replies.append(reply)
    return replies


if __name__ == "__main__":
    main()
