"""Speculative decoding: n-gram and draft-model drafting (twin of the
reference's examples/inference_speculative.py).

    python -m exllamav2_tpu_torch.cli.inference_speculative -m <model_dir>
        [-dm <draft_model_dir>]
"""

import argparse
import time


def main(argv=None) -> str:
    """-> the prompt and its completion."""
    from exllamav2_tpu_torch import model_init
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.device import resolve_device
    from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.tokenizer import load_tokenizer
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    ap.add_argument("-dm", "--draft_model_dir", default=None,
                    help="optional small draft model; omit for n-gram "
                         "drafting")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = Model.from_dir(args.model_dir, device=dev)
    tokenizer = load_tokenizer(args.model_dir)
    pages = 64

    cache = PagedKVCache.alloc(model.static.num_layers, pages,
                               model.static.num_kv_heads,
                               model.static.head_dim, "bf16", device=dev)
    if args.draft_model_dir:
        draft = Model.from_dir(args.draft_model_dir, device=dev)
        dcache = PagedKVCache.alloc(draft.static.num_layers, pages,
                                    draft.static.num_kv_heads,
                                    draft.static.head_dim, "bf16",
                                    device=dev)
        gen = DynamicGenerator(model, cache, tokenizer, draft_model=draft,
                               draft_cache=dcache, num_draft_tokens=4)
    else:
        gen = DynamicGenerator(model, cache, tokenizer,
                               use_ngram_draft=True)

    prompt = "Here is a list of the first 20 prime numbers: 2, 3, 5,"
    t0 = time.perf_counter()
    out = gen.generate(prompt, max_new_tokens=200,
                       settings=Settings.greedy())
    dt = time.perf_counter() - t0
    print(prompt + out)
    print(f"\n -- {200 / dt:.1f} t/s with speculative decoding")
    return prompt + out


if __name__ == "__main__":
    main()
