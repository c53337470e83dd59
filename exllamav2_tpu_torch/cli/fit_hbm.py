"""Device-memory fit planner: will this model + cache fit N GPUs? (twin of
the reference's util/fit_hbm.py, with its formulas and table).

Given a model config (or a geometry preset) plus target bpw, cache kind
and context budget, print per-GPU memory use for each tensor-parallel size
and the smallest one that fits. The memory a GPU has defaults to the card's
own total (``torch.cuda.get_device_properties``); without a card,
``--hbm_gib`` is required.

    python -m exllamav2_tpu_torch.cli.fit_hbm -m <model_dir> -b 2.5 -cq4 -ctx 8192
    python -m exllamav2_tpu_torch.cli.fit_hbm --preset 70b -b 2.5 -cq4 -tp 1,2,4,8

Weights are column-sharded over tp, the paged KV cache is kv-head-sharded,
embeddings/norms replicate.
"""

import argparse

GiB = 1024 ** 3

# [hidden, layers, heads, kv_heads, inter, vocab]
PRESETS = {
    "1b": (2048, 22, 32, 4, 5632, 32000),
    "7b": (4096, 32, 32, 32, 11008, 32000),
    "13b": (5120, 40, 40, 40, 13824, 32000),
    "34b": (8192, 48, 64, 8, 22016, 32000),
    "70b": (8192, 80, 64, 8, 28672, 32000),
}

# bytes per token per layer per kv-head-dim element pair (K+V), data+scales
CACHE_BYTES = {
    "bf16": 2 * 2.0,
    "fp16": 2 * 2.0,
    "fp8": 2 * 1.0,
    "q8": 2 * (1.0 + 4 / 32),      # 8-bit data + f32 scale per 32-group
    "q6": (1.0 + 4 / 32) + (0.5 + 4 / 32),   # 8-bit K + 4-bit V
    "q4": 2 * (0.5 + 4 / 32),
}


def model_bytes(hidden, layers, heads, kv_heads, inter, vocab, head_dim,
                bpw, head_bits=8.0):
    """EXL2 storage estimate: packed planes + per-group scale overhead
    (~0.7 bits/weight at gs32) on every quantized matrix; embed bf16."""
    eff = bpw + 0.7
    attn = hidden * head_dim * (heads + 2 * kv_heads) \
        + heads * head_dim * hidden
    mlp = 3 * hidden * inter
    per_layer = (attn + mlp) * eff / 8
    head = hidden * vocab * (head_bits + 0.7) / 8
    embed = hidden * vocab * 2
    norms = layers * 2 * hidden * 4
    return per_layer * layers + head + embed + norms


def cache_bytes_per_token(layers, kv_heads, head_dim, kind):
    return layers * kv_heads * head_dim * CACHE_BYTES[kind]


def card_gib() -> float:
    """Total memory of the card in GiB; raises without a GPU."""
    import torch
    from exllamav2_tpu_torch.device import resolve_device
    return torch.cuda.get_device_properties(
        resolve_device()).total_memory / GiB


def main(argv=None) -> dict:
    """-> {"weights_bytes", "cache_bytes", "budget_bytes", "fits_at"}."""
    ap = argparse.ArgumentParser(description="Per-GPU memory fit planner")
    ap.add_argument("-m", "--model_dir", default=None)
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("-b", "--bits", type=float, default=4.0)
    ap.add_argument("-hb", "--head_bits", type=float, default=8.0)
    for k in CACHE_BYTES:
        ap.add_argument(f"-c{k}", dest="kind", action="store_const",
                        const=k)
    ap.add_argument("-ctx", "--context", type=int, default=8192,
                    help="total cached tokens across all sequences")
    ap.add_argument("-tp", default="1,2,4,8,16",
                    help="comma list of GPU counts to evaluate")
    ap.add_argument("--hbm_gib", type=float, default=None,
                    help="memory per GPU (default: the card's own total)")
    ap.add_argument("--reserve_gib", type=float, default=1.5,
                    help="runtime/activations reserve per GPU")
    ap.set_defaults(kind="bf16")
    args = ap.parse_args(argv)
    if args.hbm_gib is None:
        try:
            args.hbm_gib = card_gib()
        except RuntimeError as e:
            ap.error(f"{e}; --hbm_gib is required without a GPU")

    if args.model_dir:
        from exllamav2_tpu_torch.config import ModelConfig
        c = ModelConfig.from_dir(args.model_dir)
        geom = (c.hidden_size, c.num_hidden_layers, c.num_attention_heads,
                c.num_key_value_heads, c.intermediate_size, c.vocab_size)
        head_dim = c.head_dim
        name = args.model_dir
    else:
        geom = PRESETS[args.preset or "7b"]
        head_dim = geom[0] // geom[2]
        name = args.preset or "7b"
    hidden, layers, heads, kv_heads, inter, vocab = geom

    wb = model_bytes(hidden, layers, heads, kv_heads, inter, vocab,
                     head_dim, args.bits, args.head_bits)
    cb_tok = cache_bytes_per_token(layers, kv_heads, head_dim, args.kind)
    cb = cb_tok * args.context
    budget = (args.hbm_gib - args.reserve_gib) * GiB

    print(f"{name}: weights {wb / GiB:.2f} GiB @ {args.bits} bpw, "
          f"cache {cb / GiB:.2f} GiB ({args.kind}, {args.context} tok, "
          f"{cb_tok / 1024:.1f} KiB/tok)")
    print(f"budget/chip: {budget / GiB:.1f} GiB "
          f"({args.hbm_gib} - {args.reserve_gib} reserve)\n")
    print("| tp | weights/chip | cache/chip | total/chip | fits |")
    print("|---|---|---|---|---|")
    fits_at = None
    for tp in (int(t) for t in args.tp.split(",")):
        if kv_heads % tp:
            print(f"| {tp} | - | - | - | kv_heads {kv_heads} % {tp} != 0 |")
            continue
        w_chip = wb / tp          # column-sharded (embed/norms ~ noise)
        c_chip = cb / tp          # kv-head-sharded
        tot = w_chip + c_chip
        ok = tot <= budget
        if ok and fits_at is None:
            fits_at = tp
        print(f"| {tp} | {w_chip / GiB:.2f} GiB | {c_chip / GiB:.2f} GiB "
              f"| {tot / GiB:.2f} GiB | {'YES' if ok else 'no'} |")
    if fits_at:
        print(f"\nminimum mesh: tp={fits_at}"
              + (" (multi-host)" if fits_at > 8 else ""))
    else:
        print("\ndoes not fit the evaluated mesh sizes")
    return {"weights_bytes": wb, "cache_bytes": cb, "budget_bytes": budget,
            "fits_at": fits_at}


if __name__ == "__main__":
    main()
