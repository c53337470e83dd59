"""Data-parallel serving (twin of the reference's examples/inference_dp.py):
dp replicas behind one dispatcher (parallel/dp_server.py).

    python -m exllamav2_tpu_torch.cli.inference_dp -m <model_dir> -dp 2
    torchrun --nproc-per-node 4 -m exllamav2_tpu_torch.cli.inference_dp \\
        -m <model_dir> -dp 2 -tp 2

-tp 1 (the default) keeps the replicas in this process, on --device (two
replicas may share one card); -tp N over a world of dp * N ranks serves
each replica's tensor-parallel shard. The model_init flags apply (-tp is
model_init's --tensor_parallel; the reference adds a second -tp, which
argparse refuses).
"""

import argparse


PROMPTS = [
    "Once upon a time",
    "The capital of France is",
    "def fibonacci(n):",
    "In a shocking turn of events,",
]


def main(argv=None) -> list[str]:
    """-> the completions of the four prompts."""
    from exllamav2_tpu_torch import model_init
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    ap.add_argument("-dp", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--greedy", action="store_true")
    args = ap.parse_args(argv)

    from exllamav2_tpu_torch.device import resolve_device
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.parallel.dp_server import DataParallelGenerator
    from exllamav2_tpu_torch.tokenizer import load_tokenizer

    tp = max(args.tensor_parallel, 1)
    mesh = None
    if tp > 1:
        from exllamav2_tpu_torch.parallel.sharding import make_mesh
        mesh = make_mesh(tp, args.dp, device=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    model = Model.from_dir(args.model_dir, device=device)
    tokenizer = load_tokenizer(args.model_dir)
    gen = DataParallelGenerator(
        model, tokenizer, num_pages=64, dp=args.dp, tp=tp, mesh=mesh,
        cache_kind=model_init.cache_kind(args))
    print(f" -- {args.dp} replicas, fused={gen.tp_fused}")
    settings = Settings.greedy() if args.greedy else Settings(
        temperature=0.7)
    outs = gen.generate(PROMPTS, max_new_tokens=args.tokens,
                        settings=settings)
    for p, o in zip(PROMPTS, outs):
        print(f"\n>> {p}\n{o}")
    return outs


if __name__ == "__main__":
    main()
