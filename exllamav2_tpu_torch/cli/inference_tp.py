"""Tensor-parallel serving (twin of the reference's
examples/inference_tp.py).

Every rank of a world started by torchrun runs this script: the model and
its paged cache are sharded over a (dp = 1, tp = N) mesh
(parallel/sharding.make_mesh), and the generator takes the fused path when
everything splits. Each rank prints the same text.

    torchrun --nproc-per-node 2 -m exllamav2_tpu_torch.cli.inference_tp \\
        -m <model_dir>
    python -m exllamav2_tpu_torch.parallel.launch -n 2 -- \\
        -m exllamav2_tpu_torch.cli.inference_tp -m <dir> --device cpu

--device cpu runs gloo ranks on the CPU; --backend gloo puts several ranks
on one card (NCCL refuses that). Started outside a world it raises with
the torchrun line.
"""

import argparse


def main(argv=None) -> str:
    """-> the generated text (prompt included)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model_dir", required=True)
    ap.add_argument("--tp", type=int, default=0,
                    help="0 = every rank of the world")
    ap.add_argument("--device", default=None,
                    help="default: cuda:LOCAL_RANK; 'cpu' runs on the CPU")
    ap.add_argument("--backend", default=None,
                    help="default: nccl on a card, gloo on the CPU")
    ap.add_argument("--prompt", default="The tensor-parallel answer is")
    ap.add_argument("--tokens", type=int, default=80)
    ap.add_argument("--greedy", action="store_true")
    args = ap.parse_args(argv)

    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.parallel.sharding import make_multihost_mesh
    from exllamav2_tpu_torch.tokenizer import load_tokenizer

    mesh = make_multihost_mesh(dp=1, tp=args.tp or None,
                               device=args.device, backend=args.backend)
    model = Model.from_dir(args.model_dir, device=mesh.device)
    tokenizer = load_tokenizer(args.model_dir)
    st = model.static
    cache = PagedKVCache.alloc(st.num_layers, 64, st.num_kv_heads,
                               st.head_dim, "bf16", device=mesh.device)
    gen = DynamicGenerator(model, cache, tokenizer, mesh=mesh)
    print(f"TP={mesh.tp} fused={gen._tp_fused}")
    settings = Settings.greedy() if args.greedy else Settings(
        temperature=0.7)
    text = gen.generate(args.prompt, max_new_tokens=args.tokens,
                        settings=settings, completion_only=False)
    print(text)
    return text


if __name__ == "__main__":
    main()
