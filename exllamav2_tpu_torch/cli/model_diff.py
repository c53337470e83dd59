"""Layer-by-layer activation diff between two models (twin of the
reference's model_diff.py): per-layer MSE / max-err / final KLD and top-1
agreement.

    python -m exllamav2_tpu_torch.cli.model_diff -ma <model_a_dir>
        -mb <model_b_dir> [-t tokens] [--device cpu]
"""

import argparse

import numpy as np
import torch


def hidden_states(model, ids):
    """Per-layer hidden states (embedding, then each block's output; f32
    numpy [B, T, d] each) through the linear KVCache, and the logits
    [B * T, vocab] f32 numpy."""
    from exllamav2_tpu_torch.cache import KVCache
    from exllamav2_tpu_torch.models import forward as F
    w, st = model.weights, model.static
    ids = torch.as_tensor(np.asarray(ids, np.int32), device=model.device)
    cache = KVCache.alloc(st.num_layers, ids.shape[0], ids.shape[1] + 8,
                          st.num_kv_heads, st.head_dim, device=model.device)
    with torch.inference_mode():
        pos = F._positions(0, ids.shape[1], ids.device)
        x = F._embed(w, st, ids, pos)
        rope = F._rope_rows(w, pos)
        states = [x.float().cpu().numpy()]
        for layer in range(st.num_layers):
            x, cache = F._block_forward(x, w.layers[layer], st, layer, rope,
                                        cache, 0)
            states.append(x.float().cpu().numpy())
        logits = F._head(w, st, x, False)
    return states, logits.reshape(-1, logits.shape[-1]).cpu().numpy()


def diff(sa, la, sb, lb) -> dict:
    """Print the per-layer table and the logits' KLD(A||B) and top-1
    agreement -> {"layers": [(name, mse, max_err)], "kld", "top1"}."""
    print(f"{'layer':>6} {'mse':>12} {'max_err':>12}")
    layers = []
    for i, (x, y) in enumerate(zip(sa, sb)):
        mse = float(np.mean((x - y) ** 2))
        mx = float(np.abs(x - y).max())
        name = "emb" if i == 0 else f"{i - 1}"
        layers.append((name, mse, mx))
        print(f"{name:>6} {mse:>12.6g} {mx:>12.6g}")
    ta, tb = torch.from_numpy(la), torch.from_numpy(lb)
    logp = torch.log_softmax(ta, dim=-1)
    logq = torch.log_softmax(tb, dim=-1)
    kld = float(torch.mean(torch.sum(logp.exp() * (logp - logq), dim=-1)))
    top1 = float((la.argmax(-1) == lb.argmax(-1)).mean())
    print(f"\n -- logits KLD(A||B): {kld:.6f}")
    print(f" -- top-1 agreement: {top1 * 100:.2f}%")
    return {"layers": layers, "kld": kld, "top1": top1}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("-ma", "--model_a", required=True)
    ap.add_argument("-mb", "--model_b", required=True)
    ap.add_argument("-t", "--tokens", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from exllamav2_tpu_torch.models.model import Model
    a = Model.from_dir(args.model_a, device=args.device)
    b = Model.from_dir(args.model_b, device=args.device)
    assert a.static.num_layers == b.static.num_layers

    rng = np.random.default_rng(args.seed)
    vocab = min(a.static.vocab_size, b.static.vocab_size)
    ids = rng.integers(0, vocab, (1, args.tokens)).astype(np.int32)

    sa, la = hidden_states(a, ids)
    sb, lb = hidden_states(b, ids)
    return diff(sa, la, sb, lb)


if __name__ == "__main__":
    main()
