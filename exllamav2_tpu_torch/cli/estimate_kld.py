"""Estimate the KL divergence between two models' next-token distributions
(twin of the reference's util/estimate_kld.py).

Runs both models over the same token stream in fixed-length chunks and
reports mean/max KLD of model B's logits against model A's (typically
A = fp16 reference, B = quantized) plus top-1 agreement.

    python -m exllamav2_tpu_torch.cli.estimate_kld -ma <dir_a> -mb <dir_b>
        [-t data.txt] [-r rows] [-l row_len] [--device cpu]
"""

import argparse

import numpy as np
import torch


def _rows(tokenizer, text_path, rows, row_len, seed):
    if text_path:
        with open(text_path, encoding="utf-8") as f:
            ids = tokenizer.encode(f.read())
    else:
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, tokenizer.vocab_size,
                           rows * row_len).astype(np.int32)
    n = min(rows, len(ids) // row_len)
    return np.asarray(ids[: n * row_len], np.int32).reshape(n, row_len)


def _logits(model, row):
    cache = model.new_cache(batch=1, max_seq=row.shape[0] + 8)
    lg, _ = model.forward(row[None, :], cache, 0)
    return lg[0].float()


def compare(ma, mb, data) -> dict:
    """Both models over each row of `data` [R, T]: print each row's and
    the overall KLD(A||B) and top-1 agreement -> {"mean_kld", "max_kld",
    "top1"}. The divergences are computed where the logits lie."""
    klds, agree = [], []
    for i, row in enumerate(data):
        la = _logits(ma, row)
        lb = _logits(mb, row)
        v = min(la.shape[-1], lb.shape[-1])
        la, lb = la[..., :v], lb[..., :v]
        pa = torch.log_softmax(la, dim=-1)
        pb = torch.log_softmax(lb, dim=-1)
        # zero-probability entries (padded/-inf logits) contribute nothing
        term = torch.where(pa > -torch.inf, pa.exp() * (pa - pb), 0.0)
        kld = term.sum(-1).cpu().numpy()
        klds.append(kld)
        agree.append((la.argmax(-1) == lb.argmax(-1)).cpu().numpy())
        print(f" -- row {i + 1}/{len(data)}: "
              f"mean KLD {kld.mean():.5f}  max {kld.max():.4f}")

    klds = np.concatenate(klds)
    agree = np.concatenate(agree)
    print(f" ** mean KLD: {klds.mean():.6f}")
    print(f" ** max KLD:  {klds.max():.5f}")
    print(f" ** top-1 agreement: {100.0 * agree.mean():.2f}%")
    return {"mean_kld": float(klds.mean()), "max_kld": float(klds.max()),
            "top1": float(agree.mean())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("-ma", "--model_a", required=True)
    ap.add_argument("-mb", "--model_b", required=True)
    ap.add_argument("-t", "--text", default=None,
                    help="eval text file (default: random token rows)")
    ap.add_argument("-r", "--rows", type=int, default=8)
    ap.add_argument("-l", "--length", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.tokenizer import load_tokenizer

    ma = Model.from_dir(args.model_a, device=args.device)
    mb = Model.from_dir(args.model_b, device=args.device)
    tok = load_tokenizer(args.model_a)
    return compare(ma, mb, _rows(tok, args.text, args.rows, args.length,
                                 args.seed))


if __name__ == "__main__":
    main()
