"""Quality evaluation: perplexity and KLD deltas for cache and weight
quantization (twin of the reference's tools/quality_eval.py).

The shape of the published quality tables (ppl per cache mode, bpw against
quality) on the fixtures this repository holds: synthetic tiny Llamas
converted to EXL2 at 4.0 and 6.0 bpw, a peaked-attention fixture, and the
trained fixture (tests/fixtures/trained_tiny) converted the same way. The
deltas bound the implementation's numerics (cache codec error, GPTQ
reconstruction error), not a real model's task quality.

The self-generated eval rows are temperature-sampled from the fp16 model
through a seeded torch.Generator on the model's device: the draws are not
the reference's jax.random draws, so the random-init tables read other rows
(the trained fixture's corpus rows are the same). `--write PATH` writes the
markdown (the reference writes docs/QUALITY.md); `--device` picks the
device (the card by default).

    python -m exllamav2_tpu_torch.cli.quality_eval [--write build/QUALITY.md]
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np
import torch

CACHE_KINDS = ("bf16", "fp8", "q8", "q6", "q4")
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures", "trained_tiny")


def _convert(src: str, out: str, bits: float, head_bits: int, device):
    from exllamav2_tpu_torch.convert.pipeline import convert_model
    convert_model(src, out, bits=bits, head_bits=head_bits, cal_rows=4,
                  cal_len=128, progress=lambda *a, **k: None, device=device)
    return out


def build_fixtures(tmp: str, *, vocab=384, hidden=256, layers=2, heads=8,
                   kv_heads=4, inter=512, seed=5, device=None):
    """-> (dense_dir, exl2_4bpw_dir, exl2_6bpw_dir)."""
    from exllamav2_tpu_torch.utils.testing import make_tiny_llama

    dense = os.path.join(tmp, "dense")
    make_tiny_llama(dense, quant=None, vocab=vocab, hidden=hidden,
                    layers=layers, heads=heads, kv_heads=kv_heads,
                    inter=inter, max_pos=2048, seed=seed, head_scale=6.0)
    q4 = _convert(dense, os.path.join(tmp, "q4bpw"), 4.0, 6, device)
    q6 = _convert(dense, os.path.join(tmp, "q6bpw"), 6.0, 8, device)
    return dense, q4, q6


def eval_rows(model, rows: int = 4, row_len: int = 256,
              seed: int = 3) -> np.ndarray:
    """Self-generated eval rows: temperature-sampled (0.8) continuations
    from the fp16 model of 8 random prompt tokens.

    An untrained fixture has no external text it can predict, so plain text
    ppl is noise (quantization can even "improve" it). Scoring on the fp16
    model's own samples makes degradation monotone: cache and weight
    quantization error shows up as a ppl increase relative to it.
    """
    rng = np.random.default_rng(seed)
    vocab = model.static.vocab_size
    prompts = rng.integers(3, vocab, (rows, 8)).astype(np.int32)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    cache = model.new_cache(batch=rows, max_seq=row_len + 16)
    lg, cache = model.forward(prompts, cache, 0)
    tok = torch.argmax(lg[:, -1:, :], dim=-1).to(torch.int32)
    out = [tok]
    pos = prompts.shape[1]
    for _ in range(row_len - prompts.shape[1] - 1):
        lg, cache = model.forward(tok, cache, pos)
        p = torch.softmax(lg[:, -1, :].float() / 0.8, dim=-1)
        tok = torch.multinomial(p, 1, generator=gen).to(torch.int32)
        out.append(tok)
        pos += 1
    gen_ids = torch.cat(out, dim=1).cpu().numpy()
    return np.concatenate([prompts, gen_ids], axis=1).astype(np.int32)


def cache_ppl_table(model, rows: np.ndarray) -> dict[str, float]:
    from exllamav2_tpu_torch.evals import perplexity
    return {kind: perplexity(model, rows, cache_kind=kind)
            for kind in CACHE_KINDS}


def _kld(la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    """Next-token KLD(A || B) per row of logits [..., V] (f32)."""
    pa = torch.log_softmax(torch.from_numpy(la), dim=-1)
    pb = torch.log_softmax(torch.from_numpy(lb), dim=-1)
    return torch.sum(torch.exp(pa) * (pa - pb), dim=-1).numpy()


def weight_kld(model_a, model_b, rows: np.ndarray) -> dict[str, float]:
    """Mean/max next-token KLD of B against A + top-1 agreement."""
    def logits(model, row):
        cache = model.new_cache(batch=1, max_seq=row.shape[0] + 8)
        lg, _ = model.forward(row[None, :], cache, 0)
        return lg.float().cpu().numpy()[0]

    klds, agree = [], []
    for row in rows:
        la, lb = logits(model_a, row), logits(model_b, row)
        klds.append(_kld(la, lb))
        agree.append(la.argmax(-1) == lb.argmax(-1))
    klds = np.concatenate(klds)
    return {"kld_mean": float(klds.mean()), "kld_max": float(klds.max()),
            "top1_agree": float(np.concatenate(agree).mean())}


def trained_dir() -> str | None:
    """The committed trained fixture, or None."""
    return FIXTURE if os.path.exists(os.path.join(FIXTURE, "config.json")) \
        else None


def corpus_rows(rows: int = 4, row_len: int = 257,
                offset: int = 1000) -> np.ndarray:
    """Sequential corpus windows (the text the trained fixture models)."""
    from exllamav2_tpu_torch.convert.standard_cal import STANDARD_CAL_TEXT
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    toks = np.asarray(ByteTokenizer(384).encode(STANDARD_CAL_TEXT),
                      np.int32)
    out = [toks[offset + i * row_len: offset + (i + 1) * row_len]
           for i in range(rows)]
    return np.stack(out)


def build_trained_quants(tmp: str, dense_dir: str, device=None):
    """Convert the trained fixture -> (4bpw_dir, 6bpw_dir)."""
    return (_convert(dense_dir, os.path.join(tmp, "trained_q4"), 4.0, 6,
                     device),
            _convert(dense_dir, os.path.join(tmp, "trained_q6"), 6.0, 8,
                     device))


def decode_path_scores(model, rows: np.ndarray):
    """Teacher-forced decode-path logits (one token a step, m = 1: the
    fused-kernel path W4A8 changes; prefill stays exact).
    Returns (logits [R, T-1, V] f32, ppl)."""
    out = []
    nll_sum, n_tok = 0.0, 0
    for row in rows:
        cache = model.new_cache(batch=1, max_seq=len(row) + 8)
        lgs = []
        for t in range(len(row) - 1):
            lg, cache = model.forward(np.asarray([[row[t]]], np.int32),
                                      cache, t)
            lgs.append(lg[0, -1].float().cpu().numpy())
        la = np.stack(lgs)
        out.append(la)
        lsm = torch.log_softmax(torch.from_numpy(la), dim=-1).numpy()
        nll = -lsm[np.arange(len(row) - 1), row[1:]]
        nll_sum += float(nll.sum())
        n_tok += len(row) - 1
    return np.stack(out), math.exp(nll_sum / n_tok)


def w4a8_quality(q4_dir: str, rows: np.ndarray, device=None):
    """Decode-path KLD + ppl of the W4A8 mode against the exact path on the
    same quantized checkpoint (the opt-in's quality cost)."""
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.ops.dequant import enable_w4a8

    exact = Model.from_dir(q4_dir, device=device)
    m8 = Model(enable_w4a8(exact.weights), exact.static, exact.config)
    la, ppl_exact = decode_path_scores(exact, rows)
    lb, ppl_w4a8 = decode_path_scores(m8, rows)
    kld = _kld(la, lb)
    agree = (la.argmax(-1) == lb.argmax(-1)).mean()
    return {"ppl_exact": ppl_exact, "ppl_w4a8": ppl_w4a8,
            "kld_mean": float(kld.mean()), "kld_max": float(kld.max()),
            "top1_agree": float(agree)}


def build_peaked_fixture(tmp: str, attn_scale: float = 4.0):
    """K-sensitive fixture: attn_scale peaks the softmax so K-cache
    quantization error perturbs where attention lands (the trained-model
    regime; a random-init net attends near-uniformly and hides it)."""
    from exllamav2_tpu_torch.utils.testing import make_tiny_llama
    d = os.path.join(tmp, "peaked")
    make_tiny_llama(d, quant=None, vocab=384, hidden=256, layers=2,
                    heads=8, kv_heads=4, inter=512, max_pos=2048, seed=5,
                    head_scale=6.0, attn_scale=attn_scale)
    return d


def run(write: str | None = None, tmp: str | None = None, device=None):
    from exllamav2_tpu_torch.models.model import Model

    with tempfile.TemporaryDirectory(prefix="quality_eval_") as own:
        tmp = tmp or own
        dense_dir, q4_dir, q6_dir = build_fixtures(tmp, device=device)
        dense = Model.from_dir(dense_dir, device=device)
        m4 = Model.from_dir(q4_dir, device=device)
        m6 = Model.from_dir(q6_dir, device=device)
        rows = eval_rows(dense)

        ppl_dense = cache_ppl_table(dense, rows)
        ppl_q4 = cache_ppl_table(m4, rows)
        kld4 = weight_kld(dense, m4, rows[:2])
        kld6 = weight_kld(dense, m6, rows[:2])

        peaked = Model.from_dir(build_peaked_fixture(tmp), device=device)
        ppl_peaked = cache_ppl_table(peaked, eval_rows(peaked, rows=3))

        res = {"ppl_dense": ppl_dense, "ppl_q4": ppl_q4,
               "ppl_peaked": ppl_peaked, "kld4": kld4, "kld6": kld6}

        # the trained fixture: the anchor tables, a model with real
        # structure where deltas read like the published tables
        tdir = trained_dir()
        if tdir is not None:
            tq4, tq6 = build_trained_quants(tmp, tdir, device)
            t_dense = Model.from_dir(tdir, device=device)
            t_m4 = Model.from_dir(tq4, device=device)
            trows = corpus_rows()
            res["t_ppl_dense"] = cache_ppl_table(t_dense, trows)
            res["t_ppl_q4"] = cache_ppl_table(t_m4, trows)
            res["t_kld4"] = weight_kld(t_dense, t_m4, trows[:2])
            res["t_kld6"] = weight_kld(
                t_dense, Model.from_dir(tq6, device=device), trows[:2])
            res["t_w4a8"] = w4a8_quality(tq4, trows[:2, :129], device)
    md = render(res)
    print(md)
    if write:
        if os.path.dirname(write):
            os.makedirs(os.path.dirname(write), exist_ok=True)
        with open(write, "w") as f:
            f.write(md)
        print(f"-- wrote {write}")
    return res


def render(res) -> str:
    l = []
    l.append("# Quality: cache + weight quantization deltas\n")
    l.append("Replicates the reference's quality tables "
             "(`doc/qcache_eval.md:13-77`, README model table) on the "
             "fixtures available in this zero-egress environment. Two "
             "tiers: the **trained fixture** (first section — a 2-layer "
             "byte-llama trained on the bundled calibration corpus, "
             "`cli/train_fixture.py`) anchors interpretable deltas "
             "with the reference's orderings; the random-init tables "
             "below it are CODEC-NOISE BOUNDS only (an untrained net's "
             "deltas bound the implementation's numerics, not any "
             "model's task quality — treat them as regression tripwires, "
             "not quality claims). Regenerate with "
             "`python -m exllamav2_tpu_torch.cli.quality_eval --write "
             "<path>`.\n")
    if "t_ppl_dense" in res:
        l.append("## Trained fixture: perplexity by KV-cache mode\n")
        l.append("2-layer byte-level llama trained to ppl ~1.1 on the "
                 "bundled corpus (`tests/fixtures/trained_tiny`, loss "
                 "curve in its config.json), scored on corpus windows "
                 "through the paged cache in each codec — the in-repo "
                 "stand-in for the reference's Pile rows "
                 "(`doc/qcache_eval.md:13-34`).\n")
        l.append("| model | " + " | ".join(CACHE_KINDS) + " |")
        l.append("|---|" + "---|" * len(CACHE_KINDS))
        for name, tbl in (("trained fp16", res["t_ppl_dense"]),
                          ("trained exl2 4.0bpw", res["t_ppl_q4"])):
            base = tbl["bf16"]
            cells = [f"{tbl['bf16']:.4f}"] + [
                f"{tbl[k]:.4f} ({100*(tbl[k]/base-1):+.3f}%)"
                for k in CACHE_KINDS[1:]]
            l.append(f"| {name} | " + " | ".join(cells) + " |")
        l.append("")
        l.append("## Trained fixture: weight quantization\n")
        l.append("| model | mean KLD | max KLD | top-1 agree |")
        l.append("|---|---|---|---|")
        for name, k in (("exl2 4.0bpw", res["t_kld4"]),
                        ("exl2 6.0bpw", res["t_kld6"])):
            l.append(f"| {name} | {k['kld_mean']:.5f} | "
                     f"{k['kld_max']:.5f} | "
                     f"{100*k['top1_agree']:.2f}% |")
        l.append("")
        w8 = res.get("t_w4a8")
        if w8:
            l.append("## W4A8 opt-in decode mode (trained fixture)\n")
            l.append("Cost of `DynamicGenerator(w4a8=True)` / "
                     "`enable_w4a8` — per-token per-group absmax int8 "
                     "activations on the W4A8 kernel "
                     "(`csrc/qmm_w4a8.cu`) — against the "
                     "exact decode path of the SAME 4.0bpw checkpoint, "
                     "teacher-forced through the decode path (m=1 fused "
                     "kernels; prefill and lm_head stay exact).\n")
            l.append("| metric | exact | w4a8 |")
            l.append("|---|---|---|")
            l.append(f"| decode-path ppl | {w8['ppl_exact']:.4f} | "
                     f"{w8['ppl_w4a8']:.4f} "
                     f"({100*(w8['ppl_w4a8']/w8['ppl_exact']-1):+.3f}%) |")
            l.append(f"| next-token KLD vs exact (mean / max) | — | "
                     f"{w8['kld_mean']:.5f} / {w8['kld_max']:.5f} |")
            l.append(f"| top-1 agreement | — | "
                     f"{100*w8['top1_agree']:.2f}% |")
            l.append("")
    l.append("## Codec-noise bounds (random-init fixture): "
             "perplexity by KV-cache mode\n")
    l.append("Ppl over rows sampled from the fp16 model itself (an "
             "untrained fixture has no external text to predict, so "
             "self-generated rows are the monotone signal), paged cache "
             "in each codec (`exllamav2_tpu_torch/evals.py:perplexity`). "
             "Delta is vs the same model with the bf16 cache.\n")
    l.append("| model | " + " | ".join(CACHE_KINDS) + " |")
    l.append("|---|" + "---|" * len(CACHE_KINDS))
    for name, tbl in (("fp16 weights", res["ppl_dense"]),
                      ("exl2 4.0bpw", res["ppl_q4"])):
        base = tbl["bf16"]
        cells = [f"{tbl['bf16']:.4f}"] + [
            f"{tbl[k]:.4f} ({100*(tbl[k]/base-1):+.3f}%)"
            for k in CACHE_KINDS[1:]]
        l.append(f"| {name} | " + " | ".join(cells) + " |")
    l.append("")
    l.append("### Why fp8 beats q4 here but not in the reference's table\n")
    l.append("The reference publishes Q4-cache *better* than FP8 (ppl "
             "11.60 vs 11.92, `doc/qcache_eval.md:32`). That ordering is "
             "a property of its FP8 codec, not its Q4: reference FP8 is "
             "fp16-bit **truncation** to e5m2 (`cache.cu:25-37`), with "
             "round-trip rel-RMSE ≈ 0.10 — *worse* than its own Q4 codec "
             "(≈ 0.08). Our FP8 uses round-to-nearest e5m2 (rel-RMSE "
             "≈ 0.053), strictly more accurate, which legitimately flips "
             "the ordering. A numpy golden of the reference codec "
             "(`tests/test_cache_codec_golden.py`) verifies per "
             "activation distribution that (a) our q4/q8 round-trip RMSE "
             "matches the reference codec's — the q4 codec is **not** "
             "diverging — and (b) the reference's own semantics "
             "reproduce its published inversion. Our scales store as "
             "bf16 (Mosaic has no f16) but quantize against the exact "
             "stored value rounded up a ulp, so no storage-rounding "
             "noise survives; on iid/scaled/outlier distributions ours "
             "beats the reference's fp16-scale codec (0.83–1.0× its "
             "RMSE).\n")
    l.append("## K-sensitive (peaked-attention) fixture\n")
    l.append("The flat table above under-weights K-cache error: a "
             "random-init net attends near-uniformly, so perturbing the "
             "keys barely moves the output and Q6 (8-bit K + 4-bit V, "
             "`cache.cu:259-269`) looks no better than Q4. Peaking the "
             "attention (attn_scale=4 on the q/k projections — the "
             "trained-model regime) restores the reference's structure: "
             "Q6's 8-bit K separates from Q4 by an order of magnitude, "
             "and groupwise-quantized K also beats FP8's 2-mantissa-bit "
             "relative error.\n")
    l.append("| model | " + " | ".join(CACHE_KINDS) + " |")
    l.append("|---|" + "---|" * len(CACHE_KINDS))
    tblp = res["ppl_peaked"]
    basep = tblp["bf16"]
    cells = [f"{basep:.4f}"] + [
        f"{tblp[k]:.4f} ({100*(tblp[k]/basep-1):+.2f}%)"
        for k in CACHE_KINDS[1:]]
    l.append("| fp16 weights, peaked attn | " + " | ".join(cells) + " |")
    l.append("")
    l.append("## Weight quantization KLD vs fp16 (random-init fixture)\n")
    l.append("Next-token KLD of the quantized model against the fp16 "
             "original over the same rows (cli/estimate_kld.py method). "
             "Untrained weights are incompressible noise, so these KLDs "
             "are far looser than the trained-fixture table above — "
             "regression tripwires only.\n")
    l.append("| model | mean KLD | max KLD | top-1 agree |")
    l.append("|---|---|---|---|")
    for name, k in (("exl2 4.0bpw", res["kld4"]),
                    ("exl2 6.0bpw", res["kld6"])):
        l.append(f"| {name} | {k['kld_mean']:.5f} | {k['kld_max']:.5f} "
                 f"| {100*k['top1_agree']:.2f}% |")
    l.append("")
    return "\n".join(l)



def main(argv=None) -> dict:
    """-> the tables' numbers (run's result)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", metavar="PATH", default=None,
                    help="write the markdown tables to PATH")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)
    return run(write=args.write, device=args.device)


if __name__ == "__main__":
    main()
