"""Train the tiny byte-level fixture on the bundled calibration corpus (twin of
the reference's tools/train_fixture.py).

A 2-layer byte-level Llama trained on `convert/standard_cal.py` (the text
the converter calibrates on; nothing is downloaded), written as a standard
HF-layout fp16 checkpoint that `Model.from_dir` and the converter read like
any real model. The trainer differentiates through the serving stack's own
forward (`models/forward.model_forward`) with torch autograd, so the fixture
is trained on the arithmetic it is later evaluated on. On the card the dense
products are bf16 x bf16 -> f32 with the gradient of `ops/qmm.BF16Dot`; on
the CPU they are f32, as the reference's are off its accelerator.

    python -m exllamav2_tpu_torch.cli.train_fixture [--out build/trained_tiny]
        [--steps 1200] [--batch 8] [--lr 3e-3] [--seed 7] [--device cpu]

Differences from the reference's script: `--out` defaults to
`build/trained_tiny`, not to the committed `tests/fixtures/trained_tiny`,
and `--device` picks the device (the card by default). The weights are the
serving modules' buffers copied into f32 leaves that require grad (the
modules keep buffers; `to_weights` maps the leaves back into a
ModelWeights). The optimiser is torch.optim.AdamW with optax.adamw's
constants, its learning rate optax's cosine_decay_schedule(lr, steps, 0.1)
at the step count before the update. The RoPE tables get zero gradients
and still decay under the weight decay, as the reference's do (the
committed fixture was trained that way).
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

VOCAB = 384          # ByteTokenizer range (256 bytes + specials)
HIDDEN = 256
LAYERS = 2
HEADS = 8
KV_HEADS = 4
INTER = 512
# 256-token windows: greedy generation stays on-manifold through the
# positions the evals drive
SEQ = 256
# optax.adamw's constants
BETAS, EPS, WEIGHT_DECAY, ALPHA = (0.9, 0.999), 1e-8, 0.01, 0.1
# positional constants, not parameters: zero gradients (still decayed)
ROPE = ("sin", "cos")


def corpus_tokens() -> np.ndarray:
    from exllamav2_tpu_torch.convert.standard_cal import STANDARD_CAL_TEXT
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    tok = ByteTokenizer(VOCAB)
    return np.asarray(tok.encode(STANDARD_CAL_TEXT), np.int32)


def batches(tokens: np.ndarray, rng: np.random.Generator, batch: int):
    n = len(tokens) - SEQ - 1
    while True:
        idx = rng.integers(0, n, batch)
        yield np.stack([tokens[i:i + SEQ + 1] for i in idx])


def cosine_lr(lr: float, steps: int, count: int) -> float:
    """optax.cosine_decay_schedule(lr, steps, ALPHA) at `count`, in f32."""
    f = np.float32
    frac = f(min(count, steps)) / f(steps)
    cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * frac, dtype=np.float32))
    return float(f(lr) * ((f(1) - f(ALPHA)) * cosine + f(ALPHA)))


def init_model(seed: int = 7, device=None):
    """The reference's initial fixture (utils/testing.make_tiny_llama at
    the trainer's arguments) loaded with prescale=False -> (the loaded
    ModelWeights as a template, StaticModel, {buffer name: f32 leaf})."""
    from exllamav2_tpu_torch.device import resolve_device
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.utils.testing import make_tiny_llama

    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="train_fix_") as tmp:
        init_dir = os.path.join(tmp, "init")
        make_tiny_llama(init_dir, quant=None, vocab=VOCAB, hidden=HIDDEN,
                        layers=LAYERS, heads=HEADS, kv_heads=KV_HEADS,
                        inter=INTER, max_pos=2048, seed=seed, scale=0.03)
        model = Model.from_dir(init_dir, prescale=False, device=device,
                               graphs=False)
    params = {name: b.detach().float().clone().requires_grad_(
                  name not in ROPE)
              for name, b in model.weights.named_buffers()
              if b.is_floating_point()}
    return model.weights, model.static, params


def to_weights(template, params: dict):
    """A copy of the ModelWeights `template` whose buffers are `params`."""
    w = copy.deepcopy(template)
    for name, t in params.items():
        mod, _, attr = name.rpartition(".")
        (w.get_submodule(mod) if mod else w)._buffers[attr] = t
    return w


def loss_fn(weights, st, ids: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL of ids [B, SEQ + 1] through model_forward over a
    fresh bf16 KVCache (attn_limit SEQ)."""
    from exllamav2_tpu_torch.cache import KVCache
    from exllamav2_tpu_torch.models.forward import model_forward

    cache = KVCache.alloc(st.num_layers, ids.shape[0], SEQ, st.num_kv_heads,
                          st.head_dim, device=ids.device)
    logits, _ = model_forward(weights, st, ids[:, :-1], cache, 0,
                              attn_limit=SEQ)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, ids[:, 1:, None].long())
    return nll.mean()


def optimizer(params: dict, lr: float) -> torch.optim.AdamW:
    """torch.optim.AdamW over every leaf with optax.adamw's constants."""
    return torch.optim.AdamW(list(params.values()), lr=lr, betas=BETAS,
                             eps=EPS, weight_decay=WEIGHT_DECAY)


def update(opt, params: dict, lr: float, steps: int, count: int) -> None:
    """One AdamW step at the schedule's rate for `count`, the updates
    before it; the RoPE tables take zero gradients (and decay)."""
    for n in ROPE:
        params[n].grad = torch.zeros_like(params[n])
    for g in opt.param_groups:
        g["lr"] = cosine_lr(lr, steps, count)
    opt.step()


def train(steps: int = 1200, batch: int = 8, lr: float = 3e-3,
          seed: int = 7, log=print, device=None, losses: list | None = None):
    """-> (trained ModelWeights with f32 buffers, the last step's loss).
    `losses`, where given, receives each step's loss (a 0-d tensor)."""
    template, st, params = init_model(seed, device)
    weights = to_weights(template, params)
    opt = optimizer(params, lr)
    rng = np.random.default_rng(seed)
    gen = batches(corpus_tokens(), rng, batch)
    dev = params["embed"].device
    loss = None
    for i in range(steps):
        ids = torch.as_tensor(next(gen), device=dev)
        opt.zero_grad()
        loss = loss_fn(weights, st, ids)
        loss.backward()
        update(opt, params, lr, steps, i)
        loss = loss.detach()
        if losses is not None:
            losses.append(loss)
        if i % 100 == 0 or i == steps - 1:
            log(f"step {i:4d}  loss {loss.item():.4f}")
    for p in params.values():
        p.requires_grad_(False)
    return weights, loss.item()


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def export(params, out_dir: str, final_loss: float):
    """Write trained ModelWeights as a standard HF-llama fp16 checkpoint."""
    from exllamav2_tpu_torch.stloader import write_safetensors

    os.makedirs(out_dir, exist_ok=True)
    cfg = {
        "architectures": ["LlamaForCausalLM"],
        "hidden_size": HIDDEN, "intermediate_size": INTER,
        "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
        "num_key_value_heads": KV_HEADS, "vocab_size": VOCAB,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "max_position_embeddings": 2048, "tie_word_embeddings": False,
        "bos_token_id": 1, "eos_token_id": 2,
        "_trained_fixture": {
            "corpus": "exllamav2_tpu_torch/convert/standard_cal.py",
            "final_loss": round(final_loss, 4),
            "trainer": "exllamav2_tpu_torch/cli/train_fixture.py"},
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)

    t: dict[str, np.ndarray] = {}

    def lin(key, dl):
        # DenseLinear stores [in, out]; HF stores [out, in]
        t[key + ".weight"] = np.ascontiguousarray(
            _np32(dl.weight).T).astype(np.float16)

    t["model.embed_tokens.weight"] = _np32(params.embed).astype(np.float16)
    for l, lw in enumerate(params.layers):
        p = f"model.layers.{l}"
        t[f"{p}.input_layernorm.weight"] = _np32(
            lw.attn.norm.weight).astype(np.float16)
        lin(f"{p}.self_attn.q_proj", lw.attn.q)
        lin(f"{p}.self_attn.k_proj", lw.attn.k)
        lin(f"{p}.self_attn.v_proj", lw.attn.v)
        lin(f"{p}.self_attn.o_proj", lw.attn.o)
        t[f"{p}.post_attention_layernorm.weight"] = _np32(
            lw.mlp.norm.weight).astype(np.float16)
        lin(f"{p}.mlp.gate_proj", lw.mlp.gate)
        lin(f"{p}.mlp.up_proj", lw.mlp.up)
        lin(f"{p}.mlp.down_proj", lw.mlp.down)
    t["model.norm.weight"] = _np32(params.final_norm.weight).astype(
        np.float16)
    lin("lm_head", params.head)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), t)
    return out_dir


def main(argv=None) -> dict:
    """-> {"out", "final_loss", "seconds", "ms_per_step"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/trained_tiny")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' trains on "
                         "the CPU)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    params, loss = train(steps=args.steps, batch=args.batch, lr=args.lr,
                         seed=args.seed, device=args.device)
    dt = time.perf_counter() - t0
    out = export(params, args.out, loss)
    print(f"wrote trained fixture to {out} (final loss {loss:.4f}; "
          f"byte-level uniform would be ln(384)={math.log(384):.2f}; "
          f"{args.steps} steps in {dt:.1f} s)")
    return {"out": out, "final_loss": loss, "seconds": dt,
            "ms_per_step": dt / args.steps * 1e3}


if __name__ == "__main__":
    main()
