"""Shared CLI argument handling (PyTorch port of exllamav2_tpu/model_init.py,
the reference exllamav2/model_init.py analog): args -> (model, tokenizer,
generator).

The flags are the reference's plus ``--device`` (default: the card, through
device.resolve_device; ``--device cpu`` runs the plain versions on the CPU).
``-tp`` over more than one device raises: multi-GPU serving is not ported.
"""

from __future__ import annotations

import argparse

import torch

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.tokenizer import load_tokenizer

__all__ = ["add_args", "cache_kind", "init"]


def add_args(parser: argparse.ArgumentParser):
    parser.add_argument("-m", "--model_dir", required=True,
                        help="model directory (safetensors + config.json)")
    parser.add_argument("-l", "--length", type=int, default=None,
                        help="max sequence length")
    parser.add_argument("-cq4", "--cache_q4", action="store_true")
    parser.add_argument("-cq6", "--cache_q6", action="store_true")
    parser.add_argument("-cq8", "--cache_q8", action="store_true")
    parser.add_argument("-c8", "--cache_8bit", action="store_true")
    parser.add_argument("-tp", "--tensor_parallel", type=int, default=0,
                        help="serve over this many GPUs (reference -tp; "
                             "0 = one, -1 = all; more than one is not "
                             "ported)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs "
                             "the plain versions)")


def cache_kind(args) -> str:
    if getattr(args, "cache_q4", False):
        return "q4"
    if getattr(args, "cache_q6", False):
        return "q6"
    if getattr(args, "cache_q8", False):
        return "q8"
    if getattr(args, "cache_8bit", False):
        return "fp8"
    return "bf16"


def init(args, max_batch_size: int = 8, draft_model_dir: str | None = None,
         num_draft_tokens: int = 4, use_ngram_draft: bool = False):
    """-> (model, tokenizer, generator) like model_init.init().

    draft_model_dir / use_ngram_draft enable speculative decoding
    (reference chat.py -dm / -ngram). The pool holds
    max(ceil(max_len / 256) * max_batch_size + 1, 8) pages of the cache
    kind the flags ask for. -tp -1 on a one-GPU box (or on the CPU)
    resolves to one device and builds no mesh."""
    device = resolve_device(getattr(args, "device", None))
    tp = getattr(args, "tensor_parallel", 0)
    if tp:
        n = tp if tp > 0 else (torch.cuda.device_count()
                               if device.type == "cuda" else 1)
        if n > 1:
            raise NotImplementedError(
                f"-tp {tp}: serving over {n} devices is not ported to "
                "exllamav2_tpu_torch yet (multi-GPU, ROADMAP §1 item 6)")
    model = Model.from_dir(args.model_dir, device=device)
    tokenizer = load_tokenizer(args.model_dir)
    max_len = args.length or model.config.max_seq_len
    pages = max(-(-max_len // 256) * max_batch_size + 1, 8)
    cache = PagedKVCache.alloc(
        model.static.num_layers, pages, model.static.num_kv_heads,
        model.static.head_dim, cache_kind(args), device=device)
    draft_model = draft_cache = None
    if draft_model_dir:
        draft_model = Model.from_dir(draft_model_dir, device=device)
        draft_cache = PagedKVCache.alloc(
            draft_model.static.num_layers, pages,
            draft_model.static.num_kv_heads,
            draft_model.static.head_dim, cache_kind(args), device=device)
    from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
    gen = DynamicGenerator(model, cache, tokenizer,
                           max_batch_size=max_batch_size,
                           max_seq_len=max_len,
                           draft_model=draft_model,
                           draft_cache=draft_cache,
                           num_draft_tokens=num_draft_tokens,
                           use_ngram_draft=use_ngram_draft)
    return model, tokenizer, gen
