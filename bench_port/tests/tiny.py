"""A tiny cell for the CPU tests: the real configuration files with their
widths cut, and the chat or stream mix cut to a few clients and short
requests, so that a whole run (the port's plain paths, the reference)
takes seconds."""

import copy

from bench_port import spec

# above the tiny cells' sound readings on the CPU (widest gap up to 0.23,
# mean up to 0.003 over seeds 1 and 2); the faults read above
TINY_LIMITS = {"max_logit_gap": 0.5, "mean_logit_gap": 0.008}


def tiny_cell(name: str = "mistral-7b.chat", limits: dict | None = None
              ) -> dict:
    """`name` is <config>.<traffic>: a cell of BENCHMARK.json or any other
    pairing of its files."""
    config, traffic = name.split(".")
    c = {"config": spec.load("configs", config),
         "traffic": spec.load("traffic", traffic), "chips": 1}
    cfg = c["config"]
    cfg.update(vocab_size=512, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, derived={})
    if cfg.get("num_local_experts"):
        cfg["num_local_experts"] = 4
    tr = c["traffic"]
    tr.update(clients=min(tr["clients"], 4), deck=8, preroll_completions=2,
              preroll_quiet=2,
              check_served_tokens=24)
    if tr["prefix"]["pool"]:
        tr["prefix"]["pool"] = 2
    else:
        tr["prefix"]["tokens"] = {"median": 300, "sigma": 0.3, "min": 200,
                                  "max": 400}
    tr["user_tokens"] = {"median": 32, "sigma": 0.8, "min": 8, "max": 96}
    tr["output_tokens"] = {"median": 8, "sigma": 0.5, "min": 4, "max": 24}
    if tr["session_max_context"]:
        tr["session_max_context"] = 600
    pages = -(-(max(tr["session_max_context"], 400) + 96 + 24) // 256)
    tr["cache_pages"] = tr["clients"] * pages + 4
    c["limits"] = limits or dict(TINY_LIMITS)
    return c
