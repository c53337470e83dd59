"""Operations and bytes of the model's work, counted from its shapes, and the
card's published peaks.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power
limit (a card set lower runs slower under load; the run prints the card's
limit beside its numbers).

Kernel 1 (the port's fused EXL2 matmul, one launch a linear at up to 32 rows)
reads each linear's packed words (k * n * bits / 8 bytes) and its bf16 group
scales (k / 32 * n * 2 bytes) once, reads the rows' bf16 activations and
writes their f32 outputs. In an MoE layer served by its gated entry, a
launch whose expert no row routes to reads nothing and writes its zero
output. Kernel 3 (paged decode attention) reads each job's K and V over its
context once a step, reads its query and writes its output.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "linear_bytes", "step_linears",
           "qmm_step_bytes", "qmm_step_flops", "attn_step_bytes",
           "attn_step_flops", "token_flops", "bound_seconds"]

PEAK_FLOPS = 989e12        # bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12       # HBM3 bytes/s


def linear_bytes(k: int, n: int, m: int, bits: int = 4,
                 group_rows: int = 32) -> int:
    """Bytes kernel 1 needs for one linear at m rows."""
    return (k * n * bits // 8 + k // group_rows * n * 2
            + m * k * 2 + m * n * 4)


def step_linears(d: dict, head: bool = True):
    """(k, n, expert) of every quantized linear of one forward step; expert
    is True for an expert's linear, which only its routed rows need."""
    h, hd = d["hidden"], d["head_dim"]
    out = []
    for _ in range(d["layers"]):
        out += [(h, d["heads"] * hd, False), (h, d["kv_heads"] * hd, False),
                (h, d["kv_heads"] * hd, False), (d["heads"] * hd, h, False)]
        if d["experts"]:
            out += [(h, d["inter"], True), (h, d["inter"], True),
                    (d["inter"], h, True)] * d["experts"]
        else:
            out += [(h, d["inter"], False), (h, d["inter"], False),
                    (d["inter"], h, False)]
    if head:
        out.append((h, d["vocab"], False))
    return out


def qmm_step_bytes(d: dict, m: int, head: bool = True,
                   routed: int | None = None) -> int:
    """Bytes of one step's kernel-1 launches at m rows. An MoE step streams
    `routed` experts a layer (default: top-k, the fewest any routing needs);
    the other experts' launches write their zero outputs."""
    e = d["experts"]
    r = d["topk"] if routed is None else routed
    total = 0.0
    for k, n, expert in step_linears(d, head):
        if not expert:
            total += linear_bytes(k, n, m)
        else:
            # each expert's linear appears once per expert in step_linears
            total += (r * linear_bytes(k, n, m) + (e - r) * m * n * 4) / e
    return int(round(total))


def qmm_step_flops(d: dict, m: int, head: bool = True) -> int:
    """Multiply-adds x 2 of one step's kernel-1 launches on the rows each
    linear needs (an MoE row runs top-k experts)."""
    total = 0
    for k, n, expert in step_linears(d, head):
        share = d["topk"] / d["experts"] if expert else 1
        total += 2 * m * k * n * share
    return int(total)


def attn_step_bytes(d: dict, ctx: int, kv_bytes: int = 2) -> int:
    """Bytes kernel 3 needs for one job's decode step over `ctx` cached
    tokens, every layer: K and V once, the query read, the output written."""
    hd = d["head_dim"]
    per_layer = (2 * d["kv_heads"] * hd * kv_bytes * ctx
                 + d["heads"] * hd * 2 + d["heads"] * hd * 4)
    return per_layer * d["layers"]


def attn_step_flops(d: dict, ctx: int) -> int:
    """Scores and weighted values of one query token over ctx keys, every
    layer."""
    return 4 * ctx * d["heads"] * d["head_dim"] * d["layers"]


def token_flops(d: dict, ctx: int, head: bool) -> int:
    """Model FLOPs of one token at context `ctx` (itself included): 2 x the
    active linear parameters (top-k experts and the router on an MoE
    layer; the head when the token's logits are needed) plus attention."""
    lin = qmm_step_flops(d, 1, head)
    router = 2 * d["hidden"] * d["experts"] * d["layers"]
    return lin + router + attn_step_flops(d, ctx)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the tensor-core
    peak or bytes at the memory peak, whichever is longer."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
