"""Packed EXL2 weights drawn from the seed, and the port's model built on them.

The layout is a frozen copy of the port's ``utils/testing.random_quant_linear``
(EXL2, one uniform 4-bit segment a linear, 32-row groups): plane words
int32 [K * 4 / 32, N] with the bits of uniform uint32 words, so every 4-bit
value is uniform in 0..15; ``qscale`` uint8 [K / 32, N] uniform in 1..16;
``smax`` f32 [K / 32, 1], q_scale_max / 256 with q_scale_max an fp16 number.
A weight is (q - 8) * fp16(qscale^2 * smax). Copying the layout here keeps
the yardstick still when the port's test helpers change.

One change to the values: a drawn 4-bit value 0 becomes 8 (a zero weight),
so q - 8 is symmetric about 0, as a quantized trained weight is. Uniform
values 0..15 give every weight a mean of -scale / 2, shared by the 32 rows of
a group; the MLP's outputs then carry a component common to all features,
which every later linear adds up coherently, and the residual grows a
hundredfold a layer.

q_scale_max is drawn so that each linear keeps unit gain, E[w^2] * K = g^2
(g = 2 for the head, else 1), which keeps activations of order one through
every layer, as in a trained model; the norms are uniform in [0.8, 1.2],
the embedding N(0, 1) and a router N(0, 0.1^2), both bf16. A random deep
model amplifies rounding where its choices are nearly tied: with attention
scores of spread 3 (q and k at gain 1.75), or Mixtral's router at
N(0, 0.025^2), a bf16 rounding of the f32 reference moves its logits by
10-30 % over 32 layers (PERF.md); at these gains by 1 % (Mistral).

Everything is drawn on the device from one ``torch.Generator`` seeded with
the run's seed, one call per group of same-shaped tensors a layer. The
same tensors go to the port (``program_model``, through its public
containers) and to the plain reference (``reference/``), which decodes them
itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace

import torch

__all__ = ["Linear", "Packed", "dims", "draw_packed", "program_model",
           "linear_names"]

BITS = 4
GROUP_ROWS = 32
# E[(q - 8)^2] for q uniform in 1..15 and twice as often 8, E[qs^4] for qs
# uniform in 1..16, E[u^2] for u uniform in [0.5, 1.5]
_EQ2, _EQS4, _EU2 = 17.5, 15240.5, 13.0 / 12.0
GAIN = {"head": 2.0}
ROUTER_STD = 0.1


@dataclass
class Linear:
    planes: torch.Tensor      # int32 [k * BITS / 32, n]
    qscale: torch.Tensor      # uint8 [k / GROUP_ROWS, n]
    smax: torch.Tensor        # f32 [k / GROUP_ROWS, 1]
    k: int
    n: int


@dataclass
class Packed:
    """What the benchmark hands to both sides."""
    embed: torch.Tensor               # bf16 [vocab, hidden]
    norms: torch.Tensor               # f32 [2 * layers + 1, hidden]
    router: torch.Tensor | None       # bf16 [layers, hidden, experts]
    linears: dict                     # name -> Linear

    def free(self) -> None:
        self.linears.clear()
        self.embed = self.norms = self.router = None


def dims(cfg: dict) -> dict:
    """The sizes the harness reads from a configuration file."""
    h = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    return dict(vocab=cfg["vocab_size"], hidden=h,
                layers=cfg["num_hidden_layers"], heads=heads,
                kv_heads=cfg["num_key_value_heads"],
                head_dim=cfg.get("head_dim") or h // heads,
                inter=cfg["intermediate_size"],
                experts=cfg.get("num_local_experts", 0),
                topk=cfg.get("num_experts_per_tok", 0),
                theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]))


def linear_names(d: dict) -> list[tuple[str, int, int]]:
    """(name, k, n) of every linear, in draw order."""
    h, hd = d["hidden"], d["head_dim"]
    out = []
    for l in range(d["layers"]):
        out += [(f"l{l}.q", h, d["heads"] * hd),
                (f"l{l}.k", h, d["kv_heads"] * hd),
                (f"l{l}.v", h, d["kv_heads"] * hd),
                (f"l{l}.o", d["heads"] * hd, h)]
        if d["experts"]:
            for e in range(d["experts"]):
                out += [(f"l{l}.e{e}.w1", h, d["inter"]),
                        (f"l{l}.e{e}.w3", h, d["inter"]),
                        (f"l{l}.e{e}.w2", d["inter"], h)]
        else:
            out += [(f"l{l}.gate", h, d["inter"]), (f"l{l}.up", h, d["inter"]),
                    (f"l{l}.down", d["inter"], h)]
    out.append(("head", h, d["vocab"]))
    return out


def _kind(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def draw_packed(cfg: dict, seed: int, device) -> Packed:
    """The packed model of `cfg` drawn from `seed` on `device`."""
    d = dims(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    h, L = d["hidden"], d["layers"]
    names = linear_names(d)
    for _, k, _ in names:
        if k % 256:
            raise ValueError(f"K = {k}: the layout pads K to 256 rows, "
                             "which this generator does not draw")
    # one call per group of same-shaped linears of a layer (the head alone)
    groups: dict[tuple, list[str]] = {}
    for name, k, n in names:
        layer = name.split(".", 1)[0]
        groups.setdefault((layer, k, n), []).append(name)
    linears = {}
    for (_, k, n), members in groups.items():
        g = len(members)
        planes = torch.randint(-2 ** 31, 2 ** 31, (g, k * BITS // 32, n),
                               dtype=torch.int32, generator=gen,
                               device=device)
        for j in range(32 // BITS):           # value 0 -> 8: set its top bit
            zero = ((planes >> (BITS * j)) & 15) == 0
            planes |= zero.to(torch.int32) << (BITS * j + BITS - 1)
            del zero
        qscale = torch.randint(1, 17, (g, k // GROUP_ROWS, n),
                               dtype=torch.uint8, generator=gen,
                               device=device)
        u = torch.rand((g, k // GROUP_ROWS, 1), dtype=torch.float32,
                       generator=gen, device=device) + 0.5
        for i, name in enumerate(members):
            c = GAIN.get(_kind(name), 1.0) / math.sqrt(_EQ2 * _EQS4 * _EU2 * k)
            qsm = (u[i] * (c * 256.0)).half().float()      # fp16 q_scale_max
            linears[name] = Linear(planes[i], qscale[i], qsm / 256.0, k, n)
    embed = torch.randn((d["vocab"], h), generator=gen, device=device,
                        dtype=torch.float32).to(torch.bfloat16)
    norms = torch.rand((2 * L + 1, h), generator=gen, device=device,
                       dtype=torch.float32) * 0.4 + 0.8
    router = None
    if d["experts"]:
        router = (torch.randn((L, h, d["experts"]), generator=gen,
                              device=device, dtype=torch.float32)
                  * ROUTER_STD).to(torch.bfloat16)
    return Packed(embed, norms, router, linears)


def program_model(cfg: dict, packed: Packed, max_seq: int, device):
    """The port's Model on the packed tensors (shared, not copied), built
    through its public containers."""
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.models.modules import (
        AttnWeights, LayerStatic, LayerWeights, MLPWeights, MoEWeights,
        ModelWeights, NormWeights, StaticModel)
    from exllamav2_tpu_torch.ops.rope import build_sincos
    from exllamav2_tpu_torch.quant.qtensor import (
        DenseLinear, QuantLinear, QuantSegment)

    d = dims(cfg)
    h, L = d["hidden"], d["layers"]

    def lin(name):
        x = packed.linears[name]
        seg = QuantSegment(planes=(x.planes,), qscale=x.qscale, smax=x.smax,
                           bits=BITS, plane_bits=(BITS,), rows=x.k,
                           group_rows=GROUP_ROWS)
        return QuantLinear([seg], None, None, x.k, x.n, x.n)

    def norm(i):
        return NormWeights(packed.norms[i])

    layers = []
    for l in range(L):
        attn = AttnWeights(norm(2 * l), lin(f"l{l}.q"), lin(f"l{l}.k"),
                           lin(f"l{l}.v"), lin(f"l{l}.o"))
        if d["experts"]:
            e = range(d["experts"])
            mlp = MoEWeights(norm(2 * l + 1), DenseLinear(packed.router[l]),
                             [lin(f"l{l}.e{i}.w1") for i in e],
                             [lin(f"l{l}.e{i}.w2") for i in e],
                             [lin(f"l{l}.e{i}.w3") for i in e])
        else:
            mlp = MLPWeights(norm(2 * l + 1), lin(f"l{l}.gate"),
                             lin(f"l{l}.up"), lin(f"l{l}.down"))
        layers.append(LayerWeights(attn, mlp))
    sin, cos = build_sincos(SimpleNamespace(
        rotary_dim=d["head_dim"], rotary_embedding_base=d["theta"],
        rope_scaling=None, max_seq_len=max_seq,
        max_position_embeddings=max_seq,
        original_max_position_embeddings=None, head_dim=d["head_dim"]),
        device=device)
    w = ModelWeights(embed=packed.embed, layers=layers,
                     final_norm=norm(2 * L), head=lin("head"), sin=sin,
                     cos=cos)
    st = StaticModel(
        num_layers=L, num_heads=d["heads"], num_kv_heads=d["kv_heads"],
        head_dim=d["head_dim"], hidden_size=h, vocab_size=d["vocab"],
        norm_eps=d["eps"], layers=tuple(LayerStatic() for _ in range(L)),
        num_experts=d["experts"], num_experts_per_tok=d["topk"],
        norm_topk_prob=True)
    return Model(w, st)
