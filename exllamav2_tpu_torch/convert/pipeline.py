"""EXL2 conversion pipeline: measure -> optimize -> quantize -> compile
(PyTorch port of exllamav2_tpu/convert/pipeline.py).

Calibration forward with captured intermediates, per-module candidate
measurement (RTN fast path), global bit allocation by simulated annealing +
greedy top-up (native.sim_anneal, the numpy annealer where no host compiler
builds it), Hessian-aware GPTQ quantization with the reference's
reconstruction check, lm_head quantization at head_bits, and the final
safetensors assembly. The output loads in both packages.

Module coverage is architecture-derived: MoE experts, fused qkv / gate_up
(unfused on output like the reference), ungated MLPs, parallel-decoder
blocks, post-norms and biased layers all convert.

Resumable per stage AND per layer: measurement.json persists candidate
errors incrementally; the quantize stage writes one safetensors file per
layer under out_dir/quant/ and re-derives propagation states from them on
resume. Captured activations live on the device in fp16 (the reference's
np.float16 round trip, without the trip), only for the layer being
processed. Packing, the reconstruction check and the compile stage are host
numpy (quant/formats.py), as in the reference.

Numerics: the calibration forward's linears go through
ops/qmm.linear_apply(fused=False) and its attention products are bf16 x bf16
-> f32 (ops/paged_attn.gqa_scores / gqa_values), as the port's t > 1
attention; the Hessians, the factorizations, the GPTQ updates and the
measured output errors are f32 products with TF32 off (gptq.full_f32).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil

import numpy as np
import torch
from torch import nn

from exllamav2_tpu_torch.config import ModelConfig
from exllamav2_tpu_torch.convert.gptq import AdaptiveGPTQ, full_f32
from exllamav2_tpu_torch.convert.qparams import (
    QParams, qparams_attn, qparams_mlp, qparams_head_for)
from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.models.forward import (
    _act, _attn_qkv, _route, norm_apply)
from exllamav2_tpu_torch.models.loader import load_model
from exllamav2_tpu_torch.models.modules import MoEWeights
from exllamav2_tpu_torch.ops.paged_attn import gqa_scores, gqa_values
from exllamav2_tpu_torch.ops.qmm import linear_apply
from exllamav2_tpu_torch.quant import formats as F
from exllamav2_tpu_torch.quant.qtensor import DenseLinear
from exllamav2_tpu_torch.stloader import STFile, write_safetensors

__all__ = ["convert_model", "calibration_rows", "optimize_allocation"]


def calibration_rows(tokenizer, num_rows: int = 16, row_len: int = 256,
                     text: str | None = None, seed: int = 0,
                     noise_rows: int = 1) -> np.ndarray:
    """Tokenized calibration rows (conversion/tokenize.py analog).

    `text` may be a string, a path to a .txt file, or a path to a .parquet
    file with a text column (the reference's standard calibration format).
    With nothing given, uses the bundled standard mix (standard_cal.py, the
    same text as the reference's). `noise_rows` appends rows of
    uniform-random token ids so quantization stays calibrated for token
    statistics outside the text sample (embedding.py:191-221).
    """
    if isinstance(text, str) and os.path.exists(text):
        if text.endswith(".parquet"):
            text = _read_parquet_text(text)
        else:
            with open(text) as f:
                text = f.read()
    if text is None:
        from exllamav2_tpu_torch.convert.standard_cal import (
            STANDARD_CAL_TEXT)
        text = STANDARD_CAL_TEXT
    ids = tokenizer.encode(text)
    noise_rows = min(noise_rows, max(num_rows - 1, 0))
    text_rows = num_rows - noise_rows
    need = text_rows * row_len
    while len(ids) < need:
        ids = np.concatenate([ids, ids])
    rows = ids[:need].reshape(text_rows, row_len).astype(np.int32)
    if noise_rows:
        nrng = np.random.default_rng(seed + 0x5EED)
        noise = nrng.integers(0, tokenizer.vocab_size,
                              (noise_rows, row_len)).astype(np.int32)
        rows = np.concatenate([rows, noise], axis=0)
    return rows


def _read_parquet_text(path: str) -> str:
    """Concatenate the text column of a parquet file (tokenize.py:60-87)."""
    try:
        import pyarrow.parquet as pq
        table = pq.read_table(path)
    except ImportError:
        try:
            import pandas as pd
            df = pd.read_parquet(path)
            for col in df.columns:
                if df[col].dtype == object:
                    return "\n\n".join(str(v) for v in df[col])
            raise ValueError(f"no text column in {path}")
        except ImportError as e:
            raise RuntimeError(
                "parquet calibration needs pyarrow or pandas") from e
    for name in table.column_names:
        col = table.column(name)
        if str(col.type) in ("string", "large_string"):
            return "\n\n".join(str(v) for v in col.to_pylist())
    raise ValueError(f"no text column in {path}")


# ---------------------------------------------------------------------------
# calibration forward with captured linear inputs
# ---------------------------------------------------------------------------

def _causal_attn(q, k, v, scale):
    """Full causal attention (no cache) for calibration: q [R, T, H, D],
    k / v [R, T, Hkv, D] bf16 -> f32 [R, T, H * D]; the probabilities
    rounded to bf16 before the value product."""
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, hq // hkv, hd)
    scores = gqa_scores(qg, k.permute(0, 2, 1, 3)) * scale
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    out = gqa_values(p, v.permute(0, 2, 1, 3))
    return out.reshape(b, t, hq * hd)


def _layer_forward_capture(lw, st, x, sin, cos, layer: int,
                           want_caps: bool = True):
    """Decoder layer `layer` (weights lw) on [R, T, d]; returns (out,
    captures dict).

    captures: attn_in (input to q/k/v), o_in, mlp_in (input to gate/up or
    expert w1/w3), down_in / down_in_{e} -- the Hessian sources
    (measure.py:577-605). Handles post-norms, parallel blocks, MoE and
    ungated MLPs like models/forward.py; attention is causal over the whole
    row with the main rope table, as the reference's calibration forward.
    """
    b, t, d = x.shape
    cap = {}
    hidden = norm_apply(x, lw.attn.norm, st)
    if want_caps:
        cap["attn_in"] = hidden
    q, k, v = _attn_qkv(x, lw.attn, st, sin, cos, layer)
    scale = st.attn_scale if st.attn_scale is not None else \
        st.head_dim ** -0.5
    att = _causal_attn(q, k, v, scale).to(torch.bfloat16)
    if want_caps:
        cap["o_in"] = att
    o = linear_apply(att.reshape(b * t, -1), lw.attn.o,
                     fused=False).reshape(b, t, -1)
    if lw.attn.norm_post is not None:
        o = norm_apply(o, lw.attn.norm_post, st)

    mlp = lw.mlp
    if st.parallel_blocks:
        mlp_x = x
    else:
        x = x + o * st.scale_depth
        mlp_x = x
    hidden2 = norm_apply(mlp_x, mlp.norm, st)
    if want_caps:
        cap["mlp_in"] = hidden2
    h2 = hidden2.reshape(b * t, d)

    if isinstance(mlp, MoEWeights):
        mix = _route(h2, mlp, st)
        out = None
        hb = h2.to(torch.bfloat16)
        for e in range(st.num_experts):
            gate = linear_apply(hb, mlp.w1[e], fused=False)
            up = linear_apply(hb, mlp.w3[e], fused=False)
            inter = (_act(gate, st.mlp_act) * up).to(torch.bfloat16)
            if want_caps:
                cap[f"down_in_{e}"] = inter
            y = linear_apply(inter, mlp.w2[e], fused=False)
            y = y * mix[:, e:e + 1]
            out = y if out is None else out + y
        m_out = out.reshape(b, t, -1)
    else:
        up = linear_apply(h2, mlp.up, fused=False)
        if st.mlp_gated and mlp.gate is not None:
            gate = linear_apply(h2, mlp.gate, fused=False)
            inter = (_act(gate, st.mlp_act) * up).to(torch.bfloat16)
        else:
            inter = _act(up, st.mlp_act).to(torch.bfloat16)
        if want_caps:
            cap["down_in"] = inter
        m_out = linear_apply(inter, mlp.down, fused=False).reshape(b, t, -1)
    if getattr(mlp, "norm_post", None) is not None:
        m_out = norm_apply(m_out, mlp.norm_post, st)

    if st.parallel_blocks:
        x = x + o + m_out
    else:
        x = x + m_out * st.scale_depth
    return x, cap


def _sublayer_out_err(x_in, w_orig, dq, sub_rows=4096, y0=None) -> float:
    """Relative output error of a quantized linear on captured inputs (f32
    products); `y0`, the unquantized output on the same rows, may be passed
    in when several candidates are measured against one linear."""
    xi = x_in.float().reshape(-1, w_orig.shape[0])[:sub_rows]
    if y0 is None:
        y0 = xi @ w_orig
    y1 = xi @ dq
    num = torch.sum((y1 - y0) ** 2)
    den = torch.sum(y0 ** 2) + 1e-12
    return float(num / den)


# ---------------------------------------------------------------------------
# optimizer: simulated annealing + greedy top-up (optimize.py analog)
# ---------------------------------------------------------------------------

def optimize_allocation(slots: list[list[tuple[int, float]]],
                        budget_bits: int, seed: int = 0,
                        iters: int = 20000) -> list[int]:
    """slots[i] = [(cost_bits, err), ...] -> chosen option index per slot.

    Minimizes sum(err) under the budget (ext_c.sim_anneal +
    optimize.py:129-158 greedy top-up). The returned index refers to the
    CALLER's original option order (the internal cost sort is mapped back
    through its permutation).
    """
    rng = np.random.default_rng(seed)
    n = len(slots)
    choice = [0] * n                       # cheapest first (options sorted)
    order = []                             # sorted position -> original idx
    for i, opts in enumerate(slots):
        srt = sorted(range(len(opts)), key=lambda j: opts[j][0])
        order.append(srt)
        slots[i] = [opts[j] for j in srt]

    def unsorted(ch):
        return [order[i][ch[i]] for i in range(n)]

    cost = sum(slots[i][choice[i]][0] for i in range(n))
    if cost > budget_bits:
        return unsorted(choice)            # budget below minimum: floor

    # the native annealer when a host compiler builds it
    from exllamav2_tpu_torch.native import sim_anneal as native_sim_anneal
    native = native_sim_anneal(slots, budget_bits, iters, seed)
    if native is not None:
        return unsorted(native)

    temp = max(e for sl in slots for _, e in sl) + 1e-9
    for it in range(iters):
        temp *= 0.9997
        i = rng.integers(n)
        j = rng.integers(len(slots[i]))
        dc = slots[i][j][0] - slots[i][choice[i]][0]
        de = slots[i][j][1] - slots[i][choice[i]][1]
        if cost + dc > budget_bits:
            continue
        if de <= 0 or rng.random() < np.exp(-de / max(temp, 1e-12)):
            choice[i] = j
            cost += dc
    # greedy top-up: spend leftover budget on the best err/bit upgrades
    improved = True
    while improved:
        improved = False
        best = None
        for i in range(n):
            for j in range(len(slots[i])):
                dc = slots[i][j][0] - slots[i][choice[i]][0]
                de = slots[i][j][1] - slots[i][choice[i]][1]
                if dc > 0 and de < 0 and cost + dc <= budget_bits:
                    r = -de / dc
                    if best is None or r > best[0]:
                        best = (r, i, j, dc)
        if best is not None:
            _, i, j, dc = best
            choice[i] = j
            cost += dc
            improved = True
    return unsorted(choice)


# ---------------------------------------------------------------------------
# architecture-derived module lists (measure.py:577-605 analog)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Sub:
    name: str              # canonical output key, e.g. "...self_attn.q_proj"
    cap: str               # capture key feeding it
    kind: str              # "attn" | "mlp" (allocation slot group)
    lin: object            # DenseLinear
    field: str             # attribute path for weight replacement


def _layer_subs(cfg: ModelConfig, lw, l: int) -> list[_Sub]:
    """Quantizable sub-linears of one layer, from the architecture.

    Fused qkv / gate_up checkpoints were already sliced at load; the
    output always stores unfused canonical keys (each submodule packs its
    own EXL2 tensor set, as the reference does).
    """
    arch = cfg.arch
    p = arch.lm_prefix + f"model.layers.{l}"
    subs = [
        _Sub(f"{p}.self_attn.q_proj", "attn_in", "attn", lw.attn.q, "attn.q"),
        _Sub(f"{p}.self_attn.k_proj", "attn_in", "attn", lw.attn.k, "attn.k"),
        _Sub(f"{p}.self_attn.v_proj", "attn_in", "attn", lw.attn.v, "attn.v"),
        _Sub(f"{p}.self_attn.o_proj", "o_in", "attn", lw.attn.o, "attn.o"),
    ]
    if isinstance(lw.mlp, MoEWeights):
        for e in range(cfg.num_experts):
            subs += [
                _Sub(arch.lm_prefix + arch.key_moe_w1.format(l=l, e=e),
                     "mlp_in", "mlp", lw.mlp.w1[e], f"mlp.w1.{e}"),
                _Sub(arch.lm_prefix + arch.key_moe_w3.format(l=l, e=e),
                     "mlp_in", "mlp", lw.mlp.w3[e], f"mlp.w3.{e}"),
                _Sub(arch.lm_prefix + arch.key_moe_w2.format(l=l, e=e),
                     f"down_in_{e}", "mlp", lw.mlp.w2[e], f"mlp.w2.{e}"),
            ]
    else:
        if lw.mlp.gate is not None:
            gate_key = (arch.key_mlp_gate or "model.layers.{l}.mlp.gate_proj"
                        ).split("|")[0].format(l=l)
            subs.append(_Sub(arch.lm_prefix + gate_key, "mlp_in", "mlp",
                             lw.mlp.gate, "mlp.gate"))
        up_key = arch.key_mlp_up.split("|")[0].format(l=l)
        down_key = arch.key_mlp_down.split("|")[0].format(l=l)
        if arch.fused_gate_up:
            up_key = f"model.layers.{l}.mlp.up_proj"
            if lw.mlp.gate is not None:
                subs[-1].name = arch.lm_prefix + \
                    f"model.layers.{l}.mlp.gate_proj"
        subs.append(_Sub(arch.lm_prefix + up_key, "mlp_in", "mlp",
                         lw.mlp.up, "mlp.up"))
        subs.append(_Sub(arch.lm_prefix + down_key, "down_in", "mlp",
                         lw.mlp.down, "mlp.down"))
    return subs


def _shallow(mod: nn.Module) -> nn.Module:
    """A copy of a container module that shares its tensors and children
    but whose children can be reassigned without touching `mod`."""
    out = copy.copy(mod)
    out._modules = dict(mod._modules)
    return out


def _replace_lin(lw, field: str, new):
    """A copy of LayerWeights with one sub-linear replaced (the original
    and its tensors are left as they are)."""
    parts = field.split(".")
    out = _shallow(lw)
    if parts[0] == "attn":
        out.attn = _shallow(lw.attn)
        setattr(out.attn, parts[1], new)
        return out
    out.mlp = _shallow(lw.mlp)
    if len(parts) == 3:                    # moe expert list
        lst = list(getattr(lw.mlp, parts[1]))
        lst[int(parts[2])] = new
        setattr(out.mlp, parts[1], nn.ModuleList(lst))
    else:
        setattr(out.mlp, parts[1], new)
    return out


def _dense(w: torch.Tensor, lin) -> DenseLinear:
    """A dense linear with weight w [K, N] (as bf16) and lin's bias."""
    return DenseLinear(weight=w.to(torch.bfloat16), bias=lin.bias)


# ---------------------------------------------------------------------------
# per-module GPTQ quantize + pack
# ---------------------------------------------------------------------------

def _quantize_sub(sub: _Sub, qp: QParams, cap: dict,
                  shared: dict) -> tuple[dict, np.ndarray]:
    """GPTQ-quantize one sub-linear; returns (tensor dict, recon [K, N])."""
    w_t = sub.lin.weight.float()
    k, n = w_t.shape
    g = AdaptiveGPTQ(w_t)
    if sub.cap in shared:
        g.reuse_h(shared[sub.cap])
    else:
        g.add_batch(cap[sub.cap])
        g.prepare()
        shared[sub.cap] = g
    res = g.quantize(qp.groups(k))
    invperm = res["invperm"].cpu().numpy().astype(np.int32)
    t = F.exl2_pack_quantized(
        res["q"].cpu().numpy(),
        res["qscale"].cpu().numpy().astype(np.uint16),
        res["qscale_max"].cpu().numpy().astype(np.float16) / np.float16(1.0),
        res["bits"], qp.group_size, invperm)
    # sanity: packed tensors must reconstruct dq within 0.05
    # (conversion/quantize.py:96-124 gate)
    recon = F.exl2_dequantize(t, original_order=True)
    dq_orig = res["dq"][res["invperm"]].cpu().numpy()
    diff = np.abs(recon - dq_orig).max()
    if not diff < 0.05:
        raise AssertionError(
            f"reconstruction check failed on {sub.name}: {diff}")
    tensors = {
        f"{sub.name}.q_weight": t.q_weight,
        f"{sub.name}.q_scale": t.q_scale,
        f"{sub.name}.q_scale_max": t.q_scale_max.astype(np.float16),
        f"{sub.name}.q_groups": t.q_groups,
        f"{sub.name}.q_invperm": t.q_invperm,
    }
    # biases ride along unquantized (fused-qkv sources carry them under
    # the fused key, which the compile stage drops entirely)
    if getattr(sub.lin, "bias", None) is not None:
        tensors[f"{sub.name}.bias"] = sub.lin.bias.float().cpu().numpy(
        ).astype(np.float16)
    return tensors, recon


def _load_layer_recons(path: str, subs: list[_Sub]) -> dict[str, np.ndarray]:
    """Rebuild recon weights from a finished layer file (resume path)."""
    st = STFile(path)
    out = {}
    for sub in subs:
        t = F.Exl2Tensor(
            k=0, n=0,
            q_weight=st.get_tensor(f"{sub.name}.q_weight"),
            q_scale=st.get_tensor(f"{sub.name}.q_scale"),
            q_scale_max=st.get_tensor(
                f"{sub.name}.q_scale_max").astype(np.float16),
            q_groups=st.get_tensor(f"{sub.name}.q_groups"),
            q_invperm=st.get_tensor(f"{sub.name}.q_invperm"))
        t.n = t.q_weight.shape[1]
        t.k = t.q_invperm.shape[0]
        out[sub.name] = F.exl2_dequantize(t, original_order=True)
    return out


def embed_rows(weights, st, rows: np.ndarray) -> torch.Tensor:
    """Calibration states of token rows [R, T]: the embedding rows, scaled
    as the architecture asks, in bf16 (conversion/measure.py:71-92)."""
    ids = torch.from_numpy(np.asarray(rows, np.int64)).to(
        weights.embed.device)
    x = weights.embed[ids].float()
    if st.normalize_embeddings:
        x = x * (st.hidden_size ** 0.5)
    if st.embedding_multiplier != 1.0:
        x = x * st.embedding_multiplier
    return x.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# main driver
# ---------------------------------------------------------------------------

def convert_model(model_dir: str, out_dir: str, *, bits: float = 4.0,
                  head_bits: int = 6, cal_rows: int = 8,
                  cal_len: int = 256, cal_text: str | None = None,
                  seed: int = 0, progress=print,
                  shard_size_mb: float = 8192,
                  status_output: bool = False,
                  group_size: int = 32, device=None) -> str:
    """Convert an FP16/BF16 checkpoint to EXL2 at `bits` average bpw on
    `device` (the card by default: each group's GPTQ recursion is kernel
    G1, whose failure to build or launch raises; device="cpu" runs the
    plain loop).

    head_bits: 2..8 quantizes lm_head at that width (reference
    quant_lm_head, quantize.py:443-543); 16/None keeps it fp16.
    shard_size_mb: outputs larger than this split into numbered
    safetensors shards with a weight-map index (0 disables splitting).
    status_output: emit machine-parseable [STATUS]{...}[/STATUS] stage
    lines (convert/bot_status.py).
    group_size: scale-group rows for every candidate option (default 32,
    the reference's EXL2 grid; 128 emits the coarser groups of the W4A8
    decode mode). At most gptq.MAX_BLOCK on the card.
    """
    dev = resolve_device(device)
    with full_f32(), torch.no_grad():
        return _convert(model_dir, out_dir, bits=bits, head_bits=head_bits,
                        cal_rows=cal_rows, cal_len=cal_len,
                        cal_text=cal_text, seed=seed, progress=progress,
                        shard_size_mb=shard_size_mb,
                        status_output=status_output, group_size=group_size,
                        dev=dev)


def _convert(model_dir, out_dir, *, bits, head_bits, cal_rows, cal_len,
             cal_text, seed, progress, shard_size_mb, status_output,
             group_size, dev):
    from exllamav2_tpu_torch.convert.bot_status import print_stage
    from exllamav2_tpu_torch.tokenizer import load_tokenizer
    os.makedirs(out_dir, exist_ok=True)
    quant_dir = os.path.join(out_dir, "quant")
    os.makedirs(quant_dir, exist_ok=True)
    job_path = os.path.join(out_dir, "job.json")
    meas_path = os.path.join(out_dir, "measurement.json")
    job = {"stage": "measure", "group_size": group_size}
    if os.path.exists(job_path):
        with open(job_path) as f:
            job = json.load(f)
        # group_size invalidates EVERYTHING persisted: measurement.json
        # option errors/bit totals are priced on the old grid, strategy
        # indices would silently apply to the new one, and already
        # quantized layer files keep the old groups -- a mixed-group
        # checkpoint. Refuse loudly rather than resume across it.
        prev_gs = job.get("group_size", 32)
        if prev_gs != group_size:
            raise ValueError(
                f"resume state in {out_dir} was produced with "
                f"group_size={prev_gs}, requested {group_size}; delete "
                f"the output directory (or pass a fresh one) to convert "
                f"at the new group size")

    def save_job():
        with open(job_path, "w") as f:
            json.dump(job, f)

    cfg = ModelConfig.from_dir(model_dir)
    if cfg.quant_method is not None:
        raise ValueError(f"{model_dir} holds a {cfg.quant_method} model: "
                         f"the source must be unquantized")
    weights, st = load_model(cfg, device=dev)
    tokenizer = load_tokenizer(model_dir)

    rows = calibration_rows(tokenizer, cal_rows, cal_len, cal_text, seed)
    rows = np.clip(rows, 0, cfg.vocab_size - 1)
    sin = weights.sin[:rows.shape[1]]
    cos = weights.cos[:rows.shape[1]]

    def forward(lw, hs, l, want_caps=True):
        return _layer_forward_capture(lw, st, hs, sin, cos, l, want_caps)

    attn_opts, mlp_opts = (qparams_attn(group_size),
                           qparams_mlp(group_size))
    head_qp = qparams_head_for(head_bits)
    quantize_head = (head_qp is not None and not cfg.tie_word_embeddings
                     and isinstance(weights.head, DenseLinear)
                     and cfg.tensor_file_map.has_prefix(
                         cfg.arch.lm_prefix + cfg.arch.key_head + "."))

    # ---- stage: measure (RTN candidate errors, persisted per layer) ----
    meas = {"layers": {}}
    if os.path.exists(meas_path):
        with open(meas_path) as f:
            meas = json.load(f)

    def _mid_qp(opts):
        # representative option: nearest the global bpw target
        return min(opts, key=lambda qp: abs(qp.bpw(4096, 4096) - bits))

    if job["stage"] == "measure":
        hs = embed_rows(weights, st, rows)
        for l, lw in enumerate(weights.layers):
            # prep per-sub Hessians from states that have passed through
            # PROGRESSIVELY-QUANTIZED earlier layers (each layer is
            # measured against the error it will actually see)
            _, cap = forward(lw, hs, l)
            cap = {k: v.to(torch.float16) for k, v in cap.items()}
            prepped = {"attn": [], "mlp": []}
            for sub in _layer_subs(cfg, lw, l):
                w_t = sub.lin.weight.float()
                g = AdaptiveGPTQ(w_t)
                g.add_batch(cap[sub.cap])
                # numpy's sort on the host, as the reference's
                diag = torch.diagonal(g.hessian).cpu().numpy()
                g.hessian = None
                perm = np.argsort(-diag)
                g.w = g.w[torch.from_numpy(perm).to(dev)]
                inv = torch.from_numpy(np.argsort(perm)).to(dev)
                prepped[sub.kind].append((sub, g, inv, w_t))
            if str(l) not in meas["layers"]:
                entry = {}
                for kind, opts in (("attn", attn_opts), ("mlp", mlp_opts)):
                    opt_list = []
                    # each linear's unquantized output, once for all options
                    y0s = {sub.name: cap[sub.cap].float().reshape(
                        -1, w_t.shape[0])[:4096] @ w_t
                        for sub, _, _, w_t in prepped[kind]}
                    for qp in (opts if prepped[kind] else ()):
                        tot_bits = 0
                        err = 0.0
                        for sub, g, inv, w_t in prepped[kind]:
                            k, n = w_t.shape
                            dq = g.quantize_rtn(qp.groups(k))[inv]
                            err += _sublayer_out_err(cap[sub.cap], w_t, dq,
                                                     y0=y0s[sub.name])
                            tot_bits += qp.total_bits(k, n)
                        opt_list.append((tot_bits, err))
                    del y0s
                    entry[kind] = opt_list
                meas["layers"][str(l)] = entry
                with open(meas_path, "w") as f:
                    json.dump(meas, f)
                progress(f" -- measured layer {l + 1}/{st.num_layers}")
                print_stage(status_output, "Measuring", l + 1,
                            st.num_layers)
            # advance states through an RTN reconstruction at the
            # representative option (deterministic, so resume re-derives
            # identical states)
            lw_mid = lw
            for kind, opts in (("attn", attn_opts), ("mlp", mlp_opts)):
                qp = _mid_qp(opts)
                for sub, g, inv, w_t in prepped[kind]:
                    dq = g.quantize_rtn(qp.groups(w_t.shape[0]))[inv]
                    lw_mid = _replace_lin(lw_mid, sub.field,
                                          _dense(dq, sub.lin))
            hs, _ = forward(lw_mid, hs, l, want_caps=False)
        job["stage"] = "optimize"
        save_job()

    # ---- stage: optimize (global allocation) ----
    if job["stage"] == "optimize":
        slots, slot_meta = [], []
        for l in range(st.num_layers):
            entry = meas["layers"][str(l)]
            for kind in ("attn", "mlp"):
                if entry[kind]:
                    slots.append([tuple(o) for o in entry[kind]])
                    slot_meta.append((l, kind))
        total_weights = sum(
            int(np.prod(sub.lin.weight.shape))
            for l, lw in enumerate(weights.layers)
            for sub in _layer_subs(cfg, lw, l))
        budget = int(bits * total_weights)
        choice = optimize_allocation([list(s) for s in slots], budget, seed)
        # choice indices refer to the measurement opt_list order, which is
        # exactly the attn_opts/mlp_opts order
        job["strategy"] = {f"{l}.{kind}": ci
                           for (l, kind), ci in zip(slot_meta, choice)}
        job["stage"] = "quantize"
        save_job()
        progress(" -- optimized bit allocation")
        print_stage(status_output, "Optimizing", 1, 1)

    strategy = {k: int(v) for k, v in job.get("strategy", {}).items()}

    def qp_for(l, kind):
        opts = attn_opts if kind == "attn" else mlp_opts
        return opts[strategy[f"{l}.{kind}"]]

    # ---- stage: quantize (GPTQ + per-layer output files) ----
    if job["stage"] == "quantize":
        hs = embed_rows(weights, st, rows)
        for l, lw in enumerate(weights.layers):
            subs = _layer_subs(cfg, lw, l)
            layer_path = os.path.join(quant_dir, f"layer_{l}.safetensors")
            if os.path.exists(layer_path):
                recons = _load_layer_recons(layer_path, subs)
                lw2 = lw
                for sub in subs:
                    lw2 = _replace_lin(lw2, sub.field, _dense(
                        torch.from_numpy(recons[sub.name]).to(dev),
                        sub.lin))
                weights.layers[l] = lw2
                hs, _ = forward(lw2, hs, l, want_caps=False)
                continue
            _, cap = forward(lw, hs, l)
            cap = {k: v.to(torch.float16) for k, v in cap.items()}
            shared: dict[str, AdaptiveGPTQ] = {}
            tensors = {}
            lw2 = lw
            for sub in subs:
                t, recon = _quantize_sub(sub, qp_for(l, sub.kind), cap,
                                         shared)
                tensors.update(t)
                # replace with reconstruction so later layers see the error
                # (conversion/quantize.py:132)
                lw2 = _replace_lin(lw2, sub.field, _dense(
                    torch.from_numpy(recon).to(dev), sub.lin))
            del shared, cap
            write_safetensors(layer_path, tensors)
            weights.layers[l] = lw2
            hs, _ = forward(lw2, hs, l, want_caps=False)
            progress(f" -- quantized layer {l + 1}/{st.num_layers}")
            print_stage(status_output, "Quantizing", l + 1,
                        st.num_layers)

        # lm_head at head_bits (quantize.py:443-543)
        if quantize_head:
            head_path = os.path.join(quant_dir, "head.safetensors")
            if not os.path.exists(head_path):
                hnorm = norm_apply(hs, weights.final_norm, st)
                head_key = cfg.arch.lm_prefix + cfg.arch.key_head
                sub = _Sub(head_key, "head_in", "head", weights.head, "head")
                cap = {"head_in": hnorm.to(torch.float16)}
                t, _recon = _quantize_sub(sub, head_qp, cap, {})
                write_safetensors(head_path, t)
                progress(f" -- quantized lm_head ({head_qp.desc})")
                print_stage(status_output, "Quantizing (head)", 1, 1)
        job["stage"] = "compile"
        save_job()

    # ---- stage: compile (compile.py analog) ----
    quantized_prefixes = set()
    drop_prefixes = set()
    for l, lw in enumerate(weights.layers):
        for sub in _layer_subs(cfg, lw, l):
            quantized_prefixes.add(sub.name)
        # fused source tensors were sliced + quantized under unfused
        # names (bias included); drop the originals entirely
        if cfg.arch.fused_qkv and cfg.arch.key_fused_qkv:
            drop_prefixes.add(
                cfg.arch.lm_prefix + cfg.arch.key_fused_qkv.format(l=l))
        if cfg.arch.fused_gate_up and cfg.arch.key_fused_gate_up:
            drop_prefixes.add(
                cfg.arch.lm_prefix
                + cfg.arch.key_fused_gate_up.format(l=l))
    if quantize_head:
        quantized_prefixes.add(cfg.arch.lm_prefix + cfg.arch.key_head)

    out_tensors: dict[str, np.ndarray] = {}
    dtypes: dict[str, str] = {}
    tfm = cfg.tensor_file_map
    for key in tfm.keys():
        prefix = key.rsplit(".", 1)[0]
        if prefix in drop_prefixes:
            continue                       # fused source, fully replaced
        if prefix in quantized_prefixes:
            continue                       # replaced by packed tensors
        out_tensors[key] = tfm.get_tensor(key).copy()
        if tfm.get_dtype(key) == "BF16":
            dtypes[key] = "BF16"
    for fn in sorted(os.listdir(quant_dir)):
        stf = STFile(os.path.join(quant_dir, fn))
        for key in stf.keys():
            out_tensors[key] = stf.get_tensor(key).copy()
        stf.close()

    _write_model_files(out_dir, out_tensors, dtypes, shard_size_mb)
    for fn in os.listdir(model_dir):
        if fn.endswith(".json") or fn.startswith("tokenizer"):
            shutil.copy(os.path.join(model_dir, fn),
                        os.path.join(out_dir, fn))
    # stamp quantization metadata (the reference's compile.py config keys)
    cfg_path = os.path.join(out_dir, "config.json")
    with open(cfg_path) as f:
        out_cfg = json.load(f)
    out_cfg["quantization_config"] = {
        "quant_method": "exl2", "bits": bits,
        "head_bits": head_bits if quantize_head else 16,
        "calibration": {"rows": cal_rows, "length": cal_len}}
    with open(cfg_path, "w") as f:
        json.dump(out_cfg, f, indent=1)
    job["stage"] = "done"
    save_job()
    progress(f" -- compiled -> {out_dir}")
    print_stage(status_output, "Compiling", 1, 1)
    return out_dir


def _write_model_files(out_dir: str, tensors: dict, dtypes: dict,
                       shard_size_mb: float) -> None:
    """Write model.safetensors, size-splitting into numbered shards with
    a weight-map index when over shard_size_mb (the Hugging Face
    sharded-checkpoint convention; TensorFileMap prefers the index)."""
    limit = int(shard_size_mb * 1024 * 1024) if shard_size_mb else 0
    total = sum(t.nbytes for t in tensors.values())
    if not limit or total <= limit:
        write_safetensors(os.path.join(out_dir, "model.safetensors"),
                          tensors, dtypes=dtypes)
        return
    shards: list[dict] = [{}]
    sizes = [0]
    for name, t in tensors.items():
        if sizes[-1] + t.nbytes > limit and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += t.nbytes
    n = len(shards)
    index = {"metadata": {"total_size": total}, "weight_map": {}}
    for i, shard in enumerate(shards):
        fn = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        write_safetensors(os.path.join(out_dir, fn), shard,
                          dtypes={k: v for k, v in dtypes.items()
                                  if k in shard})
        for name in shard:
            index["weight_map"][name] = fn
    with open(os.path.join(out_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump(index, f, indent=2)
