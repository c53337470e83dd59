"""Chip smoke run of the PyTorch port (exllamav2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build    compile csrc/*.cu with nvcc (one process per source, in
              parallel) and print the build time and ptxas report;
  2. qmm      the fused dequant-matmul kernel against its plain version at the
              Llama-2-7B decode shapes, m in {1, 4, 8, 16, 32} (every row
              tile of the kernel; the main path runs 1, 4 and 16), for EXL2 4-bit
              prescaled, EXL2 4-bit with qscale/smax, mixed 3/5/6-bit EXL2 and
              GPTQ 4-bit gs128 act-order; times kernel, plain version and
              torch.matmul on the pre-dequantized bf16 weight (yardstick);
  3. attn     the decode-attention kernel against its plain version at
              B in {1, 4}, 32/32 and 32/8 heads, D 128, S 2048, past_len in
              {0, 255, 1500}, plus softcap and window; SDPA as yardstick;
  4. load     Model.from_dir(tests/fixtures/trained_tiny) on the card, greedy
              tokens equal to the CPU run of the same checkpoint;
  5. 7B       random EXL2 4.0 bpw weights at Llama-2-7B geometry (32 layers,
              prescaled) built on the card; generate_greedy at batch 1 and 4,
              each with its own launch counts; decode-vs-prefill logits;
              decode tokens/s and a profile, both of generate_greedy itself.
The last lines are the card's name and power limit, one JSON line of the
kernels, and {"ok": true, "device": {...}}. Details go to
build/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "build")

# Llama-2-7B (the headline geometry of the JAX package's bench.py)
VOCAB, HIDDEN, LAYERS, HEADS, INTER = 32000, 4096, 32, 32, 11008
SHAPES = [(HIDDEN, HIDDEN), (HIDDEN, INTER), (INTER, HIDDEN),
          (HIDDEN, VOCAB)]
# launches of each shape in one decode token: q, k, v, o | gate, up | down
PER_TOKEN = {(HIDDEN, HIDDEN): 4 * LAYERS, (HIDDEN, INTER): 2 * LAYERS,
             (INTER, HIDDEN): LAYERS, (HIDDEN, VOCAB): 1}
QMM_ROWS = (1, 4, 8, 16, 32)   # one m per row tile MT of csrc/qmm.cu
QMM_TOL = 1e-4          # max |kernel - plain| <= QMM_TOL * max |plain|
ATTN_TOL = 1e-4         # max |kernel - plain| <= ATTN_TOL * max |v|
L2_BYTES = 50 << 20


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def mem_rate(card: str) -> float:
    """Bytes/s of device memory: H100 SXM 3.35 TB/s, PCIe 2.0 TB/s."""
    return 2.0e12 if "PCIe" in card else 3.35e12


def graph_ms(fns, iters: int) -> float:
    """Device time per call: `iters` calls (cycling through fns) captured
    in one CUDA graph, replayed between two events."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    g.replay()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def eager_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


# ---------------------------------------------------------------- phase 1

def phase_build():
    from exllamav2_tpu_torch import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    dt = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.library(name)
    log(f"[build] {len(reports)} sources compiled in {dt:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return {"seconds": dt, "ptxas": reports}


# ---------------------------------------------------------------- phase 2

def make_linear(kind: str, k: int, n: int, gen, dev):
    from exllamav2_tpu_torch.ops.dequant import precompute_scales_linear
    from exllamav2_tpu_torch.quant.qtensor import QuantLinear
    from exllamav2_tpu_torch.utils.testing import (
        random_gptq_linear, random_quant_linear)
    if kind == "exl2_4b_prescaled":
        return precompute_scales_linear(
            random_quant_linear(gen, k, n, bits=4, device=dev))
    if kind == "exl2_4b_qscale":
        return random_quant_linear(gen, k, n, bits=4, device=dev)
    if kind == "exl2_mixed_356":
        nsb = k // 256
        rows = [nsb // 3 * 256, (nsb - 2 * (nsb // 3)) * 256,
                nsb // 3 * 256]
        segs = [random_quant_linear(gen, r, n, bits=b, device=dev)
                .segments[0] for r, b in zip(rows, (3, 5, 6))]
        return precompute_scales_linear(
            QuantLinear(segs, None, None, k=k, n=n, n_orig=n))
    if kind == "gptq_4b_gs128_actorder":
        lin = random_gptq_linear(gen, k, n, bits=4, group_rows=128,
                                 device=dev)
        perm = torch.randperm(k, generator=gen, device=dev).to(torch.int32)
        return QuantLinear(list(lin.segments), perm, None, k=k, n=n,
                           n_orig=n)
    raise ValueError(kind)


def linear_bytes(lin, m: int) -> int:
    """Bytes the fused kernel must move for one linear: planes, the meta it
    reads, x (bf16) in and out (f32) once."""
    from exllamav2_tpu_torch.quant.qtensor import GptqSegment
    total = 0
    for seg in lin.segments:
        total += sum(p.numel() * 4 for p in seg.planes)
        if isinstance(seg, GptqSegment):
            total += seg.scale.numel() * 4 + seg.zero.numel() * 4
        elif seg.scale_f is not None:
            total += seg.scale_f.numel() * 2
        else:
            total += seg.qscale.numel() + seg.smax.numel() * 4
        total += m * seg.rows_pad * 2
    return total + m * lin.n * 4


def phase_qmm(dev, rate):
    from exllamav2_tpu_torch.ops import qmm as Q
    from exllamav2_tpu_torch.ops.dequant import dequant_linear
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows, worst = [], 0.0
    kinds = ["exl2_4b_prescaled", "exl2_4b_qscale", "exl2_mixed_356",
             "gptq_4b_gs128_actorder"]
    for kind in kinds:
        for (k, n) in SHAPES:
            one = make_linear(kind, k, n, gen, dev)
            wbytes = linear_bytes(one, 0)
            copies = [one] + [make_linear(kind, k, n, gen, dev) for _ in
                              range(max(1, -(-2 * L2_BYTES // wbytes)) - 1)]
            wdense = [dequant_linear(c, torch.bfloat16, original_order=False)
                      for c in copies[:max(1, -(-2 * L2_BYTES //
                                                 (k * n * 2)))]]
            for m in QMM_ROWS:
                x = (torch.randn((m, k), generator=gen, device=dev)
                     ).to(torch.bfloat16)

                def seg_inputs(lin):
                    xg = x if lin.perm is None else x[:, lin.perm.long()]
                    out, row = [], 0
                    for seg in lin.segments:
                        xs = xg[:, row:row + seg.rows].contiguous()
                        out.append((xs, seg))
                        row += seg.rows
                    return out

                ins = [seg_inputs(c) for c in copies]
                err, scale = 0.0, 0.0
                for xs, seg in ins[0]:
                    got = Q.fused_segment_matmul(xs, seg)
                    ref = Q.qmm_plain(xs, seg)
                    torch.cuda.synchronize()
                    assert torch.isfinite(got).all(), (kind, k, n, m)
                    err = max(err, (got - ref).abs().max().item())
                    scale = max(scale, ref.abs().max().item())
                rel = err / scale
                if rel > QMM_TOL:
                    raise AssertionError(
                        f"qmm {kind} {k}x{n} m={m}: rel err {rel:.3g}")
                worst = max(worst, err)

                def kernel_call(pairs):
                    return lambda: [Q.fused_segment_matmul(xs, s)
                                    for xs, s in pairs]

                ms = graph_ms([kernel_call(p) for p in ins], 40)
                plain_ms = eager_ms(lambda: [Q.qmm_plain(xs, s)
                                             for xs, s in ins[0]], 3)
                lib_ms = graph_ms([(lambda w=w: torch.matmul(x, w))
                                   for w in wdense], 40)
                nbytes = linear_bytes(one, m)
                bound = nbytes / rate * 1e3
                rows.append(dict(kind=kind, k=k, n=n, m=m, max_abs_err=err,
                                 rel_err=rel, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bytes=nbytes,
                                 bound_ms=bound))
                log(f"[qmm] {kind:24s} {k:5d}x{n:5d} m={m:2d} "
                    f"err={err:.2e} rel={rel:.1e} kernel={ms * 1e3:8.1f}us "
                    f"plain={plain_ms * 1e3:9.1f}us lib={lib_ms * 1e3:7.1f}us "
                    f"bound={bound * 1e3:6.1f}us "
                    f"({bound / ms * 100:4.1f}% of roofline)")
            del copies, wdense, ins
            torch.cuda.empty_cache()
    return rows, worst


# ---------------------------------------------------------------- phase 3

def phase_attn(dev, rate):
    from exllamav2_tpu_torch.models.model import _limit_bucket
    from exllamav2_tpu_torch.ops import decode_attn as A
    import torch.nn.functional as Fn
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    d, s_max, nl = 128, 2048, 16
    cases = [(b, hq, hkv, p, 0.0, 0) for b in (1, 4)
             for hq, hkv in ((32, 32), (32, 8)) for p in (0, 255, 1500)]
    cases += [(1, 32, 8, 1500, 30.0, 0), (1, 32, 8, 1500, 0.0, 512)]
    rows, worst = [], 0.0
    for b, hq, hkv, past, cap, win in cases:
        shape = (nl, b, hkv, s_max, d)
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        qs = [torch.randn((b, hq, d), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(nl)]
        limit = _limit_bucket(past + 1, s_max)
        scale = d ** -0.5
        got = A.decode_attention(qs[3], k, v, 3, past, limit, scale, cap, win)
        ref = A.decode_attention_plain(qs[3], k, v, 3, past, limit, scale,
                                       cap, win)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        vmax = v[3].float().abs().max().item()
        if not torch.isfinite(got).all() or err > ATTN_TOL * vmax:
            raise AssertionError(f"attn b={b} {hq}/{hkv} past={past} "
                                 f"cap={cap} win={win}: err {err:.3g}")
        worst = max(worst, err)
        ms = graph_ms([(lambda l=l: A.decode_attention(
            qs[l], k, v, l, past, limit, scale, cap, win))
            for l in range(nl)], 64)
        plain_ms = eager_ms(lambda: A.decode_attention_plain(
            qs[0], k, v, 0, past, limit, scale, cap, win), 5)
        lo = max(0, past - win + 1) if win else 0
        rows_read = min(limit, past + 1) - lo
        mask = torch.zeros((1, limit), dtype=torch.bool, device=dev)
        mask[:, lo:past + 1] = True

        def sdpa(l):
            return lambda: Fn.scaled_dot_product_attention(
                qs[l][:, :, None], k[l, :, :, :limit], v[l, :, :, :limit],
                attn_mask=mask, scale=scale, enable_gqa=hkv != hq)

        lib_ms = graph_ms([sdpa(l) for l in range(nl)], 64) \
            if not cap else None
        nbytes = 2 * b * hkv * rows_read * d * 2 + b * hq * d * (2 + 4)
        bound = nbytes / rate * 1e3
        rows.append(dict(b=b, hq=hq, hkv=hkv, past_len=past, limit=limit,
                         softcap=cap, window=win, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                         bound_ms=bound))
        lib_s = f"{lib_ms * 1e3:7.1f}us" if lib_ms is not None else "   n/a"
        log(f"[attn] b={b} {hq:2d}/{hkv:2d} past={past:4d} limit={limit:4d} "
            f"cap={cap:4.1f} win={win:3d} err={err:.2e} "
            f"kernel={ms * 1e3:7.1f}us plain={plain_ms * 1e3:8.1f}us "
            f"sdpa={lib_s} bound={bound * 1e3:5.1f}us "
            f"({bound / ms * 100:4.1f}% of roofline)")
        del k, v, qs
        torch.cuda.empty_cache()
    return rows, worst


# ---------------------------------------------------------------- phase 4

def phase_load(dev):
    from exllamav2_tpu_torch.models.model import Model
    d = os.path.join(HERE, "tests", "fixtures", "trained_tiny")
    prompt = np.array([[1, 50, 99, 7, 23]], np.int32)
    gpu = Model.from_dir(d, device=dev)
    cpu = Model.from_dir(d, device="cpu")
    got = gpu.generate_greedy(prompt, 16)
    ref = cpu.generate_greedy(prompt, 16)
    log(f"[load] trained_tiny gpu tokens {got[0].tolist()}")
    if got.shape != (1, 21) or not np.array_equal(got, ref):
        raise AssertionError(f"gpu {got.tolist()} != cpu {ref.tolist()}")
    lg, _ = gpu.forward(got, gpu.new_cache(1, 32), 0)
    lc, _ = cpu.forward(got, cpu.new_cache(1, 32), 0)
    rel = ((lg.cpu() - lc).abs().max() / lc.abs().max()).item()
    log(f"[load] prefill logits gpu vs cpu rel err {rel:.2e}")
    if not rel < 0.02:
        raise AssertionError(f"trained_tiny logits rel err {rel}")
    return {"tokens": got.tolist(), "logits_rel_err": rel}


# ---------------------------------------------------------------- phase 5

def phase_7b(dev):
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.ops import qmm as Q
    from exllamav2_tpu_torch.ops import decode_attn as A
    from exllamav2_tpu_torch.ops.dequant import precompute_model_scales
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    t0 = time.perf_counter()
    w, st = random_model_weights(vocab=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 heads=HEADS, kv_heads=HEADS, inter=INTER,
                                 max_seq=2048, bits=4, seed=0, device=dev)
    w = precompute_model_scales(w)
    model = Model(w, st)
    torch.cuda.synchronize()
    gbytes = sum(b.numel() * b.element_size() for b in w.buffers()) / 1e9
    log(f"[7b] weights built on {dev} in {time.perf_counter() - t0:.1f} s, "
        f"{gbytes:.2f} GB")
    rng = np.random.default_rng(0)
    prompt1 = rng.integers(3, VOCAB, (1, 16)).astype(np.int32)
    prompt4 = rng.integers(3, VOCAB, (4, 16)).astype(np.int32)
    new = 32
    model.generate_greedy(prompt1[:, :4], 2)           # warm-up
    torch.cuda.synchronize()

    # --- the main paths, each with its own counts read around the call
    steps = new - 1
    paths = {
        # 16-row prefill and every decode step on the fused kernel
        "generate_greedy_b1": (prompt1, {"qmm": 225 * (1 + steps),
                                         "decode_attn": LAYERS * steps}),
        # 64-row prefill dequantizes + matmuls; only its head (4 rows,
        # last token) and the decode steps (m = 4) are fused
        "generate_greedy_b4": (prompt4, {"qmm": 1 + 225 * steps,
                                         "decode_attn": LAYERS * steps}),
    }
    launches, seqs = {}, {}
    for name, (prompt, want) in paths.items():
        Q.LAUNCHES["qmm"] = 0
        A.LAUNCHES["decode_attn"] = 0
        seq = model.generate_greedy(prompt, new)
        got = {"qmm": Q.LAUNCHES["qmm"],
               "decode_attn": A.LAUNCHES["decode_attn"]}
        log(f"[7b] {name}: launches {got} (expected {want})")
        if got != want:
            raise AssertionError(f"{name} launch counts {got} != {want}")
        b = prompt.shape[0]
        if seq.shape != (b, 16 + new) or seq.min() < 0 or seq.max() >= VOCAB:
            raise AssertionError(f"{name}: bad generation {seq.shape}")
        launches[name], seqs[name] = got, seq
    seq1 = seqs["generate_greedy_b1"]
    log(f"[7b] batch 1 tokens {seq1[0, 16:].tolist()}")

    # --- decode tokens/s at batch 1, timed on generate_greedy itself:
    # 129 new tokens (prefill + 128 decode steps) less 1 (prefill only)
    n_dec = 128

    def wall(n_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.generate_greedy(prompt1, n_new)
        return time.perf_counter() - t

    t_pre = min(wall(1) for _ in range(3))
    t_all = min(wall(1 + n_dec) for _ in range(2))
    ms_tok = (t_all - t_pre) / n_dec * 1e3
    tps = 1e3 / ms_tok
    log(f"[7b] decode batch 1: {tps:.2f} tokens/s ({ms_tok:.3f} ms/token "
        f"over {n_dec} tokens of generate_greedy; prefill-only call "
        f"{t_pre * 1e3:.1f} ms)")

    # --- where a decode token's device time goes (kernels only)
    prof = profile_decode(model, prompt1)
    busy = prof["device_ms_per_token"]
    log(f"[7b] profile: {prof['device_launches_per_token']:.0f} device "
        f"launches/token, device busy {busy:.3f} ms of {ms_tok:.3f} "
        f"ms/token (idle share {1 - busy / ms_tok:.1%})")
    for name, ms_k in prof["top"]:
        log(f"[7b] profile:   {ms_k:6.3f} ms/token  {name}")

    # --- decode vs prefill (batch 1)
    full, _ = model.forward(prompt1, model.new_cache(1, 32), 0)
    cache = model.new_cache(1, 32)
    step = []
    for i in range(prompt1.shape[1]):
        lg, cache = model.forward(prompt1[:, i:i + 1], cache, i)
        step.append(lg[:, 0])
    step = torch.stack(step, 1)
    rel = ((step - full).abs().max() / full.abs().max()).item()
    log(f"[7b] decode vs prefill logits rel err {rel:.2e}")
    if not (torch.isfinite(full).all() and rel < 0.02):
        raise AssertionError(f"decode vs prefill rel err {rel}")
    return {"weights_gb": gbytes, "launches": launches, "profile": prof,
            "decode_tokens_per_s_b1": tps, "decode_ms_per_token_b1": ms_tok,
            "decode_vs_prefill_rel_err": rel, "tokens_b1": seq1.tolist()}


def profile_decode(model, prompt, n: int = 8) -> dict:
    """torch.profiler around generate_greedy(prompt, 1 + n) and
    generate_greedy(prompt, 1): their difference over n is one batch-1
    decode token's device time and launches, summed over kernel events only
    (operator rows repeat their kernels' time)."""
    from torch.profiler import profile, ProfilerActivity

    def kernels(n_new):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.generate_greedy(prompt, n_new)
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None) \
                    or e.self_cuda_time_total
                t, c = out.get(e.key, (0.0, 0))
                out[e.key] = (t + us, c + e.count)
        return out

    kernels(1 + n)                                    # warm-up
    long, short = kernels(1 + n), kernels(1)
    per = {k: ((t - short.get(k, (0.0, 0))[0]) / n / 1e3,
               (c - short.get(k, (0.0, 0))[1]) / n)
           for k, (t, c) in long.items()}
    top = sorted(per.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
    return {"device_ms_per_token": sum(t for t, _ in per.values()),
            "device_launches_per_token": sum(c for _, c in per.values()),
            "top": [(k[:70], t) for k, (t, _) in top]}


def summarize(qrows, qerr, arows, aerr, launches, rate):
    """One entry per kernel for the kernels line: times of the launches one
    decode token at batch 1 makes (qmm: the 4-bit prescaled rows at m=1
    weighted by PER_TOKEN; attn: 32 layers at past_len 255, 32/32 heads).
    `launches` is the count of the batch-1 path; `launches_by_path` holds
    each main path's own count."""
    main = launches["generate_greedy_b1"]

    def by_path(key):
        return {p: c[key] for p, c in launches.items()}

    sel = [r for r in qrows
           if r["kind"] == "exl2_4b_prescaled" and r["m"] == 1]

    def tot(key):
        return sum(PER_TOKEN[(r["k"], r["n"])] * r[key] for r in sel)

    att = next(r for r in arows if r["b"] == 1 and r["hkv"] == 32
               and r["past_len"] == 255)
    return [
        {"name": "qmm_fused_segment_matmul", "route": "cuda",
         "source": "exllamav2_tpu_torch/csrc/qmm.cu",
         "replaces": "exllamav2_tpu/ops/qmm.py:437",
         "launches": main["qmm"], "launches_by_path": by_path("qmm"),
         "max_abs_err": qerr,
         "ms": tot("ms"), "plain_ms": tot("plain_ms"),
         "bound_ms": tot("bytes") / rate * 1e3, "bound_by": "bytes",
         "library_ms": tot("library_ms")},
        {"name": "decode_attention", "route": "cuda",
         "source": "exllamav2_tpu_torch/csrc/decode_attn.cu",
         "replaces": "exllamav2_tpu/ops/decode_attn.py:32",
         "launches": main["decode_attn"],
         "launches_by_path": by_path("decode_attn"), "max_abs_err": aerr,
         "ms": LAYERS * att["ms"], "plain_ms": LAYERS * att["plain_ms"],
         "bound_ms": LAYERS * att["bytes"] / rate * 1e3, "bound_by": "bytes",
         "library_ms": LAYERS * att["library_ms"]},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import exllamav2_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False      # plain versions in
    torch.backends.cudnn.allow_tf32 = False            # full f32
    dev = torch.device("cuda")
    card = card_line()
    rate = mem_rate(card)
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | bound rate {rate / 1e12:.2f} TB/s")
    t_all = time.perf_counter()
    detail = {"card": card, "torch": torch.__version__}
    detail["build"] = phase_build()
    detail["qmm"], qerr = phase_qmm(dev, rate)
    detail["attn"], aerr = phase_attn(dev, rate)
    detail["load"] = phase_load(dev)
    detail["7b"] = phase_7b(dev)
    kernels = summarize(detail["qmm"], qerr, detail["attn"], aerr,
                        detail["7b"]["launches"], rate)
    detail["kernels"] = kernels
    detail["seconds"] = time.perf_counter() - t_all
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    log(f"[done] all phases passed in {detail['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
