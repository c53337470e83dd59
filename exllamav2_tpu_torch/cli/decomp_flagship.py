"""Per-component accounting of the flagship W4A8 decode step (twin of the
reference's tools/decomp_flagship.py).

Times each weight-stream matmul of the 7B GPTQ-gs128 merged + W4A8 model at
decode shape (m = 1: kernel 4, csrc/qmm_w4a8.cu), the exact lm_head
(kernel 1) and the residue (attention, RoPE, norms, sampling, dispatch:
the full step less the linears and the head) against the full graphed
decode step, with utils/timing.device_time for the kernels and the host
clock for the step. The weight-stream bound is the bytes a token reads
over the card's own memory rate (H100 SXM 3.35 TB/s, PCIe 2.0 TB/s), named
with the card; the reference's 620 GB/s was its TPU's.

    python -m exllamav2_tpu_torch.cli.decomp_flagship [--device cpu]
"""

import argparse
import time

import torch


def _rate(dev) -> tuple[str, float | None]:
    """(the card's name, its memory bytes/s), or ("cpu", None)."""
    if dev.type != "cuda":
        return str(dev), None
    name = torch.cuda.get_device_name(dev)
    if "H100" not in name:
        return name, None
    return name, 2.0e12 if "PCIe" in name else 3.35e12


def _bytes(lin) -> int:
    by = sum(p.numel() * 4 for s in lin.segments for p in s.planes)
    for s in lin.segments:
        if getattr(s, "scale_bf", None) is not None:
            by += s.scale_bf.numel() * 2 + s.zs_bf.numel() * 2
        else:
            by += s.scale.numel() * 4 + s.zero.numel() * 4
    return by


def main(argv=None) -> dict:
    """-> {"components": {name: (seconds, bytes)}, "lm_head": (seconds,
    bytes), "step_ms", "linears_ms", "head_ms", "residue_ms",
    "weight_stream_bytes", "card", "bound_ms" (None without a rate)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from exllamav2_tpu_torch.device import resolve_device
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.ops import qmm as M
    from exllamav2_tpu_torch.ops.dequant import (enable_w4a8,
                                                 merge_serving_weights,
                                                 precompute_model_scales)
    from exllamav2_tpu_torch.utils import testing
    from exllamav2_tpu_torch.utils.timing import device_time

    dev = resolve_device(args.device)
    w, st = testing.random_model_weights(max_seq=2048, bits=4, seed=0,
                                         fmt="gptq", device=dev)
    w = enable_w4a8(precompute_model_scales(merge_serving_weights(w)))
    layer = w.layers[0]
    comps = {
        "qkv_merged": layer.attn.qkv if layer.attn.qkv is not None
        else layer.attn.q,
        "o_proj": layer.attn.o,
        "gate_up_merged": layer.mlp.gate_up
        if getattr(layer.mlp, "gate_up", None) is not None
        else layer.mlp.up,
        "down_proj": layer.mlp.down,
    }
    report = {}
    for name, lin in comps.items():
        x = (torch.arange(lin.k, device=dev).to(torch.bfloat16)[None, :]
             % 7) * 0.01
        t = device_time(lambda xv, lin=lin: M.qmm(xv, lin, fused=True).to(
            torch.bfloat16), x, iters=128)
        by = _bytes(lin)
        report[name] = (t, by)
        print(f"{name:16s} {t*1e6:8.1f} us  {by/2**20:7.1f} MiB  "
              f"{by/t/1e9:6.1f} GB/s", flush=True)

    # the exact lm_head at decode shape
    head = w.head
    xh = (torch.arange(head.k, device=dev).to(torch.bfloat16)[None, :]
          % 7) * 0.01
    th = device_time(lambda xv: M.qmm(xv, head, fused=True).to(
        torch.bfloat16), xh, iters=64)
    bh = sum(p.numel() * 4 for s in head.segments for p in s.planes)
    print(f"{'lm_head(exact)':16s} {th*1e6:8.1f} us  {bh/2**20:7.1f} MiB  "
          f"{bh/th/1e9:6.1f} GB/s", flush=True)

    # the full decode step (graphed on the card), host-timed a token
    model = Model(w, st)
    cache = model.new_cache(batch=1, max_seq=2048)
    tok = torch.ones((1, 1), dtype=torch.int32, device=dev)

    def step(pos, tok):
        logits, _ = model.forward(tok, cache, pos)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]

    for i in range(3):
        tok = step(512 + i, tok)
    tok.cpu()
    t0 = time.perf_counter()
    steps = 64
    for i in range(steps):
        tok = step(515 + i, tok)
    tok.cpu()
    step_ms = (time.perf_counter() - t0) / steps * 1000

    L = st.num_layers
    lin_ms = sum(t for t, _ in report.values()) * 1000 * L
    head_ms = th * 1000
    resid = step_ms - lin_ms - head_ms
    tot_bytes = sum(by for _, by in report.values()) * L + bh
    card, rate = _rate(dev)
    bound_ms = None if rate is None else tot_bytes / rate * 1e3
    print(f"\nfull step        {step_ms:8.3f} ms  ({1000/step_ms:.1f} t/s)")
    print(f"linears x{L}      {lin_ms:8.3f} ms")
    print(f"lm_head          {head_ms:8.3f} ms")
    print(f"residue          {resid:8.3f} ms  "
          f"(attn+norms+rope+sampler+dispatch)")
    if rate is None:
        print(f"weight stream    {tot_bytes/2**30:.2f} GiB/token (no memory "
              f"rate known for {card})", flush=True)
    else:
        print(f"weight stream    {tot_bytes/2**30:.2f} GiB/token -> bound "
              f"{bound_ms:.3f} ms at {rate/1e9:.0f} GB/s ({card})",
              flush=True)
    return {"components": report, "lm_head": (th, bh), "step_ms": step_ms,
            "linears_ms": lin_ms, "head_ms": head_ms, "residue_ms": resid,
            "weight_stream_bytes": tot_bytes, "card": card,
            "bound_ms": bound_ms}


if __name__ == "__main__":
    main()
